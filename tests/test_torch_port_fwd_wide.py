"""Which design kernel C's forward and kernel B's forward and backward
run, the host helpers of the new designs, and the plain C's order of
summation, on the CPU.

``ops/vn_layer_fused.py::forward_design`` gives kernel C the wide design
(cp.async rings over a W^T scratch; FP32 FMAs in float32, the tensor cores
in bf16; the channel blocks' projections summed by a second pass) at C_in,
C_out >= 16 and the narrow one below; ``layer_fwd_design`` gives B a store
stream (no product tile) at C_in <= 2 and the narrow tile above;
``layer_bwd_design`` gives B' one fused pass at C_in <= 2 and the narrow
passes above; ``fwd_bf16_design`` gives a wide bf16 C the "wgmma" design
(proj_wgmma) where its tiles fit, whose host helpers (its shared memory,
its persistent grid) are checked here too.  The CUDA kernels take what the
wrapper picks, so the choice
for every layer of the four pipelines is checked here, where no card is
needed.  In the bf16 mode the plain C
sums its projection in the order of the design the kernel takes, so the
card can hold the kernel to it; both orders are held against JAX's Pallas
kernel here.  The kernels themselves are held against their plain versions
by the ``gpu`` tests of ``tests/test_torch_port_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_bf16 import _bf16, _check_bf16, _layer_bf16_inputs
from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused as port_layer
from vn_pointcloudcompletion_tpu_torch.utils.config import Config

torch.set_num_threads(2)

NS = 0.2
# (encoder, decoder, num_coarse): the decoders' fold layers take the
# whole-layer kernels at >= 4096 points
_PIPELINES = {
    "flagship": ("vn_pointnet", "vn_foldingnet", 256),
    "vn_dgcnn": ("vn_dgcnn_fps", "vn_foldingnet", 256),
    "dgcnn": ("dgcnn_fps", "foldingnet", 448),
    "vn_pointr": ("vn_pointr", "attention_vn_foldingnet", 448),
}
# (kernel, C_in, C_out, group) of every C, B and B' launch of one train
# step, and its design: C at final_conv.1 + .2 (256 -> 256) and
# vn_folding{1,2}.1 + .2 (256 -> 128) wide; B at final_conv.0 (2 -> 256),
# conv1 (2 -> 32) and the pair folds (1 -> 256, group 64) the store stream,
# B' there fused; the scalar DGCNN none
_EXPECTED = {
    "flagship": {("C", 256, 256, 0): "wide", ("B", 2, 256, 0): "stream",
                 ("B'", 2, 256, 0): "fused"},
    "vn_dgcnn": {("C", 256, 256, 0): "wide", ("B", 2, 256, 0): "stream",
                 ("B", 2, 32, 0): "stream", ("B'", 2, 256, 0): "fused",
                 ("B'", 2, 32, 0): "fused"},
    "dgcnn": {},
    "vn_pointr": {("C", 256, 128, 0): "wide", ("B", 2, 32, 0): "stream",
                  ("B", 1, 256, 64): "stream", ("B'", 2, 32, 0): "fused",
                  ("B'", 1, 256, 64): "fused"},
}


@pytest.mark.parametrize("name", list(_PIPELINES))
def test_design_of_every_c_and_b_bwd_layer(name, monkeypatch):
    """One train-mode forward and backward of a pipeline at num_coarse 256
    or 448: each C, B and B' call's (C_in, C_out, group) and the design the
    wrapper takes for it."""
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model

    seen = {}

    def record(kernel, fn, design):
        def wrapped(x, w, *args, **kwargs):
            group = kwargs.get("group", args[-1] if isinstance(args[-1], int) else 0)
            seen[(kernel, x.shape[2], w.shape[0], group)] = design(x.shape[2], w.shape[0])
            return fn(x, w, *args, **kwargs)
        return wrapped

    monkeypatch.setattr(port_layer, "vn_layer_fused_project",
                        record("C", port_layer.vn_layer_fused_project, port_layer.forward_design))
    monkeypatch.setattr(port_layer, "vn_layer_fused",
                        record("B", port_layer.vn_layer_fused, lambda c_in, _: port_layer
                               .layer_fwd_design(c_in)))
    monkeypatch.setattr(port_layer, "layer_bwd",
                        record("B'", port_layer.layer_bwd, lambda c_in, _: port_layer
                               .layer_bwd_design(c_in)))
    enc, dec, nc = _PIPELINES[name]
    model = build_model(Config.from_dict({"enc_type": enc, "dec_type": dec,
                                          "num_coarse": nc, "seed": 3})).train()
    xyz = torch.from_numpy((np.random.default_rng(5).standard_normal((1, 600, 3)) * 0.3)
                           .astype(np.float32))
    coarse, fine = model(xyz)
    (coarse.square().sum() + fine.square().sum()).backward()
    assert seen == _EXPECTED[name]


# (C_in, C_out, group) of every C launch of one train-mode forward under the
# bf16 policy, and the design fwd_bf16_design gives it: the "wgmma" design
# at final_conv.1 + .2 (256 -> 256, N 4096 at num_coarse 256) and
# vn_folding{1,2}.1 + .2 (256 -> 128, N 14336); the scalar DGCNN none
_EXPECTED_BF16 = {
    "flagship": {(256, 256, 0): "wgmma"},
    "vn_dgcnn": {(256, 256, 0): "wgmma"},
    "dgcnn": {},
    "vn_pointr": {(256, 128, 0): "wgmma"},
}


@pytest.mark.parametrize("name", list(_PIPELINES))
def test_bf16_design_of_every_c_layer(name, monkeypatch):
    """One train-mode forward of a pipeline under the bf16 policy: each C
    call gets bf16 x and takes the design of fwd_bf16_design, as a CUDA
    launch would (the point rows' alignment read from x itself)."""
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.nn.precision import compute_dtype_scope

    seen = {}
    project = port_layer.vn_layer_fused_project

    def wrapped(x, w, *args, **kwargs):
        group = kwargs.get("group", 0)
        assert x.dtype == torch.bfloat16
        assert port_layer.forward_design(x.shape[2], w.shape[0]) == "wide"
        seen[(x.shape[2], w.shape[0], group)] = port_layer.fwd_bf16_design(
            x.shape[2], w.shape[0], x.shape[3], port_layer._aligned(x), group)
        return project(x, w, *args, **kwargs)

    monkeypatch.setattr(port_layer, "vn_layer_fused_project", wrapped)
    enc, dec, nc = _PIPELINES[name]
    model = build_model(Config.from_dict({"enc_type": enc, "dec_type": dec,
                                          "num_coarse": nc, "seed": 3})).train()
    xyz = torch.from_numpy((np.random.default_rng(5).standard_normal((1, 600, 3)) * 0.3)
                           .astype(np.float32))
    with torch.no_grad(), compute_dtype_scope(torch.bfloat16):
        model(xyz)
    assert seen == _EXPECTED_BF16[name]


@pytest.mark.parametrize("c_in,c_out,n,aligned,group,design", [
    (256, 256, 16384, True, 0, "wgmma"), (256, 128, 14336, True, 0, "wgmma"),
    (64, 64, 1000, True, 0, "wgmma"), (128, 192, 8, True, 0, "wgmma"),
    (48, 64, 1000, True, 0, "wide"), (64, 48, 1000, True, 0, "wide"),
    (320, 256, 1000, True, 0, "wide"), (512, 512, 1000, True, 0, "wide"),
    (256, 256, 1004, True, 0, "wide"), (256, 256, 999, True, 0, "wide"),
    (256, 256, 16384, False, 0, "wide"), (256, 128, 14336, True, 16, "wide"),
    (256, 128, 14336, True, 32, "wide"), (256, 128, 14336, True, 64, "wgmma"),
    (256, 128, 16384, True, 128, "wgmma"), (256, 128, 14400, True, 96, "wide"),
])
def test_fwd_bf16_design_boundary(c_in, c_out, n, aligned, group, design):
    """bf16 C takes the wgmma design where its tiles fit: both widths
    multiples of 64, C_in at most 256 (x resident), point rows of whole
    16-byte vectors (N % 8 == 0, an aligned base), a bias column covering
    whole 64-point tiles (group 0 or a multiple of 64); the wide design
    elsewhere."""
    assert port_layer.forward_design(c_in, c_out) == "wide"
    assert port_layer.fwd_bf16_design(c_in, c_out, n, aligned, group) == design


@pytest.mark.parametrize("c_in", [64, 128, 192, 256, 320])
def test_proj_wgmma_shared_memory_fits_one_block_an_sm(c_in):
    """proj_wgmma's shared memory (x resident: 24 KB a 64-deep chunk; four
    16 KB stages of W^T and Wd^T; the staged p, d, A, B, w_out; the halves'
    sums) fits the 232,448 bytes a block may use up to C_in 256, the
    chooser's limit, and not at 320: 224,128 bytes at the main path's 256."""
    bytes_ = port_layer.proj_wgmma_smem(c_in)
    assert (bytes_ <= 232448) == (c_in <= port_layer.PROJ_WGMMA_MAX_CIN)
    if c_in == 256:
        assert bytes_ == 1024 + 4 * 24576 + 4 * 16384 + 55296 + 3072 + 768 + 128 == 224128


@pytest.mark.parametrize("bsz,n,sms", [(8, 16384, 132), (8, 14336, 132), (2, 1000, 132),
                                       (1, 64, 132), (3, 520, 4), (8, 16384, 1)])
def test_proj_wgmma_grid_walks_every_tile_once(bsz, n, sms):
    """The persistent blocks (one an SM, no more than the tiles) walk tiles
    k, k + grid, ...: every (sample, 64-point tile) exactly once, and the
    blocks' counts differ by at most one."""
    grid = port_layer.proj_wgmma_grid(bsz, n, sms)
    tiles = bsz * -(-n // port_layer.TILE)
    assert grid == min(tiles, sms)
    walked = [list(range(k, tiles, grid)) for k in range(grid)]
    assert sorted(t for ts in walked for t in ts) == list(range(tiles))
    assert max(map(len, walked)) - min(map(len, walked)) <= 1


@pytest.mark.parametrize("c_in,c_out,design", [
    (2, 256, "narrow"), (15, 256, "narrow"), (16, 15, "narrow"), (16, 16, "wide"),
    (48, 80, "wide"), (256, 128, "wide"), (256, 256, "wide"), (512, 512, "wide"),
])
def test_forward_design_boundary(c_in, c_out, design):
    """C is wide from C_in = C_out = 16 (one m16n8k16 product's depth) up,
    the same boundary as S' and C'."""
    assert port_layer.forward_design(c_in, c_out) == design
    assert port_layer.backward_design(c_in, c_out) == design


@pytest.mark.parametrize("c_in,design", [(1, "fused"), (2, "fused"), (3, "narrow"),
                                         (16, "narrow"), (256, "narrow")])
def test_layer_bwd_design_boundary(c_in, design):
    """B' fuses its passes at C_in <= 2 (csrc layer_bwd_fused instantiates
    1 and 2); the output width does not matter."""
    assert port_layer.layer_bwd_design(c_in) == design


@pytest.mark.parametrize("c_in,design", [(1, "stream"), (2, "stream"), (3, "narrow"),
                                         (16, "narrow"), (256, "narrow")])
def test_layer_fwd_design_boundary(c_in, design):
    """B streams its output at C_in <= 2 (csrc layer_fwd_stream instantiates
    1 and 2), the widths where B' fuses its passes; the output width does
    not matter."""
    assert port_layer.layer_fwd_design(c_in) == design
    assert (design == "stream") == (port_layer.layer_bwd_design(c_in) == "fused")


@pytest.mark.parametrize("c_out,bf16,blocks", [
    (256, False, 8), (256, True, 4), (128, False, 4), (128, True, 2), (80, False, 3),
    (80, True, 2), (16, False, 1), (16, True, 1),
])
def test_projection_blocks_cover_every_channel_once(c_out, bf16, blocks):
    """The wide C's grid: channel block k of 32 (float32) or 64 (bf16)
    channels holds channels k * block .. ; every channel lies in exactly
    one block and no block is empty."""
    got = port_layer.projection_blocks(c_out, bf16)
    size = port_layer.WIDE_BF16_BLOCK if bf16 else port_layer.WIDE_F32_BLOCK
    assert got == blocks
    owner = np.arange(c_out) // size
    assert set(owner.tolist()) == set(range(got))


@pytest.mark.parametrize("bsz,n,c_in,c_out", [(8, 16384, 2, 256), (8, 14336, 1, 256),
                                              (2, 1000, 2, 80), (1, 64, 1, 16)])
def test_fused_weight_partials_one_per_tile(bsz, n, c_in, c_out):
    """B''s fused pass writes dW and dWd as one (C_out, C_in) partial per
    64-point tile of each sample (the last tile ragged): 8 MB at the
    decoder's 2 -> 256, batch 8, N 16384, against the 805 MB dp/dd scratch
    of the narrow passes."""
    tiles = -(-n // port_layer.TILE)
    assert port_layer.fused_weight_partials(bsz, n, c_in, c_out) == 2 * bsz * tiles * c_out * c_in
    if (bsz, n, c_in, c_out) == (8, 16384, 2, 256):
        assert port_layer.fused_weight_partials(bsz, n, c_in, c_out) * 4 == 8 * 2 ** 20


@pytest.mark.parametrize("bsz,n,c_in,c_out", [(8, 16384, 2, 256), (8, 14336, 1, 256),
                                              (2, 1000, 2, 80), (1, 64, 1, 16)])
def test_fused_stats_weight_partials_one_per_tile(bsz, n, c_in, c_out):
    """S''s fused pass writes dW alone, one (C_out, C_in) partial per
    64-point tile of each sample: half of B''s, 4 MB at final_conv.0's 2 ->
    256, batch 8, N 16384, against the 403 MB dp scratch of the narrow
    passes."""
    tiles = -(-n // port_layer.TILE)
    got = port_layer.fused_weight_partials(bsz, n, c_in, c_out, grads=1)
    assert got == bsz * tiles * c_out * c_in
    assert 2 * got == port_layer.fused_weight_partials(bsz, n, c_in, c_out)
    if (bsz, n, c_in, c_out) == (8, 16384, 2, 256):
        assert got * 4 == 4 * 2 ** 20


def _kernel_lanes_order(prods):
    """proj_wide_mma's contraction walked lane by lane: for each channel
    block and channel warp, each of the eight row lanes sums its four
    channels (mt, r) in order from zero, the lanes add pairwise (neighbours,
    then pairs, then quads), the two warps add, the blocks add in turn."""
    b, _, c, n = prods.shape
    out = torch.zeros(b, 3, 1, n)
    for cb in range(-(-c // 64)):
        warps = []
        for wm in range(2):
            lanes = []
            for grp in range(8):
                t = torch.zeros(b, 3, 1, n)
                for mt in range(2):
                    for r in range(2):
                        ch = cb * 64 + wm * 32 + mt * 16 + 8 * r + grp
                        if ch < c:
                            t = t + prods[:, :, ch:ch + 1]
                lanes.append(t)
            while len(lanes) > 1:
                lanes = [lanes[i] + lanes[i + 1] for i in range(0, len(lanes), 2)]
            warps.append(lanes[0])
        out = out + (warps[0] + warps[1])
    return out


@pytest.mark.parametrize("c", [256, 128, 80, 16])
def test_wide_projection_order_is_the_kernels(c):
    """The plain bf16 C's wide order equals the kernel's lane-by-lane walk
    to the bit, ragged channel blocks included."""
    prods = torch.from_numpy(np.random.default_rng(c).standard_normal((2, 3, c, 40))
                             .astype(np.float32))
    assert torch.equal(port_layer._project_wide_order(prods), _kernel_lanes_order(prods))


@pytest.mark.parametrize("c_in,c_out,wide", [(8, 32, False), (48, 80, True)])
def test_kernel_c_bf16_plain_matches_pallas_in_both_orders(c_in, c_out, wide):
    """The plain bf16 C of either design against JAX's Pallas kernel in
    interpret mode, with test_torch_port_bf16's bound for C (one bf16 ulp of
    each vector, at most 5% of elements differing): the summation order
    moves bits, not values."""
    from vn_pointcloudcompletion_tpu.ops import vn_layer_fused as jax_layer

    assert (port_layer.forward_design(c_in, c_out) == "wide") == wide
    rng = np.random.default_rng(c_in + c_out)
    x, w, wd, _, _, a, b, w_out = _layer_bf16_inputs(rng, 2, c_in, c_out, 1024, 0)
    _, jx, tx = _bf16(x)
    t = [torch.from_numpy(v) for v in (w, wd, a, b, w_out)]
    got = port_layer.vn_layer_fused_project(tx, t[0], t[1], None, None, *t[2:], NS)
    want = jax_layer.vn_layer_fused_project(
        jx, jnp.asarray(w), jnp.asarray(wd), None, None,
        *map(jnp.asarray, (a, b, w_out)), NS, True, True)
    assert got.shape == (2, 3, 1, 1024)
    _check_bf16(f"C {c_in} -> {c_out}", got, want, share=0.05)
