"""Which passes kernels S, S' and C' run, and the chunking of their wide
weight-gradient pass, on the CPU.

``ops/vn_layer_fused.py::backward_design`` picks the wide passes (cp.async
rings; in the bf16 mode dx, dW and S''s p on the tensor cores) for C_in
and C_out >= 16 and the narrow ones (pd_pass, dx_gemm, dw_gemm) below
that, for C' and for S' above C_in 2; ``stats_bwd_design`` gives S' one
fused pass that walks the channels at C_in <= 2, and ``stats_design`` gives
S that walk without its gradients ("stream") there and the wide pass 1
without its dp store, or pd_pass, above; the CUDA kernels take what the
wrapper picks, so the choice for every layer a pipeline trains is checked
here, where no card is needed.
``wide_split`` cuts pass 3's reduction into whole stages of one plane
each: every point is summed by exactly one split.  The kernels themselves
are held against their plain versions by the ``gpu`` tests of
``tests/test_torch_port_kernels.py``.
"""

import numpy as np
import pytest
import torch

from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused as port_layer
from vn_pointcloudcompletion_tpu_torch.utils.config import Config

torch.set_num_threads(2)

# (encoder, decoder, num_coarse): the decoders' fold layers take the
# whole-layer kernels at >= 4096 points
_PIPELINES = {
    "flagship": ("vn_pointnet", "vn_foldingnet", 256),
    "vn_dgcnn": ("vn_dgcnn_fps", "vn_foldingnet", 256),
    "vn_pointr": ("vn_pointr", "attention_vn_foldingnet", 448),
}
# (kernel, C_in, C_out, group) of every S' and C' launch of one train step,
# and its design: final_conv.0 (2 -> 256), the pair folds (1 -> 256, group
# 64) and VN DGCNN's and vn_pointr's conv1 (2 -> 32) fused; final_conv.1
# (256 -> 256) and vn_folding{1,2}.1 (256 -> 128) wide
_EXPECTED = {
    "flagship": {("S'", 2, 256, 0): "fused", ("S'", 256, 256, 0): "wide",
                 ("C'", 256, 256, 0): "wide"},
    "vn_dgcnn": {("S'", 2, 32, 0): "fused", ("S'", 2, 256, 0): "fused",
                 ("S'", 256, 256, 0): "wide", ("C'", 256, 256, 0): "wide"},
    "vn_pointr": {("S'", 2, 32, 0): "fused", ("S'", 1, 256, 64): "fused",
                  ("S'", 256, 128, 0): "wide", ("C'", 256, 128, 0): "wide"},
}


# ... and the design each takes in the bf16 mode (pass1_bf16_design): every
# wide layer's widths are multiples of 64 and its point rows (4096 points
# at num_coarse 256, 14336 at 448) 16-byte aligned, so the wgmma passes, and
# S''s pass 1 on wgmma too ("wgmma_p"), C''s certified one ("certified":
# every C' call of a flagship and a vn_pointr_448 train step); the walk and
# the narrow passes keep theirs
_EXPECTED_BF16 = {name: {key: ("wgmma_p" if key[0] == "S'" else "certified")
                         if design == "wide" else design
                         for key, design in layers.items()}
                  for name, layers in _EXPECTED.items()}


@pytest.mark.parametrize("name", list(_PIPELINES))
def test_backward_design_of_every_trained_layer(name, monkeypatch):
    """One train-mode forward and backward of a pipeline at num_coarse 256
    or 448: each S' and C' call's (C_in, C_out, group) and the design the
    wrapper takes for it, in float32 and in the bf16 mode (where a wide
    layer's passes go to wgmma, its pass 1 too)."""
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model

    seen, seen_bf16 = {}, {}

    def record(kernel, fn, design):
        def wrapped(x, w, *args):
            group = args[-1] if isinstance(args[-1], int) else 0
            key = (kernel, x.shape[2], w.shape[0], group)
            seen[key] = design(x.shape[2], w.shape[0])
            seen_bf16[key] = (port_layer.pass1_bf16_design(kernel, x.shape[2], w.shape[0],
                                                           x.shape[3], True, group)
                              if seen[key] == "wide" else seen[key])
            return fn(x, w, *args)
        return wrapped

    monkeypatch.setattr(port_layer, "stats_bwd",
                        record("S'", port_layer.stats_bwd, port_layer.stats_bwd_design))
    monkeypatch.setattr(port_layer, "layer_project_bwd",
                        record("C'", port_layer.layer_project_bwd, port_layer.backward_design))
    enc, dec, nc = _PIPELINES[name]
    model = build_model(Config.from_dict({"enc_type": enc, "dec_type": dec,
                                          "num_coarse": nc, "seed": 3})).train()
    xyz = torch.from_numpy((np.random.default_rng(5).standard_normal((1, 600, 3)) * 0.3)
                           .astype(np.float32))
    coarse, fine = model(xyz)
    (coarse.square().sum() + fine.square().sum()).backward()
    assert seen == _EXPECTED[name]
    assert seen_bf16 == _EXPECTED_BF16[name]


# (C_in, C_out, group) of every S launch of one train step, and its
# design: the train-mode BatchNorm statistics of each whole-layer VN layer,
# so the same widths as S', and the channel walk ("stream") where S' fuses
_STATS_EXPECTED = {name: {(c_in, c_out, group): "stream" if design == "fused" else design
                          for (kernel, c_in, c_out, group), design in layers.items()
                          if kernel == "S'"}
                   for name, layers in _EXPECTED.items()}


@pytest.mark.parametrize("name", list(_PIPELINES))
def test_stats_design_of_every_trained_layer(name, monkeypatch):
    """One train-mode forward of a pipeline at num_coarse 256 or 448: each
    kernel S call's (C_in, C_out, group) and the design the wrapper takes
    for it (final_conv.1's 256 -> 256 and vn_folding{1,2}.1's 256 -> 128
    wide; 2 -> 256, 2 -> 32 and the pair folds' 1 -> 256 at group 64 the
    stream)."""
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model

    seen = {}
    stats_fwd = port_layer.stats_fwd

    def record(x, w, pbias, group=0):
        seen[(x.shape[2], w.shape[0], group)] = port_layer.stats_design(x.shape[2], w.shape[0])
        return stats_fwd(x, w, pbias, group)

    monkeypatch.setattr(port_layer, "stats_fwd", record)
    enc, dec, nc = _PIPELINES[name]
    model = build_model(Config.from_dict({"enc_type": enc, "dec_type": dec,
                                          "num_coarse": nc, "seed": 3})).train()
    xyz = torch.from_numpy((np.random.default_rng(5).standard_normal((1, 600, 3)) * 0.3)
                           .astype(np.float32))
    model(xyz)
    assert seen == _STATS_EXPECTED[name]


@pytest.mark.parametrize("c_in,c_out,design", [
    (1, 256, "stream"), (2, 256, "stream"), (2, 32, "stream"), (1, 4, "stream"),
    (3, 256, "narrow"), (15, 256, "narrow"), (16, 15, "narrow"), (15, 16, "narrow"),
    (16, 16, "wide"), (256, 128, "wide"), (256, 256, "wide"),
])
def test_stats_design_boundary(c_in, c_out, design):
    """Kernel S walks its channels at C_in <= 2 exactly where S' and B' fuse
    their passes, and above that is wide from C_in = C_out = 16 up, as S'
    and C'."""
    assert port_layer.stats_design(c_in, c_out) == design
    walks = port_layer.stats_design(c_in, c_out) == "stream"
    assert walks == (port_layer.stats_bwd_design(c_in, c_out) == "fused")
    assert walks == (port_layer.layer_bwd_design(c_in) == "fused")
    if not walks:
        assert port_layer.stats_design(c_in, c_out) == port_layer.backward_design(c_in, c_out)


@pytest.mark.parametrize("c_in,c_out,design", [
    (1, 256, "fused"), (2, 256, "fused"), (2, 32, "fused"), (1, 4, "fused"),
    (3, 256, "narrow"), (3, 16, "narrow"), (15, 256, "narrow"), (15, 16, "narrow"),
    (16, 15, "narrow"), (16, 16, "wide"), (16, 256, "wide"), (256, 256, "wide"),
])
def test_stats_bwd_design_boundary(c_in, c_out, design):
    """Kernel S' fuses its passes at C_in 1 and 2 (csrc channel_walk
    instantiates those), whatever the output width; above that it takes C''s
    passes (backward_design): narrow below C_in = C_out = 16, wide from
    there."""
    assert port_layer.stats_bwd_design(c_in, c_out) == design
    if c_in > port_layer.FUSED_MAX_CIN:
        assert design == port_layer.backward_design(c_in, c_out)


@pytest.mark.parametrize("c_in,c_out", [(1, 256), (2, 32), (3, 16), (16, 15), (16, 16),
                                        (256, 128)])
def test_design_codes_cover_every_choice(c_in, c_out):
    """Every design the choosers of S, S', C' and B' return has its code in
    DESIGN_CODES (csrc/vn_layer_bwd.cu's enum Design), and the channel walk
    has one code under both of its names."""
    codes = port_layer.DESIGN_CODES
    for design in (port_layer.stats_design(c_in, c_out), port_layer.stats_bwd_design(c_in, c_out),
                   port_layer.backward_design(c_in, c_out), port_layer.layer_bwd_design(c_in),
                   port_layer.wide_bf16_design(c_in, c_out, 1024)):
        assert design in codes
    assert codes["stream"] == codes["fused"] not in (codes["narrow"], codes["wide"])
    assert codes["wgmma"] not in (codes["narrow"], codes["wide"], codes["fused"])


@pytest.mark.parametrize("c_in,c_out,design", [
    (1, 256, "narrow"), (2, 256, "narrow"), (2, 32, "narrow"), (15, 256, "narrow"),
    (16, 15, "narrow"), (16, 16, "wide"), (48, 80, "wide"), (256, 128, "wide"),
    (256, 256, "wide"), (512, 512, "wide"),
])
def test_backward_design_boundary(c_in, c_out, design):
    """Wide from C_in = C_out = 16 (one m16n8k16 product's depth) up; C'
    at group 64 (256 -> 128, phase 3 of chip_smoke.py) is wide too: the
    choice reads the shape only."""
    assert port_layer.backward_design(c_in, c_out) == design


def _split_points(s, chunk, bsz, n, bf16, design="wide"):
    """The (plane, point) pairs that split ``s`` of the wide pass 3 sums
    over, walked as ``dw_wide_f32`` / ``dw_wide_bf16`` / ``dw_wgmma`` walk
    them: stage t is plane t // ceil(n / step), points (t % ceil(n / step))
    * step ..."""
    step = port_layer.wide_stage_points(bf16, design)
    per_plane = -(-n // step)
    for t in range(s * chunk, min((s + 1) * chunk, bsz * 3 * per_plane)):
        n0 = (t % per_plane) * step
        for p in range(n0, min(n0 + step, n)):
            yield t // per_plane, p


@pytest.mark.parametrize("bsz,n,c_in,c_out,two,bf16", [
    (2, 1000, 48, 80, True, False),
    (2, 1000, 48, 80, False, True),
    (1, 4100, 256, 256, True, True),
    (3, 17, 16, 16, False, True),
    (2, 1088, 256, 128, True, False),
    (8, 16384, 256, 256, False, False),
])
def test_wide_split_covers_every_point_once(bsz, n, c_in, c_out, two, bf16):
    """Every (plane, point) of B*3 planes of n points lies in exactly one
    split's stages, no split is empty, and the splits fill the card (132
    SMs) at least once over."""
    sms = 132
    splits, chunk = port_layer.wide_split(c_in, c_out, bsz, n, two, bf16, sms)
    step = port_layer.wide_stage_points(bf16)
    stages = bsz * 3 * -(-n // step)
    assert splits >= 1 and chunk >= 1
    assert (splits - 1) * chunk < stages <= splits * chunk  # none empty, none missing
    seen = np.zeros((bsz * 3, n), dtype=np.int64)
    for s in range(splits):
        pts = list(_split_points(s, chunk, bsz, n, bf16))
        assert pts, f"split {s} is empty"
        planes, points = np.array(pts).T
        np.add.at(seen, (planes, points), 1)
    assert (seen == 1).all()
    tiles = -(-c_out // (64 if two else 128)) * -(-c_in // 128)
    assert splits * tiles >= min(sms, stages * tiles)


@pytest.mark.parametrize("bsz,n,c_in,c_out,two", [
    (2, 1000, 64, 64, True),
    (2, 1000, 128, 64, False),
    (1, 4104, 256, 256, True),
    (8, 16384, 256, 256, False),
    (8, 14336, 256, 128, True),
    (3, 24, 64, 192, True),
])
def test_wgmma_split_covers_every_point_once(bsz, n, c_in, c_out, two):
    """The wgmma pass 3 (csrc ``dw_wgmma``) walks 64-point stages of one
    plane: every (plane, point) lies in exactly one split, none is empty,
    and its one-block-an-SM grid of 128 x 128 tiles fills the card once
    over, or takes the 64 splits that the in-order reduction sums one
    thread a column (less at most a half, where whole chunks of stages
    round the count down)."""
    sms = 132
    splits, chunk = port_layer.wide_split(c_in, c_out, bsz, n, two, True, sms, "wgmma")
    step = port_layer.wide_stage_points(True, "wgmma")
    assert step == port_layer.WGMMA_CHANNELS == 64
    stages = bsz * 3 * -(-n // step)
    assert (splits - 1) * chunk < stages <= splits * chunk
    seen = np.zeros((bsz * 3, n), dtype=np.int64)
    for s in range(splits):
        pts = list(_split_points(s, chunk, bsz, n, True, "wgmma"))
        assert pts, f"split {s} is empty"
        planes, points = np.array(pts).T
        np.add.at(seen, (planes, points), 1)
    assert (seen == 1).all()
    tiles = -(-c_out // 128) * -(-c_in // 128)
    assert splits <= port_layer.REDUCE_FEW_ROWS
    assert 2 * splits >= min(-(-sms // tiles), stages, port_layer.REDUCE_FEW_ROWS)


@pytest.mark.parametrize("c_in,c_out,n,aligned,design", [
    (64, 64, 1000, True, "wgmma"), (256, 256, 16384, True, "wgmma"),
    (256, 128, 14336, True, "wgmma"), (128, 192, 1088, True, "wgmma"),
    (48, 80, 1000, True, "wide"), (16, 64, 1000, True, "wide"), (64, 48, 1000, True, "wide"),
    (256, 256, 999, True, "wide"), (256, 256, 1004, True, "wide"),
    (256, 256, 16384, False, "wide"),
])
def test_wide_bf16_design_boundary(c_in, c_out, n, aligned, design):
    """A wide bf16 S' or C' takes the wgmma passes where both widths are
    multiples of 64 and the point rows are whole 16-byte vectors (N % 8 ==
    0, aligned bases: the tensor maps' strides); elsewhere the mma.sync
    passes of the wide design."""
    assert port_layer.wide_bf16_design(c_in, c_out, n, aligned) == design
    assert port_layer.backward_design(c_in, c_out) == "wide"


# ------------------------------------------------ the certificate of a p
#
# certified_bf16_mask says which float32 sums of bf16 products (another
# summation order than the plain version's, a tensor core's) round to bf16
# as the plain version's in-order sum does.  Held here against the sums it
# speaks for: the in-order float32 sum (``_products``), the same products in
# random orders, and the float64 sum, on random and on adversarial inputs
# (every sum within a few float32 ulps of a bf16 rounding midpoint).


def _certificate_inputs(kind, c_in, c_out, n, seed):
    """bf16 x (1, 3, c_in, n), bf16-exact w (c_out, c_in) and a bf16 bias
    (1, 3, c_out, 1).  ``adversarial``: channel 0's product t0 a power of two,
    channel 1's t0 2^-8 (so the two land on the midpoint t0 (1 + 2^-8)
    between two bf16 values), the other c_in - 2 products ~2^-25 t0 with
    random signs, so every sum lies within a few float32 ulps of the
    midpoint; the bias is zero there."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        x = rng.standard_normal((1, 3, c_in, n))
        w = rng.uniform(-1, 1, (c_out, c_in)) / np.sqrt(c_in)
        bias = rng.standard_normal((1, 3, c_out, 1))
    else:
        lead_x = np.ldexp(rng.choice([-1.0, 1.0], (1, 3, 1, n)), rng.integers(-2, 3, (1, 3, 1, n)))
        lead_w = np.ldexp(rng.choice([-1.0, 1.0], (c_out, 1)), rng.integers(-2, 3, (c_out, 1)))
        small = lambda *shape: (rng.choice([-1.0, 1.0], shape)  # noqa: E731
                                * np.ldexp(rng.uniform(1, 2, shape), -13))
        x = np.concatenate([lead_x, lead_x, lead_x * small(1, 3, c_in - 2, n)], 2)
        w = np.concatenate([lead_w, lead_w * 2.0 ** -8, lead_w * small(c_out, c_in - 2)], 1)
        bias = np.zeros((1, 3, c_out, 1))
    as16 = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    return as16(x), as16(w).float(), as16(bias)


def _ordered_sum(w, x, bias, order):
    """sum_k w[:, k] x[..., k, :] in float32, the products (exact) added one
    at a time in ``order``, then the bias: as ``_products`` for the input
    order, before its bf16 rounding."""
    wf, xf = w.float(), x.float()
    p = torch.zeros(x.shape[:2] + (w.shape[0], x.shape[3]))
    for k in order:
        p.add_(wf[:, k:k + 1] * xf[:, :, k:k + 1])
    return p + bias.float()


@pytest.mark.parametrize("c_in", [16, 64, 256])
@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_certified_bf16_mask_agrees_with_every_order(c_in, kind):
    """Every element the certificate passes rounds to one bf16 value from v
    (a float32 matrix product), from the in-order sum the plain version
    takes, from three random orders and from the float64 sum; on the
    adversarial inputs the in-order sum itself sits a few float32 ulps from a
    midpoint, where the orders do part, and the certificate passes none of
    those that part."""
    x, w, bias = _certificate_inputs(kind, c_in, 48, 96, c_in + len(kind))
    v, s, cert = port_layer.certify_probe(x, w, bias)
    assert torch.equal(cert, port_layer.certified_bf16_mask(v, s, c_in))
    want = v.to(torch.bfloat16)
    in_order = port_layer._products(w, x, bias)
    assert torch.equal(in_order.float(), _ordered_sum(w, x, bias, range(c_in)).to(torch.bfloat16)
                       .float())
    sums = [in_order]
    rng = np.random.default_rng(c_in)
    for _ in range(3):
        sums.append(_ordered_sum(w, x, bias, rng.permutation(c_in)).to(torch.bfloat16))
    exact = (torch.matmul(w.double(), x.double()) + bias.double()).float().to(torch.bfloat16)
    sums.append(exact)
    for got in sums:
        assert torch.equal(got[cert], want[cert])
    parted = torch.zeros_like(cert)
    for got in sums[1:]:
        parted |= got != in_order
    if kind == "adversarial":
        assert parted.float().mean() > 0.05  # the orders really part there
        assert (cert & parted).sum() == 0
        assert cert.float().mean() < 0.5
    else:
        assert cert.float().mean() > 0.02


def test_certificate_margin_grows_with_depth():
    """k of the margin: 2 (gamma_n + tau_n) for n exact products, the
    tensor-core steps' bound 38 u a k16 step; float32, rising with C_in."""
    u = 2.0 ** -24
    for n in (16, 64, 256, 1024):
        gamma = n * u / (1 - n * u)
        tau = 38 * u * -(-n // 16)
        k = port_layer.certificate_margin(n)
        assert k == pytest.approx(2 * (gamma + tau), rel=1e-6)
        assert k == float(np.float32(k))
    assert port_layer.certificate_margin(256) > port_layer.certificate_margin(64)


# ---------------------------------- the a-posteriori certificate of a p
#
# posterior_bf16_mask certifies a tensor-core sum from what the k16 steps
# leave behind: v, s = sum |w_k x_k| and a = the sum of |acc| read before
# each step (csrc pd_cert, C''s certified pass 1).  Held here against a
# plain model of the tensor cores' step and against float32 sums in random
# orders read in steps of 16, on the inputs of the tests above.

_U = 2.0 ** -24


def _trunc_f32(y):
    """float64 -> the float32 next to it toward zero."""
    f = y.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(y)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _tensor_core_step(acc, prods):
    """One k16 step of the model in certificate_margin's docstring: the 17
    addends (acc, float32, and the exact products) aligned to the largest
    exponent E, each truncated to a multiple of 2^(E - 23) (24 bits from
    E's), summed exactly, the sum truncated to float32."""
    addends = np.concatenate([acc[None].astype(np.float64), prods], 0)
    big = np.abs(addends).max(0)
    e = np.floor(np.log2(np.where(big > 0, big, 1.0)))
    q = np.exp2(e - 23)
    return _trunc_f32((np.trunc(addends / q) * q).sum(0))


def _stepped_sums(w, x, bias, order=None):
    """(v, s, a) of p = W x (+ bias), float32 torch tensors (1, 3, C_out, N):
    the products in k16 steps of input channels (``order`` None: the
    tensor-core model, 0, 1, ...; else float32 adds one product at a time in
    that order), a the float32 sum of |acc| read before each step, s the
    same steps over |products|, v the sum plus the bias in float32."""
    wf = w.double().numpy()
    xf = x.double().numpy()[0]  # (3, C_in, N)
    prods = wf[None, :, :, None] * xf[:, None, :, :]  # (3, C_out, C_in, N), exact
    c_in = wf.shape[1]
    ks = np.arange(c_in) if order is None else np.asarray(order)
    acc = np.zeros(prods[:, :, 0].shape, np.float32)
    mag = np.zeros_like(acc)
    a = np.zeros_like(acc)
    for k0 in range(0, c_in, 16):
        step = ks[k0:k0 + 16]
        a = a + np.abs(acc)
        chunk = np.moveaxis(prods[:, :, step], 2, 0)  # (16, 3, C_out, N)
        if order is None:
            acc = _tensor_core_step(acc, chunk)
            mag = _tensor_core_step(mag, np.abs(chunk))
        else:
            for t in chunk:
                acc = (acc + t.astype(np.float32)).astype(np.float32)
                mag = (mag + np.abs(t).astype(np.float32)).astype(np.float32)
    v = torch.from_numpy(acc)[None]
    if bias is not None:
        v = v + bias.float()
    return v, torch.from_numpy(mag)[None], torch.from_numpy(a)[None]


@pytest.mark.parametrize("c_in", [64, 256])
@pytest.mark.parametrize("kind", ["random", "adversarial"])
@pytest.mark.parametrize("summed", ["tensor cores", "random order"])
def test_posterior_certificate_passes_only_the_in_order_bits(c_in, kind, summed):
    """Every element posterior_bf16_mask passes rounds to the bf16 value of
    the plain version's in-order sum (``_products``), for sums of the
    tensor-core model and for float32 sums in a random order read in steps
    of 16; on random inputs it passes most elements, on the adversarial ones
    (every sum a few float32 ulps from a bf16 midpoint) next to none."""
    x, w, bias = _certificate_inputs(kind, c_in, 48, 96, c_in + len(kind))
    order = None if summed == "tensor cores" else np.random.default_rng(c_in).permutation(c_in)
    v, s, a = _stepped_sums(w, x, bias, order)
    cert = port_layer.posterior_bf16_mask(v, s, a)
    in_order = port_layer._products(w, x, bias)
    assert torch.equal(v.to(torch.bfloat16)[cert], in_order[cert])
    if kind == "adversarial":
        assert cert.float().mean() < 0.02
    else:
        assert cert.float().mean() > 0.8


@pytest.mark.parametrize("c_in", [64, 256])
@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_posterior_margin_never_wider_than_the_prior_one(c_in, kind):
    """The a-posteriori margin 2^-18 (a + s) + (2^-23 + 2^-42) |v| is never
    wider than the a-priori one (certificate_margin: k s + 2^-23 |v|) on
    the same tensor-core sums, so it certifies every element the other
    does; on random inputs it leaves at most half as many uncertain."""
    x, w, bias = _certificate_inputs(kind, c_in, 48, 96, c_in + 3)
    v, s, a = _stepped_sums(w, x, bias)
    k = torch.tensor(port_layer.certificate_margin(c_in), dtype=torch.float32)
    prior = k * s + 2.0 ** -23 * v.abs()
    post = (torch.tensor(port_layer.POSTERIOR_K, dtype=torch.float32) * (a + s)
            + torch.tensor(port_layer.POSTERIOR_V, dtype=torch.float32) * v.abs())
    assert bool((post <= prior).all())
    new, old = port_layer.posterior_bf16_mask(v, s, a), port_layer.certified_bf16_mask(v, s, c_in)
    assert bool((new | ~old).all())
    if kind == "random":
        assert (~new).float().mean() <= 0.5 * (~old).float().mean()


def test_tensor_core_model_errs_inside_its_bound():
    """The model's step errs within its stated 36 u (|acc| + the step's
    sum of |products|) of the exact step (float64), and truncates: an
    all-positive step never comes out above the exact sum."""
    rng = np.random.default_rng(0)
    acc = (rng.standard_normal((4096,)) * 8).astype(np.float32)
    prods = (rng.standard_normal((16, 4096)) * rng.uniform(0.01, 10, (16, 1)))
    prods = prods.astype(np.float32).astype(np.float64)
    got = _tensor_core_step(acc, prods).astype(np.float64)
    exact = acc.astype(np.float64) + prods.sum(0)
    bound = 36 * _U * (np.abs(acc) + np.abs(prods).sum(0))
    assert bool((np.abs(got - exact) <= bound).all())
    pos = _tensor_core_step(np.abs(acc), np.abs(prods)).astype(np.float64)
    assert bool((pos <= np.abs(acc) + np.abs(prods).sum(0)).all())
