"""Kernels F, K1, K2, K3 and A on the CPU: which design K2, K3 and A's bf16
mode run at each of the paths' shapes, K1's choice, the host rules of K3's
gather, F's probe, and the plain versions against the JAX package at the
paths' new shapes.

``ops/knn_pallas.py::topk_design`` gives kernel K1 the "stream" design
where its rows are whole 16-byte vectors and the parent "warp" design
elsewhere.

``ops/knn_pallas.py::knn_design`` gives kernel K2 the "coords" design over
coordinates (D <= 4, M <= 4096) and the parent "warp" design above;
``ops/vn_fused.py::fwd_design`` gives A's bf16 mode the "run8" design
where N is a multiple of 8 and the planes start 16-byte aligned, the
parent "vector" design elsewhere (float32 A has that design only).

``ops/knn_pallas.py::edge_design`` gives kernel K3 the "coords" design over
coordinates (D <= 4), the "tiled" design over features (D > 4, N <= 512)
and the parent "warp" design where neither reaches; both new designs end in
a gather whose threads split the neighbour slots as ``gather_slots`` says.
The CUDA kernels take what the wrapper picks, so the choice for every K3
call of the VN DGCNN and vn_pointr pipelines is checked here, where no card
is needed.  The plain versions, which the card holds the kernels to bit for
bit (``gpu`` tests of ``tests/test_torch_port_kernels.py``), are held
against JAX's Pallas kernels in interpret mode: K3 here over vn_pointr's D
192 features, F at the paths' shapes in
``tests/test_torch_port_dgcnn.py::test_f_plain_matches_pallas_and_jnp``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_dgcnn import _assert_knn_gap
from vn_pointcloudcompletion_tpu.ops import knn_pallas as jax_knn_pallas
from vn_pointcloudcompletion_tpu_torch.ops import fps_pallas as port_fps
from vn_pointcloudcompletion_tpu_torch.ops import knn_pallas as port_knn
from vn_pointcloudcompletion_tpu_torch.ops import vn_fused as port_fused
from vn_pointcloudcompletion_tpu_torch.utils.config import Config

torch.set_num_threads(2)

# (N, D, C3, k) of every K3 call of one eval forward at 2048 input points,
# and its design: the VN DGCNN's conv4 and conv5 over the FPS coordinates,
# vn_pointr's conv4-conv6 over the grouper's features
_K3_CALLS = {
    "vn_dgcnn": ("vn_dgcnn_fps", "vn_foldingnet", 1024,
                 {(512, 3, 384, 16): "coords", (512, 3, 768, 16): "coords"}),
    "vn_pointr": ("vn_pointr", "attention_vn_foldingnet", 448,
                  {(512, 96, 384, 16): "tiled", (512, 192, 384, 16): "tiled",
                   (128, 192, 768, 16): "tiled"}),
}
# (N, S) of every F call of the same forwards
_F_CALLS = {"vn_dgcnn": {(2048, 512), (512, 128)},
            "vn_pointr": {(2048, 512), (512, 128), (2048, 224)}}


# (N, M, D, k) of every K2 call of one eval forward at 2048 input points,
# all over coordinates: the VN DGCNN's conv1 and conv6, dgcnn_448's grouper
# layers, vn_pointr's grouper conv1 and its proxy graph (k 8)
_K2_CALLS = {
    "vn_dgcnn": {(2048, 2048, 3, 16), (128, 128, 3, 16)},
    "dgcnn_448": {(2048, 2048, 3, 16), (512, 2048, 3, 16), (512, 512, 3, 16),
                  (128, 512, 3, 16)},
    "vn_pointr": {(2048, 2048, 3, 16), (128, 128, 3, 8)},
}
# (C, N) of every call of kernel A in the same forwards
_A_CALLS = {"vn_dgcnn": {(64, 8192), (128, 8192), (512, 2048)},
            "dgcnn_448": set(),
            "vn_pointr": {(64, 8192), (128, 2048)}}
_PIPELINES = {"vn_dgcnn": ("vn_dgcnn_fps", "vn_foldingnet", 1024),
              "dgcnn_448": ("dgcnn_fps", "foldingnet", 448),
              "vn_pointr": ("vn_pointr", "attention_vn_foldingnet", 448)}


@functools.lru_cache(maxsize=None)
def _forward_calls(name):
    """The shapes with which one eval forward of a pipeline at 2048 points
    calls K3 (N, D, C3, k), F (N, S), K2 (N, M, D, k) and A (C, N)."""
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model

    calls = {"k3": set(), "f": set(), "k2": set(), "a": set()}
    saved = (port_knn.edge_knn_gather, port_fps.furthest_point_sample_kernel,
             port_knn.knn_min, port_fused.fused_bn_leaky)
    edge, fps, knn, bn = saved

    def record_edge(xflat, u, v, k):
        calls["k3"].add((xflat.shape[2], xflat.shape[1], u.shape[1], k))
        return edge(xflat, u, v, k)

    def record_fps(xyz, s):
        calls["f"].add((xyz.shape[1], s))
        return fps(xyz, s)

    def record_knn(q, r, k):
        calls["k2"].add((q.shape[1], r.shape[1], q.shape[2], k))
        return knn(q, r, k)

    def record_bn(p, d, a, b, ns):
        calls["a"].add((p.shape[2], p.shape[3]))
        return bn(p, d, a, b, ns)

    port_knn.edge_knn_gather, port_fps.furthest_point_sample_kernel = record_edge, record_fps
    port_knn.knn_min, port_fused.fused_bn_leaky = record_knn, record_bn
    try:
        enc, dec, nc = _PIPELINES[name]
        model = build_model(Config.from_dict({"enc_type": enc, "dec_type": dec,
                                              "num_coarse": nc, "seed": 3})).eval()
        xyz = torch.from_numpy((np.random.default_rng(5).standard_normal((1, 2048, 3)) * 0.3)
                               .astype(np.float32))
        with torch.no_grad():
            model(xyz)
    finally:
        (port_knn.edge_knn_gather, port_fps.furthest_point_sample_kernel,
         port_knn.knn_min, port_fused.fused_bn_leaky) = saved
    return calls


@pytest.mark.parametrize("name", list(_K3_CALLS))
def test_design_of_every_k3_call(name):
    """One eval forward of a pipeline at 2048 points: each K3 call's shape
    and the design the wrapper takes for it in either mode, and F's shapes."""
    calls = _forward_calls(name)
    seen = {shape: {port_knn.edge_design(shape[0], shape[1], shape[3], bf16)
                    for bf16 in (False, True)} for shape in calls["k3"]}
    assert seen == {shape: {design} for shape, design in _K3_CALLS[name][3].items()}
    assert calls["f"] == _F_CALLS[name]


@pytest.mark.parametrize("name", list(_K2_CALLS))
def test_design_of_every_k2_and_a_call(name):
    """The same forwards: every K2 call is over coordinates and takes the
    coords design; every A call has N a multiple of 8, so its bf16 mode
    takes the run8 design (the planes the wrapper hands over are fresh or
    contiguous copies, 16-byte aligned)."""
    calls = _forward_calls(name)
    assert calls["k2"] == _K2_CALLS[name]
    assert {port_knn.knn_design(*shape[1:]) for shape in calls["k2"]} == {"coords"}
    assert calls["a"] == _A_CALLS[name]
    assert all(port_fused.fwd_design(n) == "run8" for _, n in calls["a"])


@pytest.mark.parametrize("n,m,d,k,design", [
    (2048, 2048, 3, 16, "coords"), (128, 128, 3, 16, "coords"), (512, 2048, 3, 16, "coords"),
    (512, 512, 3, 16, "coords"), (128, 512, 3, 16, "coords"), (128, 128, 3, 8, "coords"),
    (2048, 2048, 3, 40, "coords"), (100, 4096, 4, 64, "coords"), (77, 999, 1, 1, "coords"),
    (2048, 2048, 64, 40, "warp"), (300, 700, 5, 16, "warp"), (50, 700, 512, 64, "warp"),
    (64, 8192, 3, 16, "warp"),
])
def test_knn_design(n, m, d, k, design):
    """"coords" over coordinates (D <= 4, M <= 4096: the references and
    their candidate buffers fit a block's shared memory), "warp" above:
    every path shape (the first seven, N queries against M references)
    takes coords, the classic DGCNN's graphs over 64 features warp; the
    choice does not read N."""
    assert port_knn.knn_design(m, d, k) == design


@pytest.mark.parametrize("m,d,k", [(2048, 3, 65), (2048, 3, 0), (16, 3, 17), (2048, 0, 16),
                                   (2048, 513, 16)])
def test_knn_design_refuses(m, d, k):
    """k outside [1, min(64, M)] and D outside [1, 512] have no design."""
    with pytest.raises(ValueError, match="no design"):
        port_knn.knn_design(m, d, k)


@pytest.mark.parametrize("m,k,aligned,design", [
    (2048, 16, True, "stream"), (4096, 64, True, "stream"), (2048, 40, True, "stream"),
    (4, 4, True, "stream"), (4095, 16, True, "warp"), (333, 16, True, "warp"),
    (2048, 16, False, "warp"),
])
def test_topk_design(m, k, aligned, design):
    """K1 takes the stream design where every row is whole 16-byte vectors
    (M a multiple of 4, the matrix 16-byte aligned): knn()'s matrix at M
    2048 (k 16) and the row cap 4096 at k 64; the parent warp design at a
    ragged M or an unaligned start.  The choice does not read N."""
    assert port_knn.topk_design(m, k, aligned) == design


@pytest.mark.parametrize("m,k", [(2048, 0), (2048, 65), (16, 17), (4100, 16), (8192, 64)])
def test_topk_design_refuses(m, k):
    """k outside [1, min(64, M)] and M > 4096 have no design."""
    with pytest.raises(ValueError, match="no design"):
        port_knn.topk_design(m, k, True)


# cuobjdump -sass text in the layout of the knn library's: another
# instantiation first (its vote must not be taken), then a
# knn_select_coords<16, false> whose scan loop (0x20-0xa0) holds two
# 16-byte shared loads, the flush vote, and a flush (0x70-0x80) that the
# vote's branch skips
_SCAN_SASS = """
        Function : _ZN38_GLOBAL__N__0_6_knn_cu_017knn_select_coordsILi32ELb0EEEvPKfS2_PfPiiiiillllll
        /*0000*/                   VOTE.ANY P0, P0 ;                      /* 0x0000000000ff7806 */
        Function : _ZN38_GLOBAL__N__0_6_knn_cu_017knn_select_coordsILi16ELb0EEEvPKfS2_PfPiiiiillllll
        /*0000*/                   MOV R1, c[0x0][0x28] ;                 /* 0x00000a0000017a02 */
        /*0010*/                   LDS.128 R4, [R2] ;                     /* 0x0000000002047984 */
        /*0020*/                   LDS.128 R4, [R26] ;                    /* 0x000000001a047984 */
        /*0030*/                   FADD R5, R4, R6 ;                      /* 0x0000000604057221 */
        /*0040*/                   LDS.128 R8, [R26+0x10] ;               /* 0x000010001a087984 */
        /*0050*/                   VOTE.ANY P0, P0 ;                      /* 0x0000000000ff7806 */
        /*0060*/              @!P0 BRA 0x90 ;                             /* 0x0000000000048947 */
        /*0070*/                   REDUX.MAX UR5, R15 ;                   /* 0x000000000f0573c4 */
        /*0080*/                   LDS R49, [R23] ;                       /* 0x0000000017317984 */
        /*0090*/                   ISETP.LT.AND P0, PT, R51, UR5, PT ;    /* 0x0000000533007c0c */
        /*00a0*/              @!P0 BRA 0x20 ;                             /* 0xffffffec00d48947 */
        /*00b0*/                   EXIT ;                                 /* 0x000000000000794d */
        Function : _ZN38_GLOBAL__N__0_6_knn_cu_017knn_select_coordsILi16ELb1EEEvPKfS2_PfPiiiiillllll
        /*0000*/                   VOTE.ANY P0, P0 ;                      /* 0x0000000000ff7806 */
"""


def test_knn_scan_sass_counts_one_trip():
    """chip_smoke's issue floor of K2's scan reads one trip's instructions
    (the loop less the flush it skips: 0x20-0x60 and 0x90-0xa0) and its
    references a lane (the 16-byte shared loads) from the SASS."""
    import chip_smoke

    assert chip_smoke.knn_scan_sass(_SCAN_SASS) == (7, 2)


@pytest.mark.parametrize("edit", [
    ("ILi16ELb0E", "ILi8ELb0E"),  # no such instantiation
    ("/*0050*/                   VOTE.ANY", "/*0050*/                   NOP"),  # no vote
    ("@!P0 BRA 0x20 ", "@!P0 BRA 0xb0 "),  # no loop around the vote
])
def test_knn_scan_sass_refuses(edit):
    """Code without the scan's shape gives no count."""
    import chip_smoke

    with pytest.raises(ValueError):
        chip_smoke.knn_scan_sass(_SCAN_SASS.replace(*edit))


# cuobjdump -sass text in the layout of the chamfer_bidir library's: a
# nn_sweep whose stage loop (0x10-0xb0) holds the chunk loop (0x20-0xa0):
# a branch over the sweep for warps past the rows (0x20 -> 0x60, its span
# holds the FMNMX), the sweep, and the flush (0x70-0x80, no FMNMX) that a
# forward branch skips on most trips
_SWEEP_SASS = """
        Function : _ZN45_GLOBAL__N__0_13_chamfer_bidir_cu_0_split_keysEPKyPfPil
        /*0000*/                   FMNMX R1, R2, R3, PT ;                 /* 0x0000000302017209 */
        Function : _ZN45_GLOBAL__N__0_13_chamfer_bidir_cu_0_nn_sweepEPKfS2_PyS3_iii
        /*0000*/                   MOV R1, c[0x0][0x28] ;                 /* 0x00000a0000017a02 */
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;          /* 0x0000000000007b1d */
        /*0020*/               @P3 BRA 0x60 ;                             /* 0x0000000000048947 */
        /*0030*/                   FADD R4, R5, -R6 ;                     /* 0x8000000605047221 */
        /*0040*/                   FMNMX R7, R7, R4, PT ;                 /* 0x0000000407077209 */
        /*0050*/                   FMNMX R8, R8, R4, PT ;                 /* 0x0000000408087209 */
        /*0060*/              @!P0 BRA 0x90 ;                             /* 0x0000000000048947 */
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;          /* 0x0000000000007b1d */
        /*0080*/                   ATOMG.E.MIN.64 PT, R2, [R10], R12 ;    /* 0x0000000c0a0279a8 */
        /*0090*/                   IADD3 R0, R0, 0x1, RZ ;                /* 0x0000000100007810 */
        /*00a0*/              @!P1 BRA 0x20 ;                             /* 0xffffffec00d48947 */
        /*00b0*/              @!P2 BRA 0x10 ;                             /* 0xffffffec00d48947 */
        /*00c0*/                   EXIT ;                                 /* 0x000000000000794d */
"""


def test_chamfer_sweep_sass_counts_one_trip():
    """chip_smoke's issue floor of kernel D reads one trip of its chunk
    loop (the innermost loop with the most FMNMX, 0x20-0xa0: 9
    instructions) less the flush a forward branch skips (0x70, 0x80), and
    not less the sweep that the branch for warps past the rows skips, from
    the SASS, with the pairs a lane folds a trip as given."""
    import chip_smoke

    assert chip_smoke.chamfer_sweep_sass(_SWEEP_SASS, 256) == (7, 256)


@pytest.mark.parametrize("edit", [
    ("_nn_sweepE", "_nn_swapE"),  # no such function
    ("@!P1 BRA 0x20 ", "@!P1 BRA 0xd0 "),  # then the stage loop alone: 0x10-0xb0
])
def test_chamfer_sweep_sass_refuses_or_takes_the_innermost(edit):
    """Without nn_sweep the SASS gives no count; with the chunk loop gone
    the stage loop (0x10-0xb0, the same FMNMX: 11 instructions) is the
    innermost left, less the flush."""
    import chip_smoke

    sass = _SWEEP_SASS.replace(*edit)
    if edit[0] == "_nn_sweepE":
        with pytest.raises(ValueError):
            chip_smoke.chamfer_sweep_sass(sass, 256)
    else:
        assert chip_smoke.chamfer_sweep_sass(sass, 256) == (9, 256)


@pytest.mark.parametrize("n,aligned,design", [
    (2048, True, "run8"), (512, True, "run8"), (16384, True, "run8"), (8192, True, "run8"),
    (520, True, "run8"), (516, True, "vector"), (1001, True, "vector"), (2048, False, "vector"),
    (2052, True, "vector"),
])
def test_bn_leaky_fwd_design(n, aligned, design):
    """A's bf16 mode takes run8 where each thread's 8 points are one
    16-byte run of every plane (N a multiple of 8, 520 = 65 runs included,
    and aligned starts); the parent vector design elsewhere."""
    assert port_fused.fwd_design(n, aligned) == design


@pytest.mark.parametrize("n,d,k,bf16,design", [
    (512, 3, 16, False, "coords"), (512, 3, 16, True, "coords"), (128, 3, 16, False, "coords"),
    (512, 4, 16, False, "coords"), (1024, 3, 16, True, "coords"), (64, 3, 32, False, "coords"),
    (512, 5, 16, False, "tiled"), (512, 96, 16, True, "tiled"), (512, 192, 16, False, "tiled"),
    (128, 192, 16, True, "tiled"), (128, 512, 16, False, "tiled"),
    (2048, 3, 16, False, "warp"), (1024, 3, 16, False, "warp"), (1024, 96, 16, True, "warp"),
    (512, 3, 32, False, "warp"), (512, 3, 64, False, "warp"), (300, 48, 32, False, "warp"),
    (333, 3, 32, True, "warp"), (116, 48, 16, False, "warp"), (120, 3, 16, True, "warp"),
])
def test_edge_design_boundary(n, d, k, bf16, design):
    """"coords" at D <= 4, "tiled" above at N <= 512 a multiple of 8, both
    where the gather fits (gather_slots) and k <= 32; "warp" elsewhere: N
    past 256 16-byte runs, k slots that do not split evenly over the
    threads, k > 32, N not whole runs (bf16 runs are 8 values)."""
    assert port_knn.edge_design(n, d, k, bf16) == design


@pytest.mark.parametrize("n,k,bf16,slots", [
    (512, 16, False, 8), (512, 16, True, 4), (128, 16, False, 2), (128, 16, True, 1),
    (1024, 16, False, 0), (1024, 16, True, 8), (256, 32, False, 8), (512, 32, False, 0),
    (116, 16, False, 2), (120, 16, True, 0), (600, 16, False, 0), (64, 8, False, 0),
])
def test_gather_slots(n, k, bf16, slots):
    """A gather thread owns one 16-byte run of queries and k / (256 / runs)
    consecutive slots (1, 2, 4 or 8; csrc knn.cu gather_kpt): so every
    (slot, run) pair of a row falls to exactly one thread."""
    assert port_knn.gather_slots(n, k, bf16) == slots
    if slots:
        runs = n // (8 if bf16 else 4)
        threads = (k // slots) * runs  # the threads that hold slots
        assert threads <= 256 and (k // slots) * slots == k


def test_fps_chain_probe_has_no_cpu_version():
    """F's dependency-floor probe launches the kernel without its
    arithmetic: no plain version, so a CPU tensor is refused."""
    with pytest.raises(ValueError, match="CUDA"):
        port_fps.furthest_point_sample_chain(torch.zeros(1, 64, 3), 8)


@pytest.mark.parametrize("n,d,c3", [(512, 192, 96), (128, 192, 192)])
def test_k3_plain_matches_pallas_on_features(n, d, c3):
    """K3's plain version against JAX's edge kernel in interpret mode over
    vn_pointr's D 192 features (N 512, conv5; N 128, conv6): indices equal
    (the features have a gap at the 16th neighbour far above float32
    rounding, ``_assert_knn_gap``: the two sides sum the distances in
    another order) and the gathered values equal."""
    rng = np.random.default_rng(n + d)
    # features of a 3-D cloud, as a VN layer's are of its points (512
    # independent Gaussian points in 192 dimensions leave some point's 16th
    # and 17th neighbours closer than 1e-5 of each other)
    x = np.einsum("ec,bcn->ben", rng.standard_normal((d, 3)),
                  rng.standard_normal((1, 3, n))).astype(np.float32)
    _assert_knn_gap(x.transpose(0, 2, 1), 16, 1e-5)
    u, v = (rng.standard_normal((1, c3, n)).astype(np.float32) for _ in range(2))
    want = jax_knn_pallas.edge_knn_gather(*map(jnp.asarray, (x, u, v)), 16, True)
    got, idx = port_knn.reference_edge_knn_gather(*map(torch.from_numpy, (x, u, v)), 16)
    assert got.shape == (1, c3, 16, n) and idx.shape == (1, n, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
