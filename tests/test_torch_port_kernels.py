"""The port's kernels (A, A', S, S', B, B', C, C', D, K1, K2, K3, F, E)
against the JAX package.

On the CPU each wrapper takes its plain PyTorch version; those tests hold it
against the Pallas kernel in interpret mode (and the numpy chamfer oracle)
on the same numpy inputs, and check each ``autograd.Function`` with
``torch.autograd.gradcheck`` in float64 (kernel E's plain version is held
against JAX in ``tests/test_torch_port_emd.py``).  Tests marked ``gpu`` launch the CUDA kernels and
hold them against the plain versions on the card; they skip where
``torch.cuda.is_available()`` is false.  JAX is imported inside the tests,
so the ``gpu`` tests also run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_kernels.py
"""

import numpy as np
import pytest
import torch

from vn_pointcloudcompletion_tpu_torch.ops import chamfer_pallas_bidir as port_chamfer
from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib, emd_pallas, fps_pallas, knn_pallas
from vn_pointcloudcompletion_tpu_torch.ops import vn_fused as port_fused
from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused as port_layer

torch.set_num_threads(2)

NS = 0.2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bn_inputs(rng, b, c, n):
    p = rng.standard_normal((b, 3, c, n)).astype(np.float32)
    d = rng.standard_normal((b, 3, c, n)).astype(np.float32)
    p[:, :, : c // 4, :7] = 0.0  # exact zero vectors: the |p| + EPS guard
    a = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bb = rng.normal(0.0, 0.3, c).astype(np.float32)
    return p, d, a, bb


def _layer_inputs(rng, b, c_in, c_out, n, bias):
    x = rng.standard_normal((b, 3, c_in, n)).astype(np.float32)
    bound = 1 / np.sqrt(c_in)
    w = rng.uniform(-bound, bound, (c_out, c_in)).astype(np.float32)
    wd = rng.uniform(-bound, bound, (c_out, c_in)).astype(np.float32)
    pb = rng.standard_normal((b, 3, c_out, 1)).astype(np.float32) if bias else None
    db = rng.standard_normal((b, 3, c_out, 1)).astype(np.float32) if bias else None
    a = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
    bb = rng.normal(0.0, 0.3, c_out).astype(np.float32)
    w_out = rng.uniform(-0.3, 0.3, c_out).astype(np.float32)
    return x, w, wd, pb, db, a, bb, w_out


def _t(*arrays, device="cpu"):
    return [None if a is None else torch.from_numpy(a).to(device) for a in arrays]


# --------------------------------------------------------------------- CPU


@pytest.mark.parametrize("c", [16, 128])
def test_kernel_a_plain_matches_pallas(c):
    import jax.numpy as jnp

    from vn_pointcloudcompletion_tpu.ops import vn_fused as jax_fused

    rng = np.random.default_rng(c)
    p, d, a, b = _bn_inputs(rng, 2, c, 512)
    got = port_fused.fused_bn_leaky(*_t(p, d, a, b), NS).numpy()
    before = got.copy()  # held against ``got`` after the JAX calls
    assert port_fused.eligible(torch.from_numpy(p))
    q = p * (a[None, None, :, None] + b[None, None, :, None]
             / (np.sqrt((p * p).sum(1, keepdims=True)) + 1e-6))
    assert ((q * d).sum(1) < 0).mean() > 0.3  # the reflection branch is taken
    pallas = np.asarray(jax_fused.fused_bn_leaky(
        *map(jnp.asarray, (p, d, a, b)), NS, True))
    ref = np.asarray(jax_fused.reference_bn_leaky_planes(
        *map(jnp.asarray, (p, d, a, b)), NS))
    # The outputs reach ~5, where one float32 ulp is ~5e-7, and XLA may sum
    # the three planes in another order than the port: allow 4 ulp of the
    # largest output (eps = 2^-23 of it).  A failure reports where the
    # largest gap falls, how far each side lies from float64 there, and what
    # tells a wrong computation from a later overwrite (``_kernel_a_report``).
    ulp = np.finfo(np.float32).eps * np.abs(ref).max()
    exact = _bn_leaky_float64(p, d, a, b, NS)
    for name, want in (("pallas", pallas), ("jax plain", ref)):
        gap = np.abs(got - want)
        if gap.max() <= 4 * ulp:
            continue
        i = np.unravel_index(gap.argmax(), gap.shape)
        pytest.fail(
            f"port vs {name}: {gap.max() / ulp:.2f} ulp of max|out| at {i} "
            f"(port {got[i]!r}, {name} {want[i]!r}, float64 {exact[i]!r}); "
            f"from float64 there: port {abs(got[i] - exact[i]) / ulp:.2f} ulp, "
            f"{name} {abs(want[i] - exact[i]) / ulp:.2f}; largest anywhere: "
            f"port {np.abs(got - exact).max() / ulp:.2f}, "
            f"{name} {np.abs(want - exact).max() / ulp:.2f}; "
            + _kernel_a_report(gap / ulp, got, before, (p, d, a, b)))
    assert np.all(got[:, :, : c // 4, :7] == 0.0)


def _kernel_a_report(gap_ulp, got, before, inputs) -> str:
    """What a failing kernel A comparison needs besides the gap: (a) the
    largest gap (ulp of max|out|) per sample and per channel, which shows
    whether the bad elements are one intra-op thread's contiguous share;
    (b) whether the port's function run again on one thread gives the same
    bits; (c) whether the output copied before the JAX calls equals the one
    compared (computed wrong, or overwritten later); (d) the thread count,
    torch's CPU capability and the host's CPU model."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = port_fused.fused_bn_leaky(*_t(*inputs), NS).numpy()
    finally:
        torch.set_num_threads(threads)
    model = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.startswith(("model name", "Model", "CPU part"))), model)
    except OSError:
        pass
    per_sample = np.round(gap_ulp.max(axis=(1, 2, 3)), 2).tolist()
    per_channel = np.round(gap_ulp.max(axis=(1, 3)), 2).tolist()
    return (f"(a) largest gap per sample {per_sample}, per sample and channel {per_channel}; "
            f"(b) one thread gives the same bits: {np.array_equal(one, got)} (largest gap "
            f"{np.abs(one - got).max():.3g}), before the JAX calls: "
            f"{np.array_equal(one, before)}; (c) the copy taken before the JAX calls equals "
            f"the output compared: {np.array_equal(before, got)}; (d) "
            f"torch.get_num_threads() {threads}, cpu capability "
            f"{torch.backends.cpu.get_cpu_capability()}, CPU {model!r}")


def _bn_leaky_float64(p, d, a, b, ns):
    """Kernel A's formula (``ops/vn_fused.py``'s docstring) in numpy
    float64, from the float32 inputs."""
    p, d = p.astype(np.float64), d.astype(np.float64)
    a = a.astype(np.float64)[None, None, :, None]
    b = b.astype(np.float64)[None, None, :, None]
    q = p * (a + b / (np.sqrt((p * p).sum(1, keepdims=True)) + 1e-6))
    dot = (q * d).sum(1, keepdims=True)
    z = (d * d).sum(1, keepdims=True) + 1e-6
    return q - np.where(dot >= 0, 0.0, (1 - ns) * dot / z) * d


def test_kernel_b_plain_matches_pallas():
    import jax.numpy as jnp

    from vn_pointcloudcompletion_tpu.ops import vn_layer_fused as jax_layer

    rng = np.random.default_rng(1)
    x, w, wd, pb, db, a, b, _ = _layer_inputs(rng, 2, 2, 16, 1024, bias=True)
    got = port_layer.vn_layer_fused(*_t(x, w, wd, pb, db, a, b), NS).numpy()
    want = np.asarray(jax_layer.vn_layer_fused(
        *map(jnp.asarray, (x, w, wd, pb, db, a, b)), NS, False, True))
    assert got.shape == (2, 3, 16, 1024)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_kernel_c_plain_matches_pallas():
    import jax.numpy as jnp

    from vn_pointcloudcompletion_tpu.ops import vn_layer_fused as jax_layer

    rng = np.random.default_rng(2)
    x, w, wd, _, _, a, b, w_out = _layer_inputs(rng, 2, 16, 16, 1024, bias=False)
    got = port_layer.vn_layer_fused_project(
        *_t(x, w, wd), None, None, *_t(a, b, w_out), NS).numpy()
    want = np.asarray(jax_layer.vn_layer_fused_project(
        *map(jnp.asarray, (x, w, wd)), None, None,
        *map(jnp.asarray, (a, b, w_out)), NS, False, True))
    assert got.shape == (2, 3, 1, 1024)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("c_out,n,c_in,eligible", [
    (256, 4096, 256, True), (16, 4096, 2, True), (256, 2048, 256, False),
    (1024, 4096, 256, False), (200, 4096, 2, False),
])
def test_layer_gate_matches_jax(c_out, n, c_in, eligible):
    import jax.numpy as jnp

    from vn_pointcloudcompletion_tpu.ops import vn_layer_fused as jax_layer

    x = np.zeros((1, 3, c_in, n), np.float32)
    assert port_layer.layer_eligible(torch.from_numpy(x), c_out) is eligible
    assert jax_layer.layer_eligible(jnp.asarray(x), c_out) is eligible


@pytest.mark.parametrize("c,n", [(128, 512), (1024, 2048), (16, 512), (256, 511), (200, 4096)])
def test_bn_gate_matches_jax(c, n):
    import jax.numpy as jnp

    from vn_pointcloudcompletion_tpu.ops import vn_fused as jax_fused

    p = np.zeros((1, 3, c, n), np.float32)
    assert port_fused.eligible(torch.from_numpy(p)) == jax_fused.eligible(jnp.asarray(p))


def _second_best_gap(x, y):
    diff = x[:, :, None, :].astype(np.float64) - y[:, None, :, :]
    dist = np.sort((diff * diff).sum(-1), axis=-1)
    return dist[..., 1] - dist[..., 0]


def test_kernel_d_plain_matches_pallas_and_oracle():
    import jax.numpy as jnp

    from vn_pointcloudcompletion_tpu.ops.chamfer import chamfer_distance_reference
    from vn_pointcloudcompletion_tpu.ops.chamfer_pallas_bidir import (
        nn_bidirectional_pallas,
    )

    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 300, 3)) * 0.3).astype(np.float32)
    y = (rng.standard_normal((2, 700, 3)) * 0.3).astype(np.float32)
    got = [t.numpy() for t in port_chamfer.nn_bidirectional(*_t(x, y))]
    pallas = [np.asarray(t) for t in nn_bidirectional_pallas(
        jnp.asarray(x), jnp.asarray(y), interpret=True)]
    o1, o2, oi1, oi2 = chamfer_distance_reference(x, y)
    oracle = [o1, oi1, o2, oi2]
    sure = [_second_best_gap(x, y) > 1e-6, _second_best_gap(y, x) > 1e-6]
    for want in (pallas, oracle):
        for k, mask in ((0, sure[0]), (2, sure[1])):
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)
            assert got[k + 1].dtype == np.int32
            np.testing.assert_array_equal(got[k + 1][mask], want[k + 1][mask])
    assert sure[0].mean() > 0.9 and sure[1].mean() > 0.9


def test_kernel_d_ties_go_to_lowest_index():
    x = torch.zeros(1, 2, 3)
    y = torch.eye(3)[None]
    d1, i1, d2, i2 = port_chamfer.nn_bidirectional(x, y)
    assert i1.tolist() == [[0, 0]] and d1.tolist() == [[1.0, 1.0]]
    assert i2.tolist() == [[0, 0, 0]] and d2.tolist() == [[1.0, 1.0, 1.0]]


def _nn_keys(d, i):
    """Kernel D's candidate keys (csrc/chamfer_bidir.cu make_key) in numpy:
    the float bits of d >= +0 above the index, as unsigned 64-bit."""
    return (d.astype(np.float32).view(np.uint32).astype(np.uint64) << np.uint64(32)) | \
        i.astype(np.uint32).astype(np.uint64)


def _nonnegative_floats(rng):
    """+0, the subnormals' ends, the smallest normal, random magnitudes over
    the whole exponent range, the largest finite and +inf, some repeated."""
    tiny = np.finfo(np.float32).tiny
    special = np.array([0.0, 1e-45, 2e-45, tiny * (1 - 2.0 ** -23), tiny, 1.0, 1.0,
                        np.finfo(np.float32).max, np.inf], np.float32)
    rand = (2.0 ** rng.uniform(-149, 127, 200)).astype(np.float32)
    return np.concatenate([special, rand, rand[:20]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_d_key_orders_distance_then_index(seed):
    """The 64-bit key that kernel D's blocks combine with an integer
    atomicMin orders (d, index) lexicographically for every non-negative
    float32 d (+0, subnormals, normals, +inf): its minimum is the nearest
    point, ties to the lowest index."""
    rng = np.random.default_rng(seed)
    d = _nonnegative_floats(rng)
    i = rng.integers(0, 2 ** 31 - 1, d.size).astype(np.int64)
    i[:4] = [0, 1, 2 ** 31 - 1, 5]
    keys = _nn_keys(d, i)
    by_key = np.argsort(keys, kind="stable")
    by_pair = np.lexsort((i, d))
    np.testing.assert_array_equal(keys[by_key], keys[by_pair])
    a, b = np.meshgrid(np.arange(d.size), np.arange(d.size), indexing="ij")
    less = (d[a] < d[b]) | ((d[a] == d[b]) & (i[a] < i[b]))
    np.testing.assert_array_equal(keys[a] < keys[b], less)


def test_kernel_d_distance_is_never_negative_zero():
    """The diff-form distance of coordinates with signed zeros is +0, so no
    key holds the bits of -0 (which would order above every distance)."""
    z = np.array([0.0, -0.0], np.float32)
    pts = np.stack(np.meshgrid(z, z, z, indexing="ij"), -1).reshape(1, -1, 3)
    d, _, _, _ = port_chamfer.nn_bidirectional(*_t(pts, pts))
    assert (d.numpy().view(np.uint32) == 0).all()


def test_launch_check_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lib.check_cuda("x", "float32 planes", (torch.zeros(1, 3, 16, 512), torch.float32))


def test_kernel_entry_points_exist_in_their_sources():
    names = {k.symbol: k.source for k in cuda_lib.KERNELS}
    assert names == {
        "vn_bn_leaky_fwd": "vn_fused.cu",
        "vn_bn_leaky_fwd_bf16": "vn_fused.cu",
        "vn_bn_leaky_bwd": "vn_fused.cu",
        "vn_bn_leaky_bwd_bf16": "vn_fused.cu",
        "vn_layer_fused_fwd": "vn_layer_fused.cu",
        "vn_layer_fused_project_fwd": "vn_layer_fused.cu",
        "vn_layer_fused_fwd_bf16": "vn_layer_fused.cu",
        "vn_layer_fused_project_fwd_bf16": "vn_layer_fused.cu",
        "vn_layer_stats_fwd": "vn_layer_bwd.cu",
        "vn_layer_stats_bwd": "vn_layer_bwd.cu",
        "vn_layer_fused_bwd": "vn_layer_bwd.cu",
        "vn_layer_fused_project_bwd": "vn_layer_bwd.cu",
        "vn_layer_stats_fwd_bf16": "vn_layer_bwd.cu",
        "vn_layer_stats_bwd_bf16": "vn_layer_bwd.cu",
        "vn_layer_fused_bwd_bf16": "vn_layer_bwd.cu",
        "vn_layer_fused_project_bwd_bf16": "vn_layer_bwd.cu",
        "chamfer_nn_bidir": "chamfer_bidir.cu",
        "topk_min": "knn.cu",
        "knn_min": "knn.cu",
        "edge_knn_gather": "knn.cu",
        "edge_knn_gather_bf16": "knn.cu",
        "furthest_point_sample": "fps.cu",
        "emd_rounds": "emd.cu",
    }
    assert {s.name for s in cuda_lib.sources()} == set(names.values())
    for sym, src in names.items():
        assert f"VNK_EXPORT int {sym}(" in (cuda_lib.CSRC / src).read_text()


# ---------------------------------------------------- backward, CPU vs JAX
#
# Tolerance for every comparison with the JAX function in interpret mode:
# rtol 1e-5 plus atol 1e-5 of the tensor's largest entry (the sums over
# samples and points run in another order on the two sides).


def _assert_near_jax(got, want, rel=1e-5):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        w = np.asarray(w)
        g = g.detach().numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rel, atol=rel * max(1.0, np.abs(w).max()))


def _zero_vectors(x):
    """Exact zero input vectors: with no bias, p = W x is 0 there (the
    zero-norm guard of the backward)."""
    x[:, :, :, :7] = 0.0
    return x


@pytest.mark.parametrize("n", [1024, 1000])
def test_kernel_a_bwd_plain_matches_pallas(n):
    import jax.numpy as jnp

    from vn_pointcloudcompletion_tpu.ops import vn_fused as jax_fused

    rng = np.random.default_rng(n)
    p, d, a, b = _bn_inputs(rng, 2, 16, n)
    g = rng.standard_normal(p.shape).astype(np.float32)
    got = port_fused.reference_bn_leaky_bwd(*_t(p, d, a, b, g), NS)
    want = jax_fused._fused_bwd(NS, True, tuple(map(jnp.asarray, (p, d, a, b))),
                                jnp.asarray(g))
    _assert_near_jax(got, want)
    assert all(torch.isfinite(t).all() for t in got)  # the |p| = 0 guard holds


@pytest.mark.parametrize("n,bias", [(1024, False), (1024, True), (1000, True)])
def test_kernel_s_plain_matches_pallas(n, bias):
    import jax.numpy as jnp

    from vn_pointcloudcompletion_tpu.ops import vn_layer_fused as jax_layer

    rng = np.random.default_rng(n + bias)
    x, w, _, pb, _, _, _, _ = _layer_inputs(rng, 2, 8, 16, n, bias)
    x = _zero_vectors(x)
    c1 = rng.standard_normal(16).astype(np.float32)
    c2 = rng.standard_normal(16).astype(np.float32)
    jx = [None if t is None else jnp.asarray(t) for t in (x, w, pb)]
    got = port_layer.reference_stats(*_t(x, w, pb))
    (want, res) = jax_layer._stats_fwd(*jx, False, True, 0)
    _assert_near_jax(got, want)
    got = port_layer.reference_stats_bwd(*_t(x, w, pb, c1, c2))
    want = jax_layer._stats_bwd(False, True, 0, res, (jnp.asarray(c1), jnp.asarray(c2)))
    _assert_near_jax(got, want)


@pytest.mark.parametrize("n,bias", [(1024, False), (1024, True), (1000, True)])
def test_kernel_b_bwd_plain_matches_pallas(n, bias):
    import jax.numpy as jnp

    from vn_pointcloudcompletion_tpu.ops import vn_layer_fused as jax_layer

    rng = np.random.default_rng(10 * n + bias)
    x, w, wd, pb, db, a, b, _ = _layer_inputs(rng, 2, 8, 16, n, bias)
    x = _zero_vectors(x)
    g = rng.standard_normal((2, 3, 16, n)).astype(np.float32)
    got = port_layer.reference_layer_bwd(*_t(x, w, wd, pb, db, a, b, g), NS)
    res = tuple(None if t is None else jnp.asarray(t) for t in (x, w, wd, pb, db, a, b))
    want = jax_layer._layer_bwd(NS, False, True, 0, res, jnp.asarray(g))
    _assert_near_jax(got, want)


@pytest.mark.parametrize("n,bias", [(1024, False), (1000, True)])
def test_kernel_c_bwd_plain_matches_pallas(n, bias):
    import jax.numpy as jnp

    from vn_pointcloudcompletion_tpu.ops import vn_layer_fused as jax_layer

    rng = np.random.default_rng(100 * n + bias)
    x, w, wd, pb, db, a, b, w_out = _layer_inputs(rng, 2, 8, 16, n, bias)
    x = _zero_vectors(x)
    g = rng.standard_normal((2, 3, 1, n)).astype(np.float32)
    got = port_layer.reference_layer_project_bwd(
        *_t(x, w, wd, pb, db, a, b, w_out, g), NS)
    res = tuple(None if t is None else jnp.asarray(t)
                for t in (x, w, wd, pb, db, a, b, w_out))
    want = jax_layer._proj_bwd(NS, False, True, 0, res, jnp.asarray(g))
    _assert_near_jax(got, want)


def _f64(rng, *shape, scale=1.0):
    t = torch.from_numpy(rng.standard_normal(shape) * scale)
    return t.requires_grad_()


def test_fused_bn_leaky_gradcheck():
    rng = np.random.default_rng(20)
    p, d = _f64(rng, 2, 3, 4, 5), _f64(rng, 2, 3, 4, 5)
    a = torch.from_numpy(rng.uniform(0.5, 1.5, 4)).requires_grad_()
    b = _f64(rng, 4, scale=0.3)
    assert torch.autograd.gradcheck(
        lambda *t: port_fused.fused_bn_leaky(*t, NS), (p, d, a, b))


def test_chamfer_gradcheck():
    from vn_pointcloudcompletion_tpu_torch.ops.chamfer import chamfer_distance

    rng = np.random.default_rng(23)
    x, y = _f64(rng, 2, 5, 3), _f64(rng, 2, 7, 3)
    assert torch.autograd.gradcheck(lambda a, b: chamfer_distance(a, b)[:2], (x, y))


@pytest.mark.parametrize("bias", [False, True])
def test_layer_stats_gradcheck(bias):
    rng = np.random.default_rng(21)
    x, w = _f64(rng, 2, 3, 3, 6), _f64(rng, 4, 3, scale=0.5)
    pb = _f64(rng, 2, 3, 4, 1) if bias else None
    assert torch.autograd.gradcheck(port_layer.vn_layer_stats, (x, w, pb))


@pytest.mark.parametrize("project,bias", [(False, False), (False, True), (True, True)])
def test_layer_fused_gradcheck(project, bias):
    rng = np.random.default_rng(22)
    x = _f64(rng, 2, 3, 3, 6)
    w, wd = _f64(rng, 4, 3, scale=0.5), _f64(rng, 4, 3, scale=0.5)
    pb = _f64(rng, 2, 3, 4, 1) if bias else None
    db = _f64(rng, 2, 3, 4, 1) if bias else None
    a = torch.from_numpy(rng.uniform(0.5, 1.5, 4)).requires_grad_()
    b = _f64(rng, 4, scale=0.3)
    if project:
        w_out = _f64(rng, 4)
        fn = lambda *t: port_layer.vn_layer_fused_project(*t, NS)  # noqa: E731
        args = (x, w, wd, pb, db, a, b, w_out)
    else:
        fn = lambda *t: port_layer.vn_layer_fused(*t, NS)  # noqa: E731
        args = (x, w, wd, pb, db, a, b)
    assert torch.autograd.gradcheck(fn, args)


# --------------------------------------------------------------------- card


@pytest.mark.gpu
@pytest.mark.parametrize("c,n", [(16, 512), (128, 2048), (1024, 1000)])
def test_kernel_a_cuda_matches_plain(cuda, c, n):
    rng = np.random.default_rng(c)
    args = _t(*_bn_inputs(rng, 2, c, n), device=cuda)
    before = port_fused._KERNEL.launches
    got = port_fused.fused_bn_leaky(*args, NS)
    torch.cuda.synchronize()
    assert port_fused._KERNEL.launches == before + 1
    want = port_fused.reference_bn_leaky_planes(*args, NS)
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("c_in,c_out,n,bias", [
    (2, 16, 1000, True), (2, 256, 4096, True), (16, 16, 1024, False),
    (256, 256, 4100, False),
])
def test_kernel_b_cuda_matches_plain(cuda, c_in, c_out, n, bias):
    rng = np.random.default_rng(c_out + n)
    x, w, wd, pb, db, a, b, _ = _t(*_layer_inputs(rng, 2, c_in, c_out, n, bias), device=cuda)
    got = port_layer.vn_layer_fused(x, w, wd, pb, db, a, b, NS)
    torch.cuda.synchronize()
    want = port_layer.reference_layer_fused(x, w, wd, pb, db, a, b, NS)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("c_in,c_out,n,bias", [
    (16, 16, 1024, False), (256, 256, 4100, False), (2, 100, 999, True),
])
def test_kernel_c_cuda_matches_plain(cuda, c_in, c_out, n, bias):
    rng = np.random.default_rng(c_in + n)
    x, w, wd, pb, db, a, b, w_out = _t(
        *_layer_inputs(rng, 2, c_in, c_out, n, bias), device=cuda)
    got = port_layer.vn_layer_fused_project(x, w, wd, pb, db, a, b, w_out, NS)
    torch.cuda.synchronize()
    want = port_layer.reference_layer_fused_project(x, w, wd, pb, db, a, b, w_out, NS)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


def _tie_clouds(rng, b, n, m, quantum=0.0):
    """Clouds with exact ties both ways: duplicate points in each cloud and
    points of x equal to points of y (zero distances); ``quantum`` rounds
    every coordinate to a grid, so that many distances are equal."""
    x = (rng.standard_normal((b, n, 3)) * 0.3).astype(np.float32)
    y = (rng.standard_normal((b, m, 3)) * 0.3).astype(np.float32)
    y[:, m // 2] = y[:, 0]
    x[:, n // 2] = x[:, 0]
    if n > 4 and m > 4:
        x[:, 3] = y[:, 1]
        x[:, n - 1] = y[:, 1]
        y[:, m - 2] = x[:, 2]
    if quantum:
        x, y = (np.round(t / quantum) * quantum for t in (x, y))
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m,quantum", [
    (2, 300, 700, 0.0), (2, 2048, 1500, 0.0), (2, 1, 5, 0.0),
    (8, 16384, 16384, 0.0), (8, 1024, 16384, 0.0), (8, 16384, 1024, 0.0),
    (8, 448, 14336, 0.0), (8, 14336, 14336, 0.0), (8, 2048, 2048, 0.0),
    (2, 2047, 16385, 0.0), (1, 16384, 16384, 0.0), (1, 3000, 2500, 0.0),
    (2, 4096, 4096, 1 / 16), (2, 700, 5000, 1 / 8),
])
def test_kernel_d_cuda_matches_plain(cuda, b, n, m, quantum):
    """Kernel D's one sweep (both directions from each distance, the blocks'
    minima combined by an integer atomicMin on (d, index) keys) against the
    plain version at every shape the models pass, ragged sizes and one
    sample, on clouds with exact ties both ways (and, on a grid, many equal
    distances): distances and indices equal to the bit, one counted launch
    a call, and a second launch gives the same bits."""
    x, y = _tie_clouds(np.random.default_rng(n + m), b, n, m, quantum)
    xt, yt = _t(x, y, device=cuda)
    before = cuda_lib.launch_counts()["chamfer_nn_bidir"]
    got = port_chamfer.nn_bidirectional(xt, yt)
    again = port_chamfer.nn_bidirectional(xt, yt)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["chamfer_nn_bidir"] == before + 2
    want = port_chamfer.nn_bidirectional_reference(xt, yt)
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
        assert torch.equal(g, a)


@pytest.mark.gpu
def test_cuda_model_kernels_match_plain_path(cuda):
    """Whole eval-mode model on the card, kernels against the plain chain, at
    num_coarse=256 (dense 4096: every kernel of the path is taken)."""
    from vn_pointcloudcompletion_tpu_torch.models.composer import PCNNet, init_weights_

    model = init_weights_(PCNNet(num_coarse=256), 0).to(cuda).eval()
    rng = np.random.default_rng(0)
    xyz = torch.from_numpy((rng.standard_normal((2, 2048, 3)) * 0.3).astype(np.float32)).to(cuda)
    cuda_lib.reset_launch_counts()
    with torch.no_grad():
        coarse, fine = model(xyz)
        counts = cuda_lib.launch_counts()
        model.use_kernels_(False)
        coarse_p, fine_p = model(xyz)
    assert {k: v for k, v in counts.items() if v} == {
        "vn_bn_leaky_fwd": 2, "vn_layer_fused_fwd": 1, "vn_layer_fused_project_fwd": 1}
    assert fine.shape == (2, 4096, 3)
    torch.testing.assert_close(coarse, coarse_p, atol=0, rtol=0)
    torch.testing.assert_close(fine, fine_p, atol=1e-5, rtol=1e-4)


# --------------------------------------------------------- card, backward
#
# Tolerance for the backward kernels against their plain versions on the
# card: max |kernel - plain| <= 1e-4 x max |plain| per output (the kernels
# sum the products with fmaf in input-channel order and the point sums in
# fixed trees; cuBLAS and torch.sum order them otherwise).  Every new kernel
# runs twice on the same inputs and must give the same bits (no float
# atomics).


def _assert_rel(got, want, rel=1e-4):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape
        err = (g - w).abs().max().item()
        assert err <= rel * max(w.abs().max().item(), 1e-30), (err, w.abs().max().item())


def _assert_same_bits(first, second):
    for f, s in zip(first, second):
        assert (f is None and s is None) or torch.equal(f, s)


@pytest.mark.gpu
@pytest.mark.parametrize("c,n", [(16, 512), (128, 2048), (1024, 1000)])
def test_kernel_a_bwd_cuda_matches_plain(cuda, c, n):
    rng = np.random.default_rng(c + 1)
    p, d, a, b = _t(*_bn_inputs(rng, 2, c, n), device=cuda)
    g = torch.from_numpy(rng.standard_normal((2, 3, c, n)).astype(np.float32)).to(cuda)
    before = port_fused._BWD.launches
    got = port_fused.bn_leaky_bwd(p, d, a, b, g, NS)
    again = port_fused.bn_leaky_bwd(p, d, a, b, g, NS)
    torch.cuda.synchronize()
    assert port_fused._BWD.launches == before + 2
    want = port_fused.reference_bn_leaky_bwd(p, d, a, b, g, NS)
    for k in (0, 1):  # dp, dd: the plain version is written in the kernel's order
        assert torch.equal(got[k], want[k]), (got[k] - want[k]).abs().max().item()
    _assert_rel(got[2:], want[2:], 1e-5)
    _assert_same_bits(got, again)


_LAYER_SHAPES = [(2, 16, 1000, True), (2, 256, 4096, True), (16, 16, 1024, False),
                 (256, 256, 4100, False)]


# Kernel S's shapes: _LAYER_SHAPES (2 -> 16, 2 -> 256 narrow; 16 -> 16,
# 256 -> 256 wide) and the wide design at the other widths it takes:
# 16 -> 16 and 256 -> 256 with a bias, 256 -> 128 (vn_folding{1,2}.1) on a
# ragged and a whole tile, with and without bias.
_STATS_SHAPES = [*_LAYER_SHAPES, (16, 16, 1024, True), (256, 256, 4100, True),
                 (256, 128, 1000, True), (256, 128, 4096, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("c_in,c_out,n,bias", _STATS_SHAPES)
def test_kernel_s_cuda_matches_plain(cuda, c_in, c_out, n, bias):
    rng = np.random.default_rng(c_out + n + 7)
    x, w, _, pb, _, _, _, _ = _t(*_layer_inputs(rng, 2, c_in, c_out, n, bias), device=cuda)
    c1, c2 = (torch.randn(c_out, generator=torch.Generator().manual_seed(k)).to(cuda)
              for k in (1, 2))
    s0, b0 = port_layer._STATS.launches, port_layer._STATS_BWD.launches
    key = f"vn_layer_stats_fwd/{port_layer.stats_design(c_in, c_out)}"
    v0 = cuda_lib.variant_counts().get(key, 0)
    got, again = port_layer.stats_fwd(x, w, pb), port_layer.stats_fwd(x, w, pb)
    dgot = port_layer.stats_bwd(x, w, pb, c1, c2)
    dagain = port_layer.stats_bwd(x, w, pb, c1, c2)
    torch.cuda.synchronize()
    assert port_layer._STATS.launches == s0 + 2
    assert cuda_lib.variant_counts().get(key, 0) == v0 + 2
    assert port_layer._STATS_BWD.launches == b0 + 2
    _assert_rel(got, port_layer.reference_stats(x, w, pb), 1e-5)
    _assert_rel(dgot, port_layer.reference_stats_bwd(x, w, pb, c1, c2))
    _assert_same_bits(got, again)
    _assert_same_bits(dgot, dagain)


@pytest.mark.gpu
@pytest.mark.parametrize("c_in,c_out,n,bias", [(16, 16, 1024, True), (256, 256, 4100, False),
                                              (256, 128, 1000, True)])
@pytest.mark.parametrize("bf16", [False, True])
def test_wide_stats_against_narrow_design(cuda, c_in, c_out, n, bias, bf16, monkeypatch):
    """The wide S against the narrow S on the same inputs: in float32 the
    same bits (the same products in the same order, the same partials); in
    bf16 (p on the tensor cores, summed in their own order) within the
    plain version's bound of each other."""
    rng = np.random.default_rng(c_in + c_out + n)
    x, w, _, pb, _, _, _, _ = _t(*_layer_inputs(rng, 2, c_in, c_out, n, bias), device=cuda)
    if bf16:
        x, pb = (None if t is None else t.to(torch.bfloat16) for t in (x, pb))
    wide = port_layer.stats_fwd(x, w, pb)
    monkeypatch.setattr(port_layer, "stats_design", lambda *widths: "narrow")
    narrow = port_layer.stats_fwd(x, w, pb)
    torch.cuda.synchronize()
    if bf16:
        _assert_rel(wide, narrow, 1e-4)
    else:
        _assert_same_bits(wide, narrow)


@pytest.mark.gpu
@pytest.mark.parametrize("c_in", [1, 2])
@pytest.mark.parametrize("c_out", [16, 256])
@pytest.mark.parametrize("layout,n", [("none", 999), ("sample", 999), ("sample", 4096),
                                      ("group64", 1216), ("group2", 1000)])
@pytest.mark.parametrize("bf16", [False, True])
def test_stream_layer_against_narrow_design(cuda, c_in, c_out, layout, n, bf16, monkeypatch):
    """Kernel B's stream design (C_in <= 2) against its narrow design on the
    same inputs, forced through the chooser: the same operations in the same
    order, so the same bits, in float32 and bf16, with no bias, a per-sample
    bias or one bias column per 64 (or 2) points, at ragged N (999: the
    scalar stores) and aligned N; each launch counted under its design."""
    rng = np.random.default_rng(c_in + c_out + n)
    x, w, wd, pb, db, a, b, _ = _layer_inputs(rng, 2, c_in, c_out, n, layout != "none")
    group = {"group64": 64, "group2": 2}.get(layout, 0)
    if group:
        pb, db = (rng.standard_normal((2, 3, c_out, n // group)).astype(np.float32)
                  for _ in range(2))
    if bf16:
        xt, pbt, dbt = _bf16_t(x, pb, db, device=cuda)
    else:
        xt, pbt, dbt = _t(x, pb, db, device=cuda)
    wt, wdt, at, bt = _t(w, wd, a, b, device=cuda)
    name = "vn_layer_fused_fwd" + ({(False, False): "", (False, True): "[group]",
                                    (True, False): "[bf16]", (True, True): "[group,bf16]"}
                                   [(bf16, bool(group))])
    before = cuda_lib.variant_counts()
    stream = port_layer.vn_layer_fused(xt, wt, wdt, pbt, dbt, at, bt, NS, group)
    monkeypatch.setattr(port_layer, "layer_fwd_design", lambda c_in: "narrow")
    narrow = port_layer.vn_layer_fused(xt, wt, wdt, pbt, dbt, at, bt, NS, group)
    torch.cuda.synchronize()
    after = cuda_lib.variant_counts()
    for design in ("stream", "narrow"):
        key = f"{name}/{design}"
        assert after.get(key, 0) == before.get(key, 0) + 1
    assert stream.dtype == narrow.dtype == xt.dtype
    assert torch.equal(stream, narrow)


@pytest.mark.gpu
@pytest.mark.parametrize("c_in,c_out", [(1, 32), (16, 32)])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_kernel_s_small_groups_cuda_matches_plain(cuda, c_in, c_out, group):
    """Bias columns of 1, 2 and 4 points (a thread's four points then span
    four, two or one column) in both designs."""
    rng = np.random.default_rng(group + c_in)
    x, w, _, _, _, _, _, _ = _t(*_layer_inputs(rng, 2, c_in, c_out, 1024, False), device=cuda)
    pb = torch.from_numpy(rng.standard_normal((2, 3, c_out, 1024 // group))
                          .astype(np.float32)).to(cuda)
    got = port_layer.stats_fwd(x, w, pb, group)
    _assert_rel(got, port_layer.reference_stats(x, w, pb, group), 1e-5)
    _assert_same_bits(got, port_layer.stats_fwd(x, w, pb, group))


@pytest.mark.gpu
@pytest.mark.parametrize("c_in,c_out,n,bias", _LAYER_SHAPES)
@pytest.mark.parametrize("project", [False, True])
def test_kernel_b_c_bwd_cuda_matches_plain(cuda, c_in, c_out, n, bias, project):
    rng = np.random.default_rng(c_in + c_out + n)
    x, w, wd, pb, db, a, b, w_out = _t(
        *_layer_inputs(rng, 2, c_in, c_out, n, bias), device=cuda)
    g = torch.from_numpy(rng.standard_normal(
        (2, 3, 1 if project else c_out, n)).astype(np.float32)).to(cuda)
    if project:
        kernel, fn = port_layer._PROJECT_BWD, port_layer.layer_project_bwd
        plain = port_layer.reference_layer_project_bwd
        args = (x, w, wd, pb, db, a, b, w_out, g)
    else:
        kernel, fn = port_layer._LAYER_BWD, port_layer.layer_bwd
        plain = port_layer.reference_layer_bwd
        args = (x, w, wd, pb, db, a, b, g)
    before = kernel.launches
    got, again = fn(*args, NS), fn(*args, NS)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    _assert_rel(got, plain(*args, NS))
    _assert_same_bits(got, again)


# group=S: the biases are (B, 3, C_out, N // S), column n // S at point n
# (the attention decoder's pair folds run S = 64).  S = 16 splits a 64-point
# tile into four bias sums, N = 4112 leaves a ragged last tile; S = 128 sums
# two whole tiles.  B at C_in = 1 (the pair fold's width) is exact: one
# product and the bias add, then the epilogue in the plain version's order.


def _group_inputs(rng, c_in, c_out, n, s):
    x, w, wd, _, _, a, b, w_out = _layer_inputs(rng, 2, c_in, c_out, n, bias=False)
    pb, db = (rng.standard_normal((2, 3, c_out, n // s)).astype(np.float32) for _ in range(2))
    return x, w, wd, pb, db, a, b, w_out


_GROUP_SHAPES = [(1, 256, 4112, 16), (1, 256, 4096, 64), (16, 32, 1920, 128)]


def _group_counts(symbols):
    counts = cuda_lib.launch_counts()
    return [(counts[s], counts[f"{s}[group]"]) for s in symbols]


@pytest.mark.gpu
@pytest.mark.parametrize("c_in,c_out,n,s", _GROUP_SHAPES)
def test_kernel_group_forward_cuda_matches_plain(cuda, c_in, c_out, n, s):
    """B, C and S with group=S against their plain versions, twice each for
    equal bits; the launches counted under ``<symbol>[group]``."""
    rng = np.random.default_rng(n + s)
    x, w, wd, pb, db, a, b, w_out = _t(*_group_inputs(rng, c_in, c_out, n, s), device=cuda)
    symbols = ("vn_layer_fused_fwd", "vn_layer_fused_project_fwd", "vn_layer_stats_fwd")
    before = _group_counts(symbols)
    runs = [(port_layer.vn_layer_fused(x, w, wd, pb, db, a, b, NS, group=s),
             port_layer.vn_layer_fused_project(x, w, wd, pb, db, a, b, w_out, NS, group=s),
             port_layer.stats_fwd(x, w, pb, group=s)) for _ in range(2)]
    torch.cuda.synchronize()
    assert _group_counts(symbols) == [(n0, ng + 2) for n0, ng in before]
    got_b, got_c, got_s = runs[0]
    want_b = port_layer.reference_layer_fused(x, w, wd, pb, db, a, b, NS, s)
    if c_in == 1:
        assert torch.equal(got_b, want_b), (got_b - want_b).abs().max().item()
    torch.testing.assert_close(got_b, want_b, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_c, port_layer.reference_layer_fused_project(
        x, w, wd, pb, db, a, b, w_out, NS, s), atol=1e-4, rtol=1e-5)
    _assert_rel(got_s, port_layer.reference_stats(x, w, pb, s), 1e-5)
    for first, second in zip(*runs):
        _assert_same_bits(first if isinstance(first, tuple) else (first,),
                          second if isinstance(second, tuple) else (second,))


@pytest.mark.gpu
@pytest.mark.parametrize("c_in,c_out,n,s", _GROUP_SHAPES)
def test_kernel_group_backward_cuda_matches_plain(cuda, c_in, c_out, n, s):
    """S', B' and C' with group=S against their plain versions (the bias
    gradients summed over each group's S points), 1e-4 of each output's
    max, twice each for equal bits."""
    rng = np.random.default_rng(n + s + 1)
    x, w, wd, pb, db, a, b, w_out = _t(*_group_inputs(rng, c_in, c_out, n, s), device=cuda)
    c1, c2 = (torch.from_numpy(rng.standard_normal(c_out).astype(np.float32)).to(cuda)
              for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((2, 3, c_out, n)).astype(np.float32)).to(cuda)
    g1 = torch.from_numpy(rng.standard_normal((2, 3, 1, n)).astype(np.float32)).to(cuda)
    cases = (
        (lambda: port_layer.stats_bwd(x, w, pb, c1, c2, s),
         lambda: port_layer.reference_stats_bwd(x, w, pb, c1, c2, s)),
        (lambda: port_layer.layer_bwd(x, w, wd, pb, db, a, b, g, NS, s),
         lambda: port_layer.reference_layer_bwd(x, w, wd, pb, db, a, b, g, NS, s)),
        (lambda: port_layer.layer_project_bwd(x, w, wd, pb, db, a, b, w_out, g1, NS, s),
         lambda: port_layer.reference_layer_project_bwd(
             x, w, wd, pb, db, a, b, w_out, g1, NS, s)),
    )
    symbols = ("vn_layer_stats_bwd", "vn_layer_fused_bwd", "vn_layer_fused_project_bwd")
    before = _group_counts(symbols)
    for kernel, plain in cases:
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        want = plain()
        assert got[-1 if kernel is cases[0][0] else 3].shape == (2, 3, c_out, n // s)
        _assert_rel(got, want)
        _assert_same_bits(got, again)
    assert _group_counts(symbols) == [(n0, ng + 2) for n0, ng in before]


@pytest.mark.gpu
@pytest.mark.parametrize("batch,grad_tol", [(4, 3e-4), (8, 7.5e-4)])
def test_cuda_train_step_kernels_match_plain_path(cuda, batch, grad_tol):
    """One guarded train step at num_coarse=256 (dense 4096: all nine
    kernels launched) on the synthetic set, through the kernels and through
    the plain path from the same weights, compared as ``chip_smoke.py``
    compares them at full width: losses and running statistics rtol 1e-4,
    every gradient within ``grad_tol`` of its tensor's max |g|, about twice
    what ``chip_smoke.py`` phase 5b reads on an H100 (1.07e-4 at batch 4,
    3.74e-4 at batch 8; the float32 sums of the BatchNorm-on-norms variance
    set the gap, and the step gives the same bits on every run)."""
    import chip_smoke

    case = chip_smoke.small_step_case(cuda, batch)
    cuda_lib.reset_launch_counts()
    loss_err, stat_err, errs = chip_smoke.step_agreement(*case)
    counts = cuda_lib.launch_counts()
    assert all(counts[k] > 0 for k in chip_smoke.FLAGSHIP_KERNELS), counts
    assert loss_err <= 1e-4 and stat_err <= 1e-4, (loss_err, stat_err)
    assert max(errs.values()) <= grad_tol, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.gpu
def test_cuda_train_steps_are_reproducible(cuda):
    """Two guarded train steps from the same weights and batch give the same
    bits: the kernels sum in fixed orders and the chamfer backward's scatter
    is sort-based."""
    from vn_pointcloudcompletion_tpu_torch.models.composer import PCNNet, init_weights_
    from vn_pointcloudcompletion_tpu_torch.training import steps as port_steps
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state
    from vn_pointcloudcompletion_tpu_torch.utils.config import Config

    rng = np.random.default_rng(1)
    partial = torch.from_numpy((rng.standard_normal((2, 2048, 3)) * 0.3).astype(np.float32)).to(cuda)
    complete = torch.from_numpy((rng.standard_normal((2, 4096, 3)) * 0.3).astype(np.float32)).to(cuda)
    cfg = Config.from_dict({"num_coarse": 256, "lr": 1e-4, "rotation": "so3"})
    runs = []
    for _ in range(2):
        state = create_train_state(init_weights_(PCNNet(num_coarse=256), 0).to(cuda), cfg, 1)
        gen = torch.Generator().manual_seed(0)
        losses = [port_steps.train_step(state, partial, complete, gen)["total"] for _ in range(2)]
        runs.append((torch.stack(losses), state.model.state_dict()))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


@pytest.mark.gpu
def test_cuda_remat_step_equals_plain_step(cuda):
    """A guarded train step with ``remat`` through the kernels at
    num_coarse=256, batch 4, between two without, from the same weights:
    the losses, every gradient, every parameter after the update and every
    running statistic equal in bits; the forward kernels (A, S, B, C)
    launched twice, the backward kernels and D once each
    (``chip_smoke.py`` phase 14a at full width)."""
    import chip_smoke

    model, _, config, partial, complete = chip_smoke.small_step_case(cuda, 4)
    runs = chip_smoke.remat_step_runs(model, config, partial, complete)
    assert chip_smoke.check_remat("[remat test]", runs) == {}
    plain, remat = runs[0][3], runs[1][3]
    assert all(plain.get(k) for k in chip_smoke.FLAGSHIP_KERNELS), plain
    for k in chip_smoke.FLAGSHIP_KERNELS:
        assert remat[k] == plain[k] * (2 if k in chip_smoke.REMAT_FORWARD else 1), (k, remat)


@pytest.mark.gpu
def test_cuda_device_memory_stats_and_step_timer(cuda):
    """``utils/profiling.py`` on the card: ``device_memory_stats`` reads the
    allocator's bytes in use and their peak and the card's memory under
    JAX's keys; ``StepTimer`` times each step on the device as well."""
    from vn_pointcloudcompletion_tpu_torch.utils.profiling import StepTimer, device_memory_stats

    torch.cuda.synchronize()
    before = device_memory_stats()[0]["bytes_in_use"]
    torch.cuda.reset_peak_memory_stats()
    x = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    stats = device_memory_stats()
    assert len(stats) == torch.cuda.device_count() and stats[0]["device"] == "cuda:0"
    assert stats[0]["bytes_in_use"] == before + (64 << 20)
    assert stats[0]["peak_bytes_in_use"] >= stats[0]["bytes_in_use"]
    assert stats[0]["bytes_limit"] == torch.cuda.get_device_properties(0).total_memory
    del x
    after = device_memory_stats()[0]
    assert after["bytes_in_use"] == before and after["peak_bytes_in_use"] >= before + (64 << 20)
    timer = StepTimer(warmup=1)
    a = torch.ones(2048, 2048, device=cuda)
    for _ in range(3):
        with timer:
            a @ a
    assert len(timer.device_times) == 3 and all(t > 0 for t in timer.device_times)
    assert timer.device_summary()["steps"] == 2 and timer.summary()["steps"] == 2


@pytest.mark.gpu
def test_cuda_trace_and_log_compile_time(cuda, tmp_path):
    """``utils/profiling.py``'s ``trace`` records the card's kernels through
    CUPTI and writes a Chrome trace; ``log_compile_time`` times a first and
    a second call, each up to its synchronisation."""
    import json
    import os

    from vn_pointcloudcompletion_tpu_torch.utils.profiling import log_compile_time, trace

    a = torch.ones(1024, 1024, device=cuda)
    first, steady = log_compile_time(lambda: {"out": a @ a})
    assert first > 0 and steady > 0
    with trace(str(tmp_path / "tb")) as prof:
        a @ a
    assert any(e.self_device_time_total > 0 for e in prof.key_averages())
    (name,) = os.listdir(tmp_path / "tb")
    with open(tmp_path / "tb" / name) as f:
        assert json.load(f)["traceEvents"]


# ------------------------------------------------ card, DGCNN family
#
# K1, K2, K3 and F against their plain versions on the card: the plain
# versions do the kernels' operations in the kernels' order, so indices and
# values are equal; each kernel runs twice and must give the same bits.


def _cloud(seed, b, n):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.uniform(-0.5, 0.5, (b, n, 3))).astype(np.float32))


def _lane_tie_cloud(b, m, period=32):
    """(b, m, 3) reference points whose distances from the origin tie the
    way duplicate points do inside one warp lane of K1-K3 (columns j and
    j + period, 32; 16 for one lane of K1's stream design), with a nearer
    point later in the same lane (column j + 2 period) for j < 8
    (``chip_smoke.lane_tie_cloud``).  Of k = 32 nearest to the origin at
    period 32, ties to the lowest index give m - 1, then 64..71 (in some
    order), then 0, 32, 1, 33, ..."""
    from chip_smoke import lane_tie_cloud

    return lane_tie_cloud(torch.device("cpu"), b, m, period)


def test_lane_tie_cloud_orders_ties_by_index():
    """The tie pattern of the card tests below: the plain selection keeps the
    lower index of each duplicate pair first."""
    r = _lane_tie_cloud(2, 333)
    _, idx = knn_pallas.reference_knn_min(r[:, -1:], r, 32)
    got = idx[0, 0].tolist()
    assert got[0] == 332 and sorted(got[1:9]) == list(range(64, 72))
    assert got[9:13] == [0, 32, 1, 33]


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m,k,case", [
    (2, 300, 700, 16, "randn"), (2, 2048, 2048, 16, "randn"), (2, 64, 4096, 64, "randn"),
    (2, 100, 333, 32, "int"), (2, 16, 333, 40, "lane"), (8, 2048, 2048, 16, "scans"),
    (8, 2048, 4096, 64, "randn"), (2, 100, 2047, 16, "randn"), (2, 100, 336, 32, "int"),
    (2, 64, 2048, 64, "int"), (2, 16, 336, 40, "lane16"), (2, 3, 4, 4, "int")])
def test_kernel_k1_cuda_matches_plain(cuda, b, n, m, k, case, monkeypatch):
    """K1 in the design ``topk_design`` picks (stream at M % 4 == 0, the
    parent warp design at M 333 and 2047) against its plain version, a
    second launch and the warp design: indices and values equal to the
    bit, each launch counted under its design.  "scans": the distance
    matrix of the main path's rotated partial scans (their resampling
    repeats points, so distances tie); "int": integers 0-6, ties in every
    lane and across lanes; "lane", "lane16": the squared norms of the
    lane-tie cloud, its duplicate pairs inside one lane of the warp design
    (32 columns apart) or of the stream design (16)."""
    g = torch.Generator().manual_seed(n + m)
    if case == "scans":
        import chip_smoke
        from vn_pointcloudcompletion_tpu_torch.ops.rotations import rotate_points

        partial, _, rot = chip_smoke.main_path_batch(cuda)
        q = rotate_points(partial, rot)
        d = knn_pallas.pairwise_sqdist(q, q)
    elif case.startswith("lane"):
        cloud = _lane_tie_cloud(b, m, 16 if case == "lane16" else 32)
        d = (cloud ** 2).sum(-1)[:, None, :].expand(b, n, m).contiguous()
    elif case == "int":
        d = torch.randint(0, 7, (b, n, m), generator=g).float()
    else:
        d = torch.randn(b, n, m, generator=g)
    d = d.to(cuda)
    design = knn_pallas.topk_design(m, k, True)
    assert design == ("stream" if m % 4 == 0 else "warp")
    key = f"topk_min/{design}"
    before = cuda_lib.variant_counts().get(key, 0)
    got, again = knn_pallas.topk_min_fwd(d, k), knn_pallas.topk_min_fwd(d, k)
    torch.cuda.synchronize()
    assert cuda_lib.variant_counts()[key] == before + 2
    want = knn_pallas.reference_topk_min(d, k)
    monkeypatch.setattr(knn_pallas, "topk_design", lambda *shape: "warp")
    warp = knn_pallas.topk_min_fwd(d, k)
    torch.cuda.synchronize()
    for a, w, c, p in zip(got, want, again, warp):
        assert torch.equal(a, w) and torch.equal(a, c) and torch.equal(a, p)


@pytest.mark.gpu
def test_kernel_k1_unaligned_rows_take_the_warp_design(cuda):
    """A matrix whose start is not 16-byte aligned takes the warp design
    (the stream design copies 16-byte vectors); the result still equals
    the plain version's."""
    d = torch.randn(2, 100, 2048, generator=torch.Generator().manual_seed(5)).to(cuda)
    view = d.new_empty(d.numel() + 1)[1:].view(d.shape).copy_(d)
    assert view.data_ptr() % 16
    before = cuda_lib.variant_counts().get("topk_min/warp", 0)
    got = knn_pallas.topk_min_fwd(view, 16)
    torch.cuda.synchronize()
    assert cuda_lib.variant_counts()["topk_min/warp"] == before + 1
    for a, w in zip(got, knn_pallas.reference_topk_min(d, 16)):
        assert torch.equal(a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,dim,k", [(2048, 2048, 3, 16), (128, 128, 3, 16),
                                       (512, 2048, 3, 16), (100, 333, 40, 32),
                                       (50, 700, 512, 64), (0, 333, 3, 32),
                                       (128, 128, 3, 8), (-1, 128, 3, 8),
                                       (2048, 2048, 3, 40), (2048, 2048, 64, 40),
                                       (-1, 2048, 3, 40)])
def test_kernel_k2_cuda_matches_plain(cuda, n, m, dim, k):
    """n = 0: the lane-tie cloud, every point a query.  k = 8 on 128 points:
    vn_pointr's proxy graph over its centres; n = -1 with the repeats of FPS
    centres (resample padding wraps back to index 0) and a duplicate pair.
    k = 40 at 2048 points: the classic DGCNN's four graphs (D 3 and 64)."""
    g = torch.Generator().manual_seed(n + dim)
    if n == -1:
        q = r = _cloud(k, 2, m)
        q[:, 100:] = q[:, :1]
        q[:, 50:60] = q[:, 10:20]
        q = r = q.to(cuda)
    elif n == 0:
        q = r = _lane_tie_cloud(2, m).to(cuda)
    else:
        q = torch.randn(2, n, dim, generator=g).to(cuda)
        r = torch.randn(2, m, dim, generator=g).to(cuda)
    got, again = knn_pallas.knn_min_fwd(q, r, k), knn_pallas.knn_min_fwd(q, r, k)
    torch.cuda.synchronize()
    want = knn_pallas.reference_knn_min(q, r, k)
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("n,dim,c3,k", [(512, 3, 384, 16), (512, 3, 768, 16),
                                        (300, 48, 96, 32), (2048, 3, 384, 16),
                                        (512, 0, 96, 32), (512, 0, 384, 16), (128, 0, 96, 16),
                                        (512, 96, 384, 16), (512, 192, 384, 16),
                                        (128, 192, 768, 16), (64, 40, 32, 32), (116, 48, 64, 16)])
def test_kernel_k3_cuda_matches_plain(cuda, n, dim, c3, k):
    """Forward equal to the bit, twice, in the design ``edge_design`` picks
    (coords: D 3 and the lane-tie cloud at k 16; tiled: vn_pointr's D 96
    and 192 at N 512, 128, and D 40 at N 64; warp: N 2048, k 32 at N 300
    and 512, N 116 not a multiple of 8); the backward (du scatter, dv sum)
    within 1e-6 of its max against autograd of the plain chain.  dim = 0:
    the lane-tie cloud's coordinates."""
    g = torch.Generator().manual_seed(n + c3)
    if dim == 0:
        x = _lane_tie_cloud(2, n).transpose(1, 2).contiguous().to(cuda)
    else:
        x = torch.randn(2, dim, n, generator=g).to(cuda)
    u, v = (torch.randn(2, c3, n, generator=g).to(cuda) for _ in range(2))
    design = knn_pallas.edge_design(n, x.shape[1], k, False)
    key = f"edge_knn_gather/{design}"
    before = cuda_lib.variant_counts().get(key, 0)
    got, again = knn_pallas.edge_knn_gather_fwd(x, u, v, k), knn_pallas.edge_knn_gather_fwd(x, u, v, k)
    torch.cuda.synchronize()
    assert cuda_lib.variant_counts()[key] == before + 2
    want = knn_pallas.reference_edge_knn_gather(x, u, v, k)
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    cot = torch.randn(2, c3, k, n, generator=g).to(cuda)
    grads = []
    for fn in (knn_pallas.edge_knn_gather,
               lambda *a: knn_pallas.reference_edge_knn_gather(*a)[0]):
        uu, vv = u.clone().requires_grad_(), v.clone().requires_grad_()
        (fn(x, uu, vv, k) * cot).sum().backward()
        grads.append((uu.grad, vv.grad))
    _assert_rel(grads[0], grads[1], 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["coords", "tiled"])
def test_kernel_k3_designs_agree_with_the_warp_design(cuda, design, monkeypatch):
    """The new designs and the parent warp design on the same inputs at a
    path shape: the same indices and bits."""
    n, dim = (512, 3) if design == "coords" else (512, 192)
    g = torch.Generator().manual_seed(dim)
    x = torch.randn(2, dim, n, generator=g).to(cuda)
    u, v = (torch.randn(2, 384, n, generator=g).to(cuda) for _ in range(2))
    assert knn_pallas.edge_design(n, dim, 16, False) == design
    got = knn_pallas.edge_knn_gather_fwd(x, u, v, 16)
    monkeypatch.setattr(knn_pallas, "edge_design", lambda *shape: "warp")
    warp = knn_pallas.edge_knn_gather_fwd(x, u, v, 16)
    torch.cuda.synchronize()
    for a, b in zip(got, warp):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 8, 16, 40, 64])
@pytest.mark.parametrize("case", ["ragged", "duplicates", "strided"])
def test_kernel_k2_coords_against_plain_and_warp_design(cuda, k, case, monkeypatch):
    """K2's coords design (D 3) against its plain version and the parent
    warp design on the same inputs: indices and values equal to the bit,
    twice.  ragged: N 300 != M 700, neither a multiple of a block's 64
    queries or a warp's 32-reference span; duplicates: the lane-tie cloud
    (ties inside one lane's list and across a query's lanes) with the
    queries a suffix of it; strided: q and r as transposed views of (B, 3,
    N) planes, which the coords design reads in place."""
    g = torch.Generator().manual_seed(k)
    if case == "duplicates":
        r = _lane_tie_cloud(2, 333).to(cuda)
        q = r[:, 333 - 100:]
    else:
        q, r = torch.randn(2, 300, 3, generator=g), torch.randn(2, 700, 3, generator=g)
        if case == "strided":
            q, r = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, r))
        q, r = q.to(cuda), r.to(cuda)
    assert knn_pallas.knn_design(r.shape[1], 3, k) == "coords"
    before = cuda_lib.variant_counts().get("knn_min/coords", 0)
    got, again = knn_pallas.knn_min_fwd(q, r, k), knn_pallas.knn_min_fwd(q, r, k)
    torch.cuda.synchronize()
    assert cuda_lib.variant_counts()["knn_min/coords"] == before + 2
    want = knn_pallas.reference_knn_min(q, r, k)
    monkeypatch.setattr(knn_pallas, "knn_design", lambda *shape: "warp")
    warp = knn_pallas.knn_min_fwd(q, r, k)
    torch.cuda.synchronize()
    for a, b, c, w in zip(got, want, again, warp):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [224, 128], ids=["self", "cross"])
@pytest.mark.parametrize("case", ["random", "duplicates"])
def test_kernel_k2_decoder_graphs_match_plain(cuda, m, case):
    """K2 at the shapes of vn_pointr's decoder stack, 224 queries (the
    coarse points) over themselves or over the 128 centres, k 8: indices
    and distances equal to the plain version's, twice; duplicates: the
    lane-tie cloud, the queries the cloud repeated up to 224."""
    g = torch.Generator().manual_seed(m)
    if case == "duplicates":
        r = _lane_tie_cloud(2, m).to(cuda)
        q = torch.cat([r] * -(-224 // m), dim=1)[:, -224:]
    else:
        r = torch.randn(2, m, 3, generator=g).to(cuda)
        q = r if m == 224 else torch.randn(2, 224, 3, generator=g).to(cuda)
    got, again = knn_pallas.knn_min_fwd(q, r, 8), knn_pallas.knn_min_fwd(q, r, 8)
    want = knn_pallas.reference_knn_min(q, r, 8)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.gpu
def test_cuda_pointr_decoder_forward_matches_plain_on_one_tape(cuda):
    """The root config's pipeline with ``pointr_decoder`` at full width,
    batch 2: the eval forward through the kernels (K2 4 launches) against
    the plain path on one ``chip_smoke.DecisionTape``, the coarse and dense
    clouds and the refined queries within ``chip_smoke.POINTR_FWD_TOL`` of
    each one's max, as phase 15a holds them at batch 8."""
    import chip_smoke

    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model

    model = build_model(chip_smoke._smoke_config("vn_pointr_448_dec")).to(cuda).eval()
    xyz, _ = chip_smoke.synthetic_batch(cuda, 2)
    queries = []
    model.encoder.register_forward_hook(lambda m, i, out: queries.append(out[1][1]))
    with torch.no_grad(), chip_smoke.DecisionTape() as tape:
        cuda_lib.reset_launch_counts()
        kern = model(xyz)
        torch.cuda.synchronize()
        assert cuda_lib.launch_counts()["knn_min"] == 4
        model.use_kernels_(False)
        tape.run(tape.rec)
        plain = model(xyz)
    for got, want in zip((*kern, queries[0]), (*plain, queries[1])):
        err = ((got - want).abs().max() / want.abs().max()).item()
        assert err <= chip_smoke.POINTR_FWD_TOL, err


@pytest.mark.gpu
def test_kernel_k2_coords_shared_memory_grows_and_shrinks(cuda):
    """K2's coords design takes 16 M + 30 KB of shared memory, above the
    48 KB default from M ~1150: M 4000, then 2900, then 4000 again (one
    kernel, k 16, sizes no other test asks for) each launch and match the
    plain version; the third reuses the first's cached occupancy."""
    g = torch.Generator().manual_seed(11)
    for m in (4000, 2900, 4000):
        r = torch.randn(2, m, 3, generator=g).to(cuda)
        q = r[:, :200]
        got = knn_pallas.knn_min_fwd(q, r, 16)
        torch.cuda.synchronize()
        for a, b in zip(got, knn_pallas.reference_knn_min(q, r, 16)):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [16, 128, 1024])
@pytest.mark.parametrize("n", [2048, 520])
def test_kernel_a_bf16_run8_against_vector_design(cuda, c, n, monkeypatch):
    """A's bf16 run8 design against its plain version and the parent vector
    design: equal to the bit (N 520: 65 runs of 8 points, a row that fills
    no power-of-two block)."""
    p, d, a, b = _bn_inputs(np.random.default_rng(c + n), 2, c, n)
    (pt, dt), (at, bt) = _bf16_t(p, d, device=cuda), _t(a, b, device=cuda)
    assert port_fused.fwd_design(n) == "run8"
    before = cuda_lib.variant_counts().get("vn_bn_leaky_fwd[bf16]/run8", 0)
    got = port_fused.fused_bn_leaky(pt, dt, at, bt, NS)
    torch.cuda.synchronize()
    assert cuda_lib.variant_counts()["vn_bn_leaky_fwd[bf16]/run8"] == before + 1
    want = port_fused.reference_bn_leaky_planes(pt, dt, at, bt, NS)
    monkeypatch.setattr(port_fused, "fwd_design", lambda *shape: "vector")
    vector = port_fused.fused_bn_leaky(pt, dt, at, bt, NS)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want) and torch.equal(got, vector)


@pytest.mark.gpu
def test_kernel_a_bf16_unaligned_planes_take_the_vector_design(cuda):
    """bf16 planes whose start is not 16-byte aligned take the vector
    design; the output still equals the plain version's."""
    p, d, a, b = _bn_inputs(np.random.default_rng(7), 2, 16, 1024)
    (pt, dt), (at, bt) = _bf16_t(p, d, device=cuda), _t(a, b, device=cuda)
    # contiguous copies that start one element (2 bytes) into their storage
    views = [t.new_empty(t.numel() + 1)[1:].view(t.shape).copy_(t) for t in (pt, dt)]
    assert all(v.data_ptr() % 16 for v in views)
    before = cuda_lib.variant_counts().get("vn_bn_leaky_fwd[bf16]/vector", 0)
    got = port_fused.fused_bn_leaky(*views, at, bt, NS)
    torch.cuda.synchronize()
    assert cuda_lib.variant_counts()["vn_bn_leaky_fwd[bf16]/vector"] == before + 1
    assert torch.equal(got, port_fused.reference_bn_leaky_planes(*views, at, bt, NS))


@pytest.mark.gpu
def test_kernel_k2_bwd_cuda_matches_plain(cuda):
    """dq and dr of the K2 Function against autograd of the plain chain,
    within 1e-4 of their max (the Function forms 2 g (q - r), autograd of
    the distance 2 g q - 2 g r)."""
    q, r = _cloud(1, 2, 512).to(cuda), _cloud(2, 2, 2048).to(cuda)
    cot = torch.randn(2, 512, 16, generator=torch.Generator().manual_seed(3)).to(cuda)
    grads = []
    for fn in (knn_pallas.knn_min, knn_pallas.reference_knn_min):
        qq, rr = q.clone().requires_grad_(), r.clone().requires_grad_()
        (fn(qq, rr, 16)[0] * cot).sum().backward()
        grads.append((qq.grad, rr.grad))
    _assert_rel(grads[0], grads[1], 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("n,s,cloud", [(2048, 512, "dup"), (512, 128, "dup"), (2048, 224, "dup"),
                                       (600, 700, "dup"), (16384, 4096, "dup"),
                                       (9000, 700, "dup"), (100, 300, "dup"),
                                       (2048, 512, "one")])
def test_kernel_f_cuda_matches_plain(cuda, n, s, cloud):
    """The paths' shapes, N 16384 and S 4096 (the gate), N above 8192 (the
    minima in registers, the coordinates read from shared memory), and more
    samples than points: equal indices, twice, from the (B, N, 3) cloud and
    from the transposed view of (B, 3, N) planes (the kernel reads
    strides).  "dup": 40 exact duplicates; "one": every point the same, so
    every pick is index 0."""
    xyz = _cloud(n + s, 8 if n <= 2048 else 2, n)
    if cloud == "one":
        xyz[:] = xyz[:, :1]
    else:
        xyz[:, 300 % n:300 % n + 40] = xyz[:, :40]
    xyz = xyz.to(cuda)
    view = xyz.transpose(1, 2).contiguous().transpose(1, 2)
    want = fps_pallas.reference_furthest_point_sample(xyz, s)
    before = fps_pallas._KERNEL.launches
    for x in (xyz, view):
        got = fps_pallas.furthest_point_sample_kernel(x, s)
        again = fps_pallas.furthest_point_sample_kernel(x, s)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got, again)
    assert fps_pallas._KERNEL.launches == before + 4
    if cloud == "one":
        assert not want.any()


@pytest.mark.gpu
@pytest.mark.parametrize("enc,dec,nc,counts", [
    ("vn_dgcnn_fps", "vn_foldingnet", 256, {"knn_min": 2, "edge_knn_gather": 2,
                                            "furthest_point_sample": 2, "vn_bn_leaky_fwd": 3,
                                            "vn_layer_fused_fwd": 2,
                                            "vn_layer_fused_project_fwd": 1}),
    ("dgcnn_fps", "foldingnet", 448, {"knn_min": 4, "furthest_point_sample": 3}),
    ("vn_pointr", "attention_vn_foldingnet", 448, {
        "knn_min": 2, "edge_knn_gather": 3, "furthest_point_sample": 3, "vn_bn_leaky_fwd": 3,
        "vn_layer_fused_fwd": 1, "vn_layer_fused_fwd[group]": 2,
        "vn_layer_fused_project_fwd": 2}),
])
def test_cuda_dgcnn_kernels_match_plain_path(cuda, enc, dec, nc, counts):
    """The eval-mode pipeline on the card, the kernels against the plain
    path: the launches of one forward at 2048 points, coarse and dense
    within 1e-5 + 1e-4 relative (the neighbour and FPS picks are equal; the
    layer kernels B and C round otherwise than cuBLAS)."""
    from vn_pointcloudcompletion_tpu_torch.models.composer import PCNNet, init_weights_

    model = init_weights_(PCNNet(enc, dec, nc), 0).to(cuda).eval()
    xyz = _cloud(0, 2, 2048).to(cuda)
    cuda_lib.reset_launch_counts()
    with torch.no_grad():
        coarse, fine = model(xyz)
        got = cuda_lib.launch_counts()
        model.use_kernels_(False)
        coarse_p, fine_p = model(xyz)
    assert {k: v for k, v in got.items() if v} == counts
    torch.testing.assert_close(coarse, coarse_p, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(fine, fine_p, atol=1e-5, rtol=1e-4)


# ------------------------------------------------------------ card, EMD
#
# Kernel E against its plain version on the card.  The two sum the same
# terms in another order, and the level -4^7 amplifies that rounding on near
# ties of the annealing: the cost within 2e-4 of its max, each moment within
# 1e-2 of its max (the bounds ``tests/test_ops.py::TestEMDOracle`` holds
# JAX's Pallas kernel to against its streamed path).


def _emd_clouds(seed, b, n, m, kind="gauss"):
    """Gaussian clouds x 0.3, or (``"cluster"``) both clouds drawn around
    the same 16 centres at 1e-3, every third point an exact copy of its
    predecessor: near ties at every level and exact ones."""
    rng = np.random.default_rng(seed)
    if kind == "gauss":
        return [torch.from_numpy((rng.standard_normal((b, k, 3)) * 0.3).astype(np.float32))
                for k in (n, m)]
    centres = rng.standard_normal((b, 16, 3)) * 0.3
    clouds = []
    for k in (n, m):
        pick = rng.integers(0, 16, (b, k))
        pts = np.take_along_axis(centres, pick[..., None], 1)
        pts = pts + rng.standard_normal((b, k, 3)) * 1e-3
        pts[:, 2::3] = pts[:, 1:-1:3][:, :pts[:, 2::3].shape[1]]
        clouds.append(torch.from_numpy(pts.astype(np.float32)))
    return clouds


def _assert_emd_close(got, want):
    for name, g, w in zip(("cost", "s_n", "t_n", "s_m", "t_m"), got, want):
        assert g.shape == w.shape, name
        tol = 2e-4 if name == "cost" else 1e-2
        err = (g - w).abs().max().item()
        assert err <= tol * w.abs().max().item(), (name, err, w.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,kind", [
    (1024, 1024, "gauss"), (2048, 512, "gauss"), (512, 2048, "gauss"), (1100, 1030, "gauss"),
    (1537, 2049, "gauss"), (1100, 1030, "cluster"), (2500, 777, "cluster"),
])
def test_kernel_e_cuda_matches_plain(cuda, n, m, kind):
    """One counted launch per call, the plain version's numbers, the same
    bits again, and no further from the plain version in float64 than 3x the
    float32 plain version plus a floor of 2e-4 of the scale (3e-3 for t).
    Ragged sizes: no multiple of a block's 512 points, of the 1024-point
    tile or of a 64-term chunk; clustered clouds: near and exact ties."""
    x1, x2 = (t.to(cuda) for t in _emd_clouds(n * m, 2, n, m, kind))
    before = emd_pallas._KERNEL.launches
    got = emd_pallas.emd_rounds_kernel(x1, x2)
    again = emd_pallas.emd_rounds_kernel(x1, x2)
    torch.cuda.synchronize()
    assert emd_pallas._KERNEL.launches == before + 2
    _assert_same_bits(got, again)
    want = emd_pallas.reference_emd_rounds(x1, x2)
    _assert_emd_close(got, want)
    ref = emd_pallas.reference_emd_rounds(x1.double(), x2.double())
    for name, g, w, r in zip(("cost", "s_n", "t_n", "s_m", "t_m"), got, want, ref):
        scale = r.abs().max().item()
        floor = (3e-3 if name[0] == "t" else 2e-4) * scale
        assert (g.double() - r).abs().max() <= 3 * (w.double() - r).abs().max() + floor, name


@pytest.mark.gpu
def test_kernel_e_gradient_matches_plain(cuda):
    """The trainable streamed EMD through kernel E against the same Function
    on the plain version: the costs rtol 2e-4, both gradients within 5e-3 of
    their max (the moments' rounding, as JAX's fused-vs-streamed bound)."""
    from vn_pointcloudcompletion_tpu_torch.ops.emd import earth_mover_distance_blocked

    x1, x2 = (t.to(cuda) for t in _emd_clouds(7, 2, 1024, 1024))
    out = []
    for use_kernels in (True, False):
        a, b = x1.clone().requires_grad_(), x2.clone().requires_grad_()
        cost = earth_mover_distance_blocked(a, b, use_kernels)
        cost.sum().backward()
        out.append((cost.detach(), a.grad, b.grad))
    (ck, gak, gbk), (cp, gap, gbp) = out
    torch.testing.assert_close(ck, cp, rtol=2e-4, atol=0)
    _assert_rel((gak, gbk), (gap, gbp), 5e-3)


@pytest.mark.gpu
def test_cuda_dgcnn_classic_matches_plain_path(cuda):
    """The classic DGCNN (k 40) in eval mode on the card: K2 four times per
    forward, the plain path's coarse cloud within 1e-5 + 1e-4 relative."""
    from vn_pointcloudcompletion_tpu_torch.models.composer import init_weights_
    from vn_pointcloudcompletion_tpu_torch.models.dgcnn import DGCNN

    model = init_weights_(DGCNN(448), 0).to(cuda).eval()
    xyz = _cloud(4, 2, 2048).to(cuda)
    cuda_lib.reset_launch_counts()
    with torch.no_grad():
        coarse, fg = model(xyz)
        got = cuda_lib.launch_counts()
        model.use_kernels = False
        coarse_p, fg_p = model(xyz)
    assert {k: v for k, v in got.items() if v} == {"knn_min": 4}
    torch.testing.assert_close(coarse, coarse_p, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(fg, fg_p, atol=1e-5, rtol=1e-4)


# ------------------------------------------------------- bf16 modes, card


def _bf16_t(*arrays, device):
    return [None if a is None else torch.from_numpy(a).to(device, torch.bfloat16)
            for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("c,n", [(128, 2048), (1024, 2048), (16, 1000)])
def test_kernel_a_bf16_cuda_matches_plain(cuda, c, n):
    """bf16 planes: the kernel's bf16 mode, counted apart, equal to the
    plain version to the bit."""
    p, d, a, b = _bn_inputs(np.random.default_rng(c + 1), 2, c, n)
    (pt, dt), (at, bt) = _bf16_t(p, d, device=cuda), _t(a, b, device=cuda)
    kernel = cuda_lib.launch_counts
    before = kernel()
    got = port_fused.fused_bn_leaky(pt, dt, at, bt, NS)
    torch.cuda.synchronize()
    after = kernel()
    assert after["vn_bn_leaky_fwd[bf16]"] == before["vn_bn_leaky_fwd[bf16]"] + 1
    assert after["vn_bn_leaky_fwd"] == before["vn_bn_leaky_fwd"]
    want = port_fused.reference_bn_leaky_planes(pt, dt, at, bt, NS)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("c_in,c_out,n,group", [
    (2, 256, 16384, 0), (2, 16, 1000, 0), (1, 256, 14336, 64), (1, 32, 4096, 16),
])
def test_kernel_b_bf16_cuda_matches_plain(cuda, c_in, c_out, n, group):
    """bf16 x and biases (per sample, or per ``group`` points), float32
    weights: equal to the bit (C_in <= 2: the float32 sums of exact
    products cannot differ in order)."""
    rng = np.random.default_rng(c_out + n)
    x, w, wd, pb, db, a, b, _ = _layer_inputs(rng, 2, c_in, c_out, n, True)
    if group:
        pb = rng.standard_normal((2, 3, c_out, n // group)).astype(np.float32)
        db = rng.standard_normal((2, 3, c_out, n // group)).astype(np.float32)
    xt, pbt, dbt = _bf16_t(x, pb, db, device=cuda)
    wt, wdt, at, bt = _t(w, wd, a, b, device=cuda)
    name = "vn_layer_fused_fwd[group,bf16]" if group else "vn_layer_fused_fwd[bf16]"
    before = cuda_lib.launch_counts()[name]
    got = port_layer.vn_layer_fused(xt, wt, wdt, pbt, dbt, at, bt, NS, group)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()[name] == before + 1
    want = port_layer.reference_layer_fused(xt, wt, wdt, pbt, dbt, at, bt, NS, group)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("c_in,c_out,n", [(256, 256, 16384), (256, 128, 14336), (16, 16, 1000)])
def test_kernel_c_bf16_cuda_matches_plain(cuda, c_in, c_out, n):
    """All three widths take the wide design (C_in, C_out >= 16), whose p
    and d come from the tensor cores, summed in their order: a p or d at a
    bf16 rounding boundary rounds one ulp away from the plain version's at
    rare points, which moves the projected output of its point by up to
    several ulps of a small (cancelling) result.  So the output is held in
    root-mean-square, within chip_smoke.BF16_C_RMS of the plain version's
    norm, and not per element."""
    rng = np.random.default_rng(c_in + n + 1)
    x, w, wd, _, _, a, b, w_out = _layer_inputs(rng, 2, c_in, c_out, n, False)
    (xt,) = _bf16_t(x, device=cuda)
    wt, wdt, at, bt, wot = _t(w, wd, a, b, w_out, device=cuda)
    before = cuda_lib.launch_counts()["vn_layer_fused_project_fwd[bf16]"]
    got = port_layer.vn_layer_fused_project(xt, wt, wdt, None, None, at, bt, wot, NS)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["vn_layer_fused_project_fwd[bf16]"] == before + 1
    want = port_layer.reference_layer_fused_project(xt, wt, wdt, None, None, at, bt, wot, NS)
    from chip_smoke import BF16_C_RMS, bf16_rms, bf16_ulps  # run from the repo root

    assert port_layer.forward_design(c_in, c_out) == "wide"
    worst, differ = bf16_ulps(got, want)
    rms = bf16_rms(got, want)
    print(f"C bf16 ({c_in}, {c_out}, {n}): RMS {rms:.3e}; worst {worst} ulp, {differ} of "
          f"{got.numel()} differ")
    assert got.dtype == torch.bfloat16 and rms <= BF16_C_RMS


@pytest.mark.gpu
@pytest.mark.parametrize("n,dim,c3,k,x_bf16", [(512, 3, 768, 16, True), (2048, 3, 384, 16, True),
                                               (512, 96, 384, 16, True), (512, 3, 384, 16, False),
                                               (333, 0, 96, 32, True), (512, 192, 384, 16, True),
                                               (128, 192, 768, 16, True), (512, 0, 384, 16, True),
                                               (512, 96, 384, 16, False), (1024, 3, 64, 16, True)])
def test_kernel_k3_bf16_cuda_matches_plain(cuda, n, dim, c3, k, x_bf16):
    """bf16 features (and bf16 or float32 coordinates): equal indices and
    bits, twice, in the design ``edge_design`` picks (coords at D 3, N 512
    and 1024; tiled at vn_pointr's D 96 and 192; warp at N 2048 and N 333);
    dim = 0: the lane-tie cloud, rounded to bf16 (more ties)."""
    g = torch.Generator().manual_seed(n + c3 + 1)
    if dim == 0:
        x = _lane_tie_cloud(2, n).transpose(1, 2).contiguous()
    else:
        x = torch.randn(2, dim, n, generator=g)
    x = x.to(cuda, torch.bfloat16 if x_bf16 else torch.float32)
    u, v = (torch.randn(2, c3, n, generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    key = f"edge_knn_gather[bf16]/{knn_pallas.edge_design(n, x.shape[1], k, True)}"
    before = cuda_lib.launch_counts()["edge_knn_gather[bf16]"]
    before_design = cuda_lib.variant_counts().get(key, 0)
    got, again = knn_pallas.edge_knn_gather_fwd(x, u, v, k), knn_pallas.edge_knn_gather_fwd(x, u, v, k)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["edge_knn_gather[bf16]"] == before + 2
    assert cuda_lib.variant_counts()[key] == before_design + 2
    want = knn_pallas.reference_edge_knn_gather(x, u, v, k)
    assert got[0].dtype == torch.bfloat16
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.gpu
def test_bf16_reaches_no_float32_kernel(cuda):
    """A bf16 CUDA tensor given to a wrapper with no bf16 mode raises (D,
    K1, E, which take float32), and one with a bf16 mode never falls back
    to the float32 kernel: mixed types raise (bf16 activations with a
    float32 bias or cotangent, in the forwards and the backwards alike)."""
    rng = np.random.default_rng(3)
    x, w, wd, pb, db, a, b, w_out = _layer_inputs(rng, 2, 2, 16, 1024, True)
    xt, pbt, dbt = _bf16_t(x, pb, db, device=cuda)
    wt, wdt, at, bt, wot = _t(w, wd, a, b, w_out, device=cuda)
    g = torch.zeros(2, 3, 16, 1024, device=cuda)
    planes = g.to(torch.bfloat16) + 1  # (2, 3, 16, 1024) bf16
    pts = xt[:, :, 0].transpose(1, 2).contiguous()  # (2, 1024, 3) bf16
    before = cuda_lib.launch_counts()
    for call in (
        lambda: port_layer.stats_fwd(xt, wt, pbt.float()),
        lambda: port_layer.layer_bwd(xt, wt, wdt, pbt, dbt, at, bt, g, NS),
        lambda: port_layer.layer_project_bwd(xt, wt, wdt, pbt, dbt, at, bt, wot, g[:, :, :1], NS),
        lambda: port_layer.stats_bwd(xt, wt, pbt, at.to(torch.bfloat16), bt),
        lambda: port_fused.bn_leaky_bwd(planes, planes, at, bt, planes.float(), NS),
        lambda: port_chamfer.nn_bidirectional(pts, pts),
        lambda: knn_pallas.topk_min_fwd(xt[:, 0], 4),
        lambda: emd_pallas.emd_rounds_kernel(pts, pts),
        lambda: port_layer.vn_layer_fused(xt, wt, wdt, pbt.float(), dbt.float(), at, bt, NS),
        lambda: port_fused.fused_bn_leaky(planes, planes.float(), at, bt, NS),
        lambda: knn_pallas.edge_knn_gather_fwd(xt[:, 0], xt[:, 0], xt[:, 0].float(), 4),
    ):
        with pytest.raises(TypeError, match="takes"):
            call()
    assert cuda_lib.launch_counts() == before


# ------------------------------------------- bf16 backward modes, card
#
# The bf16 modes of A', S, S', B' and C' against their plain bf16 versions:
# the bf16 outputs (dp, dd of A'; dx; the bias gradients) within one bf16
# ulp of the output's largest magnitude (float32 sums taken in another
# order, then one rounding), A''s dp and dd equal to the bit (elementwise,
# in the plain version's order); the float32 outputs (dW, dA, dB, dw_out,
# the sums of S) within 1e-4 of their max, as the float32 modes; every
# kernel twice, for equal bits.


def _assert_bf16_bwd(got, want, rel=1e-4):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        scale = max(w.float().abs().max().item(), 2.0 ** -126)
        if w.dtype == torch.bfloat16:
            assert err <= 2.0 ** (np.floor(np.log2(scale)) - 7), (err, scale)
        else:
            assert err <= rel * scale, (err, scale)


def _bf16_layer_case(cuda, c_in, c_out, n, group, seed):
    """(x, w, wd, pbias, dbias, a, b, w_out) on the card: bf16 x and biases
    (per sample, or per ``group`` points), float32 parameters."""
    rng = np.random.default_rng(seed)
    x, w, wd, pb, db, a, b, w_out = _layer_inputs(rng, 2, c_in, c_out, n, True)
    if group:
        pb = rng.standard_normal((2, 3, c_out, n // group)).astype(np.float32)
        db = rng.standard_normal((2, 3, c_out, n // group)).astype(np.float32)
    xt, pbt, dbt = _bf16_t(x, pb, db, device=cuda)
    return (xt, *_t(w, wd, device=cuda), pbt, dbt, *_t(a, b, w_out, device=cuda)), rng


def _counts_of(name, run):
    """``run()``'s result and the launches it made under ``name``."""
    before = cuda_lib.launch_counts()
    out = run()
    torch.cuda.synchronize()
    after = cuda_lib.launch_counts()
    assert all(after[k] == before[k] for k in after if k != name), "another kernel launched"
    return out, after[name] - before[name]


@pytest.mark.gpu
@pytest.mark.parametrize("c,n", [(128, 2048), (1024, 2048), (16, 1000)])
def test_kernel_a_bwd_bf16_cuda_matches_plain(cuda, c, n):
    rng = np.random.default_rng(c + 3)
    p, d, a, b = _bn_inputs(rng, 2, c, n)
    g = rng.standard_normal(p.shape).astype(np.float32)
    (pt, dt, gt), (at, bt) = _bf16_t(p, d, g, device=cuda), _t(a, b, device=cuda)
    got, launched = _counts_of("vn_bn_leaky_bwd[bf16]",
                               lambda: port_fused.bn_leaky_bwd(pt, dt, at, bt, gt, NS))
    assert launched == 1
    want = port_fused.reference_bn_leaky_bwd(pt, dt, at, bt, gt, NS)
    for k in (0, 1):
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], want[k])
    _assert_rel(got[2:], want[2:], 1e-5)
    _assert_same_bits(got, port_fused.bn_leaky_bwd(pt, dt, at, bt, gt, NS))


# (C_in, C_out, N, group): the decoder's first fold layer, a 16-channel
# layer on a ragged tile, the pair folds (group 64, and 16 on a ragged
# tile), the fold's 256-channel layer
_BF16_BWD_SHAPES = [(2, 256, 4096, 0), (16, 16, 1000, 0), (1, 256, 4096, 64),
                    (1, 32, 1040, 16), (256, 256, 4100, 0)]


def _grouped(symbol, group):
    return f"{symbol}[group,bf16]" if group else f"{symbol}[bf16]"


@pytest.mark.gpu
@pytest.mark.parametrize("c_in,c_out,n,group", _BF16_BWD_SHAPES)
def test_kernel_s_bf16_cuda_matches_plain(cuda, c_in, c_out, n, group):
    (x, w, _, pb, _, *_), _ = _bf16_layer_case(cuda, c_in, c_out, n, group, n + 11)
    c1, c2 = (torch.randn(c_out, generator=torch.Generator().manual_seed(k)).to(cuda)
              for k in (1, 2))
    key = _variant("vn_layer_stats_fwd", group, True, port_layer.stats_design(c_in, c_out))
    v0 = cuda_lib.variant_counts().get(key, 0)
    got, launched = _counts_of(_grouped("vn_layer_stats_fwd", group),
                               lambda: port_layer.stats_fwd(x, w, pb, group))
    assert launched == 1 and cuda_lib.variant_counts().get(key, 0) == v0 + 1
    _assert_bf16_bwd(got, port_layer.reference_stats(x, w, pb, group), 1e-5)
    dgot, launched = _counts_of(_grouped("vn_layer_stats_bwd", group),
                                lambda: port_layer.stats_bwd(x, w, pb, c1, c2, group))
    assert launched == 1 and dgot[0].dtype == torch.bfloat16
    _assert_bf16_bwd(dgot, port_layer.reference_stats_bwd(x, w, pb, c1, c2, group))
    _assert_same_bits(got, port_layer.stats_fwd(x, w, pb, group))
    _assert_same_bits(dgot, port_layer.stats_bwd(x, w, pb, c1, c2, group))


@pytest.mark.gpu
@pytest.mark.parametrize("c_in,c_out,n,group,bias", [
    (16, 16, 1000, 0, False), (256, 256, 4100, 0, False), (256, 128, 1000, 0, False),
    (256, 128, 1000, 0, True), (256, 128, 1088, 64, True),
])
def test_kernel_s_bf16_wide_cuda_matches_plain(cuda, c_in, c_out, n, group, bias):
    """The wide bf16 S (p on the tensor cores) at widths without and with
    a bias (per sample, group 64), counted under its design, twice for
    equal bits, against its plain bf16 version within 1e-4 of the max
    (chip_smoke.py's bound for bf16 S): the tensor cores sum p in their own
    order, so a p at a bf16 rounding boundary rounds one ulp away from the
    plain version's at rare points, and at 2000 points a channel one such
    point moves s2 by ~1e-5 of its max (1.02e-5 at 256 -> 128, N 1000, no
    bias: NVIDIA H100 80GB HBM3, 700 W)."""
    (x, w, _, pb, _, *_), _ = _bf16_layer_case(cuda, c_in, c_out, n, group, n + 11)
    pb = pb if bias else None
    key = _variant("vn_layer_stats_fwd", group, True, "wide")
    v0 = cuda_lib.variant_counts().get(key, 0)
    got, launched = _counts_of(_grouped("vn_layer_stats_fwd", group),
                               lambda: port_layer.stats_fwd(x, w, pb, group))
    assert launched == 1 and cuda_lib.variant_counts().get(key, 0) == v0 + 1
    _assert_bf16_bwd(got, port_layer.reference_stats(x, w, pb, group), 1e-4)
    _assert_same_bits(got, port_layer.stats_fwd(x, w, pb, group))


@pytest.mark.gpu
@pytest.mark.parametrize("c_in,c_out,n,group,project", [
    *[(*shape, False) for shape in _BF16_BWD_SHAPES],
    *[(*shape, True) for shape in _BF16_BWD_SHAPES if not shape[3]],  # C': group 0 only
])
def test_kernel_b_c_bwd_bf16_cuda_matches_plain(cuda, c_in, c_out, n, group, project):
    (x, w, wd, pb, db, a, b, w_out), rng = _bf16_layer_case(
        cuda, c_in, c_out, n, group, c_in + c_out + n)
    g = torch.from_numpy(rng.standard_normal((2, 3, 1 if project else c_out, n)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    if project:
        symbol, fn = "vn_layer_fused_project_bwd", port_layer.layer_project_bwd
        plain, args = port_layer.reference_layer_project_bwd, (x, w, wd, pb, db, a, b, w_out, g)
    else:
        symbol, fn = "vn_layer_fused_bwd", port_layer.layer_bwd
        plain, args = port_layer.reference_layer_bwd, (x, w, wd, pb, db, a, b, g)
    got, launched = _counts_of(_grouped(symbol, group), lambda: fn(*args, NS, group))
    assert launched == 1 and got[0].dtype == got[3].dtype == torch.bfloat16
    _assert_bf16_bwd(got, plain(*args, NS, group))
    _assert_same_bits(got, fn(*args, NS, group))


# ------------------------------------------------ the wide passes of S', C'
#
# S' and C' at C_in, C_out >= 16 run the wide passes (cp.async rings; bf16
# products on the tensor cores), below that the narrow ones
# (port_layer.backward_design).  Ragged shapes: 48 -> 80 channels, N 1000
# (no multiple of a 64-point pass-1 tile, a 128-point pass-2 tile or a
# pass-3 stage) and 1088 for the bias groups, which must divide N; group 16
# splits each 64-point tile's bias sums, group 64 sums whole tiles.  Each
# against its plain version at chip_smoke.py phase 3's bounds (float32:
# 1e-4 of each output's max; bf16: one bf16 ulp of the max for bf16
# outputs, 1e-4 for the float32 ones), twice for equal bits, counted under
# its design.


def _wide_inputs(cuda, c_in, c_out, n, group, bias, bf16, seed):
    rng = np.random.default_rng(seed)
    x, w, wd, pb, db, a, b, w_out = _layer_inputs(rng, 2, c_in, c_out, n, bias)
    if group:
        pb, db = (rng.standard_normal((2, 3, c_out, n // group)).astype(np.float32)
                  for _ in range(2))
    c1, c2 = (rng.standard_normal(c_out).astype(np.float32) for _ in range(2))
    g1 = rng.standard_normal((2, 3, 1, n)).astype(np.float32)
    act = _bf16_t if bf16 else _t
    x, pb, db, g1 = act(x, pb, db, g1, device=cuda)
    return (x, *_t(w, wd, device=cuda), pb, db, *_t(a, b, w_out, c1, c2, device=cuda), g1)


def _wide_run(kernel, x, w, wd, pb, db, a, b, w_out, c1, c2, g1, group):
    """(launch, plain version, symbol) of S' or C' on these inputs."""
    if kernel == "S'":
        return (lambda: port_layer.stats_bwd(x, w, pb, c1, c2, group),
                lambda: port_layer.reference_stats_bwd(x, w, pb, c1, c2, group),
                "vn_layer_stats_bwd")
    args = (x, w, wd, pb, db, a, b, w_out, g1, NS, group)
    return (lambda: port_layer.layer_project_bwd(*args),
            lambda: port_layer.reference_layer_project_bwd(*args), "vn_layer_fused_project_bwd")


def _variant(symbol, group, bf16, design):
    mode = ("[group,bf16]" if bf16 else "[group]") if group else ("[bf16]" if bf16 else "")
    return f"{symbol}{mode}/{design}"


@pytest.mark.gpu
@pytest.mark.parametrize("group,n,bias", [(0, 1000, False), (0, 1000, True), (16, 1088, True),
                                          (64, 1088, True)])
@pytest.mark.parametrize("kernel", ["S'", "C'"])
@pytest.mark.parametrize("bf16", [False, True])
def test_wide_backward_cuda_matches_plain(cuda, group, n, bias, kernel, bf16):
    inputs = _wide_inputs(cuda, 48, 80, n, group, bias, bf16, n + group + 31)
    launch, plain, symbol = _wide_run(kernel, *inputs, group)
    key = _variant(symbol, group, bf16, "wide")
    before = cuda_lib.variant_counts().get(key, 0)
    got, again = launch(), launch()
    torch.cuda.synchronize()
    assert cuda_lib.variant_counts().get(key, 0) == before + 2
    (_assert_bf16_bwd if bf16 else _assert_rel)(got, plain())
    _assert_same_bits(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("c_in,design", [(2, "narrow"), (16, "wide")])
@pytest.mark.parametrize("kernel", ["S'", "C'"])
@pytest.mark.parametrize("bf16", [False, True])
def test_wide_backward_dispatch_boundary(cuda, c_in, design, kernel, bf16):
    """C_in 2 takes the narrow passes, 16 the wide ones; both against the
    plain version."""
    assert port_layer.backward_design(c_in, 64) == design
    inputs = _wide_inputs(cuda, c_in, 64, 1000, 0, True, bf16, c_in + 5)
    launch, plain, symbol = _wide_run(kernel, *inputs, 0)
    key = _variant(symbol, 0, bf16, design)
    before = cuda_lib.variant_counts().get(key, 0)
    got = launch()
    torch.cuda.synchronize()
    assert cuda_lib.variant_counts().get(key, 0) == before + 1
    (_assert_bf16_bwd if bf16 else _assert_rel)(got, plain())


# ------------------------------------------ the wide C and the fused B'
#
# C at C_in, C_out >= 16 runs the wide design (port_layer.forward_design:
# cp.async rings over W^T; FP32 FMAs in float32, the tensor cores in bf16;
# the channel blocks' projections summed by a second pass), and B' at C_in
# <= 2 one fused pass (port_layer.layer_bwd_design).  Ragged shapes: C_in 48
# (no multiple of a 16- or 32-channel stage), N 1000 (no multiple of a
# 64-point tile), 999 (odd: no 16-byte row, so no cp.async or vector
# load), and 1088 for the bias groups, which must divide N; C_out
# 80 for B' (no multiple of its 64-channel walk), 128 and 256 for C (the
# main paths' widths).  float32 C against its plain version as the narrow C
# (atol 1e-4 + rtol 1e-5); bf16 C within chip_smoke.BF16_C_RMS (the tensor
# cores sum p and d in their own order, so a p at a bf16 rounding boundary
# rounds one ulp away at rare points); B' at chip_smoke.py phase 3's bounds.
# Each twice, for equal bits, counted under its design.


@pytest.mark.gpu
@pytest.mark.parametrize("c_out,n,group", [(128, 1000, 0), (256, 1000, 0), (128, 1088, 64),
                                           (256, 1088, 16), (128, 999, 0)])
@pytest.mark.parametrize("bf16", [False, True])
def test_wide_forward_cuda_matches_plain(cuda, c_out, n, group, bf16):
    import chip_smoke  # run from the repo root

    inputs = _wide_inputs(cuda, 48, c_out, n, group, bool(group), bf16, c_out + n + group)
    x, w, wd, pb, db, a, b, w_out = inputs[:8]
    args = (x, w, wd, pb, db, a, b, w_out, NS, group)
    key = _variant("vn_layer_fused_project_fwd", group, bf16, "wide")
    before = cuda_lib.variant_counts().get(key, 0)
    got, again = (port_layer.vn_layer_fused_project(*args) for _ in range(2))
    torch.cuda.synchronize()
    assert cuda_lib.variant_counts().get(key, 0) == before + 2
    want = port_layer.reference_layer_fused_project(*args)
    assert got.dtype == want.dtype and got.shape == (2, 3, 1, n)
    if bf16:
        rms = chip_smoke.bf16_rms(got, want)
        print(f"C bf16 (48, {c_out}, {n}, group {group}): RMS {rms:.3e}, "
              f"{chip_smoke.bf16_ulps(got, want)}")
        assert rms <= chip_smoke.BF16_C_RMS, rms
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("c_in", [1, 2])
@pytest.mark.parametrize("group,n,bias", [(0, 1000, False), (0, 1000, True), (16, 1088, True),
                                          (64, 1088, True), (0, 999, True)])
@pytest.mark.parametrize("bf16", [False, True])
def test_fused_layer_bwd_cuda_matches_plain(cuda, c_in, group, n, bias, bf16):
    x, w, wd, pb, db, a, b, *_ = _wide_inputs(cuda, c_in, 80, n, group, bias, bf16,
                                               c_in + n + group)
    rng = np.random.default_rng(n + group + 5)
    g = torch.from_numpy(rng.standard_normal((2, 3, 80, n)).astype(np.float32)).to(
        cuda, torch.bfloat16 if bf16 else torch.float32)
    args = (x, w, wd, pb, db, a, b, g, NS, group)
    key = _variant("vn_layer_fused_bwd", group, bf16, "fused")
    before = cuda_lib.variant_counts().get(key, 0)
    got, again = port_layer.layer_bwd(*args), port_layer.layer_bwd(*args)
    torch.cuda.synchronize()
    assert cuda_lib.variant_counts().get(key, 0) == before + 2
    (_assert_bf16_bwd if bf16 else _assert_rel)(got, port_layer.reference_layer_bwd(*args))
    _assert_same_bits(got, again)
