"""The port's kernels (A, A', S, S', B, B', C, C', D) against the JAX package.

On the CPU each wrapper takes its plain PyTorch version; those tests hold it
against the Pallas kernel in interpret mode (and the numpy chamfer oracle)
on the same numpy inputs, and check each ``autograd.Function`` with
``torch.autograd.gradcheck`` in float64.  Tests marked ``gpu`` launch the CUDA kernels and
hold them against the plain versions on the card; they skip where
``torch.cuda.is_available()`` is false.  JAX is imported inside the tests,
so the ``gpu`` tests also run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_kernels.py
"""

import numpy as np
import pytest
import torch

from vn_pointcloudcompletion_tpu_torch.ops import chamfer_pallas_bidir as port_chamfer
from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
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
    assert port_fused.eligible(torch.from_numpy(p))
    q = p * (a[None, None, :, None] + b[None, None, :, None]
             / (np.sqrt((p * p).sum(1, keepdims=True)) + 1e-6))
    assert ((q * d).sum(1) < 0).mean() > 0.3  # the reflection branch is taken
    pallas = np.asarray(jax_fused.fused_bn_leaky(
        *map(jnp.asarray, (p, d, a, b)), NS, True))
    ref = np.asarray(jax_fused.reference_bn_leaky_planes(
        *map(jnp.asarray, (p, d, a, b)), NS))
    np.testing.assert_allclose(got, pallas, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert np.all(got[:, :, : c // 4, :7] == 0.0)


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


def test_launch_check_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lib.check_cuda_f32("x", torch.zeros(1, 3, 16, 512))


def test_kernel_entry_points_exist_in_their_sources():
    names = {k.symbol: k.source for k in cuda_lib.KERNELS}
    assert names == {
        "vn_bn_leaky_fwd": "vn_fused.cu",
        "vn_bn_leaky_bwd": "vn_fused.cu",
        "vn_layer_fused_fwd": "vn_layer_fused.cu",
        "vn_layer_fused_project_fwd": "vn_layer_fused.cu",
        "vn_layer_stats_fwd": "vn_layer_bwd.cu",
        "vn_layer_stats_bwd": "vn_layer_bwd.cu",
        "vn_layer_fused_bwd": "vn_layer_bwd.cu",
        "vn_layer_fused_project_bwd": "vn_layer_bwd.cu",
        "chamfer_nn_one_sided": "chamfer_bidir.cu",
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


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(300, 700), (2048, 1500), (1, 5)])
def test_kernel_d_cuda_matches_plain(cuda, n, m):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((2, n, 3)) * 0.3).astype(np.float32)
    y = (rng.standard_normal((2, m, 3)) * 0.3).astype(np.float32)
    y[:, m // 2] = y[:, 0]  # an exact duplicate: its tie goes to index 0
    xt, yt = _t(x, y, device=cuda)
    got = port_chamfer.nn_bidirectional(xt, yt)
    torch.cuda.synchronize()
    want = port_chamfer.nn_bidirectional_reference(xt, yt)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


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


@pytest.mark.gpu
@pytest.mark.parametrize("c_in,c_out,n,bias", _LAYER_SHAPES)
def test_kernel_s_cuda_matches_plain(cuda, c_in, c_out, n, bias):
    rng = np.random.default_rng(c_out + n + 7)
    x, w, _, pb, _, _, _, _ = _t(*_layer_inputs(rng, 2, c_in, c_out, n, bias), device=cuda)
    c1, c2 = (torch.randn(c_out, generator=torch.Generator().manual_seed(k)).to(cuda)
              for k in (1, 2))
    s0, b0 = port_layer._STATS.launches, port_layer._STATS_BWD.launches
    got, again = port_layer.stats_fwd(x, w, pb), port_layer.stats_fwd(x, w, pb)
    dgot = port_layer.stats_bwd(x, w, pb, c1, c2)
    dagain = port_layer.stats_bwd(x, w, pb, c1, c2)
    torch.cuda.synchronize()
    assert port_layer._STATS.launches == s0 + 2
    assert port_layer._STATS_BWD.launches == b0 + 2
    _assert_rel(got, port_layer.reference_stats(x, w, pb), 1e-5)
    _assert_rel(dgot, port_layer.reference_stats_bwd(x, w, pb, c1, c2))
    _assert_same_bits(got, again)
    _assert_same_bits(dgot, dagain)


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
    assert all(v > 0 for v in counts.values()), counts
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
