"""The port's four kernels (A, B, C, D) against the JAX package.

On the CPU each wrapper takes its plain PyTorch version; those tests hold it
against the Pallas kernel in interpret mode (and the numpy chamfer oracle)
on the same numpy inputs.  Tests marked ``gpu`` launch the CUDA kernels and
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
        "vn_layer_fused_fwd": "vn_layer_fused.cu",
        "vn_layer_fused_project_fwd": "vn_layer_fused.cu",
        "chamfer_nn_one_sided": "chamfer_bidir.cu",
    }
    assert {s.name for s in cuda_lib.sources()} == set(names.values())
    for sym, src in names.items():
        assert f"VNK_EXPORT int {sym}(" in (cuda_lib.CSRC / src).read_text()


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
    assert counts == {"vn_bn_leaky_fwd": 2, "vn_layer_fused_fwd": 1,
                      "vn_layer_fused_project_fwd": 1, "chamfer_nn_one_sided": 0}
    assert fine.shape == (2, 4096, 3)
    torch.testing.assert_close(coarse, coarse_p, atol=0, rtol=0)
    torch.testing.assert_close(fine, fine_p, atol=1e-5, rtol=1e-4)
