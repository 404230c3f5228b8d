"""The standalone models of the port, ``PCN``, ``VNPCN`` and the classic
``DGCNN`` with its ``TransformNet``, against the JAX package on the CPU.

Weights come from a JAX ``init`` (every norm layer given a non-identity
scale, bias and running statistics) carried across with
``state_dict_from_jax_variables`` and loaded strictly; inputs from numpy
seeds.  Eval mode, in float32 within 1e-4 of each output's max (the two
sides sum the products in another order) and in float64 (JAX with x64)
within 1e-8.  The sizes are those of ``tests/test_models.py``.  The DGCNN's
clouds have a gap between the k-th and (k+1)-th neighbour distances far
above float32 rounding (``_assert_knn_gap``), so both sides pick the same
neighbours (in float64 JAX's kNN is made to select in float64 too); the VN
pools' seeds have no top-2 gap below rounding.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vn_pointcloudcompletion_tpu.models import DGCNN as JaxDGCNN
from vn_pointcloudcompletion_tpu.models import PCN as JaxPCN
from vn_pointcloudcompletion_tpu.models import VNPCN as JaxVNPCN
from vn_pointcloudcompletion_tpu.ops import grid as jax_grid
from vn_pointcloudcompletion_tpu_torch.models import pcn as port_pcn
from vn_pointcloudcompletion_tpu_torch.models.composer import init_weights_
from vn_pointcloudcompletion_tpu_torch.models.dgcnn import DGCNN, TransformNet
from vn_pointcloudcompletion_tpu_torch.models.pcn import PCN, VNPCN
from vn_pointcloudcompletion_tpu_torch.training.interop import state_dict_from_jax_variables

torch.set_num_threads(2)


def _randomize_norms(tree, rng):
    """Non-identity scale/bias of every norm layer and non-trivial running
    statistics."""
    def walk(node):
        if not isinstance(node, dict):
            return np.array(node)
        out = {k: walk(v) for k, v in node.items()}
        if {"scale", "bias"} <= set(out) and "kernel" not in out:
            c = out["scale"].shape[0]
            out["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            out["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
        if {"mean", "var"} <= set(out):
            c = out["mean"].shape[0]
            out["mean"] = rng.uniform(0.0, 0.5, c).astype(np.float32)
            out["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        return out

    return walk(tree)


def _assert_knn_gap(pts, k, rel=1e-5):
    """pts (B, N, D): every point's k-th and (k+1)-th squared neighbour
    distances (float64) differ by more than ``rel`` of the larger."""
    p = np.asarray(pts, np.float64)
    d = np.sort(((p[:, :, None] - p[:, None]) ** 2).sum(-1), -1)
    gap = (d[..., k] - d[..., k - 1]) / d[..., k]
    assert gap.min() > rel, gap.min()


def _carry(jax_model, port_model, xyz, seed):
    """Init the JAX model, randomise its norms, load the port model."""
    v = jax_model.init(jax.random.key(seed), jnp.asarray(xyz), train=False)
    v = {k: _randomize_norms(jax.tree.map(np.asarray, dict(v[k])), np.random.default_rng(seed))
         for k in v}
    port_model.load_state_dict(state_dict_from_jax_variables(v), strict=True)
    return v


def _compare(jax_model, v, port_model, xyz, dtype, monkeypatch):
    """Outputs of both sides in ``dtype`` (float64: JAX with x64), each
    within 1e-4 (float32) or 1e-8 (float64) of its max."""
    f = lambda t: jax.tree.map(lambda a: np.asarray(a, dtype), t)  # noqa: E731
    monkeypatch.setattr(port_pcn, "folding_grid_2d", lambda g: torch.from_numpy(
        np.array(jax_grid.folding_grid_2d(g))))
    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)
    try:
        want = jax.jit(lambda vv, x: jax_model.apply(vv, x, train=False))(f(v), f(xyz))
    finally:
        jax.config.update("jax_enable_x64", False)
    model = port_model.to(torch.float64 if dtype == np.float64 else torch.float32).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(f(xyz)))
    rel = 1e-8 if dtype == np.float64 else 1e-4
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == (torch.float64 if dtype == np.float64
                                                  else torch.float32)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=rel * np.abs(w).max())
    return got


def _cloud(seed, b, n, scale=0.3):
    return (np.random.default_rng(seed).standard_normal((b, n, 3)) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("only_coarse", [False, True])
def test_pcn_matches_jax(only_coarse, dtype, monkeypatch):
    xyz = _cloud(1, 2, 128)
    jm = JaxPCN(num_dense=256, latent_dim=64, grid_size=4, only_coarse=only_coarse)
    model = PCN(num_dense=256, latent_dim=64, grid_size=4, only_coarse=only_coarse)
    v = _carry(jm, model, xyz, 0)
    coarse, fine = _compare(jm, v, model, xyz, dtype, monkeypatch)
    assert coarse.shape == (2, 16, 3)
    assert (fine is None) == only_coarse and (only_coarse or fine.shape == (2, 256, 3))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_vnpcn_matches_jax(dtype, monkeypatch):
    """Coarse only, 1024 points and the (B, 2L, 3, 1) global feature; the
    dense path raises on both sides."""
    xyz = _cloud(2, 2, 64)
    jm = JaxVNPCN(latent_dim=8)
    model = VNPCN(latent_dim=8)
    v = _carry(jm, model, xyz, 1)
    coarse, fg = _compare(jm, v, model, xyz, dtype, monkeypatch)
    assert coarse.shape == (2, 1024, 3) and fg.shape == (2, 16, 3, 1)
    with pytest.raises(NotImplementedError):
        JaxVNPCN(only_coarse=False).init(jax.random.key(0), jnp.asarray(xyz))
    with pytest.raises(NotImplementedError):
        VNPCN(only_coarse=False)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [8, 40])
def test_dgcnn_matches_jax(k, dtype, monkeypatch):
    """The classic DGCNN at 128 points, k 8 (``tests/test_models.py``'s
    size) and k 40 (its default): coarse and the global feature."""
    xyz = _cloud(30 + k, 2, 128)
    _assert_knn_gap(xyz, k)
    if dtype == np.float64:
        # JAX's kNN takes its distances in float32 whatever the input; in
        # float64 the feature-space graphs then see near ties that the two
        # sides round apart, so JAX's selection is run in float64 here
        jax_knn = importlib.import_module("vn_pointcloudcompletion_tpu.ops.knn")
        monkeypatch.setattr(jax_knn, "pairwise_sqdist", lambda q, r: (
            jnp.sum(q * q, -1)[:, :, None] + jnp.sum(r * r, -1)[:, None, :]
            - 2.0 * jnp.einsum("bnd,bmd->bnm", q, r, precision=jax.lax.Precision.HIGHEST)))
    jm = JaxDGCNN(num_coarse=16, n_knn=k)
    model = DGCNN(num_coarse=16, n_knn=k)
    v = _carry(jm, model, xyz, 2)
    coarse, fg = _compare(jm, v, model, xyz, dtype, monkeypatch)
    assert coarse.shape == (2, 16, 3) and fg.shape == (2, 1024)


def test_transform_net_starts_at_identity():
    """Identity at initialisation, as the JAX module's zero kernel and eye
    bias, also after the port's seeded redraw of every linear map."""
    net = init_weights_(TransformNet(), 0).eval()
    x = torch.randn(2, 6, 32, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        t = net(x)
    assert torch.equal(t, torch.eye(3).expand(2, 3, 3))
