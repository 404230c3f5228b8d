"""The port's approximate EMD and DCD against the JAX package on the CPU.

- the dense ``approx_match`` / ``earth_mover_distance`` against JAX and the
  numpy float64 oracle;
- the plain version of kernel E (the streamed ``_emd_blocked_impl``)
  against JAX's streamed path and its Pallas kernel in interpret mode, and
  against the float64 oracle no worse than JAX's streamed path (the bounds
  of ``tests/test_ops.py::TestEMDOracle``);
- the trainable ``earth_mover_distance_blocked``'s gradients against JAX's
  dense ones, ``emd_loss`` above 2048^2 pairs, ``calc_dcd`` and the
  ``emd``/``dcd`` coarse losses against JAX (values and gradients);
- the CLI: ``overfit`` with ``coarse_loss`` ``emd`` and ``dcd``, then
  ``--resume --emd test``, and the EMD column against JAX's metric step on
  the same weights.

Inputs come from numpy seeds; every comparison states its tolerance.  The
CUDA kernel itself is held against the plain version on the card (``gpu``
tests in ``tests/test_torch_port_kernels.py``, ``chip_smoke.py`` phase 3).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vn_pointcloudcompletion_tpu.metrics import losses as jax_losses
from vn_pointcloudcompletion_tpu.ops import emd as jax_emd
from vn_pointcloudcompletion_tpu.ops import emd_pallas as jax_emd_pallas
from vn_pointcloudcompletion_tpu.training import steps as jax_steps
from vn_pointcloudcompletion_tpu.utils.config import Config as JaxConfig
from vn_pointcloudcompletion_tpu_torch import __main__ as cli
from vn_pointcloudcompletion_tpu_torch.metrics import losses as port_losses
from vn_pointcloudcompletion_tpu_torch.metrics.metrics import emd_sum
from vn_pointcloudcompletion_tpu_torch.ops import emd as port_emd
from vn_pointcloudcompletion_tpu_torch.ops import emd_pallas as port_emd_pallas
from vn_pointcloudcompletion_tpu_torch.training import steps as port_steps
from vn_pointcloudcompletion_tpu_torch.utils.config import Config

torch.set_num_threads(2)

NAMES = ("cost", "s_n", "t_n", "s_m", "t_m")


def _clouds(seed, b, n, m, scale=0.3):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, n, 3)) * scale).astype(np.float32),
            (rng.standard_normal((b, m, 3)) * scale).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _oracle_moments(a, b):
    """The float64 oracle's (None, s_n, t_n, s_m, t_m) from its match."""
    match = port_emd.approx_match_reference(a, b)  # (B, M, N)
    an, bn = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (None, match.sum(1), np.einsum("bmn,bmd->bnd", match, bn), match.sum(2),
            np.einsum("bmn,bnd->bmd", match, an))


# ------------------------------------------------------------------ dense


@pytest.mark.parametrize("n,m", [(64, 64), (96, 32), (32, 96)])
def test_approx_match_and_cost_match_jax_and_oracle(n, m):
    """match within 5e-5 of JAX and of the oracle; the cost rtol 1e-4 (+ atol
    1e-6) against both, as ``TestEMDOracle`` holds JAX.  The level -4^7
    turns an ulp of d into ~1e-4 of a weight, and near ties of the annealing
    amplify that further: on some clouds JAX itself lies 5e-4 from the
    oracle.  These clouds are checked to have none (JAX within 5e-5)."""
    a, b = _clouds(125, 2, n, m)
    got = port_emd.approx_match(*_t(a, b)).numpy()
    assert got.shape == (2, m, n)
    want = port_emd.approx_match_reference(a, b)
    jax_match = np.asarray(jax_emd.approx_match(a, b))
    np.testing.assert_allclose(jax_match, want, atol=5e-5)
    np.testing.assert_allclose(got, jax_match, atol=5e-5)
    np.testing.assert_allclose(got, want, atol=5e-5)
    cost = port_emd.earth_mover_distance(*_t(a, b)).numpy()
    np.testing.assert_allclose(cost, np.asarray(jax_emd.earth_mover_distance(a, b)),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(cost, port_emd.earth_mover_distance_reference(a, b),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(emd_sum(*_t(a, b)).item(), cost.sum(), rtol=1e-6)


def test_oracle_is_jax_oracle():
    """The port's copy of the numpy oracle gives JAX's numbers."""
    a, b = _clouds(5, 1, 40, 20)
    np.testing.assert_array_equal(port_emd.approx_match_reference(a, b),
                                  jax_emd.approx_match_reference(a, b))


# --------------------------------------------- the plain version of kernel E


@pytest.mark.parametrize("n,m", [(64, 64), (100, 72), (256, 256)])
def test_streamed_matches_jax_streamed_and_pallas(n, m, monkeypatch):
    """Against JAX's streamed path (``VN_EMD_FUSED=0``) and its Pallas kernel
    in interpret mode: the cost within 2e-4 of its scale, the moments 1e-2
    (the level -4^7 amplifies float32 rounding of d on near ties); and each
    output's distance from the float64 oracle at most 3x JAX's streamed
    path's plus a floor of 2e-4 x scale (3e-3 for t), the bound
    ``TestEMDOracle`` holds the Pallas kernel to.  (The Pallas kernel's
    bf16-split ratio sums put its t moments up to 2e-2 from JAX's own
    streamed path on some clouds; on these, seed 3, within 4e-3.)"""
    monkeypatch.setenv("VN_EMD_FUSED", "0")
    a, b = _clouds(3, 2, n, m)
    streamed = jax_emd._emd_blocked_impl(jnp.asarray(a), jnp.asarray(b), 32)
    pallas = jax_emd_pallas.emd_rounds_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    got = port_emd._emd_blocked_impl(*_t(a, b))
    oracle = _oracle_moments(a, b)
    oracle = (port_emd.earth_mover_distance_reference(a, b),) + oracle[1:]
    for name, g, w, p, o in zip(NAMES, got, streamed, pallas, oracle):
        g, w, p = g.numpy(), np.asarray(w), np.asarray(p)
        assert g.shape == w.shape and g.dtype == np.float32, name
        scale = max(float(np.abs(w).max()), 1e-6)
        tol = 2e-4 if name == "cost" else 1e-2
        np.testing.assert_allclose(g, w, atol=tol * scale, err_msg=name)
        np.testing.assert_allclose(g, p, atol=tol * scale, err_msg=name)
        floor = (3e-3 if name[0] == "t" else 2e-4) * scale
        assert np.abs(g - o).max() <= 3.0 * np.abs(w - o).max() + floor, name


def test_streamed_keeps_float64():
    """The plain version keeps float64, and lies within 1e-9 of the oracle's
    cost there (the card's float64 reference)."""
    a, b = _clouds(7, 1, 48, 40)
    got = port_emd_pallas.reference_emd_rounds(*_t(a.astype(np.float64), b.astype(np.float64)))
    assert all(t.dtype == torch.float64 for t in got)
    np.testing.assert_allclose(got[0].numpy(), port_emd.earth_mover_distance_reference(a, b),
                               rtol=1e-9)
    for name, g, o in zip(NAMES[1:], got[1:], _oracle_moments(a, b)[1:]):
        np.testing.assert_allclose(g.numpy(), o, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("n,m,eligible", [(1024, 1024, True), (2048, 512, True),
                                          (1000, 1000, False), (16384, 16384, True),
                                          (16385, 128, False)])
def test_gate_matches_jax(n, m, eligible):
    assert port_emd_pallas.fused_eligible(n, m) == jax_emd_pallas.fused_eligible(n, m) \
        == eligible


@pytest.mark.parametrize("n,m", [(64, 64), (100, 72)])
def test_blocked_gradients_match_jax_dense(n, m):
    """The streamed form's gradients (from the moments) against JAX's dense
    match-constant gradients, both inputs, within 2e-4 of their scale."""
    a, b = _clouds(n - m, 2, n, m)
    want = jax.grad(lambda x, y: jax_emd.earth_mover_distance(x, y).sum(),
                    argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    x, y = (t.requires_grad_() for t in _t(a, b))
    port_emd.earth_mover_distance_blocked(x, y).sum().backward()
    for g, w in zip((x.grad, y.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4 * np.abs(w).max())


def test_emd_loss_takes_the_blocked_form_above_2048_squared(monkeypatch):
    """4096 vs 4096, batch 1: the streamed form (kernel E's plain version on
    the CPU), a finite loss and a nonzero finite gradient."""
    calls = []
    real = port_emd_pallas.emd_rounds_kernel
    monkeypatch.setattr(port_emd_pallas, "emd_rounds_kernel",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    a, b = _clouds(11, 1, 4096, 4096)
    x = torch.from_numpy(a).requires_grad_()
    loss = port_losses.emd_loss(x, torch.from_numpy(b))
    loss.backward()
    assert calls == [(1, 4096, 3)]
    assert torch.isfinite(loss) and torch.isfinite(x.grad).all() and x.grad.abs().max() > 0


# --------------------------------------------------------------- DCD, losses


def _repeated(seed, b, n, m):
    """Clouds whose prediction repeats points, so that several ground-truth
    points share a nearest neighbour and the counts exceed 1."""
    x, gt = _clouds(seed, b, n, m)
    x[:, n // 2:] = x[:, : n - n // 2]
    return x, gt


@pytest.mark.parametrize("alpha,n_lambda,non_reg", [(200, 0.5, False), (1000, 1, True)])
def test_calc_dcd_matches_jax(alpha, n_lambda, non_reg):
    """Values (loss, cd_p, cd_t) within rtol 1e-5 and the gradient within
    1e-4 of its max: the chamfer's distances differ by rounding (JAX's CPU
    path expands |x|^2 + |y|^2 - 2 x.y, the port takes the difference form),
    and alpha up to 1000 scales that in exp(-alpha d) (3e-5 at 1000); the
    nearest neighbours, and so the counts, are equal."""
    x, gt = _repeated(3, 2, 96, 160)
    jx = jnp.asarray(x)

    def jax_loss(p):
        loss, cd_p, cd_t = jax_losses.calc_dcd(p, jnp.asarray(gt), alpha, n_lambda,
                                               non_reg=non_reg)
        return loss.sum(), (loss, cd_p, cd_t)

    (_, want), jgrad = jax.value_and_grad(jax_loss, has_aux=True)(jx)
    px = torch.from_numpy(x).requires_grad_()
    got = port_losses.calc_dcd(px, torch.from_numpy(gt), alpha, n_lambda, non_reg=non_reg)
    got[0].sum().backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(px.grad.numpy(), jgrad, atol=1e-4 * np.abs(jgrad).max())
    idx1 = port_losses.calc_cd(torch.from_numpy(x), torch.from_numpy(gt), return_raw=True)[4]
    counts = port_losses._match_counts(idx1, 96)  # over the 160 ground-truth points
    assert counts.sum(1).tolist() == [160, 160] and counts.max() > 1


@pytest.mark.parametrize("loss", ["emd", "dcd"])
def test_coarse_loss_matches_jax(loss):
    """The coarse loss of a (2, 64, 3) coarse cloud against a 1024-point
    complete cloud, value and gradient, both sides in float32 (JAX's EMD
    computes in float32 even under x64): value rtol 1e-5, gradient within
    1e-4 of its max (EMD: the dense match's float32 sums in another order,
    amplified by the level -4^7)."""
    coarse, complete = _clouds(21, 2, 64, 1024)
    coarse[:, 32:] = coarse[:, :32]
    jcfg = JaxConfig(coarse_loss=loss)
    want, jgrad = jax.value_and_grad(
        lambda c: jax_steps._coarse_loss(jcfg, c, jnp.asarray(complete)))(jnp.asarray(coarse))
    pc = torch.from_numpy(coarse).requires_grad_()
    got = port_steps.coarse_loss(Config(coarse_loss=loss), pc, torch.from_numpy(complete))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(pc.grad.numpy(), jgrad, atol=1e-4 * np.abs(jgrad).max())


# ------------------------------------------------------------------- the CLI


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """The tiny CPU recipe: num_coarse 64 (dense 1024), 256 partial and 1024
    complete points, batch 2, synthetic data."""
    cfg = {
        "name": "t", "enc_type": "vn_pointnet", "dec_type": "vn_foldingnet",
        "num_coarse": 64, "latent_dim": 2048, "only_coarse": False,
        "batch_size": 2, "lr": 1e-4, "rotation": "z", "val_rotation": "so3",
        "test_rotation": "none", "dataset": "synthetic", "num_workers": 1,
        "synthetic_train_samples": 2, "synthetic_test_samples": 2,
        "synthetic_n_partial": 256, "synthetic_n_complete": 1024, "seed": 0,
        "log_frequency": 1,
    }
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "out"))
    return tmp_path


@pytest.mark.parametrize("loss", ["emd", "dcd"])
def test_cli_overfit_coarse_loss_then_emd_test(workdir, loss, capsys):
    c = json.loads((workdir / "config.json").read_text())
    c["coarse_loss"] = loss
    (workdir / "config.json").write_text(json.dumps(c))
    summary = cli.main(["-n", "t", "-epochs", "1", "--device", "cpu", "overfit"])
    assert summary["epochs_run"] == 2
    (run,) = os.listdir(workdir / "out")
    exp = workdir / "out" / run
    rows = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    coarse = [r["value"] for r in rows if r["tag"] == "Loss/Epoch/Coarse"]
    assert coarse and all(np.isfinite(v) and v > 0 for v in coarse)
    assert (exp / "models" / "model_last.pth").exists()
    summary = cli.main(["-n", run, "--resume", "-epochs", "2", "--device", "cpu", "train"])
    assert summary["epochs_run"] == 1
    capsys.readouterr()
    res = cli.main(["-n", run, "--resume", "--emd", "--device", "cpu", "test"])
    printed = capsys.readouterr().out
    assert "EMD(1e-3)" in printed
    assert set(res["synthetic"]) == {"l1", "l2", "f", "iou", "emd"}
    assert 0 < res["synthetic"]["emd"] < 1


def test_emd_column_matches_jax_metric_step():
    """The port's metric step with the EMD column against JAX's
    ``_make_metric_step(with_emd=True)`` on the same weights (a JAX
    ``PCNNet.init`` carried across) and the same batch, no rotation: every
    column within 2e-4 relative (the forward agrees within 1e-4 of its max;
    EMD 1024 vs 1024 takes the streamed form on both sides)."""
    from vn_pointcloudcompletion_tpu.models.composer import PCNNet as JaxPCNNet
    from vn_pointcloudcompletion_tpu.training import evaluate as jax_evaluate
    from vn_pointcloudcompletion_tpu.training.state import TrainState

    from vn_pointcloudcompletion_tpu_torch.data.synthetic import SyntheticCompletionDataset
    from vn_pointcloudcompletion_tpu_torch.models.composer import PCNNet
    from vn_pointcloudcompletion_tpu_torch.training.evaluate import metric_step
    from vn_pointcloudcompletion_tpu_torch.training.interop import (
        state_dict_from_jax_variables,
    )

    ds = SyntheticCompletionDataset(2, seed=4, n_partial=256, n_complete=1024)
    p = np.stack([ds[i][0] for i in range(2)])
    c = np.stack([ds[i][1] for i in range(2)])
    jm = JaxPCNNet(num_coarse=64, latent_dim=2048)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jnp.asarray(p), train=False))
    state = TrainState.create(apply_fn=jm.apply, params=v["params"], tx=optax.identity(),
                              batch_stats=v["batch_stats"])
    jcfg = JaxConfig(num_coarse=64, test_rotation="none")
    want, _ = jax_evaluate._make_metric_step(jcfg, with_emd=True)(
        state, jnp.asarray(p), jnp.asarray(c), jax.random.key(0))
    model = PCNNet(num_coarse=64)
    model.load_state_dict(state_dict_from_jax_variables(v))
    got, _ = metric_step(model.eval(), *_t(p, c), None, with_emd=True)
    assert set(got) == set(want)
    for k in ("l1", "l2", "emd"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-4, err_msg=k)
