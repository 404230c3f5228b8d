"""The port's training path against the JAX package on the CPU.

- the whole-layer training path (kernels S, S', B', C' through their plain
  versions) against JAX ``layer_fused=True`` in interpret mode;
- one flagship train step: losses, every parameter's gradient, the updated
  BatchNorm running statistics, and the losses of the first three optimiser
  steps, with the same weights (a JAX ``PCNNet.init`` carried across) and
  the same rotation on both sides;
- the non-finite guard, the StepLR schedule, clipping and Adam against
  optax, the checkpoint pair, and the ``overfit``/``train --resume`` CLI.

Inputs come from numpy seeds; every comparison states its tolerance.  A
train step through the kernels against the plain path on the card is in
``tests/test_torch_port_kernels.py`` (marked ``gpu``; that file imports no
JAX at module level, as the machine with the card has none).
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vn_pointcloudcompletion_tpu.metrics import losses as jax_losses
from vn_pointcloudcompletion_tpu.models.composer import PCNNet as JaxPCNNet
from vn_pointcloudcompletion_tpu.training import state as jax_state
from vn_pointcloudcompletion_tpu.training import steps as jax_steps
from vn_pointcloudcompletion_tpu.utils.config import Config as JaxConfig
from vn_pointcloudcompletion_tpu_torch import __main__ as cli
from vn_pointcloudcompletion_tpu_torch.models import pcn as port_pcn
from vn_pointcloudcompletion_tpu_torch.models.composer import PCNNet, build_model
from vn_pointcloudcompletion_tpu_torch.nn import vn as port_vn
from vn_pointcloudcompletion_tpu_torch.training import steps as port_steps
from vn_pointcloudcompletion_tpu_torch.training.checkpoint import (
    payload,
    restore_checkpoint,
    save_checkpoint,
    save_model,
)
from vn_pointcloudcompletion_tpu_torch.training.interop import state_dict_from_jax_variables
from vn_pointcloudcompletion_tpu_torch.training.state import (
    clip_by_global_norm,
    create_train_state,
    step_lr,
)
from vn_pointcloudcompletion_tpu_torch.utils.config import Config

torch.set_num_threads(2)

NUM_COARSE = 64  # dense 1024 points


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _randomize_bn(tree, rng):
    """Non-identity BatchNorm scale/bias and running statistics."""
    def walk(node):
        if not isinstance(node, dict):
            return np.array(node)
        out = {k: walk(v) for k, v in node.items()}
        if "BatchNorm_0" in out:
            bn = out["BatchNorm_0"]
            c = next(iter(bn.values())).shape[0]
            if "scale" in bn:
                bn["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                bn["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
            else:
                bn["mean"] = rng.uniform(0.0, 0.5, c).astype(np.float32)
                bn["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        return out

    return walk(tree)


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| in units of max |want|."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------ the whole-layer path


def _layer_bn(v):
    bn = v["params"]["batchnorm"]["BatchNorm_0"]
    st = v["batch_stats"]["batchnorm"]["BatchNorm_0"]
    return {
        "batchnorm.bn.weight": torch.from_numpy(bn["scale"]),
        "batchnorm.bn.bias": torch.from_numpy(bn["bias"]),
        "batchnorm.bn.running_mean": torch.from_numpy(st["mean"]),
        "batchnorm.bn.running_var": torch.from_numpy(st["var"]),
    }


# Tolerance of the layer tests: outputs and running statistics rtol 1e-5 +
# atol 1e-5; gradients 1e-4 of the tensor's largest entry (the BatchNorm
# variance E[n^2] - E[n]^2 amplifies the order of the f32 sums).


@pytest.mark.parametrize("project", [False, True])
def test_whole_layer_train_path_matches_jax(project):
    from vn_pointcloudcompletion_tpu.nn.vn import VNLinearLeakyReLU as JaxLayer

    rng = np.random.default_rng(31 + project)
    x = rng.standard_normal((2, 3, 8, 4096)).astype(np.float32)
    w_out = rng.uniform(-0.3, 0.3, (1, 16)).astype(np.float32)
    cot = rng.standard_normal((2, 3, 1 if project else 16, 4096)).astype(np.float32)
    jl = JaxLayer(16, layout="plane", layer_fused=True)
    v = _randomize_bn(_np_tree(jl.init(jax.random.key(3), jnp.asarray(x), train=False)), rng)

    def jax_loss(params, xx, wo):
        out, mut = jl.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                            train=True, project_out=wo if project else None,
                            mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut)

    (_, (j_out, j_mut)), j_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
            v["params"], jnp.asarray(x), jnp.asarray(w_out))

    layer = port_vn.VNLinearLeakyReLU(8, 16, layout="plane").train()
    layer.load_state_dict({"map_to_feat.weight": torch.from_numpy(v["params"]["kernel"]),
                           "map_to_dir.weight": torch.from_numpy(v["params"]["dir_kernel"]),
                           **_layer_bn(v)})
    xt = torch.from_numpy(x).requires_grad_()
    wo_t = torch.from_numpy(w_out).requires_grad_()
    out = layer(xt, project_out=wo_t if project else None)
    (out * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-5)
    st = j_mut["batch_stats"]["batchnorm"]["BatchNorm_0"]
    np.testing.assert_allclose(layer.batchnorm.bn.running_mean.numpy(), st["mean"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(layer.batchnorm.bn.running_var.numpy(), st["var"],
                               rtol=1e-5, atol=1e-5)
    jp = j_grads[0]
    pairs = [(layer.map_to_feat.weight.grad, jp["kernel"]),
             (layer.map_to_dir.weight.grad, jp["dir_kernel"]),
             (layer.batchnorm.bn.weight.grad, jp["batchnorm"]["BatchNorm_0"]["scale"]),
             (layer.batchnorm.bn.bias.grad, jp["batchnorm"]["BatchNorm_0"]["bias"]),
             (xt.grad, j_grads[1])]
    if project:
        pairs.append((wo_t.grad, j_grads[2]))
    for got, want in pairs:
        assert _rel_err(got.numpy(), np.asarray(want)) <= 1e-4


def test_split_fold_layer_train_path_matches_jax():
    from vn_pointcloudcompletion_tpu.models.pcn import _VNSplitFoldLayerFused

    rng = np.random.default_rng(41)
    glob = rng.standard_normal((2, 3, 32, 1)).astype(np.float32)
    seed = rng.standard_normal((2, 3, 1, 4096)).astype(np.float32)
    point = rng.standard_normal((2, 3, 1, 4096)).astype(np.float32)
    cot = rng.standard_normal((2, 3, 16, 4096)).astype(np.float32)
    jl = _VNSplitFoldLayerFused(16)
    args = tuple(map(jnp.asarray, (glob, seed, point)))
    v = _randomize_bn(_np_tree(jl.init(jax.random.key(4), *args, train=False)), rng)

    def jax_loss(params, g, s, p):
        out, mut = jl.apply({"params": params, "batch_stats": v["batch_stats"]}, g, s, p,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut)

    (_, (j_out, j_mut)), j_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 3), has_aux=True)(v["params"], *args)

    p = v["params"]
    layer = port_pcn._SplitFoldLayer(34, 16, layout="plane").train()
    layer.load_state_dict({
        "map_to_feat.weight": torch.from_numpy(np.concatenate(
            [p["kernel_global"], p["kernel_seed"], p["kernel_point"]], 1)),
        "map_to_dir.weight": torch.from_numpy(np.concatenate(
            [p["dir_kernel_global"], p["dir_kernel_seed"], p["dir_kernel_point"]], 1)),
        **_layer_bn(v)})
    gt, pt = (torch.from_numpy(a).requires_grad_() for a in (glob, point))
    out = layer(gt, torch.from_numpy(seed), pt)
    (out * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-5)
    st = j_mut["batch_stats"]["batchnorm"]["BatchNorm_0"]
    np.testing.assert_allclose(layer.batchnorm.bn.running_mean.numpy(), st["mean"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(layer.batchnorm.bn.running_var.numpy(), st["var"],
                               rtol=1e-5, atol=1e-5)
    jp = j_grads[0]
    pairs = [
        (layer.map_to_feat.weight.grad, np.concatenate(
            [jp["kernel_global"], jp["kernel_seed"], jp["kernel_point"]], 1)),
        (layer.map_to_dir.weight.grad, np.concatenate(
            [jp["dir_kernel_global"], jp["dir_kernel_seed"], jp["dir_kernel_point"]], 1)),
        (layer.batchnorm.bn.weight.grad, jp["batchnorm"]["BatchNorm_0"]["scale"]),
        (layer.batchnorm.bn.bias.grad, jp["batchnorm"]["BatchNorm_0"]["bias"]),
        (gt.grad, j_grads[1]), (pt.grad, j_grads[2])]
    for got, want in pairs:
        assert _rel_err(got.numpy(), np.asarray(want)) <= 1e-4


# ------------------------------------------------ one flagship train step


@pytest.fixture(scope="module")
def flagship():
    """A JAX flagship model's variables carried into the port, a batch
    (partial 256 points, complete 1024, batch 2) and an so3 rotation."""
    rng = np.random.default_rng(0)
    jm = JaxPCNNet(num_coarse=NUM_COARSE, latent_dim=2048)
    partial = (rng.standard_normal((2, 256, 3)) * 0.3).astype(np.float32)
    complete = (rng.standard_normal((2, 1024, 3)) * 0.3).astype(np.float32)
    v = jm.init(jax.random.key(0), jnp.asarray(partial), None, train=False)
    v = {k: _randomize_bn(_np_tree(dict(v[k])), rng) for k in v}
    q = rng.standard_normal(4)
    from vn_pointcloudcompletion_tpu.ops.rotations import quaternion_to_matrix

    r = np.asarray(quaternion_to_matrix(jnp.asarray(q / np.linalg.norm(q), jnp.float32)))
    return jm, v, partial, complete, np.repeat(r[None], 2, axis=0)


@contextlib.contextmanager
def _float64(flagship, monkeypatch):
    """The flagship case in float64 on both sides (JAX with x64 for the
    duration), as ``tests/test_torch_parity.py`` compares train-mode
    gradients: at random init the encoder's argmax pools see top-2 gaps of
    ~1e-10 relative (channels whose pool direction is nearly orthogonal to
    the features), which float32 rounding resolves differently in any two
    implementations.  The port's decoder takes the JAX folding seed (the two
    ``linspace`` round 1 ulp apart in float32), so that nothing but float64
    rounding separates the two sides.  Yields (JAX model, JAX variables,
    port model, partial, complete, rotation), all float64."""
    from vn_pointcloudcompletion_tpu.ops.grid import folding_grid_3d

    monkeypatch.setattr(port_pcn, "folding_grid_3d",
                        lambda g: torch.from_numpy(np.array(folding_grid_3d(g))))
    jm, v, partial, complete, rot = flagship
    model = PCNNet(num_coarse=NUM_COARSE)
    model.load_state_dict(state_dict_from_jax_variables(v), strict=True)
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    jax.config.update("jax_enable_x64", True)
    try:
        yield (jm, jax.tree.map(f64, v), model.double(), f64(partial), f64(complete),
               f64(rot))
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("rotated", [False, True])
def test_train_step_matches_jax(flagship, rotated, monkeypatch):
    """Step 0 of the port's ``train_step`` in float64 against the JAX
    forward and backward: losses rtol 1e-9; every gradient (the ``.grad``
    the step leaves) within 1e-7 of its tensor's max |g|; the updated
    running statistics rtol 1e-9."""
    with _float64(flagship, monkeypatch) as (jm, v, model, partial, complete, rot):
        rot = rot if rotated else None
        monkeypatch.setattr(port_steps, "sample_rotation",
                            lambda *a: None if rot is None else torch.from_numpy(rot))
        jp, jc = jnp.asarray(partial), jnp.asarray(complete)
        jr = None if rot is None else jnp.asarray(rot)
        if rot is not None:
            jp, jc = jax_steps.rotate_points(jp, jr), jax_steps.rotate_points(jc, jr)

        def jax_loss(params):
            (coarse, fine), mut = jm.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, jp, jr,
                train=True, mutable=["batch_stats"])
            l1, l2 = jax_losses.cd_loss_l1(coarse, jc), jax_losses.cd_loss_l1(fine, jc)
            return l1 + l2, (l1, l2, mut)

        (_, (j1, j2, mut)), j_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            v["params"])
        j_grads, mut = _np_tree(j_grads), _np_tree(mut)
        state = create_train_state(model, Config.from_dict({"num_coarse": NUM_COARSE}), 1)
        m = port_steps.train_step(state, torch.from_numpy(partial), torch.from_numpy(complete),
                                  torch.Generator().manual_seed(0))
        grads = {k: p.grad for k, p in model.named_parameters()}

    assert float(m["skipped"]) == 0.0
    np.testing.assert_allclose([float(m["coarse"]), float(m["dense"])],
                               [float(j1), float(j2)], rtol=1e-9)
    zero_stats = jax.tree.map(np.zeros_like, v["batch_stats"])
    want = state_dict_from_jax_variables({"params": j_grads, "batch_stats": zero_stats})
    assert set(grads) <= set(want) and len(grads) == 26
    for name, g in grads.items():
        if "maxpool" in name:  # the pools' direction maps feed only an argmax
            assert (g is None or not g.any()) and not want[name].any(), name
            continue
        assert _rel_err(g.numpy(), want[name].numpy()) <= 1e-7, name
    new_stats = state_dict_from_jax_variables({"params": v["params"],
                                               "batch_stats": mut["batch_stats"]})
    buffers = dict(model.named_buffers())
    assert len(buffers) == 8
    for name, b in buffers.items():
        np.testing.assert_allclose(b.numpy(), new_stats[name].numpy(), rtol=1e-9, atol=1e-12)


def test_first_three_steps_match_jax(flagship, monkeypatch):
    """Adam + StepLR + BatchNorm updates over three guarded steps under an
    so3 rotation (the same matrix on both sides), in float64: the losses of
    each step rtol 1e-4 (and the third at least 1e-2 away from the first),
    then the parameters and running statistics as the last lines state.  lr 1e-5: the first Adam steps move every weight
    by about lr whatever its gradient's size, and once that reaches the
    pools' top-2 gaps the two sides pick other points (at lr 1e-4 the
    losses part from the third step on; the chaos of
    ``tests/test_trajectory_parity.py``)."""
    with _float64(flagship, monkeypatch) as (jm, v, model, partial, complete, rot):
        monkeypatch.setattr(jax_steps, "sample_rotation", lambda *a: jnp.asarray(rot))
        monkeypatch.setattr(port_steps, "sample_rotation", lambda *a: torch.from_numpy(rot))
        jcfg = JaxConfig(num_coarse=NUM_COARSE, latent_dim=2048, lr=1e-5, rotation="so3")
        state = jax_state.create_train_state(jm, jcfg, 10, jax.random.key(1),
                                             jnp.asarray(partial))
        state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
        step = jax_steps.make_train_step(jcfg)
        pstate = create_train_state(model, Config.from_dict(
            {"num_coarse": NUM_COARSE, "lr": 1e-5, "rotation": "so3"}), 10)
        gen = torch.Generator().manual_seed(0)
        losses = []
        for k in range(3):
            state, jm_ = step(state, jnp.asarray(partial), jnp.asarray(complete),
                              jax.random.key(k))
            pm = port_steps.train_step(pstate, torch.from_numpy(partial),
                                       torch.from_numpy(complete), gen)
            losses.append(({key: float(pm[key]) for key in pm},
                           {key: float(jm_[key]) for key in jm_}))
        jax_step = int(state.step)
        want = state_dict_from_jax_variables(_np_tree(
            {"params": state.params, "batch_stats": state.batch_stats}))
    for k, (got, want_k) in enumerate(losses):
        assert got["skipped"] == 0.0 and want_k["skipped"] == 0.0
        for key in ("coarse", "dense", "total"):
            np.testing.assert_allclose(got[key], want_k[key], rtol=1e-4,
                                       err_msg=f"step {k} {key}")
    assert pstate.step == 3 and jax_step == 3
    for side in (0, 1):  # the steps move the loss far beyond the tolerance
        first, last = losses[0][side]["total"], losses[2][side]["total"]
        assert abs(last - first) >= 1e-2 * first, (side, first, last)
    # Where the three updates took each tensor, in units of its largest
    # change on the JAX side: parameters within 5e-2 (measured 2.4e-2: Adam
    # divides gradients far below its eps of 1e-8 by about eps, which turns
    # their float64 differences into visible ones), running statistics
    # within 1e-6 (measured 1.2e-7).
    start = state_dict_from_jax_variables(v)
    for name, t in model.state_dict().items():
        moved = np.abs(want[name].numpy() - start[name].numpy()).max()
        if "maxpool" in name:
            assert moved == 0.0 and torch.equal(t, start[name].double()), name
            continue
        tol = 1e-6 if "running" in name else 5e-2
        assert moved > 0.0 and np.abs(t.numpy() - want[name].numpy()).max() <= tol * moved, name


# ------------------------------------------------ guard, schedule, optimiser


def _tiny_state(lr=1e-3, **extra):
    cfg = Config.from_dict({"num_coarse": NUM_COARSE, "lr": lr, "seed": 5, **extra})
    return create_train_state(build_model(cfg), cfg, 4)


def _clouds(seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy((rng.standard_normal((2, 256, 3)) * 0.3).astype(np.float32)),
            torch.from_numpy((rng.standard_normal((2, 1024, 3)) * 0.3).astype(np.float32)))


def test_non_finite_step_changes_nothing():
    state = _tiny_state()
    gen = torch.Generator().manual_seed(0)
    partial, complete = _clouds(1)
    assert float(port_steps.train_step(state, partial, complete, gen)["skipped"]) == 0.0
    before = {k: t.clone() for k, t in state.model.state_dict().items()}
    opt_before = {i: {k: t.clone() if torch.is_tensor(t) else t for k, t in s.items()}
                  for i, s in state.optimizer.state_dict()["state"].items()}
    bad = partial.clone()
    bad[0, 0, 0] = float("nan")
    m = port_steps.train_step(state, bad, complete, gen)
    assert float(m["skipped"]) == 1.0
    assert state.step == 1
    for k, t in state.model.state_dict().items():
        assert torch.equal(t, before[k]), k
    for i, s in state.optimizer.state_dict()["state"].items():
        for k, t in s.items():
            assert torch.equal(torch.as_tensor(t), torch.as_tensor(opt_before[i][k])), (i, k)


def test_step_lr_matches_optax_schedule():
    sched = jax_state.step_lr_schedule(1e-3, 7)
    for count in (0, 1, 349, 350, 699, 700, 3500):
        assert step_lr(1e-3, count, 7) == pytest.approx(float(sched(count)), rel=1e-6)
    assert step_lr(1e-3, 50 * 7, 7) == pytest.approx(0.8e-3)
    state = _tiny_state()
    state.step = 50 * 4  # 50 epochs of 4 steps
    partial, complete = _clouds(2)
    port_steps.train_step(state, partial, complete, torch.Generator())
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(0.8e-3)


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clipping_matches_optax(max_norm):
    import optax

    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((4, 5), (7,), (2, 3, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm(got, max_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_adam_matches_optax():
    """torch.optim.Adam under the port's schedule against optax.adam: four
    updates, rtol 1e-5 (the two round the bias correction differently)."""
    import optax

    rng = np.random.default_rng(4)
    p0 = rng.standard_normal(6).astype(np.float32)
    grads = [rng.standard_normal(6).astype(np.float32) for _ in range(4)]
    tx = optax.adam(jax_state.step_lr_schedule(1e-2, 1), b1=0.9, b2=0.999)
    jp, opt = jnp.asarray(p0), None
    opt = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    model = torch.nn.Module()
    model.w = param
    from vn_pointcloudcompletion_tpu_torch.training.state import TrainState

    state = TrainState(model, torch.optim.Adam([param], lr=1e-2, betas=(0.9, 0.999), eps=1e-8),
                       Config.from_dict({"lr": 1e-2}), steps_per_epoch=1)
    for g in grads:
        upd, opt = tx.update(jnp.asarray(g), opt, jp)
        jp = optax.apply_updates(jp, upd)
        param.grad = torch.from_numpy(g.copy())
        state.apply_gradients()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), rtol=1e-5)


# ------------------------------------------------ checkpoints and CLI


def test_checkpoint_pair_round_trip_and_mismatch(tmp_path):
    state = _tiny_state()
    partial, complete = _clouds(3)
    port_steps.train_step(state, partial, complete, torch.Generator())
    save_checkpoint(str(tmp_path), payload(state), 4, 0.25, 3, "last")
    other = _tiny_state()
    restored, epoch, best, best_epoch = restore_checkpoint(str(tmp_path), other, "last")
    assert (epoch, best, best_epoch, restored.step) == (4, 0.25, 3, 1)
    for k, t in state.model.state_dict().items():
        assert torch.equal(t, other.model.state_dict()[k]), k
    a, b = state.optimizer.state_dict(), other.optimizer.state_dict()
    for i in a["state"]:
        for k in a["state"][i]:
            assert torch.equal(torch.as_tensor(a["state"][i][k]),
                               torch.as_tensor(b["state"][i][k]))
    assert restore_checkpoint(str(tmp_path), other, "best") is None
    save_model(str(tmp_path), _tiny_state().model, "last")  # a crash between renames
    with pytest.raises(RuntimeError, match="mismatch"):
        restore_checkpoint(str(tmp_path), other, "last")


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    cfg = {
        "name": "t", "enc_type": "vn_pointnet", "dec_type": "vn_foldingnet",
        "num_coarse": NUM_COARSE, "latent_dim": 2048, "only_coarse": False,
        "batch_size": 2, "lr": 1e-4, "rotation": "z", "val_rotation": "so3",
        "dataset": "shapenet", "num_workers": 1, "synthetic_n_partial": 256,
        "synthetic_n_complete": 1024, "seed": 0, "log_frequency": 1,
    }
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "out"))
    return tmp_path


def test_cli_overfit_then_resume(workdir):
    summary = cli.main(["-n", "t", "-epochs", "1", "--device", "cpu", "overfit"])
    assert summary["epochs_run"] == 2  # epochs 0 and 1, as the JAX trainer counts
    (run,) = os.listdir(workdir / "out")
    exp = workdir / "out" / run
    for f in ("models/model_best.pth", "models/model_last.pth",
              "optimizer/optim_best.pth", "optimizer/optim_last.pth",
              "metrics.jsonl", "overfit.log", "config.json"):
        assert (exp / f).exists(), f
    stored = json.loads((exp / "config.json").read_text())
    assert stored["dataset"] == "synthetic" and stored["synthetic_train_samples"] == 2
    log = (exp / "overfit.log").read_text()
    assert "Training Epoch [001/001]: Coarse = " in log
    assert "Validate Epoch [001/001]: Coarse = " in log
    rows = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    assert {r["tag"] for r in rows} >= {"Loss/Batch/Total", "Loss/Epoch/Total"}
    assert all(np.isfinite(r["value"]) for r in rows)

    summary = cli.main(["-n", run, "--resume", "-epochs", "2", "--device", "cpu", "train"])
    assert summary["epochs_run"] == 1
    log = (exp / "train.log").read_text()
    assert "[RESUME INFO] resume ckpts @ 1 epoch" in log
    assert "Training Epoch [002/002]" in log and "Training Epoch [000" not in log
    meta = torch.load(exp / "optimizer" / "optim_last.pth", weights_only=True)
    assert meta["epoch"] == 2 and meta["step"] == 3


def test_trained_checkpoint_loads_into_jax_encoder(workdir):
    from vn_pointcloudcompletion_tpu.training import torch_interop

    cli.main(["-n", "t", "-epochs", "0", "--device", "cpu", "overfit"])
    (run,) = os.listdir(workdir / "out")
    path = workdir / "out" / run / "models" / "model_last.pth"
    sd = torch_interop.load_torch_state_dict(str(path))
    enc_p, enc_s = torch_interop.encoder_variables_from_torch(sd, "vn_pointnet")
    ours = torch.load(path, weights_only=True)
    np.testing.assert_array_equal(enc_p["trunk"]["second_conv_0"]["kernel"],
                                  ours["encoder.second_conv.0.map_to_feat.weight"].numpy())
    np.testing.assert_array_equal(
        enc_s["trunk"]["first_conv_0"]["batchnorm"]["BatchNorm_0"]["var"],
        ours["encoder.first_conv.0.batchnorm.bn.running_var"].numpy())
    # one train step moved the running variance off its init
    assert not np.allclose(ours["encoder.first_conv.0.batchnorm.bn.running_var"].numpy(), 1.0)


@pytest.mark.parametrize("cfg,match", [
    ({"dtype": "bfloat16", "remat": True}, "item 7"), ({"remat": True}, "item 7"),
    ({"enc_pretrained": "enc.pth"}, "item 7"),
])
def test_unported_training_options_raise(workdir, cfg, match):
    c = json.loads((workdir / "config.json").read_text())
    c.update(cfg)
    (workdir / "config.json").write_text(json.dumps(c))
    with pytest.raises(NotImplementedError, match=match):
        cli.main(["-epochs", "0", "--device", "cpu", "overfit"])
    with pytest.raises(NotImplementedError, match="item 6"):
        cli.main(["--mesh", "2", "--device", "cpu", "train"])
