"""The training options of the port's trainer against the JAX package on the
CPU: ``remat``, a pretrained encoder (``enc_pretrained`` / ``--ckpt_path``),
branching a run with ``-from``, and ``utils/profiling.py``.

- a remat step against the plain step of the port (equal bits: losses,
  gradients, parameters after the update, BatchNorm running statistics;
  float32 and under the bf16 policy), and against JAX's
  ``make_train_step`` with ``remat`` in float64;
- ``load_pretrained_encoder`` on a ``.pth`` for each of the four encoders
  against JAX's ``load_pretrained_encoder`` on the same file, and a
  flagship step with the frozen encoder against JAX's;
- ``-from`` and ``--ckpt_path`` end to end through the port's CLI;
- ``StepTimer``, ``device_memory_stats``, ``log_compile_time``, ``trace``
  and the parameter counts against JAX's.

Inputs come from numpy seeds; every comparison states its tolerance.  A
remat step through the kernels on the card is in
``tests/test_torch_port_kernels.py`` (marked ``gpu``).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_port_train import (  # noqa: F401  (flagship: a fixture)
    NUM_COARSE,
    _float64,
    _np_tree,
    _randomize_bn,
    _rel_err,
    flagship,
)
from vn_pointcloudcompletion_tpu.models.composer import PCNNet as JaxPCNNet
from vn_pointcloudcompletion_tpu.training import checkpoint as jax_ckpt
from vn_pointcloudcompletion_tpu.training import state as jax_state
from vn_pointcloudcompletion_tpu.training import steps as jax_steps
from vn_pointcloudcompletion_tpu.utils.config import Config as JaxConfig
from vn_pointcloudcompletion_tpu_torch import __main__ as cli
from vn_pointcloudcompletion_tpu_torch.models.composer import PCNNet, build_model
from vn_pointcloudcompletion_tpu_torch.nn.precision import compute_dtype_scope
from vn_pointcloudcompletion_tpu_torch.training import steps as port_steps
from vn_pointcloudcompletion_tpu_torch.training.checkpoint import load_pretrained_encoder
from vn_pointcloudcompletion_tpu_torch.training.interop import state_dict_from_jax_variables
from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state
from vn_pointcloudcompletion_tpu_torch.utils import profiling
from vn_pointcloudcompletion_tpu_torch.utils.config import Config
from vn_pointcloudcompletion_tpu_torch.utils.experiments import get_num_params


def _count_forwards(model):
    """A list that grows by one at each call of ``model``'s forward."""
    calls = []
    model.register_forward_pre_hook(lambda *_: calls.append(1))
    return calls


# ------------------------------------------------ remat


_REMAT_CASES = {
    # (config, partial points, complete points)
    "flagship": ({"num_coarse": NUM_COARSE}, 256, 1024),
    "vn_pointr": ({"enc_type": "vn_pointr", "dec_type": "attention_vn_foldingnet",
                   "num_coarse": 448}, 600, 1024),
}


@pytest.mark.parametrize("path,dtype", [("flagship", torch.float32),
                                        ("flagship", torch.bfloat16),
                                        ("vn_pointr", torch.bfloat16)])
def test_remat_step_equals_plain_step(path, dtype):
    """One guarded step with ``remat`` against one without, from the same
    weights on the same batch under an so3 rotation: the losses, every
    gradient, every parameter after the update and every BatchNorm running
    statistic equal to the bit (the recomputation repeats the forward's
    bits and discrete decisions, and the step puts back the forward's
    running statistics), the forward run twice.  ``vn_pointr`` in bf16: the
    root ``config.json``'s pipeline under its policy."""
    extra, n_partial, n_complete = _REMAT_CASES[path]
    rng = np.random.default_rng(0)
    partial = torch.from_numpy((rng.standard_normal((2, n_partial, 3)) * 0.3).astype(np.float32))
    complete = torch.from_numpy((rng.standard_normal((2, n_complete, 3)) * 0.3).astype(np.float32))
    runs = []
    for remat in (False, True):
        cfg = Config.from_dict({**extra, "rotation": "so3", "seed": 5, "remat": remat})
        model = build_model(cfg)
        calls = _count_forwards(model)
        state = create_train_state(model, cfg, 4)
        with compute_dtype_scope(dtype):
            m = port_steps.train_step(state, partial, complete, torch.Generator().manual_seed(0))
        runs.append((m, {k: p.grad for k, p in model.named_parameters() if p.grad is not None},
                     model.state_dict(), len(calls)))
    (m0, g0, s0, n0), (m1, g1, s1, n1) = runs
    assert (n0, n1) == (1, 2)
    assert float(m0["skipped"]) == 0.0
    for k in ("total", "coarse", "dense", "skipped"):
        assert torch.equal(m0[k], m1[k]), k
    assert set(g0) == set(g1) and g0
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in s0:  # parameters after the update and the running statistics
        assert torch.equal(s0[k], s1[k]), k
    assert any("running_var" in k and not torch.equal(s0[k], torch.ones_like(s0[k]))
               for k in s0)


@pytest.mark.parametrize("rotated", [False, True])
def test_remat_step_matches_jax_remat_step(flagship, rotated, monkeypatch):  # noqa: F811
    """The port's remat step against JAX's ``make_train_step`` with
    ``remat`` (the forward under ``jax.checkpoint``), step 0 in float64 as
    ``tests/test_torch_port_train.py::test_train_step_matches_jax``: losses
    rtol 1e-9, every gradient within 1e-7 of its tensor's max |g|, the
    running statistics rtol 1e-9.  JAX's gradient is read from its step
    with the optimiser swapped for ``p + g`` (``optax.sgd(-1)``)."""
    with _float64(flagship, monkeypatch) as (jm, v, model, partial, complete, rot):
        rot = rot if rotated else None
        monkeypatch.setattr(port_steps, "sample_rotation",
                            lambda *a: None if rot is None else torch.from_numpy(rot))
        monkeypatch.setattr(jax_steps, "sample_rotation",
                            lambda *a: None if rot is None else jnp.asarray(rot))
        jcfg = JaxConfig(num_coarse=NUM_COARSE, latent_dim=2048, remat=True)
        jstate = jax_state.TrainState.create(apply_fn=jm.apply, params=v["params"],
                                             tx=optax.sgd(-1.0), batch_stats=v["batch_stats"])
        new, j_metrics = jax_steps.make_train_step(jcfg)(
            jstate, jnp.asarray(partial), jnp.asarray(complete), jax.random.key(0))
        j_grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), _np_tree(new.params),
                               v["params"])
        new_stats = _np_tree(new.batch_stats)
        state = create_train_state(model, Config.from_dict(
            {"num_coarse": NUM_COARSE, "remat": True}), 1)
        calls = _count_forwards(model)
        m = port_steps.train_step(state, torch.from_numpy(partial), torch.from_numpy(complete),
                                  torch.Generator().manual_seed(0))
        grads = {k: p.grad for k, p in model.named_parameters()}

    assert len(calls) == 2 and float(m["skipped"]) == 0.0 == float(j_metrics["skipped"])
    np.testing.assert_allclose([float(m["coarse"]), float(m["dense"])],
                               [float(j_metrics["coarse"]), float(j_metrics["dense"])], rtol=1e-9)
    zero_stats = jax.tree.map(np.zeros_like, v["batch_stats"])
    want = state_dict_from_jax_variables({"params": j_grads, "batch_stats": zero_stats})
    assert set(grads) <= set(want) and len(grads) == 26
    for name, g in grads.items():
        if "maxpool" in name:  # the pools' direction maps feed only an argmax
            assert (g is None or not g.any()) and not want[name].any(), name
            continue
        assert _rel_err(g.numpy(), want[name].numpy()) <= 1e-7, name
    stats = state_dict_from_jax_variables({"params": v["params"], "batch_stats": new_stats})
    buffers = dict(model.named_buffers())
    assert len(buffers) == 8
    for name, b in buffers.items():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(), rtol=1e-9, atol=1e-12)


# ------------------------------------------------ pretrained encoders


# encoder -> (decoder, num_coarse, input points of the JAX model's shapes)
_PIPELINES = {
    "vn_pointnet": ("vn_foldingnet", 64, 256),
    "vn_dgcnn_fps": ("vn_foldingnet", 64, 600),
    "dgcnn_fps": ("foldingnet", 448, 600),
    "vn_pointr": ("attention_vn_foldingnet", 448, 600),
}


def _random_variables(enc: str, seed: int):
    """A JAX PCNNet's ``{params, batch_stats}`` tree (its shapes by
    ``jax.eval_shape`` of its init) filled from a numpy seed: running
    variances in [0.5, 2], every other leaf N(0, 0.1)."""
    dec, nc, n = _PIPELINES[enc]
    jm = JaxPCNNet(enc, dec, nc)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.key(0), x, None, train=False),
                            jax.ShapeDtypeStruct((1, n, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if getattr(path[-1], "key", None) == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(draw, shapes)
    return jm, {k: jax.tree.map(np.asarray, dict(v[k])) for k in ("params", "batch_stats")}


def _reference_file(enc: str, path, bare: bool, seed: int = 1):
    """A reference-style ``.pth`` of a pretrained ``enc`` written to
    ``path``: a whole ``PCNNet`` state dict (``encoder.``/``decoder.`` keys)
    with the reference's ``num_batches_tracked`` counters, or (``bare``) the
    encoder's own dict.  vn_pointr's carries the reference's dead keys and
    its 1024-channel ``vn_coarse_pred.2``.  Returns the dict saved."""
    _, v = _random_variables(enc, seed)
    sd = state_dict_from_jax_variables(v)
    g = torch.Generator().manual_seed(seed)
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    if enc == "vn_pointr":
        sd["encoder.vn_coarse_pred.2.map_to_feat.weight"] = torch.randn(1024, 512, generator=g)
        for k, shape in (("input_proj.0.weight", (128, 384, 1)), ("pos_embed.0.weight", (128, 3, 1)),
                         ("vn_pos_embed.0.map_to_feat.weight", (64, 1)),
                         ("encoder.0.attn.qkv.weight", (384, 128)),
                         ("encoder.0.attn.proj.weight", (128, 128)),
                         ("encoder.3.conv1.map_to_feat.weight", (128, 256)),
                         ("encoder.3.conv2.map_to_feat.weight", (128, 128)),
                         ("vn_mlp_query.0.map_to_feat.weight", (128, 1024)),
                         ("decoder.0.norm1.layer_norm.weight", (128,))):
            sd[f"encoder.{k}"] = torch.randn(*shape, generator=g)
    if bare:
        sd = {k[len("encoder."):]: t for k, t in sd.items() if k.startswith("encoder.")}
    torch.save(sd, str(path))
    return sd


@pytest.mark.parametrize("enc,bare", [("vn_pointnet", False), ("vn_pointnet", True),
                                      ("vn_dgcnn_fps", False), ("dgcnn_fps", False),
                                      ("vn_pointr", False), ("vn_pointr", True)])
def test_load_pretrained_encoder_matches_jax(enc, bare, tmp_path):
    """JAX's ``load_pretrained_encoder`` and the port's on the same ``.pth``,
    from the same initial weights: every tensor of the port's model equal
    to the bit to JAX's loaded tree carried across by
    ``state_dict_from_jax_variables``; every encoder tensor from the file
    but vn_pointr's coarse head (it keeps its init, as JAX's does), the
    decoder untouched."""
    jm, init = _random_variables(enc, 0)
    path = str(tmp_path / "enc.pth")
    saved = _reference_file(enc, path, bare)
    jstate = jax_state.TrainState.create(apply_fn=jm.apply, params=init["params"],
                                         tx=optax.identity(), batch_stats=init["batch_stats"])
    jloaded = jax_ckpt.load_pretrained_encoder(jstate, path, enc_type=enc)
    want = state_dict_from_jax_variables({"params": _np_tree(jloaded.params),
                                          "batch_stats": _np_tree(jloaded.batch_stats)})

    dec, nc, _ = _PIPELINES[enc]
    model = PCNNet(enc, dec, nc)
    start = state_dict_from_jax_variables(init)
    model.load_state_dict(start, strict=True)
    keys = load_pretrained_encoder(model, path, enc)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, t in got.items():
        assert torch.equal(t, want[k]), k
    head = "encoder.vn_coarse_pred.2.map_to_feat.weight"
    assert len(keys) == sum(k.startswith("encoder.") for k in got) - (enc == "vn_pointr")
    for k, t in got.items():
        file_key = k[len("encoder."):] if bare else k
        if k.startswith("encoder.") and k != head:
            assert torch.equal(t, saved[file_key]), k
        else:
            assert torch.equal(t, start[k]), k


@pytest.mark.parametrize("fault", ["ckpt", "shape", "missing"])
def test_load_pretrained_encoder_refuses_as_jax(fault, tmp_path):
    """A flax ``.ckpt`` tree without one of the encoder's leaves raises
    ValueError in JAX and KeyError naming it in the port (the port reads
    JAX's ``.ckpt`` files since they were ported,
    ``tests/test_torch_port_ckpt.py``); an encoder tensor of another shape
    raises ValueError and a missing one KeyError, on both sides."""
    jm, init = _random_variables("vn_pointnet", 0)
    model = PCNNet("vn_pointnet", "vn_foldingnet", 64)
    if fault == "ckpt":
        import flax.serialization

        _, v = _random_variables("vn_pointnet", 1)
        del v["params"]["encoder"]["trunk"]["second_conv_1"]
        path = str(tmp_path / "enc.ckpt")
        with open(path, "wb") as f:
            f.write(flax.serialization.msgpack_serialize(v))
        jstate = jax_state.TrainState.create(apply_fn=jm.apply, params=init["params"],
                                             tx=optax.identity(),
                                             batch_stats=init["batch_stats"])
        with pytest.raises(ValueError):
            jax_ckpt.load_pretrained_encoder(jstate, path, enc_type="vn_pointnet")
        with pytest.raises(KeyError, match="second_conv"):
            load_pretrained_encoder(model, path, "vn_pointnet")
        return
    sd = _reference_file("vn_pointnet", tmp_path / "enc.pth", bare=False)
    key = "encoder.second_conv.0.map_to_feat.weight"
    if fault == "shape":
        sd[key] = sd[key][:, :-1]
    else:
        del sd[key]
    path = str(tmp_path / "bad.pth")
    torch.save(sd, path)
    err = ValueError if fault == "shape" else KeyError
    jstate = jax_state.TrainState.create(apply_fn=jm.apply, params=init["params"],
                                         tx=optax.identity(), batch_stats=init["batch_stats"])
    with pytest.raises(err):
        jax_ckpt.load_pretrained_encoder(jstate, path, enc_type="vn_pointnet")
    with pytest.raises(err, match="second_conv"):
        load_pretrained_encoder(model, path, "vn_pointnet")


def test_frozen_pretrained_encoder_step_matches_jax(flagship, tmp_path, monkeypatch):  # noqa: F811
    """A flagship step with a pretrained encoder (``enc_pretrained``: loaded,
    then frozen) against JAX's, in float64 under an so3 rotation: on both
    sides the encoder's parameters unchanged, its BatchNorm running
    statistics moved off the file's, equally (rtol 1e-9); the losses rtol
    1e-9; the decoder's parameters moved by the same update, each within
    5e-3 of its tensor's largest change (measured 1.2e-3: Adam's first
    update divides gradients near its eps of 1e-8 by about eps, which turns
    their float64 differences into visible ones, as in
    ``test_first_three_steps_match_jax``)."""
    jm, _, partial32, _, _ = flagship
    file_v = jm.init(jax.random.key(1), jnp.asarray(partial32), None, train=False)
    file_v = {k: _randomize_bn(_np_tree(dict(file_v[k])), np.random.default_rng(1))
              for k in file_v}
    path = str(tmp_path / "pretrained.pth")
    torch.save(state_dict_from_jax_variables(file_v), path)
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    with _float64(flagship, monkeypatch) as (jm, v, model, partial, complete, rot):
        monkeypatch.setattr(port_steps, "sample_rotation", lambda *a: torch.from_numpy(rot))
        monkeypatch.setattr(jax_steps, "sample_rotation", lambda *a: jnp.asarray(rot))
        jcfg = JaxConfig(num_coarse=NUM_COARSE, latent_dim=2048, rotation="so3",
                         enc_pretrained=path)
        jstate = jax_state.create_train_state(jm, jcfg, 1, jax.random.key(1), jnp.asarray(partial))
        jstate = jstate.replace(params=v["params"], batch_stats=v["batch_stats"])
        jstate = jax_ckpt.load_pretrained_encoder(jstate, path, enc_type="vn_pointnet")
        jstate = jstate.replace(params=jax.tree.map(f64, jstate.params),
                                batch_stats=jax.tree.map(f64, jstate.batch_stats))
        before = state_dict_from_jax_variables(_np_tree(
            {"params": jstate.params, "batch_stats": jstate.batch_stats}))
        new, j_metrics = jax_steps.make_train_step(jcfg)(
            jstate, jnp.asarray(partial), jnp.asarray(complete), jax.random.key(0))
        want = state_dict_from_jax_variables(_np_tree(
            {"params": new.params, "batch_stats": new.batch_stats}))

        cfg = Config.from_dict({"num_coarse": NUM_COARSE, "rotation": "so3",
                                "enc_pretrained": path})
        load_pretrained_encoder(model, path, "vn_pointnet")
        state = create_train_state(model, cfg, 1)
        m = port_steps.train_step(state, torch.from_numpy(partial), torch.from_numpy(complete),
                                  torch.Generator().manual_seed(0))
        got = model.state_dict()

    assert float(m["skipped"]) == 0.0 == float(j_metrics["skipped"])
    np.testing.assert_allclose([float(m["coarse"]), float(m["dense"])],
                               [float(j_metrics["coarse"]), float(j_metrics["dense"])], rtol=1e-9)
    for name, t in got.items():
        moved = np.abs(want[name].numpy() - before[name].numpy()).max()
        if name.startswith("encoder.") and "running" not in name:
            assert moved == 0.0 and torch.equal(t, before[name]), name  # frozen
        elif "running" in name:
            assert moved > 0.0, name
            np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-9, atol=1e-12)
        else:
            err = np.abs(t.numpy() - want[name].numpy()).max()
            assert moved > 0.0 and err <= 5e-3 * moved, name


# ------------------------------------------------ the CLI: -from, --ckpt_path


@pytest.fixture
def project(tmp_path, monkeypatch):
    """A tiny synthetic flagship project (num_coarse 64, 256 / 1024 points,
    batch 2, two steps an epoch), as JAX's ``tests/test_cli.py`` sets one up;
    its runs are deleted afterwards (a flagship checkpoint pair is ~260 MB)."""
    cfg = {
        "name": "cli_smoke", "enc_type": "vn_pointnet", "dec_type": "vn_foldingnet",
        "num_coarse": NUM_COARSE, "latent_dim": 2048, "only_coarse": False, "batch_size": 2,
        "lr": 1e-3, "rotation": "none", "val_rotation": "none", "dataset": "synthetic",
        "num_workers": 1, "log_frequency": 1, "synthetic_train_samples": 4,
        "synthetic_val_samples": 2, "synthetic_n_partial": 256, "synthetic_n_complete": 1024,
    }
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "experiments"))
    yield tmp_path
    shutil.rmtree(tmp_path / "experiments", ignore_errors=True)


def _runs(project):
    return sorted(os.listdir(project / "experiments"))


@pytest.mark.parametrize("frm", ["1", "best"])
def test_cli_branch_from_epoch(project, frm, monkeypatch):
    """JAX's ``test_branch_from_epoch`` on the port: a source run with
    ``checkpoint_every 1`` trains epochs 0..1; ``-n <src> -from <N> -epochs
    3 train`` makes a new run holding a byte copy of the pair ``model_N`` /
    ``optim_N`` (read at its first step: the run may write a new ``best``
    later), logs ``[BRANCH INFO]``, starts its first step from the pair's
    weights and trains from epoch N + 1 to 3."""
    from vn_pointcloudcompletion_tpu_torch.training import trainer

    cfg = json.loads((project / "config.json").read_text())
    cfg["checkpoint_every"] = 1
    (project / "config.json").write_text(json.dumps(cfg))
    cli.main(["-n", "cli_smoke", "-epochs", "1", "--device", "cpu", "train"])
    (src,) = _runs(project)
    src_dir = project / "experiments" / src
    assert (src_dir / "models" / "model_1.pth").exists()
    epoch = torch.load(src_dir / "optimizer" / f"optim_{frm}.pth", weights_only=True)["epoch"]

    first = []  # at the first step: the weights, and the pair's bytes in the new run
    step = trainer.train_step

    def spy(state, *a):
        if not first:
            exp = state.config.exp_dir
            first.append(({k: t.clone() for k, t in state.model.state_dict().items()},
                          [open(os.path.join(exp, sub, f"{stem}_{frm}.pth"), "rb").read()
                           for sub, stem in (("models", "model"), ("optimizer", "optim"))]))
        return step(state, *a)

    monkeypatch.setattr(trainer, "train_step", spy)
    summary = cli.main(["-n", src, "-from", frm, "-epochs", "3", "--device", "cpu", "train"])
    runs = _runs(project)
    assert len(runs) == 2 and summary["epochs_run"] == 3 - epoch
    new_dir = project / "experiments" / runs[1]
    weights, copied = first[0]
    assert copied == [(src_dir / sub / f"{stem}_{frm}.pth").read_bytes()
                      for sub, stem in (("models", "model"), ("optimizer", "optim"))]
    pair = torch.load(src_dir / "models" / f"model_{frm}.pth", weights_only=True)
    assert all(torch.equal(weights[k], pair[k]) for k in pair)
    assert torch.load(new_dir / "optimizer" / "optim_last.pth", weights_only=True)["epoch"] == 3
    log = (new_dir / "train.log").read_text()
    assert f"[BRANCH INFO] new run {runs[1]} branched from epoch {epoch}" in log
    assert f"Epoch [{epoch + 1:03d}/003]" in log and f"Epoch [{epoch:03d}/003]" not in log
    stored = json.loads((new_dir / "config.json").read_text())
    assert stored["checkpoint"] == (int(frm) if frm.isdigit() else frm)


def test_cli_branch_from_missing_checkpoint_fails(project):
    """JAX's ``test_branch_from_missing_checkpoint_fails``: ``-from 7`` of a
    run without numbered checkpoints raises FileNotFoundError with the
    ``checkpoint_every`` hint, and leaves no new run dir behind."""
    cli.main(["-n", "cli_smoke", "-epochs", "0", "--device", "cpu", "train"])
    (src,) = _runs(project)
    with pytest.raises(FileNotFoundError, match="checkpoint_every"):
        cli.main(["-n", src, "-from", "7", "--device", "cpu", "train"])
    assert _runs(project) == [src]


def test_cli_from_flag_semantics(project, capsys):
    """``main.py:86-99``: ``-from`` without ``-n`` is a parser error;
    ``-from 0`` is off (a new run from ``config.json``); ``--resume`` takes
    precedence over ``-from`` (the named run continues, no new run)."""
    with pytest.raises(SystemExit):
        cli.main(["-from", "1", "--device", "cpu", "train"])
    assert "-from requires -n" in capsys.readouterr().err
    cli.main(["-n", "cli_smoke", "-from", "0", "-epochs", "0", "--device", "cpu", "train"])
    (run,) = _runs(project)
    assert "Start a brand new experiment" in (project / "experiments" / run / "train.log").read_text()
    cli.main(["-n", run, "--resume", "-from", "5", "-epochs", "1", "--device", "cpu", "train"])
    assert _runs(project) == [run]
    log = (project / "experiments" / run / "train.log").read_text()
    assert "[RESUME INFO] resume ckpts @ 0 epoch" in log and "[BRANCH INFO]" not in log


def test_cli_ckpt_path_trains_with_a_frozen_pretrained_encoder(project):
    """``--ckpt_path <a run's model_best.pth> overfit``: the run's encoder
    parameters equal the file's to the bit after training, its encoder
    BatchNorm running statistics moved off the file's, its decoder moved
    off its initial weights."""
    cli.main(["-n", "first", "-epochs", "0", "--device", "cpu", "overfit"])
    (first,) = _runs(project)
    path = str(project / "experiments" / first / "models" / "model_best.pth")
    pretrained = torch.load(path, weights_only=True)
    summary = cli.main(["-n", "second", "--ckpt_path", path, "-epochs", "1", "--device", "cpu",
                        "overfit"])
    assert summary["epochs_run"] == 2
    run = [r for r in _runs(project) if "_second_" in r][0]
    exp = project / "experiments" / run
    assert "Loaded pretrained encoder from" in (exp / "overfit.log").read_text()
    assert json.loads((exp / "config.json").read_text())["enc_pretrained"] == path
    trained = torch.load(exp / "models" / "model_last.pth", weights_only=True)
    init = build_model(Config.from_dict(json.loads((exp / "config.json").read_text())))
    init = init.state_dict()
    for k, t in trained.items():
        if k.startswith("encoder.") and "running" not in k:
            assert torch.equal(t, pretrained[k]), k
        elif k.startswith("encoder."):
            assert not torch.equal(t, pretrained[k]), k
        elif "running" not in k:
            assert not torch.equal(t, init[k]), k


# ------------------------------------------------ profiling, parameter counts


def test_step_timer_summary_matches_jax():
    """``StepTimer.summary()``: JAX's keys and values on the same step
    times (warm-up discarded; all steps when there are no more); on the CPU
    the timer needs no card and records no device time."""
    from vn_pointcloudcompletion_tpu.utils import profiling as jax_profiling

    times = [0.5, 0.012, 0.011, 0.014, 0.010, 0.013]
    for warmup, ts in ((2, times), (2, times[:2])):
        ours, theirs = profiling.StepTimer(warmup), jax_profiling.StepTimer(warmup)
        ours.times, theirs.times = list(ts), list(ts)
        assert ours.summary() == theirs.summary()
    timer = profiling.StepTimer(warmup=1)
    for _ in range(3):
        with timer:
            torch.ones(64, 64) @ torch.ones(64, 64)
    s = timer.summary()
    assert set(s) == {"mean_s", "p50_s", "p90_s", "steps"} and s["steps"] == 2
    assert all(t > 0 for t in timer.times) and timer.device_times == []
    with pytest.raises(ValueError):
        timer.device_summary()


def test_device_memory_stats_on_cpu_matches_jax():
    """On the CPU, JAX's ``device_memory_stats`` gives its CPU device's
    entry with zeros under three keys; the port gives the CPU's the same."""
    from vn_pointcloudcompletion_tpu.utils import profiling as jax_profiling

    theirs = jax_profiling.device_memory_stats()
    ours = profiling.device_memory_stats()
    assert ours == [{"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0,
                     "device": "cpu"}]
    for entry in theirs:
        assert set(entry) == set(ours[0])
        assert {k: v for k, v in entry.items() if k != "device"} == {
            k: v for k, v in ours[0].items() if k != "device"}


def test_log_compile_time_and_trace(tmp_path):
    """``log_compile_time`` runs the function twice and returns both times;
    ``trace`` writes a Chrome trace of the region that holds its ops."""
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": (x @ x, None)}

    first, steady = profiling.log_compile_time(fn, torch.ones(32, 32))
    assert len(calls) == 2 and first > 0 and steady > 0
    with profiling.trace(str(tmp_path / "tb")) as prof:
        torch.ones(16, 16).mm(torch.ones(16, 16))
    assert any("mm" in e.key for e in prof.key_averages())
    (name,) = os.listdir(tmp_path / "tb")
    assert name.endswith(".pt.trace.json")
    assert "traceEvents" in json.loads((tmp_path / "tb" / name).read_text())


@pytest.mark.parametrize("enc", ["vn_pointnet", "vn_pointr"])
def test_num_params_matches_jax(enc):
    """``get_num_params`` of the port's model against JAX's of its tree."""
    from vn_pointcloudcompletion_tpu.utils.experiments import get_num_params as jax_num_params

    _, v = _random_variables(enc, 0)
    dec, nc, _ = _PIPELINES[enc]
    assert get_num_params(PCNNet(enc, dec, nc)) == jax_num_params(v["params"])
