"""The port's data-parallel training (``parallel/``, ``--mesh``) on the CPU,
and the data tooling of the same slice.

- Two gloo ranks (``torch.multiprocessing``, spawned once for the module)
  take one train step each over their rows of a global batch: flagship and
  vn_dgcnn at small widths in float64, under an so3 rotation drawn for the
  global batch.  Their gradients, losses, updated parameters and running
  statistics against the port's single-process step on the same global
  batch within 1e-10, and against JAX's ``parallel.make_parallel_steps`` on a
  2-device virtual CPU mesh within the float64 1e-7 of the other step tests.
- The ``BatchNormCh`` and VN norm-BatchNorm moments under two ranks (the
  ``norm`` path and the kernel-S path) against one process.
- A world of one rank gives the bits of a step without a mesh and launches
  one collective, the gradient all-reduce.
- One float64 ``train`` epoch on two ranks against the one-process epoch
  (the ranks split each global batch of the one-process loader); the
  loader's rank shards; a step without its mesh refused inside a group.
- ``--mesh`` through the CLI; ``ShapeNetPCN``'s per-process shares against
  JAX's; ``mesh_bench``'s line and its refusal of sizes past the visible
  cards; the fastply reader against the numpy reader.

Every ``init_process_group`` has a timeout and every spawn a deadline, so a
hang fails in seconds.  JAX is imported inside the tests: the ``gpu`` tests
(two ranks sharing one card over gloo) run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_parallel.py
"""

import json
import os
import shutil
from datetime import timedelta

import numpy as np
import pytest
import torch

from vn_pointcloudcompletion_tpu_torch.models import pcn as port_pcn
from vn_pointcloudcompletion_tpu_torch.parallel import mesh as port_mesh

TIMEOUT = timedelta(seconds=60)  # every collective of a rank
DEADLINE_S = 150.0  # every spawn, from start to the last rank's exit
NUM_COARSE = 64
SEED = 7  # the rotation generator's
LR = 1e-4


def spawn(fn, world: int, *args):
    """``parallel/mesh.py::spawn_ranks`` within the tests' deadline."""
    port_mesh.spawn_ranks(fn, world, *args, deadline=DEADLINE_S)


def digest(tensors: dict) -> dict:
    """Each tensor's bits as a hash, by name: equal bits across ranks."""
    import hashlib

    return {k: hashlib.sha256(t.detach().cpu().reshape(-1).view(torch.uint8).numpy()
                              .tobytes()).hexdigest() for k, t in tensors.items()}


def _patch_grids(grids):
    """The folding grids the JAX package builds (the two ``linspace`` round
    1 ulp apart in float32), by grid size."""
    for name, table in grids.items():
        setattr(port_pcn, name, lambda g, t=table: torch.from_numpy(t[repr(g)]))


def _model(case, dtype=torch.float64, device="cpu"):
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.utils.config import Config

    cfg = Config.from_dict(case["config"])
    model = build_model(cfg)
    model.load_state_dict(case["state_dict"], strict=True)
    return cfg, model.to(device=device, dtype=dtype)


def _step(case, mesh=None, dtype=torch.float64, device="cpu"):
    """One train step of ``case`` (the rank's rows under ``mesh``): the
    metrics, the gradients, the state after the update (parameters and
    buffers) and Adam's state."""
    from vn_pointcloudcompletion_tpu_torch.training import steps
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state

    cfg, model = _model(case, dtype, device)
    state = create_train_state(model, cfg, 1)
    partial, complete = (port_mesh.data_sharding(mesh, torch.from_numpy(case[k]))
                         .to(device=device, dtype=dtype) for k in ("partial", "complete"))
    m = steps.train_step(state, partial, complete, torch.Generator().manual_seed(SEED), mesh)
    grads = {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    adam = {f"{k}.{n}": t.detach().cpu().clone() for k, p in model.named_parameters()
            for n, t in state.optimizer.state.get(p, {}).items()}
    return ({k: float(v) for k, v in m.items()}, grads,
            {k: t.detach().cpu().clone() for k, t in model.state_dict().items()}, adam)


def _moment_layers():
    """A train-mode BatchNormCh, a VN norm-BatchNorm on vec features (the
    ``norm`` path) and a plane VN layer wide enough for kernel S (N 4096),
    with their inputs and cotangents: {name: (module, x, cotangent)}."""
    from vn_pointcloudcompletion_tpu_torch.models.common import BatchNormCh
    from vn_pointcloudcompletion_tpu_torch.nn.vn import VNBatchNorm, VNLinearLeakyReLU

    g = torch.Generator().manual_seed(3)
    layers = {  # module, input shape, output shape
        "batchnorm_ch": (BatchNormCh(6), (4, 6, 50, 3), (4, 6, 50, 3)),
        "vn_norm": (VNBatchNorm(5), (4, 5, 3, 60), (4, 5, 3, 60)),
        "vn_kernel_s": (VNLinearLeakyReLU(4, 8, layout="plane"), (4, 3, 4, 4096),
                        (4, 3, 8, 4096)),
    }
    out = {}
    for name, (module, x_shape, out_shape) in layers.items():
        module = module.double().train()
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=g, dtype=p.dtype) * 0.5 + 0.5)
        x = torch.randn(x_shape, generator=g, dtype=torch.float64) * 2 + 1
        out[name] = (module, x, torch.randn(out_shape, generator=g, dtype=torch.float64))
    return out


def _moments(mesh=None):
    """Each moment layer's forward and backward over the rank's rows:
    outputs, input gradients, parameter gradients and running statistics."""
    res = {}
    for name, (module, x, cot) in _moment_layers().items():
        x = port_mesh.data_sharding(mesh, x).clone().requires_grad_()
        out = module(x)
        (out * port_mesh.data_sharding(mesh, cot)).sum().backward()
        res[name] = {"out": out.detach(), "dx": x.grad,
                     **{f"grad.{k}": p.grad for k, p in module.named_parameters()},
                     **{k: b.clone() for k, b in module.named_buffers()}}
    return res


def _rank_cases(rank, world, init, workdir):
    """A rank of the module's 2-rank run: every step case and the moment
    layers.  Each rank writes its mesh, the hashes of its step results
    (metrics, gradients, state, Adam's state) and its moment layers'
    results to ``workdir/rank<r>.pt``; rank 0 its step results too
    (``steps0.pt``).  One intra-op thread a rank: with two, the float64
    steps' gradients moved from run to run by up to 3e-9 of a tensor's
    max."""
    from vn_pointcloudcompletion_tpu_torch.training import steps as port_steps
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state

    torch.set_num_threads(1)
    cases = torch.load(os.path.join(workdir, "cases.pt"), weights_only=False)
    mesh = port_mesh.make_mesh(rank, world, init, "cpu", timeout=TIMEOUT)
    try:
        out = {"mesh": (mesh.rank, mesh.world, mesh.backend, str(mesh.device))}
        steps = {}
        for name, case in cases.items():
            _patch_grids(case["grids"])
            m, grads, sd, adam = _step(case, mesh)
            steps[name] = (m, grads, sd)
            out[name] = (m, digest(grads), digest(sd), digest(adam))
        remat = {**cases["flagship"], "config": {**cases["flagship"]["config"], "remat": True}}
        _patch_grids(remat["grids"])
        m, grads, sd, adam = _step(remat, mesh)
        out["flagship_remat"] = (m, digest(grads), digest(sd), digest(adam))
        out["moments"] = _moments(mesh)
        cfg, model = _model(cases["flagship"])
        try:  # a step without its mesh inside the group
            port_steps.train_step(create_train_state(model, cfg, 1),
                                  *(torch.from_numpy(cases["flagship"][k][:1])
                                    for k in ("partial", "complete")),
                                  torch.Generator().manual_seed(SEED))
            out["refused"] = None
        except RuntimeError as e:
            out["refused"] = str(e)
        out["grads_untouched"] = all(p.grad is None for p in model.parameters())
    finally:
        port_mesh.destroy_mesh()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    if rank == 0:
        torch.save(steps, os.path.join(workdir, "steps0.pt"))


# ------------------------------------------------------------ the step cases


def _case(name: str):
    """A port model drawn from a seed, its norm layers' affines and running
    statistics randomised, and the JAX package's variables for the same
    weights (``training/torch_interop.py``: no JAX init to compile); the
    global batch of 2: (JAX model, variables, partial, complete, config)."""
    from tests.test_torch_port_dgcnn import _assert_knn_gap, _cloud
    from vn_pointcloudcompletion_tpu.models.composer import PCNNet as JaxPCNNet
    from vn_pointcloudcompletion_tpu.training import torch_interop
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.utils.config import Config

    if name == "flagship":
        extra, latent = {"num_coarse": NUM_COARSE}, 2048
        partial, complete = _cloud(0, n=256), _cloud(1, n=1024)
    else:  # neighbour gaps wide enough for JAX's float32 picks
        extra, latent = {"enc_type": "vn_dgcnn_fps", "dec_type": "vn_foldingnet",
                         "num_coarse": 32}, 512
        partial, complete = _cloud(60), _cloud(22, n=512)
        _assert_knn_gap(partial)
    rng = np.random.default_rng(1)
    sd = {k: t.numpy().copy() for k, t in
          build_model(Config.from_dict({**extra, "seed": 3})).state_dict().items()}
    for k, t in sd.items():
        c = t.shape
        if k.endswith("bn.weight"):
            sd[k] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        elif k.endswith("bn.bias"):
            sd[k] = rng.normal(0.0, 0.2, c).astype(np.float32)
        elif k.endswith("running_mean"):
            sd[k] = rng.uniform(0.0, 0.5, c).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    enc_p, enc_s = torch_interop.encoder_variables_from_torch(sd, extra.get("enc_type",
                                                                            "vn_pointnet"))
    dec_p, dec_s = torch_interop.vn_foldingnet_from_state_dict(sd, latent_dim=latent)
    v = {"params": {"encoder": enc_p, "decoder": dec_p},
         "batch_stats": {"encoder": enc_s, "decoder": dec_s}}
    jm = JaxPCNNet(extra.get("enc_type", "vn_pointnet"), "vn_foldingnet", extra["num_coarse"],
                   latent)
    return jm, v, partial, complete, extra


def _jax_grids():
    """JAX's folding grids, recorded by size as the port's model asks."""
    from vn_pointcloudcompletion_tpu.ops import grid as jax_grid

    tables = {}

    def recorder(name):
        fn = getattr(jax_grid, name)

        def grid(g):
            t = tables.setdefault(name, {})
            t.setdefault(repr(g), np.array(fn(g), np.float64))
            return torch.from_numpy(t[repr(g)])
        return grid

    return tables, {name: recorder(name) for name in ("folding_grid_2d", "folding_grid_3d")}


@pytest.fixture(scope="module")
def parallel_run(tmp_path_factory):
    """The step cases (JAX models' weights carried into the port, global
    batch 2, so3 rotations drawn from ``SEED``), the port's single-process
    steps, JAX's 2-device mesh steps (their gradients), and the 2-rank
    run's results."""
    import jax
    import jax.numpy as jnp
    import optax

    from vn_pointcloudcompletion_tpu.parallel import make_mesh, make_parallel_steps, shard_state
    from vn_pointcloudcompletion_tpu.training import state as jax_state
    from vn_pointcloudcompletion_tpu.training import steps as jax_steps
    from vn_pointcloudcompletion_tpu.utils.config import Config as JaxConfig
    from vn_pointcloudcompletion_tpu_torch.ops.rotations import sample_rotation
    from vn_pointcloudcompletion_tpu_torch.training.interop import state_dict_from_jax_variables

    workdir = str(tmp_path_factory.mktemp("parallel"))
    rot = sample_rotation(torch.Generator().manual_seed(SEED), "so3", 2).double().numpy()
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    cases, single, jax_out = {}, {}, {}
    saved = {name: getattr(port_pcn, name) for name in ("folding_grid_2d", "folding_grid_3d")}
    saved_rotation = jax_steps.sample_rotation
    jax.config.update("jax_enable_x64", True)
    try:
        jax_steps.sample_rotation = lambda *a: jnp.asarray(rot)
        for name in ("flagship", "vn_dgcnn"):
            jm, v, partial, complete, extra = _case(name)
            config = {**extra, "rotation": "so3", "batch_size": 2, "lr": LR, "seed": 0}
            tables, grids = _jax_grids()
            for g, fn in grids.items():
                setattr(port_pcn, g, fn)
            case = {"config": config, "state_dict": state_dict_from_jax_variables(v),
                    "partial": f64(partial), "complete": f64(complete), "grids": tables}
            threads = torch.get_num_threads()
            torch.set_num_threads(1)  # as the ranks
            try:  # the port, one process, the global batch
                single[name] = _step(case)[:3]
            finally:
                torch.set_num_threads(threads)
            cases[name] = case
            v64 = jax.tree.map(f64, v)
            jcfg = JaxConfig(**{k: config[k] for k in extra}, latent_dim=2048, rotation="so3",
                             batch_size=2)
            jstate = jax_state.TrainState.create(apply_fn=jm.apply, params=v64["params"],
                                                 tx=optax.sgd(-1.0),
                                                 batch_stats=v64["batch_stats"])
            mesh = make_mesh(jax.devices()[:2])
            ptrain, _, sh = make_parallel_steps(jcfg, mesh)
            new, metrics = ptrain(shard_state(jstate, mesh), jax.device_put(jnp.asarray(
                f64(partial)), sh), jax.device_put(jnp.asarray(f64(complete)), sh),
                jax.random.key(0))
            grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                 jax.tree.map(np.asarray, new.params), v64["params"])
            zero = jax.tree.map(np.zeros_like, v["batch_stats"])
            jax_out[name] = (
                {k: float(metrics[k]) for k in ("coarse", "dense", "skipped")},
                state_dict_from_jax_variables({"params": grads, "batch_stats": zero}),
                state_dict_from_jax_variables({"params": v["params"], "batch_stats":
                                               jax.tree.map(np.asarray, new.batch_stats)}))
    finally:
        jax.config.update("jax_enable_x64", False)
        jax_steps.sample_rotation = saved_rotation
        for name, fn in saved.items():
            setattr(port_pcn, name, fn)
    torch.save(cases, os.path.join(workdir, "cases.pt"))
    spawn(_rank_cases, 2, workdir)
    load = lambda f: torch.load(os.path.join(workdir, f), weights_only=False)  # noqa: E731
    out = {"single": single, "jax": jax_out, "steps": load("steps0.pt"),
           "ranks": [load(f"rank{r}.pt") for r in range(2)]}
    shutil.rmtree(workdir)  # some hundred MB of float64 state
    return out


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in units of max |want|."""
    want = torch.as_tensor(want, dtype=torch.float64)
    return float((got.double() - want).abs().max() / max(want.abs().max().item(), 1e-30))


@pytest.mark.parametrize("name", ["flagship", "vn_dgcnn"])
def test_two_rank_step_equals_single_process_step(parallel_run, name):
    """The 2-rank step (one sample a rank) against the port's one-process
    step on the same global batch of 2, in float64: the two ranks hold the
    same bits (metrics, gradients, parameters, buffers, Adam's state);
    losses rtol 1e-10; every gradient within 1e-10 of the model's largest
    |g| (a tensor's own max is no scale where its gradient is a
    cancellation: the one-process step at 1 and at 8 threads parts by
    1.0e-10 of vn_dgcnn's ``conv7.0`` max); the running statistics within
    1e-10 of the tensor's max, the parameters after Adam's first update as
    well, plus what the gradients' gap moves them: that update is
    ``lr g / (|g| + eps)``, whose slope in g is at most ``1 / eps``."""
    r0, r1 = (r[name] for r in parallel_run["ranks"])
    assert r0 == r1 and all(r0[1:])
    assert parallel_run["ranks"][0]["mesh"] == (0, 2, "gloo", "cpu")
    m0, g0, s0 = parallel_run["steps"][name]
    ms, gs, ss = parallel_run["single"][name]
    assert ms["skipped"] == m0["skipped"] == 0.0
    for k in ("total", "coarse", "dense"):
        assert m0[k] == pytest.approx(ms[k], rel=1e-10, abs=0), k
    assert g0.keys() == gs.keys()
    scale = max(float(g.abs().max()) for g in gs.values())
    for k in gs:
        err = float((g0[k] - gs[k]).abs().max())
        assert err <= 1e-10 * scale, (k, err / scale)
    assert s0.keys() == ss.keys()
    for k in ss:
        err = (s0[k] - ss[k]).abs()
        bound = 1e-10 * float(ss[k].abs().max()) + 1e-14
        if k in gs:  # a parameter: Adam's first update of its gradient
            bound = bound + LR * (g0[k] - gs[k]).abs() / 1e-8
        assert bool((err <= bound).all()), (k, float(err.max()))
    assert any("running_var" in k and not torch.equal(s0[k], torch.ones_like(s0[k]))
               for k in s0)


@pytest.mark.parametrize("name", ["flagship", "vn_dgcnn"])
def test_two_rank_step_matches_jax_mesh_step(parallel_run, name):
    """The 2-rank step against JAX's ``make_parallel_steps`` on a 2-device
    mesh (the same weights and rotation, float64): losses rtol 1e-9, every
    gradient within 1e-7 of its tensor's max |g| (a bias a train-mode
    BatchNorm follows: below 1e-12 on both sides), the running statistics
    rtol 1e-9."""
    m, grads, sd = parallel_run["steps"][name]
    jm, jgrads, jstats = parallel_run["jax"][name]
    assert jm["skipped"] == m["skipped"] == 0.0
    np.testing.assert_allclose([m["coarse"], m["dense"]], [jm["coarse"], jm["dense"]],
                               rtol=1e-9)
    assert set(grads) <= set(jgrads)
    for k, g in grads.items():
        w = jgrads[k].double()
        if w.abs().max() < 1e-12:
            assert g.abs().max() < 1e-12, k
            continue
        assert _rel(g, w) <= 1e-7, (k, _rel(g, w))
    buffers = [k for k in sd if "running" in k]
    assert buffers
    for k in buffers:
        np.testing.assert_allclose(sd[k].numpy(), jstats[k].double().numpy(), rtol=1e-9,
                                   atol=1e-12)


@pytest.mark.parametrize("name", ["batchnorm_ch", "vn_norm", "vn_kernel_s"])
def test_two_rank_batchnorm_moments_are_global(parallel_run, name):
    """Under two ranks each BatchNorm normalises with the global batch's
    statistics: outputs and input gradients (each rank's rows), parameter
    gradients (summed over ranks) and running statistics (equal on both
    ranks) against one process on the whole batch, within 1e-12 of the
    tensor's max (float64)."""
    r0, r1 = (r["moments"][name] for r in parallel_run["ranks"])
    whole = _moments()[name]
    for k, want in whole.items():
        if k in ("out", "dx"):
            got = torch.cat([r0[k], r1[k]])
        elif k.startswith("grad."):
            got = r0[k] + r1[k]
        else:
            assert torch.equal(r0[k], r1[k]), k
            got = r0[k]
        assert got.shape == want.shape, k
        assert _rel(got, want) <= 1e-12, (k, _rel(got, want))
    assert any("running_var" in k and not torch.equal(v, torch.ones_like(v))
               for k, v in r0.items())


def test_step_without_its_mesh_is_refused_inside_a_group(parallel_run):
    """Inside a group of two ranks a train step called without its mesh
    raises before it runs: the BatchNorms read the group, the step's
    gradient all-reduce reads the mesh, and the two must agree."""
    for rank in parallel_run["ranks"]:
        assert "give the step its mesh" in rank["refused"]
        assert rank["grads_untouched"]


def test_two_rank_remat_step_equals_two_rank_step(parallel_run):
    """``remat`` under two ranks: the recomputed forward repeats the
    BatchNorm all-reduces on both ranks, and the step gives the bits of
    the 2-rank step without it (metrics, gradients, parameters, running
    statistics put back to the forward's, Adam's state), on both ranks."""
    for rank in parallel_run["ranks"]:
        assert rank["flagship_remat"] == rank["flagship"]


def _small_flagship(seed=5, **extra):
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.utils.config import Config

    cfg = Config.from_dict({"num_coarse": NUM_COARSE, "rotation": "so3", "seed": seed,
                            "val_rotation": "so3", **extra})
    return cfg, build_model(cfg)


def _clouds(b, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((rng.standard_normal((b, n, 3)) * 0.3).astype(np.float32))
                 for n in (256, 1024))


def test_world_of_one_gives_the_bits_of_no_mesh(monkeypatch):
    """A gloo group of one rank (``--mesh 1``): the train step and the eval
    step give the bits of the steps without a mesh, float32, so3, and
    launch one collective each, the gradient all-reduce and the eval sums'
    (no BatchNorm collective at world size 1)."""
    from vn_pointcloudcompletion_tpu_torch.training import steps
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state

    partial, complete = _clouds(2)
    runs = []
    all_reduce = torch.distributed.all_reduce
    for with_mesh in (False, True):
        cfg, model = _small_flagship()
        state = create_train_state(model, cfg, 1)
        calls = []
        monkeypatch.setattr(torch.distributed, "all_reduce",
                            lambda t, *a, **k: calls.append(t.numel()) or all_reduce(t, *a, **k))
        mesh = (port_mesh.make_mesh(0, 1, f"tcp://localhost:{port_mesh.free_port()}", "cpu",
                                    timeout=TIMEOUT) if with_mesh else None)
        try:
            m = steps.train_step(state, partial, complete, torch.Generator().manual_seed(0), mesh)
            n_train = len(calls)
            e, _ = steps.eval_step(model, cfg, partial, complete,
                                   torch.Generator().manual_seed(1), mesh)
        finally:
            port_mesh.destroy_mesh()
        runs.append((m, e, {k: p.grad for k, p in model.named_parameters()},
                     model.state_dict(), (n_train, len(calls) - n_train)))
    (m0, e0, g0, s0, c0), (m1, e1, g1, s1, c1) = runs
    assert c0 == (0, 0) and c1 == (1, 1), (c0, c1)
    assert not torch.distributed.is_initialized()
    for a, b in ((m0, m1), (e0, e1), (g0, g1), (s0, s1)):
        assert a.keys() == b.keys()
        for k in a:
            assert (a[k] is None and b[k] is None) or torch.equal(a[k], b[k]), k


def test_parallel_steps_refuse_an_indivisible_batch():
    """As JAX's ``make_parallel_steps``: the global batch must divide over
    the ranks."""
    from vn_pointcloudcompletion_tpu_torch.parallel.train_parallel import check_batch

    cfg, _ = _small_flagship(batch_size=6)
    assert check_batch(cfg, 3) == 2
    with pytest.raises(ValueError, match="batch_size=6 must be divisible by the mesh's "
                                         "'data' axis size 4"):
        check_batch(cfg, 4)


# ------------------------------------------------------------ the CLI


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    cfg = {
        "name": "t", "enc_type": "vn_pointnet", "dec_type": "vn_foldingnet",
        "num_coarse": NUM_COARSE, "latent_dim": 2048, "only_coarse": False,
        "batch_size": 2, "lr": 1e-4, "rotation": "so3", "val_rotation": "so3",
        "test_rotation": "so3", "dataset": "synthetic", "num_workers": 1,
        "synthetic_n_partial": 256, "synthetic_n_complete": 1024,
        "synthetic_test_samples": 2, "seed": 0, "log_frequency": 1,
    }
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "out"))
    yield tmp_path
    shutil.rmtree(tmp_path / "out", ignore_errors=True)  # ~260 MB a checkpoint pair


def test_cli_mesh_trains_on_two_gloo_ranks(workdir, capsys, monkeypatch):
    """``--device cpu --mesh 2 overfit``: two ranks of one sample each over
    the global batch of 2; rank 0 alone writes the log, the scalars and the
    checkpoints.  The ranks split each global batch of the one-process run,
    as JAX's devices of one process do: the epoch is one step over both
    samples, as without ``--mesh``.  Then ``--mesh`` on ``test`` warns as
    JAX does and runs on one device."""
    from vn_pointcloudcompletion_tpu_torch import __main__ as cli
    from vn_pointcloudcompletion_tpu_torch.parallel import train_parallel

    ranks = train_parallel.train_on_ranks
    monkeypatch.setattr(train_parallel, "train_on_ranks", lambda *a, **k: ranks(
        *a, timeout=TIMEOUT, deadline=DEADLINE_S, **k))
    summary = cli.main(["-n", "t", "-epochs", "0", "--device", "cpu", "--mesh", "2",
                        "overfit"])
    assert summary["epochs_run"] == 1
    (run,) = os.listdir(workdir / "out")
    exp = workdir / "out" / run
    for f in ("models/model_best.pth", "models/model_last.pth", "optimizer/optim_last.pth"):
        assert (exp / f).exists(), f
    log = (exp / "overfit.log").read_text()
    assert log.count("Training Epoch [000/000]: Coarse = ") == 1
    assert "Iteration [001/001]" in log and "Iteration [002/" not in log
    assert log.count("Validate Epoch [000/000]: Coarse = ") == 1
    rows = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    assert sum(r["tag"] == "Loss/Epoch/Total" for r in rows) == 2  # train and val, once
    assert all(np.isfinite(r["value"]) for r in rows)
    meta = torch.load(exp / "optimizer" / "optim_last.pth", weights_only=True)
    assert meta["step"] == 1

    capsys.readouterr()
    table = cli.main(["-n", run, "--resume", "--device", "cpu", "--mesh", "2", "test"])
    assert "warning: --mesh applies to train/overfit only; test runs single-device" in (
        capsys.readouterr().err)
    assert all(np.isfinite(v) for v in table["synthetic"].values())


def _epoch_rank(rank, world, init, config, workdir):
    """``training/trainer.py::train`` in float64 on one thread (the model
    and the staged batches cast up): as rank ``rank`` of a gloo group of
    ``world``, then, on rank 0 of two, once more without a mesh into its
    own run directory.  Each run's final parameters, buffers, count of
    accepted steps and the gradients of each update go to
    ``workdir/<run><rank>.pt``."""
    from vn_pointcloudcompletion_tpu_torch.training import trainer

    torch.set_num_threads(1)
    build, prefetch, create = trainer.build_model, trainer.device_prefetch, trainer.create_train_state
    made, grads = [], []

    def created(*a, **k):
        state = create(*a, **k)
        apply = state.apply_gradients

        def logged():  # the (averaged) gradients each update reads
            grads.append({n: p.grad.clone() for n, p in state.model.named_parameters()
                          if p.grad is not None})
            apply()

        state.apply_gradients = logged
        made.append(state)
        return state

    trainer.build_model = lambda cfg: build(cfg).double()
    trainer.device_prefetch = lambda it, dev: (tuple(t.double() for t in b)
                                               for b in prefetch(it, dev))
    trainer.create_train_state = created

    def run(name, mesh):
        config.exp_dir = os.path.join(workdir, name)
        os.makedirs(config.exp_dir, exist_ok=True)
        summary = trainer.train(config, device="cpu", mesh=mesh)
        state = made.pop()
        torch.save({"summary": summary, "step": state.step, "grads": grads[:],
                    "state": {k: t.clone() for k, t in state.model.state_dict().items()}},
                   os.path.join(workdir, f"{name}{rank}.pt"))
        grads.clear()

    mesh = port_mesh.make_mesh(rank, world, init, "cpu", timeout=TIMEOUT)
    try:
        run("mesh", mesh)
    finally:
        port_mesh.destroy_mesh()
    if rank == 0:
        run("one", None)


EPOCH_LR = 1e-10


def test_two_rank_epoch_equals_one_process_epoch(tmp_path):
    """One ``train`` epoch (4 synthetic samples, shuffled, global batch 2,
    so3) on two gloo ranks against the one-process epoch, in float64: the
    same count of steps (2: the ranks split each global batch, they do not
    each take a batch of their own), the two ranks' parameters and buffers
    equal in bits; each update's gradients within 1e-10 of the model's
    largest |g| (as ``test_two_rank_step_equals_single_process_step``);
    the running statistics within 1e-10 of the tensor's max, the parameters
    as well plus what the gradients' gaps move two Adam updates, each at
    most ``lr |dg| / eps``.  ``lr`` is 1e-10, which makes that slope 1e-2:
    at 1e-4 it is 1e4, and the first update's rounding (1e-12 of a
    gradient whose |g| is near eps) moves the second step's parameters by
    up to 1e-7, and its gradients by 3.5e-9 of the model's largest |g|, on
    either side alike."""
    from vn_pointcloudcompletion_tpu_torch.utils.config import Config

    config = Config.from_dict({
        "num_coarse": NUM_COARSE, "latent_dim": 512, "batch_size": 2, "lr": EPOCH_LR,
        "rotation": "so3", "val_rotation": "so3", "dataset": "synthetic", "num_workers": 1,
        "synthetic_n_partial": 256, "synthetic_n_complete": 1024,
        "synthetic_train_samples": 4, "synthetic_val_samples": 2, "seed": 3,
        "max_epochs": 0, "log_frequency": 1})
    spawn(_epoch_rank, 2, config, str(tmp_path))
    load = lambda f: torch.load(tmp_path / f, weights_only=False)  # noqa: E731
    r0, r1, one = load("mesh0.pt"), load("mesh1.pt"), load("one0.pt")
    assert r0["step"] == r1["step"] == one["step"] == len(one["grads"]) == len(r0["grads"]) == 2
    assert r0["summary"] == r1["summary"] and r0["summary"]["epochs_run"] == 1
    assert digest(r0["state"]) == digest(r1["state"])
    moved = {}
    for got, want in zip(r0["grads"], one["grads"]):
        assert got.keys() == want.keys()
        scale = max(float(g.abs().max()) for g in want.values())
        for k in want:
            gap = (got[k] - want[k]).abs()
            assert float(gap.max()) <= 1e-10 * scale, (k, float(gap.max()) / scale)
            moved[k] = moved.get(k, 0) + EPOCH_LR * gap / 1e-8
    assert r0["state"].keys() == one["state"].keys()
    for k, want in one["state"].items():
        assert want.dtype == torch.float64 or "num_batches" in k, k
        if not want.is_floating_point():
            assert torch.equal(r0["state"][k], want), k
            continue
        err = (r0["state"][k] - want).abs()
        bound = 1e-10 * float(want.abs().max()) + moved.get(k, 0)
        assert bool((err <= bound).all()), (k, float(err.max()))


def test_loader_shards_split_each_global_batch():
    """``BatchLoader(shard=(rank, world))``: the ranks' rows of each
    shuffled global batch, in rank order, are the one-process batch, with
    as many batches an epoch; an uneven split is refused."""
    from vn_pointcloudcompletion_tpu_torch.data.pipeline import BatchLoader

    class Rows:
        def __len__(self):
            return 13

        def __getitem__(self, i):
            return np.full((2, 3), i, np.float32), np.full((4, 3), -i, np.float32)

    kw = dict(shuffle=True, seed=5, num_workers=2)
    whole = BatchLoader(Rows(), 4, **kw)
    shards = [BatchLoader(Rows(), 4, shard=(r, 2), **kw) for r in range(2)]
    for loader in (whole, *shards):
        loader.set_epoch(3)
    assert len(whole) == len(shards[0]) == len(shards[1]) == 3
    for want, *got in zip(whole, *shards):
        for j in range(2):
            np.testing.assert_array_equal(np.concatenate([g[j] for g in got]), want[j])
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        BatchLoader(Rows(), 4, shard=(0, 3))
    with pytest.raises(ValueError, match="drops the short last batch"):
        BatchLoader(Rows(), 4, shard=(0, 2), drop_last=False)


@pytest.mark.parametrize("argv,message", [
    (["--device", "cpu", "--mesh", "0"], "--mesh 0 counts the visible cards"),
    (["--mesh", "1"], "--mesh 1: 0 cards visible"),
    (["--device", "cpu", "--mesh", "4"], "must be divisible by the mesh's 'data' axis size 4"),
])
def test_cli_mesh_refusals(workdir, capsys, argv, message):
    """``--mesh`` refuses what it cannot run before a rank starts: 0 on the
    CPU, more cards than are visible (none here), a batch of 2 over 4."""
    from vn_pointcloudcompletion_tpu_torch import __main__ as cli

    if not message.startswith("must") and torch.cuda.device_count():
        pytest.skip("counts the cards of a machine without one")
    try:
        cli.main(["-n", "t", "-epochs", "0", *argv, "overfit"])
    except SystemExit:
        assert message in capsys.readouterr().err
    except ValueError as e:
        assert message in str(e)
    else:
        pytest.fail("not refused")


# ------------------------------------------------------------ data tooling


@pytest.mark.parametrize("count", [1, 2, 3])
def test_shapenet_process_shares_match_jax(tmp_path, count):
    """``ShapeNetPCN(process_index, process_count)`` lists the models JAX's
    lists (strided shares, cut to equal sizes: 7 models over 2 or 3
    processes leave a remainder), and reads them."""
    from tests.datagen import build_mini_pcn
    from vn_pointcloudcompletion_tpu.data.shapenet import ShapeNetPCN as JaxShapeNetPCN
    from vn_pointcloudcompletion_tpu_torch.data.shapenet import ShapeNetPCN

    root = str(tmp_path / "PCN")
    build_mini_pcn(root, splits=("train", "valid"), n_models=7, n_partial=64,
                   n_complete=128)
    for split in ("train", "valid"):
        shares = []
        for index in range(count):
            port = ShapeNetPCN(root, split, process_index=index, process_count=count)
            want = JaxShapeNetPCN(root, split, process_index=index, process_count=count)
            assert port.partial_paths == want.partial_paths
            assert port.complete_paths == want.complete_paths
            assert len(port) == 7 // count
            shares += port.complete_paths
            partial, complete = port[0]
            assert partial.shape == (2048, 3) and complete.shape == (16384, 3)
        assert len(set(shares)) == len(shares) == 7 // count * count


def test_mesh_bench_prints_jax_schema(capsys):
    """``mesh_bench.main(sizes=(1, 2), device="cpu")``: one JSON line with
    the JAX probe's keys, ``platform`` "cpu-gloo", positive rates (one
    2-step chunk a size here)."""
    from vn_pointcloudcompletion_tpu_torch.parallel import mesh_bench

    mesh_bench.main(sizes=(1, 2), iters=1, warmup=0, deadline=DEADLINE_S, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    out = json.loads(lines[-1])
    assert set(out) == {"steps_per_sec", "speedup_vs_1", "global_batch", "platform",
                        "host_cores"}
    assert out["platform"] == "cpu-gloo" and out["global_batch"] == 8
    assert set(out["steps_per_sec"]) == set(out["speedup_vs_1"]) == {"1", "2"}
    assert all(v > 0 for v in out["steps_per_sec"].values())
    assert out["speedup_vs_1"]["1"] == 1.0 and out["host_cores"] == os.cpu_count()


def test_mesh_bench_runs_on_the_cards_unless_asked(monkeypatch):
    """The probe's ranks take one card each unless the caller asks for the
    CPU: sizes beyond the visible cards are refused before a rank starts."""
    from vn_pointcloudcompletion_tpu_torch.parallel import mesh_bench

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(mesh_bench, "_rank_bench", None)  # no rank may start
    with pytest.raises(RuntimeError, match=r"sizes \(1, 2\) need one card a rank; 1 visible"):
        mesh_bench.main(sizes=(1, 2))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match=r"sizes \(\) need one card a rank; 0 visible"):
        mesh_bench.main()


def _needs_compiler():
    from vn_pointcloudcompletion_tpu_torch.data import fastply_binding

    if fastply_binding.compiler() is None:
        pytest.skip("no C++ compiler to build tools/fastply.cpp")
    return fastply_binding


def test_fastply_matches_numpy_reader(tmp_path):
    """JAX ``tests/test_native_tools.py``'s cases on the port's build of
    ``tools/fastply.cpp``: a written cloud read back equal, and
    ``read_ply_points`` counting the reader that ran."""
    from vn_pointcloudcompletion_tpu_torch.data import ply

    fastply = _needs_compiler()
    pts = np.random.default_rng(0).standard_normal((1000, 3)).astype(np.float32)
    p = str(tmp_path / "a.ply")
    ply.write_ply_points(p, pts)
    out = fastply.read_points(p)
    assert out is not None
    np.testing.assert_array_equal(out, pts)
    np.testing.assert_array_equal(out, ply.read_ply_points_numpy(p))
    before = ply.READERS["fastply"]
    np.testing.assert_array_equal(ply.read_ply_points(p), pts)
    assert ply.READERS["fastply"] == before + 1
    assert fastply.library_path().parent == fastply.BUILD_DIR


def test_fastply_extra_properties(tmp_path):
    fastply = _needs_compiler()
    from vn_pointcloudcompletion_tpu_torch.data import ply

    p = str(tmp_path / "b.ply")
    data = np.zeros(7, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                              ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")])
    xyz = np.random.default_rng(1).standard_normal((7, 3)).astype(np.float32)
    data["x"], data["y"], data["z"] = xyz.T
    with open(p, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 7\n"
                b"property float x\nproperty float y\nproperty float z\n"
                b"property float nx\nproperty float ny\nproperty float nz\n"
                b"end_header\n" + data.tobytes())
    np.testing.assert_allclose(fastply.read_points(p), xyz)
    np.testing.assert_array_equal(fastply.read_points(p), ply.read_ply_points_numpy(p))


def test_fastply_corrupt_file_falls_back_to_numpy(tmp_path):
    """The library returns nothing for a file it cannot read; the numpy
    reader takes it (and raises, as JAX's does)."""
    fastply = _needs_compiler()
    from vn_pointcloudcompletion_tpu_torch.data import ply

    p = str(tmp_path / "bad.ply")
    with open(p, "wb") as f:
        f.write(b"not a ply file at all")
    assert fastply.read_points(p) is None
    before = ply.READERS["numpy"]
    with pytest.raises(Exception):
        ply.read_ply_points(p)
    assert ply.READERS["numpy"] == before + 1


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_two_ranks_on_one_card_match_one_process(cuda, tmp_path):
    """``chip_smoke.py`` phase 16b small: two ranks sharing the card over
    gloo (CUDA tensors), the flagship at num_coarse 256 (dense 4096: the
    nine kernels on the path), global batch 8 (4 a rank), through the
    kernels, each rank replaying its rows of the one-process step's
    discrete decisions (``chip_smoke.DecisionTape``: the encoder's split
    BatchNorm sums round otherwise and would flip near-tied argmax pools).
    Both ranks launch every flagship kernel in a step and end the compared
    step with the same bits (metrics, gradients, parameters, buffers,
    Adam's state); rank 0's gradients against the one-process step at
    batch 8 on the same card within 7.5e-4 of each tensor's max and its
    losses rtol 1e-4, the bounds of ``tests/test_torch_port_kernels.py::
    test_cuda_train_step_kernels_match_plain_path`` at this case (the
    float32 sums of the BatchNorm-on-norms variance set the gap, and the
    ranks split kernel S's sums)."""
    import chip_smoke

    model, _, config, partial, complete = chip_smoke.small_step_case(cuda, 8)
    config.batch_size = 8
    m, want, _ = chip_smoke.one_process_step(model, config, partial, complete,
                                             str(tmp_path))
    spawn(chip_smoke.mesh_rank, 2, "cuda:0", config, partial.cpu(), complete.cpu(),
          str(tmp_path), 1)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    for k in ("metrics", "grads", "state", "adam"):
        assert ranks[0][k] == ranks[1][k], k
    for rank in ranks:
        assert all(rank["launches"].get(k) for k in chip_smoke.FLAGSHIP_KERNELS), rank
    got = torch.load(tmp_path / "grads0.pt", weights_only=True)
    for k in ("coarse", "dense"):
        assert got["metrics"][k] == pytest.approx(float(m[k]), rel=1e-4), k
    errs = chip_smoke.rel_errs({k: g.to(cuda) for k, g in got["grads"].items()}, want)
    assert max(errs.values()) <= 7.5e-4, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
