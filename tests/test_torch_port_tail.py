"""The port's last numpy-side modules against the JAX package on the CPU.

- ``data/render.py`` against JAX's ``data/render.py``: the same points in
  the same order (equal arrays), the camera equal to the bit, and the
  render entry's files byte for byte the files of JAX's points.
- ``utils/obj_io.py``: vertices and faces equal, OBJ files byte-identical.
- ``visualization/``: the same PNG bytes as JAX's ``plot_pcd_one_view``.
- The trainer's per-epoch figure: JAX's (batch, sample) draws epoch by
  epoch, the clouds of that batch's ``eval_step``, JAX's PNG bytes
  (JAX's own ``_save_epoch_png`` on the same clouds); a 2-rank gloo
  ``--mesh`` run against one process; without matplotlib, one warning and
  the same draws.

Every input comes from a numpy seed.  The JAX package is imported inside
the tests: the spawned ranks of the ``--mesh`` test import this module.
"""

import json
import os
import shutil
import sys
import types
import zlib
from datetime import timedelta

import numpy as np
import pytest
import torch

from vn_pointcloudcompletion_tpu_torch import __main__ as cli
from vn_pointcloudcompletion_tpu_torch.data import render
from vn_pointcloudcompletion_tpu_torch.metrics.metrics import points_to_voxels
from vn_pointcloudcompletion_tpu_torch.parallel import mesh as port_mesh
from vn_pointcloudcompletion_tpu_torch.training import trainer
from vn_pointcloudcompletion_tpu_torch.utils import obj_io
from vn_pointcloudcompletion_tpu_torch.visualization import visualization as vis

MESH_TIMEOUT = timedelta(seconds=60)  # every collective of a rank


@pytest.fixture(autouse=True)
def _drop_tmp(tmp_path):
    """Remove each test's files (checkpoint pairs of ~100-500 MB) when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules the port is held against."""
    from vn_pointcloudcompletion_tpu import visualization
    from vn_pointcloudcompletion_tpu.data import ply, render
    from vn_pointcloudcompletion_tpu.training.trainer import _save_epoch_png
    from vn_pointcloudcompletion_tpu.utils import obj_io

    return types.SimpleNamespace(render=render, ply=ply, obj_io=obj_io, vis=visualization,
                                 save_epoch_png=_save_epoch_png)

# ------------------------------------------------------------ render


def _mesh_sample(n: int, seed: int) -> np.ndarray:
    """An area-weighted surface sample of a ``tools/gen_shapes.py`` chair."""
    from tools.gen_shapes import generate

    v, f = generate("chair", seed)
    tri = v[f]
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(f), n, p=area / area.sum())
    r1, r2 = rng.random((2, n))
    s = np.sqrt(r1)
    pts = ((1 - s)[:, None] * tri[idx, 0] + (s * (1 - r2))[:, None] * tri[idx, 1]
           + (s * r2)[:, None] * tri[idx, 2])
    return pts.astype(np.float32)


def _cloud(kind: str, n: int = 16384, seed: int = 0) -> np.ndarray:
    if kind == "mesh":
        return _mesh_sample(n, seed)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = 0.3 if kind == "sphere" else rng.uniform(0.25, 0.35, (n, 1))
    return (v * r).astype(np.float32)


@pytest.mark.parametrize("kind", ["sphere", "shell", "mesh"])
def test_generate_partials_are_jax_points_in_order(ref, kind):
    """8 views of a 16384-point cloud: each partial the JAX partial's
    points in the JAX partial's order (equal arrays); one view through
    ``render_partial`` too."""
    pts = _cloud(kind)
    want = ref.render.generate_partials(pts, n_views=8, seed=4)
    got = render.generate_partials(pts, n_views=8, seed=4, device="cpu")
    assert len(got) == 8
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and 100 < len(w) < len(pts)
        np.testing.assert_array_equal(g.numpy(), w)
    eye = np.array([0.4, -1.1, 0.7])
    np.testing.assert_array_equal(render.render_partial(pts, eye, device="cpu").numpy(),
                                  ref.render.render_partial(pts, eye))


def test_camera_equals_jax(ref):
    """``look_at`` (eyes around the sphere; the near-vertical ones take the
    other up vector), one eye and batched, and ``sample_camera_poses``:
    JAX's, to the bit."""
    rng = np.random.default_rng(5)
    eyes = np.concatenate([rng.standard_normal((16, 3)) * rng.uniform(0.1, 5, (16, 1)),
                           [[0.0, 0.0, 2.0], [1e-4, 0.0, -3.0]]])
    want = np.stack([ref.render.look_at(e, np.zeros(3)) for e in eyes])
    np.testing.assert_array_equal(render.look_at(torch.from_numpy(eyes), torch.zeros(3)).numpy(),
                                  want)
    np.testing.assert_array_equal(render.look_at(eyes[3], np.zeros(3)).numpy(), want[3])
    np.testing.assert_array_equal(
        render.sample_camera_poses(8, np.float32(0.9), np.random.default_rng(3)).numpy(),
        ref.render.sample_camera_poses(8, np.float32(0.9), np.random.default_rng(3)))


def test_render_entry_writes_jax_files(ref, tmp_path):
    """``python -m ...data.render <root> --split train|valid --device cpu``
    on a 3-model tree: the files JAX's ``generate_partials`` and
    ``write_ply_points`` make of the same clouds with
    ``tools/render_partials.py``'s seed per model, byte for byte."""
    models = {("02691156", "a1"): "sphere", ("02691156", "b2"): "mesh",
              ("03001627", "c3"): "shell"}
    for split in ("train", "valid"):
        for (cat, model), kind in models.items():
            os.makedirs(tmp_path / split / "complete" / cat, exist_ok=True)
            ref.ply.write_ply_points(str(tmp_path / split / "complete" / cat / f"{model}.ply"),
                                     _cloud(kind, 4096, seed=len(model) + ord(model[0])))
        assert render.main([str(tmp_path), "--split", split, "--seed", "2",
                            "--device", "cpu"]) == 3
    for split in ("train", "valid"):
        for (cat, model) in models:
            complete = ref.ply.read_ply_points(
                str(tmp_path / split / "complete" / cat / f"{model}.ply"))
            seed = 2 + zlib.crc32(f"{cat}/{model}".encode()) % (2**31)
            parts = ref.render.generate_partials(complete, n_views=8, seed=seed)
            names = ([f"{model}_{k}.ply" for k in range(8)] if split == "train"
                     else [f"{model}.ply"])
            for name, part in zip(names, parts):
                expected = tmp_path / "expected.ply"
                ref.ply.write_ply_points(str(expected), part)
                got = tmp_path / split / "partial" / cat / name
                assert got.read_bytes() == expected.read_bytes(), (split, cat, name)
        listed = sorted(os.listdir(tmp_path / split / "partial" / "02691156"))
        assert len(listed) == (16 if split == "train" else 2)


# ------------------------------------------------------------ obj_io


_GRIDS = ("random", "dense random", "solid block", "empty", "points_to_voxels 64")


def _grids():
    rng = np.random.default_rng(6)
    block = np.zeros((9, 10, 11))
    block[1:7, 2:9, 0:11] = 1.0
    cloud = torch.from_numpy(rng.standard_normal((2048, 3)).astype(np.float32))
    return {"random": rng.random((12, 9, 10)), "dense random": rng.random((8, 8, 8)) * 0.45,
            "solid block": block, "empty": np.zeros((5, 5, 5)),
            "points_to_voxels 64": points_to_voxels(cloud).numpy()}


@pytest.mark.parametrize("surface_view", [True, False])
@pytest.mark.parametrize("grid", _GRIDS)
def test_obj_export_equals_jax(ref, grid, surface_view, tmp_path):
    """``voxel2mesh`` against JAX's: vertices and faces equal (float64 and
    int64), and ``voxel2obj``'s file byte for byte JAX's."""
    g = _grids()[grid]
    want_v, want_f = ref.obj_io.voxel2mesh(g, surface_view)
    got_v, got_f = obj_io.voxel2mesh(torch.from_numpy(g), surface_view)
    assert got_v.dtype == torch.float64 and got_f.dtype == torch.int64
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    obj_io.voxel2obj(str(tmp_path / "port.obj"), torch.from_numpy(g), surface_view)
    ref.obj_io.voxel2obj(str(tmp_path / "jax.obj"), g, surface_view)
    assert (tmp_path / "port.obj").read_bytes() == (tmp_path / "jax.obj").read_bytes()
    if grid == "solid block" and surface_view:  # the enclosed voxels are dropped
        assert 0 < len(got_f) < 12 * int((g > 0.3).sum())


# ------------------------------------------------------------ visualization


@pytest.mark.parametrize("panels", [3, 4])
def test_plot_pcd_one_view_writes_jax_png(ref, panels, tmp_path):
    """The same figure as JAX's, byte for byte, from tensors on the port's
    side and numpy arrays on JAX's (one matplotlib, one process)."""
    rng = np.random.default_rng(panels)
    clouds = [(rng.standard_normal((n, 3)) * 0.2).astype(np.float32)
              for n in (256, 128, 1024, 1024)[:panels]]
    titles = ["Input", "Coarse", "Dense", "Ground Truth"][:panels]
    kw = dict(xlim=(-0.35, 0.35), ylim=(-0.35, 0.35), zlim=(-0.35, 0.35))
    if panels == 3:
        kw.update(suptitle="epoch 3", sizes=[0.5, 1.0, 0.25])
    vis.plot_pcd_one_view(str(tmp_path / "port.png"), [torch.from_numpy(c) for c in clouds],
                          titles, **kw)
    ref.vis.plot_pcd_one_view(str(tmp_path / "jax.png"), clouds, titles, **kw)
    png = (tmp_path / "port.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and png == (tmp_path / "jax.png").read_bytes()


# ------------------------------------------------------------ the trainer's figure


def _cli_recipe(tmp_path, monkeypatch, **extra):
    """``tests/test_cli.py``'s synthetic recipe, 7 validation samples (batches
    of 2, 2, 2 and 1)."""
    cfg = {"name": "cli_smoke", "enc_type": "vn_pointnet", "dec_type": "vn_foldingnet",
           "num_coarse": 1024, "latent_dim": 2048, "only_coarse": True, "batch_size": 2,
           "lr": 1e-3, "rotation": "none", "val_rotation": "none", "test_rotation": "none",
           "dataset": "synthetic", "num_workers": 1, "coarse_loss": "cd", "category": "all",
           "log_frequency": 1, "synthetic_train_samples": 4, "synthetic_val_samples": 7,
           "synthetic_test_samples": 2, "synthetic_n_partial": 512,
           "synthetic_n_complete": 2048, **extra}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "out"))
    return cfg


def _spy(monkeypatch):
    """Record the trainer's validation clouds (each ``eval_step``) and
    figures (each ``plot_pcd_one_view``, which still writes)."""
    seen = {"clouds": [], "plots": []}
    evaluate, plot = trainer.eval_step, trainer.plot_pcd_one_view

    def eval_step(*a, **k):
        out, clouds = evaluate(*a, **k)
        seen["clouds"].append([None if c is None else c.clone() for c in clouds])
        return out, clouds

    def plot_pcd_one_view(path, pcds, titles, **kw):
        seen["plots"].append((path, [c.clone() for c in pcds], titles))
        return plot(path, pcds, titles, **kw)

    monkeypatch.setattr(trainer, "eval_step", eval_step)
    monkeypatch.setattr(trainer, "plot_pcd_one_view", plot_pcd_one_view)
    return seen


def _jax_figures(ref, monkeypatch, out_dir, batches, val_batches: int, only_coarse: bool,
                 epochs):
    """JAX's draws and figures over ``epochs`` from ``batches`` (the port's
    validation clouds, in order): ``rand_iter`` as JAX's trainer draws it
    (``trainer.py:249``), then JAX's own ``_save_epoch_png`` on that batch.
    Returns (batch drawn, the clouds JAX plots, its PNG path) per epoch."""
    rng = np.random.default_rng(0 + 17)  # the recipe's seed, 0
    plotted = []
    real = ref.vis.plot_pcd_one_view
    monkeypatch.setattr(ref.vis, "plot_pcd_one_view",
                        lambda path, pcds, *a, **k: plotted.append(pcds) or real(
                            path, pcds, *a, **k))
    out = []
    for j, epoch in enumerate(epochs):
        rand_iter = int(rng.integers(0, val_batches))
        clouds = tuple(None if c is None else c.numpy()
                       for c in batches[j * val_batches + rand_iter])
        ref.save_epoch_png(str(out_dir), epoch, clouds,
                           types.SimpleNamespace(only_coarse=only_coarse), rng)
        out.append((rand_iter, plotted[-1], os.path.join(out_dir, f"epoch_{epoch:03d}.png")))
    return out


@pytest.mark.parametrize("case", ["coarse", "dense"])
def test_epoch_figure_draws_jax_sample(ref, case, tmp_path, monkeypatch):
    """3 epochs of ``train`` on the recipe of ``tests/test_cli.py`` (the
    dense case: ``only_coarse`` off at 64 coarse points, so3 validation):
    each epoch's figure shows the (batch, sample) JAX's sequence draws
    (``np.random.default_rng(seed + 17)``, ``trainer.py:187,249,351``; the
    last batch of one sample included), its clouds are that batch's
    ``eval_step`` clouds, its PNG is JAX's ``_save_epoch_png``'s byte for
    byte.  The coarse case then resumes for one epoch, which draws from a
    new sequence, as JAX's resumed run does."""
    extra = ({} if case == "coarse" else
             {"only_coarse": False, "num_coarse": 64, "val_rotation": "so3"})
    cfg = _cli_recipe(tmp_path, monkeypatch, **extra)
    seen = _spy(monkeypatch)
    cli.main(["-n", "cli_smoke", "-epochs", "2", "--device", "cpu", "train"])
    (run,) = os.listdir(tmp_path / "out")
    vis_dir = tmp_path / "out" / run / "visualizations"
    assert sorted(os.listdir(vis_dir)) == [f"epoch_{e:03d}.png" for e in range(3)]
    assert len(seen["clouds"]) == 3 * 4 and len(seen["plots"]) == 3
    (tmp_path / "jax").mkdir()
    want = _jax_figures(ref, monkeypatch, tmp_path / "jax", seen["clouds"], 4, cfg["only_coarse"],
                        range(3))
    titles = (["Input", "Coarse", "Ground Truth"] if cfg["only_coarse"]
              else ["Input", "Coarse", "Dense", "Ground Truth"])
    for (path, pcds, got_titles), (_, jax_pcds, jax_png) in zip(seen["plots"], want):
        assert got_titles == titles
        assert len(pcds) == len(jax_pcds) == len(titles)
        for got, w in zip(pcds, jax_pcds):
            np.testing.assert_array_equal(got.numpy(), w)
        assert open(path, "rb").read() == open(jax_png, "rb").read()
    assert len({r for r, _, _ in want}) > 1  # more than one batch drawn over the run
    if case == "coarse":
        n = len(seen["clouds"])
        cli.main(["-n", run, "--resume", "-epochs", "3", "--device", "cpu", "train"])
        (rand_iter, jax_pcds, _), = _jax_figures(ref, monkeypatch, tmp_path / "jax", seen["clouds"][n:],
                                                 4, True, [3])
        for got, w in zip(seen["plots"][-1][1], jax_pcds):
            np.testing.assert_array_equal(got.numpy(), w)
        assert os.path.exists(vis_dir / "epoch_003.png")


def test_epoch_figure_without_matplotlib(tmp_path, monkeypatch):
    """matplotlib missing: the run finishes, logs one warning naming it,
    writes no PNG, and makes JAX's draws (the figure's generator ends in
    the state of JAX's after two draws an epoch)."""
    _cli_recipe(tmp_path, monkeypatch)
    figures = []
    made = trainer._EpochFigure
    monkeypatch.setattr(trainer, "_EpochFigure",
                        lambda *a: figures.append(made(*a)) or figures[-1])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    summary = cli.main(["-n", "cli_smoke", "-epochs", "2", "--device", "cpu", "train"])
    assert summary["epochs_run"] == 3
    (run,) = os.listdir(tmp_path / "out")
    assert not os.listdir(tmp_path / "out" / run / "visualizations")
    log = (tmp_path / "out" / run / "train.log").read_text()
    assert log.count("matplotlib is not installed") == 1
    rng = np.random.default_rng(17)
    for _ in range(3):
        rand_iter = rng.integers(0, 4)
        rng.integers(0, 1 if rand_iter == 3 else 2)
    assert figures[0].rng.bit_generator.state == rng.bit_generator.state


def _mesh_config():
    from vn_pointcloudcompletion_tpu_torch.utils.config import Config

    # seed 0: the sample of epoch 0 is global row 1 (rank 1's), of epoch 1
    # row 0 (rank 0's)
    return Config.from_dict({
        "num_coarse": 64, "latent_dim": 512, "batch_size": 2, "lr": 1e-10, "rotation": "so3",
        "val_rotation": "so3", "dataset": "synthetic", "num_workers": 1,
        "synthetic_n_partial": 256, "synthetic_n_complete": 1024,
        "synthetic_train_samples": 2, "synthetic_val_samples": 4, "seed": 0,
        "max_epochs": 1, "log_frequency": 1})


def _figure_run(config, workdir: str, name: str, mesh) -> None:
    """``train`` in float64 (the model and the staged batches cast up),
    recording each figure's clouds and the figure's generator's final state
    into ``workdir/<name>.pt``."""
    build, prefetch = trainer.build_model, trainer.device_prefetch
    made, plots = [], []
    figure = trainer._EpochFigure
    trainer.build_model = lambda cfg: build(cfg).double()
    trainer.device_prefetch = lambda it, dev: (tuple(t.double() for t in b)
                                               for b in prefetch(it, dev))
    trainer._EpochFigure = lambda *a: made.append(figure(*a)) or made[-1]
    trainer.plot_pcd_one_view = lambda path, pcds, titles, **kw: plots.append(
        [c.clone() for c in pcds])
    config.exp_dir = os.path.join(workdir, name)
    os.makedirs(config.exp_dir, exist_ok=True)
    trainer.train(config, device="cpu", mesh=mesh)
    torch.save({"plots": plots, "rng": made[0].rng.bit_generator.state},
               os.path.join(workdir, f"{name}.pt"))


def _figure_rank(rank, world, init, config, workdir):
    torch.set_num_threads(1)  # the two ranks share the host's cores
    mesh = port_mesh.make_mesh(rank, world, init, "cpu", timeout=MESH_TIMEOUT)
    try:
        _figure_run(config, workdir, f"mesh{rank}", mesh)
    finally:
        port_mesh.destroy_mesh()


def test_epoch_figure_under_a_two_rank_mesh(tmp_path, monkeypatch):
    """2 epochs on 2 gloo ranks (global batch 2, 2 validation batches) in
    float64 against one process: every rank makes the draws of one
    process (the generators end in one state), rank 0 alone plots, and it
    plots the sample one process plots, in epoch 0 from rank 1's rows
    (broadcast to rank 0), in epoch 1 from its own: within 1e-12 of the
    largest coordinate (the ranks' BatchNorm sums round otherwise)."""
    config = _mesh_config()
    rng = np.random.default_rng(config.seed + 17)
    owners = []
    for _ in range(2):
        rng.integers(0, 2)
        owners.append(int(rng.integers(0, 2)))
    assert owners == [1, 0]
    port_mesh.spawn_ranks(_figure_rank, 2, config, str(tmp_path), deadline=150.0)
    for name in ("build_model", "device_prefetch", "_EpochFigure", "plot_pcd_one_view"):
        monkeypatch.setattr(trainer, name, getattr(trainer, name))  # restored after
    _figure_run(_mesh_config(), str(tmp_path), "one", None)
    load = lambda f: torch.load(tmp_path / f, weights_only=False)  # noqa: E731
    r0, r1, one = load("mesh0.pt"), load("mesh1.pt"), load("one.pt")
    assert r0["rng"] == r1["rng"] == one["rng"]
    assert r1["plots"] == [] and len(r0["plots"]) == len(one["plots"]) == 2
    for got, want in zip(r0["plots"], one["plots"]):
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max())
