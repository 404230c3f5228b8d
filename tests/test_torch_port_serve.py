"""The port's serving surface on the CPU: CLI ``predict`` and ``test``,
checkpoints, data loading, and the rule that the port never imports JAX."""

import ast
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from vn_pointcloudcompletion_tpu_torch import __main__ as cli
from vn_pointcloudcompletion_tpu_torch.data.pipeline import BatchLoader, device_prefetch
from vn_pointcloudcompletion_tpu_torch.data.ply import read_ply_points, write_ply_points
from vn_pointcloudcompletion_tpu_torch.data.shapenet import ShapeNetPCN
from vn_pointcloudcompletion_tpu_torch.data.synthetic import SyntheticCompletionDataset
from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
from vn_pointcloudcompletion_tpu_torch.training import predict as predict_mod
from vn_pointcloudcompletion_tpu_torch.training.checkpoint import load_model, save_model
from vn_pointcloudcompletion_tpu_torch.utils.config import Config, load_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def experiment(tmp_path, monkeypatch):
    """A tiny experiment dir (test_cli-style config, dense 1024 points) with
    a checkpoint written by the port."""
    cfg = {
        "name": "port_smoke", "enc_type": "vn_pointnet",
        "dec_type": "vn_foldingnet", "num_coarse": 64, "latent_dim": 2048,
        "only_coarse": False, "batch_size": 2, "rotation": "none",
        "val_rotation": "none", "test_rotation": "so3", "dataset": "synthetic",
        "num_workers": 1, "synthetic_test_samples": 3,
        "synthetic_n_partial": 512, "synthetic_n_complete": 2048, "seed": 1,
    }
    out = tmp_path / "experiments"
    exp_dir = out / "run_000"
    (exp_dir / "models").mkdir(parents=True)
    cfg["exp_dir"] = str(exp_dir)
    (exp_dir / "config.json").write_text(json.dumps(cfg))
    monkeypatch.setenv("OUTPUT_DIR", str(out))
    config = load_config("run_000")
    save_model(str(exp_dir), build_model(config), "best")
    return config


def test_cli_predict_end_to_end(experiment, tmp_path):
    in_dir = tmp_path / "raw"
    in_dir.mkdir()
    rng = np.random.default_rng(0)
    for i, n in enumerate((700, 3000)):  # one short cloud, one long
        write_ply_points(str(in_dir / f"scan{i}.ply"),
                         rng.standard_normal((n, 3)).astype(np.float32) * 0.2)
    (in_dir / "notes.txt").write_text("not a cloud")
    out_dir = tmp_path / "pred"
    written = cli.main(["-n", "run_000", "--resume", "--device", "cpu", "predict",
                        "-i", str(in_dir), "-o", str(out_dir), "--save"])
    assert sorted(os.listdir(out_dir)) == [
        "scan0_coarse.ply", "scan0_completion.ply",
        "scan1_coarse.ply", "scan1_completion.ply"]
    assert written == [str(out_dir / "scan0_completion.ply"),
                       str(out_dir / "scan1_completion.ply")]
    fine = read_ply_points(written[0])
    coarse = read_ply_points(str(out_dir / "scan0_coarse.ply"))
    assert fine.shape == (1024, 3) and coarse.shape == (64, 3)
    assert np.isfinite(fine).all()
    assert (Path(experiment.exp_dir) / "predict.log").exists()

    # the same cloud alone gives the same completion: padding rows are dropped
    alone = predict_mod.predict(experiment, str(in_dir / "scan0.ply"),
                                str(tmp_path / "alone"), device="cpu")
    np.testing.assert_allclose(read_ply_points(alone[0]), fine, atol=1e-6)


def test_cli_test_end_to_end(experiment, capsys):
    res = cli.main(["-n", "run_000", "--resume", "--device", "cpu", "test"])
    assert set(res) == {"synthetic", "average"}
    row = res["synthetic"]
    assert set(row) == {"l1", "l2", "f", "iou"}
    assert all(np.isfinite(v) for v in row.values())
    assert 0 < row["l1"] < 1 and 0 <= row["f"] <= 1 and 0 < row["iou"] <= 1
    printed = capsys.readouterr().out
    assert "L1_CD(1e-3)" in printed and "average" in printed


def test_metric_step_matches_jax_metrics(experiment):
    import jax.numpy as jnp

    from vn_pointcloudcompletion_tpu.metrics import metrics as jax_metrics
    from vn_pointcloudcompletion_tpu_torch.training.evaluate import metric_step

    model = build_model(experiment).eval()
    ds = SyntheticCompletionDataset(2, seed=4, n_partial=512, n_complete=2048)
    p = np.stack([ds[i][0] for i in range(2)])
    c = np.stack([ds[i][1] for i in range(2)])
    out, pred = metric_step(model, torch.from_numpy(p), torch.from_numpy(c), None)
    pj, cj = jnp.asarray(pred.numpy()), jnp.asarray(c)
    np.testing.assert_allclose(out["l1"].sum().item(),
                               float(jax_metrics.l1_cd(pj, cj)), rtol=1e-5)
    np.testing.assert_allclose(out["l2"].sum().item(),
                               float(jax_metrics.l2_cd(pj, cj)), rtol=1e-5)
    np.testing.assert_allclose(out["f"].numpy(),
                               np.asarray(jax_metrics.f_score(pj, cj)), atol=1e-6)


def test_cli_test_with_emd(experiment, capsys):
    """``--emd`` adds the per-point EMD column (x1e3): the dense 1024 points
    against the first 1024 of the ground truth."""
    res = cli.main(["-n", "run_000", "--resume", "--device", "cpu", "--emd", "test"])
    assert set(res["synthetic"]) == {"l1", "l2", "f", "iou", "emd"}
    assert 0 < res["synthetic"]["emd"] < 1 and res["average"]["emd"] == res["synthetic"]["emd"]
    printed = capsys.readouterr().out
    assert "EMD(1e-3)" in printed
    assert f"{res['average']['emd'] * 1e3:12.4f}" in printed


def test_cli_rejects_missing_flags(experiment):
    with pytest.raises(SystemExit):
        cli.main(["-n", "run_000", "--device", "cpu", "test"])
    with pytest.raises(SystemExit):
        cli.main(["-n", "run_000", "--resume", "--device", "cpu", "predict"])


def test_cuda_without_a_card_raises(experiment, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        predict_mod.predict(experiment, str(tmp_path), str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["-n", "run_000", "--resume", "test"])


def test_checkpoint_round_trip_and_reference_counters(tmp_path):
    cfg = Config.from_dict({"num_coarse": 64, "seed": 2})
    model = build_model(cfg)
    path = save_model(str(tmp_path), model, "last")
    assert path.endswith(os.path.join("models", "model_last.pth"))
    sd = torch.load(path, weights_only=True)
    # a reference checkpoint also carries BatchNorm step counters
    sd["encoder.first_conv.0.batchnorm.bn.num_batches_tracked"] = torch.tensor(3)
    torch.save(sd, path)
    other = build_model(cfg.replace(seed=9))
    assert load_model(str(tmp_path), other) == path
    for k, v in model.state_dict().items():
        assert torch.equal(v, other.state_dict()[k]), k
    with pytest.raises(FileNotFoundError):
        load_model(str(tmp_path / "nowhere"), other)


def test_port_checkpoint_loads_into_jax_encoder(tmp_path):
    from vn_pointcloudcompletion_tpu.training import torch_interop

    model = build_model(Config.from_dict({"num_coarse": 64, "only_coarse": True}))
    path = save_model(str(tmp_path), model, "best")
    sd = torch_interop.load_torch_state_dict(path)
    enc_p, enc_s = torch_interop.encoder_variables_from_torch(sd, "vn_pointnet")
    np.testing.assert_array_equal(
        enc_p["trunk"]["maxpool2"]["dir_kernel"],
        model.state_dict()["encoder.maxpool2.map_to_dir.weight"].numpy())


def test_ply_matches_jax_reader(tmp_path):
    from vn_pointcloudcompletion_tpu.data.ply import read_ply_points as jax_read

    pts = np.random.default_rng(1).standard_normal((50, 3)).astype(np.float32)
    write_ply_points(str(tmp_path / "a.ply"), pts)
    np.testing.assert_array_equal(read_ply_points(str(tmp_path / "a.ply")), pts)
    ascii_ply = ("ply\nformat ascii 1.0\nelement vertex 2\nproperty double x\n"
                 "property double y\nproperty double z\nproperty uchar red\n"
                 "end_header\n1 2 3 255\n4 5 6 0\n")
    (tmp_path / "b.ply").write_text(ascii_ply)
    got = read_ply_points(str(tmp_path / "b.ply"))
    np.testing.assert_array_equal(got, jax_read(str(tmp_path / "b.ply")))
    np.testing.assert_array_equal(got, [[1, 2, 3], [4, 5, 6]])


def test_synthetic_dataset_matches_jax():
    from vn_pointcloudcompletion_tpu.data.synthetic import (
        SyntheticCompletionDataset as JaxSynthetic,
    )

    ours = SyntheticCompletionDataset(3, seed=7, n_partial=100, n_complete=300)
    theirs = JaxSynthetic(3, seed=7, n_partial=100, n_complete=300)
    for i in range(3):
        for a, b in zip(ours[i], theirs[i]):
            np.testing.assert_array_equal(a, b)


def test_shapenet_reader_and_loader(tmp_path):
    root = tmp_path / "PCN"
    rng = np.random.default_rng(2)
    lines = []
    for k, cat in enumerate(("02691156", "03001627")):
        mid = f"m{k}"
        lines.append(f"{cat}/{mid}")
        for kind, n in (("partial", 1000), ("complete", 20000)):
            d = root / "test" / kind / cat
            d.mkdir(parents=True, exist_ok=True)
            write_ply_points(str(d / f"{mid}.ply"), rng.standard_normal((n, 3)))
    (root / "test.list").write_text("\n".join(lines) + "\n")
    ds = ShapeNetPCN(str(root), "test")
    assert len(ds) == 2 and len(ShapeNetPCN(str(root), "test", "chair")) == 1
    p, c = ds[0]
    assert p.shape == (2048, 3) and c.shape == (16384, 3)
    np.testing.assert_array_equal(ds[0][0], p)  # per-index sampling stream
    loader = BatchLoader(ds, 3, num_workers=2, drop_last=False)
    batches = list(device_prefetch(loader, torch.device("cpu")))
    assert len(batches) == 1 and batches[0][0].shape == (2, 2048, 3)
    assert isinstance(batches[0][0], torch.Tensor)
    np.testing.assert_array_equal(batches[0][0][0].numpy(), p)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    files = sorted((REPO / "vn_pointcloudcompletion_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {f"vn_pointcloudcompletion_tpu_torch/{m}.py" for m in (
        "training/steps", "training/state", "training/trainer", "training/checkpoint",
        "utils/experiments", "metrics/losses", "ops/chamfer", "ops/vn_layer_fused",
        "ops/knn", "ops/knn_pallas", "ops/fps", "ops/fps_pallas", "models/dgcnn",
        "models/common", "nn/precision",
    )} <= names
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "vn_pointcloudcompletion_tpu"), f"{f}: imports {mod}"
