"""The harness finds every cell, configuration and per-layer metric of
BENCHMARK.json by its file, and picks up a new cell and a new metric that
are only new files and entries."""

import json
import shutil
import sys
import time

from port_bench import harness
from port_bench.tests._tiny import CPU, FLAGSHIP, SEED


def test_every_entry_has_its_files():
    bench = harness.benchmark()
    readers = harness.readers()
    for m in bench["per_layer"]:
        assert m["name"] in readers, m["name"]
    for w in bench["workloads"]:
        entry, work, config = harness.cell(bench, w["name"])
        assert work["chips"] == entry["chips"] == 1
        assert (harness.HERE / "modes" / f"{work['mode']}.py").exists()
        assert set(work["limits"]) and all(v > 0 for v in work["limits"].values())
        assert config["name"] == entry["config"]
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).exists()
    assert bench["paths"] == ["port_bench"]


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(bench, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.cell_metrics(bench, w["name"], "per_layer")
        assert layer and all(m["moves"] in e2e for m in layer)


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = harness.benchmark()
    work = json.loads((harness.HERE / "workloads" / "flagship-train-b8.json").read_text())
    work["traffic"] = "train_b2_norot"
    work["batch"] = 2
    (root / "port_bench" / "workloads" / "flagship-train-b2.json").write_text(json.dumps(work))
    (root / "port_bench" / "metrics" / "steps_seen.py").write_text(
        "def read(record):\n    return float(record['window']['steps'])\n")
    bench["workloads"].append({"name": "flagship-train-b2", "config": "flagship",
                               "traffic": "train_b2_norot", "chips": 1, "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("flagship-train-b2")
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "train step",
                               "moves": "train_samples_per_s", "workloads": ["flagship-train-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert "steps_seen" in harness.readers(root / "port_bench")
    new = harness.benchmark(root)
    assert harness.cell(new, "flagship-train-b2", root / "port_bench")[1]["batch"] == 2
    layer = [m["name"] for m in harness.cell_metrics(new, "flagship-train-b2", "per_layer")]
    assert layer == ["steps_seen"]
    tiny = {"config": FLAGSHIP["config"], "work": {"pool": 3, "warmup": 0}}
    result = harness.run("flagship-train-b2", SEED, 0.5, True, CPU, time.perf_counter(),
                         root=root, here=root / "port_bench", overrides=tiny)
    assert result["metrics"]["steps_seen"]["value"] >= 1
    assert result["attempted"] % 2 == 0
    sys.modules.pop("port_bench.metrics.steps_seen", None)
