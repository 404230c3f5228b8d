"""The harness: finds a cell's files by name, runs set-up, the measured
window, the traced tail (``--trace 1``) and the check against the reference,
and forms the result line.

Everything that belongs to one cell, configuration, traffic mode or
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives:

- ``port_bench/workloads/<cell>.json``: the cell (its configuration, mode,
  batch, rotation, pool, seed offsets, warm-up and the limits of its
  comparison);
- ``port_bench/configs/<config>.json``: the configuration;
- ``port_bench/modes/<mode>.py``: the loop a mode's window drives;
- ``port_bench/metrics/<metric>.py``: one per-layer metric, ``read(record)``;
- ``port_bench/counts/<config>.py``: the configuration's work from shapes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from port_bench import counts, tracing

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vn_pointcloudcompletion_tpu")
TRACE_STEPS = {"train": 12, "serve": 12}
NOT_MEASURED = "not measured"  # what a run off the card reports for every metric


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str, here: Path = HERE):
    """(BENCHMARK.json's entry, workload file, configuration file) of a cell."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    work = load_json(here / "workloads" / f"{name}.json")
    if work["config"] != entry["config"] or work["traffic"] != entry["traffic"]:
        raise ValueError(f"{name}: the workload file and BENCHMARK.json disagree")
    config = load_json(here / "configs" / f"{entry['config']}.json")
    return entry, work, config


def readers(here: Path = HERE) -> dict:
    """Every per-layer metric's reader, by file name (``<metric>.py``)."""
    out = {}
    for path in sorted((here / "metrics").glob("*.py")):
        if path.name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod.read
    return out


def cell_metrics(bench: dict, name: str, kind: str) -> list:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that cell
    ``name`` reports."""
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end":
            out.append(m)
        else:  # no list: every cell that reports the metric it moves
            moved = [e for e in cell_metrics(bench, name, "end_to_end") if e["name"] == m["moves"]]
            if moved:
                out.append(m)
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(name: str, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, root: Path = ROOT, here: Path = HERE,
        overrides: Optional[dict] = None) -> dict:
    """One run of a cell; returns the result object (the line's keys, in order)."""
    bench = benchmark(root)
    entry, work, config = cell(bench, name, here)
    if overrides:
        config = {**config, **overrides.get("config", {})}
        work = {**work, **overrides.get("work", {})}
    cuda = device.type == "cuda"
    mode = importlib.import_module(f"port_bench.modes.{work['mode']}")
    tracing.stamp("the program's modules")
    sut = mode.setup(config, work, seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"[setup] setup_s {setup_s:.3f} s", file=sys.stderr)
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    win = sut.window(seconds)
    print(f"[window] {win['steps']} steps, {win['window_s']:.6f} s on the host clock",
          file=sys.stderr)
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    record = {"mode": work["mode"], "window": win, "peak_window_bytes": peak_window if cuda else None,
              "work": counts.step(config, work["mode"], work["batch"]), "trace": None,
              "device": device.type}
    if trace:
        from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib

        cuda_lib.reset_launch_counts()
        record["trace"] = tracing.trace(sut.step, TRACE_STEPS[work["mode"]], device)
        steps = record["trace"]["steps"]
        launches = {k: v / steps for k, v in cuda_lib.launch_counts().items() if v}
        designs = {k: v / steps for k, v in cuda_lib.variant_counts().items()}
        print(f"[launches a step] {json.dumps(launches)}", file=sys.stderr)
        print(f"[launches a step by design] {json.dumps(designs)}", file=sys.stderr)
        print(f"[trace] {json.dumps({k: v for k, v in record['trace'].items() if k not in ('device_ops', 'idle_gaps')})}",
              file=sys.stderr)
    sut.release()
    t_check = time.perf_counter()
    readings = sut.readings()
    print(f"[readings] {json.dumps(readings)}", file=sys.stderr)
    print(f"[check] the reference took {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    limits = work["limits"]
    compared = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    correct = all(v["value"] <= v["limit"] for v in compared.values()) and win["steps"] > 0
    if trace:
        metrics = {}
        for m in cell_metrics(bench, name, "per_layer"):
            value = readers(here)[m["name"]](record)
            if value is None and not cuda:
                value = NOT_MEASURED
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {}
        for m in cell_metrics(bench, name, "end_to_end"):
            value = setup_s if m["name"] == "setup_s" else win["e2e"][m["name"]]
            if not cuda:
                value = NOT_MEASURED
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": max(peak_setup, peak_window)}
    if trace:
        dev["busy_s"] = record["trace"]["busy_s"]
        dev["window_s"] = record["trace"]["window_s"]
    result = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                               "idle_gaps": record["trace"]["idle_gaps"]}
    result["compared"] = compared
    return result
