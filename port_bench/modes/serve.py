"""Serve mode: a closed loop with one batch in flight, as the program's
``test`` runs: stage the batch's host arrays (``data/pipeline.py::
stage_batch``), run ``training/evaluate.py::metric_step`` (rotation, eval
forward, Chamfer, F-score, IoU) and read the batch's metrics on the host.

A batch's latency runs from the hand-over of its host arrays to staging
until its metrics are on the host.  The outputs of ``check_batches``
batches (the workload's), drawn from the seed among the window's first
``SAMPLE_SPAN``, and of the window's last batch are kept (by reference, no
copy) for the reference to judge once the window has closed; the coarse
cloud, which ``metric_step`` does not return, is taken by a forward hook.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import check, traffic, weights
from port_bench.modes.train import build_model
from port_bench.reference import steps as reference
from port_bench.tracing import span, stamp
from vn_pointcloudcompletion_tpu_torch.data.pipeline import stage_batch
from vn_pointcloudcompletion_tpu_torch.training.evaluate import metric_step

KEYS = check.SERVE_KEYS
SAMPLE_SPAN = 64


class Serve:
    def __init__(self, config: dict, work: dict, seed: int, device: torch.device):
        self.config, self.work, self.device = config, work, device
        self.batch = work["batch"]
        offsets = work["seed_offsets"]
        data = traffic.pool(seed + offsets["data"], work["pool"], self.batch,
                            config["n_partial"], config["n_dense"])
        rots = traffic.rotations(seed + offsets["rotation"], work["rotation"], work["pool"],
                                 self.batch)
        self.pool = [(p, c) if r is None else (p, c, r) for (p, c), r in zip(data, rots)]
        stamp("data pool")
        self.spec = reference.model(config).param_spec(config)
        self.w_seed = seed + offsets["weights"]
        self.model = build_model(config, weights.make(self.spec, self.w_seed, device), device)
        self.model.eval()
        stamp("weights and model")
        self.coarse = [None]
        self.hook = self.model.register_forward_hook(
            lambda m, args, out: self.coarse.__setitem__(0, out[0]))
        rng = np.random.default_rng((seed + offsets["sample"]) % traffic.SEED_MOD)
        self.sampled = set(rng.choice(SAMPLE_SPAN, work["check_batches"], replace=False).tolist())
        self.i = 0
        for i in range(work["warmup"]):
            self.step()
            if i == 0:
                stamp("first batch")
        stamp("warm-up")

    def step(self, _=None):
        """One batch: (latency s, host enqueue s, metrics (4, B) numpy, pred)."""
        t0 = time.perf_counter()
        k = self.i % len(self.pool)
        with span("stage_batch"):
            staged = stage_batch(self.pool[k], self.device)
        rot = staged[2] if len(staged) == 3 else None
        h0 = time.perf_counter()
        with span("metric_step"):
            out, pred = metric_step(self.model, staged[0], staged[1], rot)
        h1 = time.perf_counter()
        with span("host_read"):
            vals = torch.stack([out[key].float() for key in KEYS]).cpu().numpy()
        t1 = time.perf_counter()
        self.i += 1
        return k, t1 - t0, h1 - h0, vals, pred

    def window(self, seconds: float) -> dict:
        lat, host, kept = [], [], []
        failed = 0
        last = None
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            k, latency, enqueue, vals, pred = self.step()
            lat.append(latency)
            host.append(enqueue)
            failed += int((~np.isfinite(vals).all(0)).sum())
            last = (k, pred, self.coarse[0], vals)
            if n in self.sampled:
                kept.append(last)
            n += 1
        elapsed = time.perf_counter() - t0
        if last is not None and (n - 1) not in self.sampled:
            kept.append(last)
        self.kept = kept
        done = n * self.batch - failed
        return {"e2e": {"serve_completions_per_s": done / elapsed,
                        "serve_batch_p95_ms": float(np.percentile(lat, 95)) * 1e3},
                "attempted": n * self.batch, "failed": failed, "window_s": elapsed,
                "steps": n, "samples": done, "host_s": host, "latency_s": lat}

    def release(self) -> None:
        self.hook.remove()
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self) -> dict:
        """Each kept batch against the reference over the same clouds and
        rotation (``check.py``)."""
        w = weights.make(self.spec, self.w_seed, self.device)
        kept, refs, scored = [], [], []
        for k, pred, coarse, vals in self.kept:
            staged = stage_batch(self.pool[k], self.device)
            rot = staged[2] if len(staged) == 3 else None
            refs.append(reference.serve(self.config, w, staged[0], staged[1], rot))
            whole = len(pred) == len(staged[1])  # else compare_serve reads a wrong shape
            scored.append(reference.score(pred.float(), staged[1], rot) if whole else None)
            kept.append({"coarse": coarse, "dense": pred, **check.as_tensors(vals, self.device)})
        return check.compare_serve(kept, refs, scored)


def setup(config: dict, work: dict, seed: int, device: torch.device) -> Serve:
    return Serve(config, work, seed, device)
