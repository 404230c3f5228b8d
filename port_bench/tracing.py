"""The traced part of a ``--trace 1`` run: a few steps of the window's own
loop under ``torch.profiler`` (CPU and CUDA activities), reduced to the
device's busy time, its idle gaps and what the host was doing in each, and
the device operations that took the most time.

The harness marks its calls into the program with ``record_function``
spans named ``pb.*`` (``pb.step``, ``pb.stage_batch``, ``pb.metric_step``,
``pb.host_read``, ``pb.train_step``); spans inside the program are a later
change.  The profiler mirrors those spans on the device's timeline as user
annotations: they are left out of the device's busy time and operations.  Nothing is written to disk: the profiler's events are read in
memory.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

TOP = 10
NAME_CHARS = 160  # a kernel's name is cut to this many characters


def span(name: str):
    """A harness span, ``pb.<name>``, when a profiler is on (cheap otherwise)."""
    return torch.profiler.record_function(f"pb.{name}")


_LAST_STAMP = [time.perf_counter()]


def stamp(what: str, start: float = None) -> None:
    """Print on standard error the host seconds set-up spent on ``what``:
    since the previous stamp, or since ``start`` (which later stamps count
    from), with the device's queue drained first."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    now = time.perf_counter()
    since = _LAST_STAMP[0] if start is None else start
    print(f"[setup] {what} {now - since:.3f} s", file=sys.stderr)
    _LAST_STAMP[0] = now


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge [start, end) intervals (k, 2) sorted by start."""
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.float64).reshape(-1, 2)


def _host_activity(cpu: List[tuple], mids: np.ndarray) -> List[str]:
    """For each time in ``mids`` what the host's main thread was doing: the
    innermost harness span (``pb.*``, not ``pb.step``) and the innermost
    operation of the program inside it, by a sweep over the nested events."""
    evs = sorted(cpu, key=lambda c: (c[0], -c[1]))
    out = [""] * len(mids)
    stack: List[tuple] = []
    j = 0
    for k in np.argsort(mids):
        m = mids[k]
        while j < len(evs) and evs[j][0] <= m:
            while stack and stack[-1][1] < evs[j][0]:
                stack.pop()
            stack.append(evs[j])
            j += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        spans = [e[2] for e in stack if e[2].startswith("pb.") and e[2] != "pb.step"]
        ops = [e[2] for e in stack if not e[2].startswith("pb.")]
        out[k] = " > ".join(([spans[-1]] if spans else []) + ([ops[-1]] if ops else [])) \
            or "between spans"
    return out


def reduce(events) -> dict:
    """Kineto events -> busy, window, gaps and device operations (seconds)."""
    dev, cpu, spans = [], [], []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", bool)() and not e.name().startswith("pb."):
                dev.append((start, start + dur, e.name()[:NAME_CHARS]))
        else:
            cpu.append((start, start + dur, e.name(), e.start_thread_id()))
            if e.name() == "pb.step":
                spans.append((start, start + dur, e.start_thread_id()))
    if not spans:
        raise RuntimeError("the traced window holds no pb.step span")
    main = spans[0][2]
    cpu = [c[:3] for c in cpu if c[3] == main]
    lo = min(s for s, _, _ in spans)
    hi = max(max(e for _, e, _ in spans), max((e for _, e, _ in dev), default=0))
    window = (hi - lo) * 1e-9
    ops: Dict[str, float] = {}
    iv = []
    for s, e, name in dev:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            iv.append((s, e))
            ops[name] = ops.get(name, 0.0) + (e - s) * 1e-9
    busy_iv = _union(np.asarray(sorted(iv), dtype=np.float64).reshape(-1, 2))
    busy = float((busy_iv[:, 1] - busy_iv[:, 0]).sum() * 1e-9) if len(busy_iv) else 0.0
    edges = np.concatenate([[lo], busy_iv.reshape(-1), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    by_host: Dict[str, float] = {}
    for key, (s, e) in zip(_host_activity(cpu, gaps.mean(1)), gaps):
        by_host[key] = by_host.get(key, 0.0) + (e - s) * 1e-9
    return {
        "busy_s": busy, "window_s": window, "steps": len(spans), "device_events": len(dev),
        "device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in by_host.items()), key=lambda kv: -kv[1])[:TOP],
        "gaps": int(len(gaps)),
    }


def trace(step: Callable[[int], None], steps: int, device: torch.device) -> dict:
    """Run ``step(i)`` for i < ``steps`` under the profiler and reduce."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for i in range(steps):
            with span("step"):
                step(i)
        if device.type == "cuda":
            torch.cuda.synchronize()
    return reduce(prof.profiler.kineto_results.events())

