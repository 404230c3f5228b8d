"""Tracing and profiling (port of ``utils/profiling.py``).

- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace, which TensorBoard's profiler plugin and ``chrome://tracing``
  read, for a region of steps.
- :class:`StepTimer`: wall-clock time per step with a warm-up discarded and
  a percentile summary; once CUDA is in use each step also ends in a
  synchronisation, so its time is the card's, and CUDA events time it on
  the device as well.
- :func:`device_memory_stats`: a per-device snapshot of device memory,
  under the JAX function's keys.
- :func:`log_compile_time`: a function's first call (the kernels' build at
  first use, cuBLAS's initialisation) against a second one.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _synchronize() -> None:
    if _cuda_in_use():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a region: ``with trace("tb") as prof: run_steps()``.

    Writes ``<logdir>/<host>_<pid>.<time>.pt.trace.json`` when the region
    ends, and yields the ``torch.profiler.profile`` for its
    ``key_averages()``.  Where CUDA is available the trace holds the
    device's activity too, read through CUPTI."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()


def _summary(ts: Sequence[float]) -> Dict[str, float]:
    ts = np.asarray(ts)
    return {
        "mean_s": float(ts.mean()),
        "p50_s": float(np.percentile(ts, 50)),
        "p90_s": float(np.percentile(ts, 90)),
        "steps": len(ts),
    }


class StepTimer:
    """Collects per-step times; ``summary()`` gives the mean, p50 and p90.

    ``with timer: step()`` times one step.  Once CUDA is in use,
    ``__exit__`` synchronises the card (JAX's timer forces a host read for
    the same reason) and CUDA events give the step's device time too
    (``device_summary()``)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self.device_times: List[float] = []
        self._t0: Optional[float] = None
        self._events = None

    def __enter__(self):
        _synchronize()
        if _cuda_in_use():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        _synchronize()
        self.times.append(time.perf_counter() - self._t0)
        if self._events is not None:
            self.device_times.append(self._events[0].elapsed_time(self._events[1]) / 1e3)
            self._events = None

    def summary(self) -> Dict[str, float]:
        """Wall-clock seconds per step after the warm-up steps."""
        return _summary(self.times[self.warmup:] or self.times)

    def device_summary(self) -> Dict[str, float]:
        """CUDA-event seconds per step after the warm-up steps (CUDA only)."""
        if not self.device_times:
            raise ValueError("no step was timed on a CUDA device")
        return _summary(self.device_times[self.warmup:] or self.device_times)


def device_memory_stats() -> List[Dict[str, float]]:
    """Per-device memory snapshot in bytes, under JAX's keys
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``, ``device``):
    the caching allocator's allocated bytes, their peak since the last
    ``torch.cuda.reset_peak_memory_stats`` and the card's total memory, for
    every CUDA device.  Where there is none, one entry for the CPU with
    zeros, as JAX's CPU device gives."""
    if not torch.cuda.is_available():
        return [{"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0, "device": "cpu"}]
    out = []
    for i in range(torch.cuda.device_count()):
        d = torch.device("cuda", i)
        raw = torch.cuda.memory_stats(d)
        out.append({
            "bytes_in_use": raw.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": raw.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(d).total_memory,
            "device": str(d),
        })
    return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def log_compile_time(fn: Callable, *args, sync: Callable = None):
    """Run ``fn(*args)`` twice; returns (first_call_s, steady_call_s).

    Each call ends in ``sync(out)``, by default a synchronisation of the
    card where the first tensor in ``out`` lies on it."""

    def _sync(out):
        if sync is not None:
            return sync(out)
        tensors = [x for x in _leaves(out) if isinstance(x, torch.Tensor)]
        if tensors and tensors[0].is_cuda:
            torch.cuda.synchronize(tensors[0].device)
        return out

    t0 = time.perf_counter()
    _sync(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    _sync(fn(*args))
    steady = time.perf_counter() - t0
    return first, steady
