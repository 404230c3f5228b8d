#!/usr/bin/env python3
"""Eval-forward and train-step times of the port's DGCNN-family paths on one
card, to compare two checkouts of the repository in one call (in the order
parent, change, change, parent):

    cd <checkout> && python3 <this repository>/tools/time_paths.py [reps] [path ...]

It imports the port package and ``chip_smoke.py`` of the current directory,
so the same code times the package of whichever commit is checked out
there: ``vn_dgcnn``, ``dgcnn_448``, ``vn_pointr_448`` and, where the
checkout's ``chip_smoke.PATHS`` has it, ``vn_pointr_448_dec`` (with the
decoder stack) at full width (``chip_smoke._smoke_config``: random weights
from seed 0, batch 8, 2048 input points, ``chip_smoke.main_path_batch``),
and the flagship's eval forwards.  For each path it times the eval forward in float32 and under the
bfloat16 policy and (but the flagship) the float32 train step, ``reps``
calls each (default 20) after two warm-up calls, CUDA events around each
call (a call ends in its own synchronisation, as ``chip_smoke.cuda_ms``
times it: the host's time where it is the slower), and then its device
time, the sum of its kernels' durations under torch.profiler over 5 calls,
in all, for kernels F and K3 alone and for kernels K2 and A alone; it
prints one JSON line per path with the median and the quartiles in ms,
and (``host``) the quartiles of the host's time to return from each call,
before its synchronisation: where that is near the call's time, the host
sets the pace.  The flagship and ``vn_pointr_448`` also time the train
step under the bfloat16 policy (``train_step_bf16``): ``reps`` guarded
steps after two warm-up steps through ``chip_smoke.step_cost`` (CUDA
events around each, a step ending in its one host read, the allocator's
peak), then the profiler's device time over 5 steps, in all and for the
kernels of the wide bf16 S, S' and C' (``WIDE_BWD``: pass 1
``pd_wide_mma`` or ``pd_wgmma``, passes 2 and 3 ``dx_``/``dw_wide_bf16``
or ``dx_``/``dw_wgmma``) and of the wide
bf16 C (``PROJ_FWD``: ``proj_wide_mma`` and ``proj_sum``, or
``proj_wgmma``), each of those kernels apart.  Paths named after
``reps`` are the only ones timed, and the kernels' line is then left out.
Before the paths, one JSON line times kernels F (2048 -> 512, 512 -> 128,
2048 -> 224), K3 (the five path shapes, float32 and bf16), K2 (the path
shapes over the rotated scans) and A in bf16 (the path shapes) alone
through the checkout's wrappers: a call, back to back and on the device
(``chip_smoke.graph_ms``), and K2's and A's host time a call
(``host_us``: 50 calls queued without a synchronisation, the host's time
over them; the wrapper, its checks and the launch).  The first line is the card's name and power
limit.  It builds the checkout's kernels first, needs a CUDA
card, and imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# The kernels of the wide bf16 S, S' and C' (S's pass 1; S''s and C''s
# passes 1, 2 and 3, in every design), which the bf16 train steps time apart
WIDE_BWD = ("pd_wide_mma<", "pd_wgmma", "dx_wide_bf16",
            "dw_wide_bf16", "dx_wgmma", "dw_wgmma")
# ... and of the wide bf16 C (the forward): proj_wide_mma and proj_sum, or proj_wgmma
PROJ_FWD = ("proj_wide_mma", "proj_sum", "proj_wgmma")
BF16_STEP_PATHS = ("flagship", "vn_pointr_448")


def quartiles(times):
    q = statistics.quantiles(times, n=4)
    return {"median": statistics.median(times), "q1": q[0], "q3": q[2]}


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("time_paths: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.nn.precision import compute_dtype_scope
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
    from vn_pointcloudcompletion_tpu_torch.training import steps
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    only = sys.argv[2:]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cuda_lib.build_all()
    dev = torch.device("cuda")
    partial, complete, rot = cs.main_path_batch(dev)
    xyz = partial @ rot

    def device_ms(fn, calls=5):
        """(all kernels, F and K3's, K2 and A's kernels) device ms a call."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        graph = [e for e in kernels if any(k in e.key for k in ("fps_kernel", "edge_"))]
        k2_a = [e for e in kernels
                if any(k in e.key for k in ("knn_min_kernel", "knn_select", "bn_leaky_fwd"))]
        return tuple(sum(e.self_device_time_total for e in es) / 1e3 / calls
                     for es in (kernels, graph, k2_a))

    def times(fn):
        for _ in range(2):
            fn()
        out, host = [], []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        row = quartiles(out)
        row["host"] = quartiles(host)
        row["device"], row["device_f_k3"], row["device_k2_a"] = device_ms(fn)
        return row

    def bf16_step(model, config):
        """The bf16 train step: clock, peak, device time (all, wide S', C')."""
        step_ms, _, peak, _ = cs.step_cost(model, config, partial, complete, torch.bfloat16,
                                           reps)
        state = create_train_state(model, config, 1)
        gen = torch.Generator().manual_seed(0)
        with compute_dtype_scope(torch.bfloat16):
            steps.train_step(state, partial, complete, gen)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    steps.train_step(state, partial, complete, gen)
                torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        wide = [e for e in kernels if any(k in e.key for k in WIDE_BWD)]
        proj = [e for e in kernels if any(k in e.key for k in PROJ_FWD)]
        return {"step_ms": step_ms, "peak_gib": peak,
                "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / 5,
                "wide_bwd_device_ms": sum(e.self_device_time_total for e in wide) / 1e3 / 5,
                "wide_bwd": {e.key[:60]: e.self_device_time_total / 1e3 / 5 for e in wide},
                "proj_fwd_device_ms": sum(e.self_device_time_total for e in proj) / 1e3 / 5,
                "proj_fwd": {e.key[:60]: e.self_device_time_total / 1e3 / 5 for e in proj}}

    if not only:
        timed_kernels(cs, dev, xyz)
    for path in ("flagship", "vn_dgcnn", "dgcnn_448", "vn_pointr_448", "vn_pointr_448_dec"):
        if path not in cs.PATHS or (only and path not in only):  # PATHS: a checkout
            continue  # from before the decoder stack lacks vn_pointr_448_dec
        config = cs._smoke_config(path)
        model = build_model(config).to(dev).eval()
        row = {"path": path, "batch": cs.BATCH, "reps": reps}
        for name, dtype in (("forward_float32", torch.float32), ("forward_bf16", torch.bfloat16)):
            def forward(dtype=dtype):
                with torch.no_grad(), compute_dtype_scope(dtype):
                    return model(xyz, rot)
            row[name] = times(forward)
        model.train()
        if path != "flagship":  # the flagship's float32 step is chip_smoke's phase 5b
            state = create_train_state(model, config, 1)
            gen = torch.Generator().manual_seed(0)
            row["train_step_float32"] = times(
                lambda: steps.train_step(state, partial, complete, gen))
            del state
        if path in BF16_STEP_PATHS:
            row["train_step_bf16"] = bf16_step(model, config)
        print(json.dumps(row), flush=True)
        del model
    return 0


def timed_kernels(cs, dev, xyz) -> None:
    """One JSON line: kernels F, K3, K2 and A bf16 alone at the paths'
    shapes (the module docstring)."""
    import torch

    # kernels F and K3 alone at the paths' shapes, through the checkout's
    # own wrappers: chip_smoke.cuda_ms (a call, host time included) and
    # chip_smoke.stream_ms (a call in a run of calls back to back)
    from vn_pointcloudcompletion_tpu_torch.ops import fps_pallas, knn_pallas

    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = []
    for n, s in ((2048, 512), (512, 128), (2048, 224)):
        pts = torch.rand(cs.BATCH, n, 3, generator=gen, device=dev) - 0.5
        if s != 224:  # the trunks hand F the transposed view of (B, 3, N) planes
            pts = pts.transpose(1, 2).contiguous().transpose(1, 2)
        fn = lambda: fps_pallas.furthest_point_sample_kernel(pts, s)  # noqa: E731
        kernels.append({"name": f"F {n} -> {s}", "ms": cs.cuda_ms(fn, 20),
                        "b2b_ms": cs.stream_ms(fn, 20)})
    for n, dim, c3 in ((512, 3, 768), (512, 3, 384), (512, 96, 384), (512, 192, 384),
                       (128, 192, 768)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(cs.BATCH, dim, n, generator=gen, device=dev).to(dtype)
            u = torch.randn(cs.BATCH, c3, n, generator=gen, device=dev).to(dtype)
            v = torch.randn(cs.BATCH, c3, n, generator=gen, device=dev).to(dtype)
            fn = lambda: knn_pallas.edge_knn_gather_fwd(x, u, v, 16)  # noqa: E731
            kernels.append({"name": f"K3 N {n} D {dim} C3 {c3} {str(dtype)[6:]}",
                            "ms": cs.cuda_ms(fn, 20), "b2b_ms": cs.stream_ms(fn, 20)})
    # K2 over the rotated scans and A in bf16, each at its path shapes
    from vn_pointcloudcompletion_tpu_torch.ops import vn_fused

    def host_us(fn, calls=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        spent = time.perf_counter() - t0
        torch.cuda.synchronize()
        return spent / calls * 1e6

    for n, m, k in ((2048, 2048, 16), (128, 128, 16), (512, 2048, 16), (512, 512, 16),
                    (128, 512, 16), (128, 128, 8), (2048, 2048, 40), (224, 224, 8),
                    (224, 128, 8)):
        q, r = xyz[:, :n], xyz[:, :m]
        fn = lambda: knn_pallas.knn_min_fwd(q, r, k)  # noqa: E731
        kernels.append({"name": f"K2 {n} vs {m} k {k}", "ms": cs.cuda_ms(fn, 20),
                        "b2b_ms": cs.stream_ms(fn, 20), "device_ms": cs.graph_ms(fn),
                        "host_us": host_us(fn)})
    for c, n in ((1024, 2048), (128, 2048), (64, 8192), (128, 8192), (512, 2048)):
        p, d = (torch.randn(cs.BATCH, 3, c, n, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        a = torch.rand(c, generator=gen, device=dev) + 0.5
        b = torch.randn(c, generator=gen, device=dev) * 0.3
        fn = lambda: vn_fused.fused_bn_leaky(p, d, a, b, 0.2)  # noqa: E731
        kernels.append({"name": f"A bf16 C {c} N {n}", "ms": cs.cuda_ms(fn, 20),
                        "b2b_ms": cs.stream_ms(fn, 20), "device_ms": cs.graph_ms(fn),
                        "host_us": host_us(fn)})
        del p, d
    print(json.dumps({"kernels": kernels}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
