#!/usr/bin/env python3
"""Eval-forward and train-step times of the port's DGCNN-family paths on one
card, to compare two checkouts of the repository in one call (in the order
parent, change, change, parent):

    cd <checkout> && python3 <this repository>/tools/time_paths.py [reps]

It imports the port package and ``chip_smoke.py`` of the current directory,
so the same code times the package of whichever commit is checked out
there: ``vn_dgcnn``, ``dgcnn_448`` and ``vn_pointr_448`` at full width
(``chip_smoke._smoke_config``: random weights from seed 0, batch 8, 2048
input points, ``chip_smoke.main_path_batch``).  For each path it times the
eval forward in float32 and under the bfloat16 policy and the float32 train
step, ``reps`` calls each (default 20) after two warm-up calls, CUDA events
around each call (a call ends in its own synchronisation, as
``chip_smoke.cuda_ms`` times it: the host's time where it is the slower),
and then its device time, the sum of its kernels' durations under
torch.profiler over 5 calls, in all and for kernels F and K3 alone; it
prints one JSON line per path with the median and the quartiles in ms.
Before the paths, one JSON line times kernels F (2048 -> 512, 512 -> 128,
2048 -> 224) and K3 (the five path shapes, float32 and bf16) alone through
the checkout's wrappers.  The first line is the card's name and power
limit.  It builds the checkout's kernels first, needs a CUDA
card, and imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys


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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cuda_lib.build_all()
    dev = torch.device("cuda")
    partial, complete, rot = cs.main_path_batch(dev)
    xyz = partial @ rot

    def device_ms(fn, calls=5):
        """(all kernels, F and K3's kernels) device ms a call."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        graph = [e for e in kernels if any(k in e.key for k in ("fps_kernel", "edge_"))]
        return tuple(sum(e.self_device_time_total for e in es) / 1e3 / calls
                     for es in (kernels, graph))

    def times(fn):
        for _ in range(2):
            fn()
        out = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        row = quartiles(out)
        row["device"], row["device_f_k3"] = device_ms(fn)
        return row

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
    print(json.dumps({"kernels": kernels}), flush=True)

    for path in ("vn_dgcnn", "dgcnn_448", "vn_pointr_448"):
        config = cs._smoke_config(path)
        model = build_model(config).to(dev).eval()
        row = {"path": path, "batch": cs.BATCH, "reps": reps}
        for name, dtype in (("forward_float32", torch.float32), ("forward_bf16", torch.bfloat16)):
            def forward(dtype=dtype):
                with torch.no_grad(), compute_dtype_scope(dtype):
                    return model(xyz, rot)
            row[name] = times(forward)
        state = create_train_state(model.train(), config, 1)
        gen = torch.Generator().manual_seed(0)
        row["train_step_float32"] = times(lambda: steps.train_step(state, partial, complete, gen))
        print(json.dumps(row), flush=True)
        del model, state
    return 0


if __name__ == "__main__":
    sys.exit(main())
