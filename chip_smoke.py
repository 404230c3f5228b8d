#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vn_pointcloudcompletion_tpu_torch``)
on one NVIDIA GPU:

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions and the TF32 settings.
2. Builds every kernel under ``vn_pointcloudcompletion_tpu_torch/csrc/``
   (one ``nvcc`` per source, all at once) and prints the build time.
3. Holds each kernel (A, B, C, D) against its plain PyTorch version on the
   card at the shapes of the main path (batch 8), with the tolerance stated
   beside it, and times both with CUDA events.
4. Drives the main path at full width (encoder latent 1024 -> 2048-channel
   global feature, 2048 input points, 1024 coarse, 16384 dense points, random
   weights from a seed) through the port's command line: ``predict`` on 8
   partial PLYs and ``test`` on 2 batches of the synthetic set, with every
   launch counter set to 0 just before and read just after; then compares the
   whole forward through the kernels with the port's plain path.

Any failure exits non-zero.  The line before the last is a JSON object with
one record per kernel; the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM, NVIDIA's data sheet: FP32 outside the tensor cores, HBM3 rate.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
BATCH = 8
NS = 0.2  # the VN leaky slope of every layer on the path


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` on the current stream (CUDA events)."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float):
    """Least time for the work on the card: (ms, what bounds it)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def check_kernels(dev):
    """Phase 3: each kernel against its plain version at main-path shapes."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import chamfer_pallas_bidir as chamfer
    from vn_pointcloudcompletion_tpu_torch.ops import vn_fused, vn_layer_fused

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def uniform(lo, hi, *shape):
        return torch.rand(*shape, generator=g, device=dev) * (hi - lo) + lo

    records = []

    def record(name, source, replaces, kernel_fn, plain_fn, compare, tol,
               work_bytes, work_ops, reps=20, plain_reps=5):
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err, ok = compare(got, want)
        b_ms, b_by = bound(work_bytes, work_ops)
        rec = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": cuda_ms(kernel_fn, reps), "plain_ms": cuda_ms(plain_fn, plain_reps),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }
        print(f"[kernel {name}] max_abs_err {err:.3e} (tolerance {tol}) "
              f"{'PASS' if ok else 'FAIL'}; kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              "library: none", flush=True)
        if not ok:
            raise AssertionError(f"kernel {name} disagrees with its plain version")
        records.append(rec)

    def close(atol, rtol):
        def cmp(got, want):
            diff = (got - want).abs()
            return diff.max().item(), bool((diff <= atol + rtol * want.abs()).all())
        return cmp

    # A: encoder first_conv.0 (C=128) and second_conv.0 (C=1024) at N=2048
    for c in (128, 1024):
        p = randn(BATCH, 3, c, 2048)
        p[:, :, :8, :16] = 0.0  # exact zero vectors
        d = randn(BATCH, 3, c, 2048)
        a, b = uniform(0.5, 1.5, c), randn(c, scale=0.3)
        if c == 128:
            got = vn_fused.fused_bn_leaky(p, d, a, b, NS)
            want = vn_fused.reference_bn_leaky_planes(p, d, a, b, NS)
            err = (got - want).abs().max().item()
            print(f"[kernel A] C=128 max_abs_err {err:.3e} (tolerance 1e-6)")
            if err > 1e-6:
                raise AssertionError("kernel A disagrees at C=128")
            continue
        vecs = BATCH * c * 2048
        record("A fused_bn_leaky", "vn_pointcloudcompletion_tpu_torch/csrc/vn_fused.cu",
               "vn_pointcloudcompletion_tpu/ops/vn_fused.py:189",
               lambda: vn_fused.fused_bn_leaky(p, d, a, b, NS),
               lambda: vn_fused.reference_bn_leaky_planes(p, d, a, b, NS),
               close(1e-6, 0.0), "atol 1e-6",
               nbytes(p, d, a, b) + nbytes(p), 32 * vecs)
    del p, d

    # B: decoder final_conv.0, C_in=2 (seed, point), C_out=256, per-sample bias
    n, c_out = 16384, 256
    x = randn(BATCH, 3, 2, n, scale=0.3)
    w, wd = uniform(-0.02, 0.02, c_out, 2), uniform(-0.02, 0.02, c_out, 2)
    pb, db = randn(BATCH, 3, c_out, 1), randn(BATCH, 3, c_out, 1)
    a, b = uniform(0.5, 1.5, c_out), randn(c_out, scale=0.3)
    vecs = BATCH * c_out * n
    record("B vn_layer_fused", "vn_pointcloudcompletion_tpu_torch/csrc/vn_layer_fused.cu",
           "vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py:541",
           lambda: vn_layer_fused.vn_layer_fused(x, w, wd, pb, db, a, b, NS),
           lambda: vn_layer_fused.reference_layer_fused(x, w, wd, pb, db, a, b, NS),
           close(1e-5, 1e-5), "atol 1e-5 + rtol 1e-5",
           nbytes(x, w, wd, pb, db, a, b) + 4 * 3 * vecs,
           2 * 3 * vecs * 2 * 2 + 38 * vecs)

    # C: decoder final_conv.1 + final_conv.2, C_in = C_out = 256
    x = randn(BATCH, 3, 256, n)
    w, wd = uniform(-1 / 16, 1 / 16, 256, 256), uniform(-1 / 16, 1 / 16, 256, 256)
    w_out = uniform(-1 / 16, 1 / 16, 256)
    record("C vn_layer_fused_project",
           "vn_pointcloudcompletion_tpu_torch/csrc/vn_layer_fused.cu",
           "vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py:821",
           lambda: vn_layer_fused.vn_layer_fused_project(x, w, wd, None, None, a, b, w_out, NS),
           lambda: vn_layer_fused.reference_layer_fused_project(
               x, w, wd, None, None, a, b, w_out, NS),
           close(1e-4, 1e-4), "atol 1e-4 + rtol 1e-4",
           nbytes(x, w, wd, a, b, w_out) + 4 * 3 * BATCH * n,
           2 * 3 * vecs * 2 * 256 + (32 + 6) * vecs, reps=10)
    del x

    # D: test-time chamfer, dense prediction (16384) against complete (16384)
    px = uniform(-0.3, 0.3, BATCH, n, 3)
    py = uniform(-0.3, 0.3, BATCH, n, 3)

    def exact(got, want):
        dmax = max((got[k] - want[k]).abs().max().item() for k in (0, 2))
        same = all(torch.equal(got[k], want[k]) for k in range(4))
        return dmax, same

    record("D nn_bidirectional",
           "vn_pointcloudcompletion_tpu_torch/csrc/chamfer_bidir.cu",
           "vn_pointcloudcompletion_tpu/ops/chamfer_pallas_bidir.py:159",
           lambda: chamfer.nn_bidirectional(px, py),
           lambda: chamfer.nn_bidirectional_reference(px, py),
           exact, "distances and indices exact",
           nbytes(px, py) + 2 * 4 * 2 * BATCH * n,
           BATCH * n * n * (8 + 2), reps=10, plain_reps=3)
    return records


def main_path(dev):
    """Phase 4: predict + test at full width through the CLI, counted."""
    import numpy as np
    import torch

    from vn_pointcloudcompletion_tpu_torch import __main__ as cli
    from vn_pointcloudcompletion_tpu_torch.data.ply import read_ply_points, write_ply_points
    from vn_pointcloudcompletion_tpu_torch.data.synthetic import SyntheticCompletionDataset
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
    from vn_pointcloudcompletion_tpu_torch.training.checkpoint import save_model
    from vn_pointcloudcompletion_tpu_torch.utils.config import Config, store_config

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    exp_dir = os.path.join(work, "experiments", "smoke")
    os.makedirs(os.path.join(exp_dir, "models"))
    config = Config.from_dict({
        "name": "smoke", "enc_type": "vn_pointnet", "dec_type": "vn_foldingnet",
        "num_coarse": 1024, "latent_dim": 2048, "only_coarse": False,
        "batch_size": BATCH, "test_rotation": "so3", "dataset": "synthetic",
        "num_workers": 4, "seed": 0, "synthetic_test_samples": 2 * BATCH,
        "synthetic_n_partial": 2048, "synthetic_n_complete": 16384,
    })
    config.exp_dir = exp_dir
    store_config(config)
    model = build_model(config)
    save_model(exp_dir, model, "best")

    in_dir = os.path.join(work, "partials")
    os.makedirs(in_dir)
    scans = SyntheticCompletionDataset(8, seed=11, n_partial=3000)
    for i in range(8):
        write_ply_points(os.path.join(in_dir, f"scan{i}.ply"), scans[i][0])
    out_dir = os.path.join(work, "completions")
    os.environ["OUTPUT_DIR"] = os.path.join(work, "experiments")

    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    written = cli.main(["-n", "smoke", "--resume", "predict", "-i", in_dir,
                        "-o", out_dir, "--save"])
    t1 = time.perf_counter()
    table = cli.main(["-n", "smoke", "--resume", "test"])
    t2 = time.perf_counter()
    counts = cuda_lib.launch_counts()
    print(f"[main path] predict 8 clouds: {t1 - t0:.3f} s; test 2 batches of "
          f"{BATCH}: {t2 - t1:.3f} s (host clock, first call, build included "
          "if any)")
    print(f"[main path] launches: {json.dumps(counts)}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    if len(written) != 8:
        raise AssertionError(f"predict wrote {len(written)} files, not 8")
    for path in written:
        pts = read_ply_points(path)
        coarse = read_ply_points(path.replace("_completion", "_coarse"))
        if pts.shape != (16384, 3) or coarse.shape != (1024, 3):
            raise AssertionError(f"{path}: shapes {pts.shape} {coarse.shape}")
        if not (np.isfinite(pts).all() and np.isfinite(coarse).all()):
            raise AssertionError(f"{path}: non-finite points")
    row = table["synthetic"]
    if not all(np.isfinite(v) for v in row.values()) or not 0 < row["iou"] <= 1:
        raise AssertionError(f"bad metric row {row}")

    # the whole forward through the kernels against the port's plain path
    model = model.to(dev).eval()
    ds = SyntheticCompletionDataset(BATCH, seed=3)
    xyz = torch.from_numpy(np.stack([ds[i][0] for i in range(BATCH)])).to(dev)
    from vn_pointcloudcompletion_tpu_torch.ops.rotations import random_rotations

    rot = random_rotations(torch.Generator().manual_seed(1), BATCH).to(dev)
    xyz = xyz @ rot
    with torch.no_grad():
        coarse_k, fine_k = model(xyz, rot)
        model.use_kernels_(False)
        coarse_p, fine_p = model(xyz, rot)
        model.use_kernels_(True)
    torch.cuda.synchronize()
    err_c = (coarse_k - coarse_p).abs().max().item()
    err_f = (fine_k - fine_p).abs().max().item()
    scale = fine_p.abs().max().item()
    tol_f = 1e-4 * scale
    print(f"[main path] forward kernels vs plain: coarse max_abs_err {err_c:.3e} "
          f"(tolerance 0: the encoder's kernel A is bit-exact), fine max_abs_err "
          f"{err_f:.3e} (tolerance 1e-4 x max|fine| = {tol_f:.3e})")
    if err_c != 0.0 or err_f > tol_f or fine_k.shape != (BATCH, 16384, 3):
        raise AssertionError("full forward: kernels disagree with the plain path")
    shutil.rmtree(work, ignore_errors=True)
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
    from vn_pointcloudcompletion_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; allow_tf32: matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    reports = cuda_lib.build_all()
    print(f"[build] {len(reports)} sources in {time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    records = check_kernels(dev)
    counts = main_path(dev)
    symbol = {"A": "vn_bn_leaky_fwd", "B": "vn_layer_fused_fwd",
              "C": "vn_layer_fused_project_fwd", "D": "chamfer_nn_one_sided"}
    for rec in records:
        rec["launches"] = counts[symbol[rec["name"][0]]]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
