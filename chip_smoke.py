#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vn_pointcloudcompletion_tpu_torch``)
on one NVIDIA GPU:

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions and the TF32 settings.
2. Builds every kernel under ``vn_pointcloudcompletion_tpu_torch/csrc/``
   (one ``nvcc`` per source, all at once) and prints the build time.
3. Holds each of the nine kernels (A, A', S, S', B, B', C, C', D) against its
   plain PyTorch version on the card at the shapes of the main paths (batch
   8), with the tolerance stated beside it, times both with CUDA events, and
   runs each backward-slice kernel twice to show that it gives the same bits.
4. Serving at full width (encoder latent 1024 -> 2048-channel global
   feature, 2048 input points, 1024 coarse, 16384 dense points, random
   weights from a seed) through the port's command line: ``predict`` on 8
   partial PLYs and ``test`` on 2 batches of the synthetic set, with every
   launch counter set to 0 just before and read just after; then the whole
   forward through the kernels against the port's plain path.
5. Training at the same width through the command line: ``overfit`` at
   batch 8 for a few epochs (one step and one validation batch each), with
   the counters set to 0 just before and read just after (all nine must be
   launched), the losses checked finite and falling, the checkpoints
   checked, and ``train --resume`` for one more epoch.
5b. The decoder's backward through the kernels against float64; one train
   step through the kernels against the same step through the plain path
   on the same model and batch (losses, every gradient, the running
   statistics); the median step time of both; and torch.profiler's device
   time by kernel over three steps through the kernels.

Any failure exits non-zero.  The line before the last is a JSON object with
one record per kernel (its launches are those of the training run of phase
5); the last line is ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX.
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
TRAIN_EPOCHS = 16  # phase 5: epochs 0..15, then one more with --resume
# Phase 5b, each gradient's max|dg| / max|g|: the whole step through the
# kernels against the plain path (measured 1.70e-4 at full width, batch 8),
# and the decoder's backward through the kernels against float64 (measured
# 2.86e-3; the plain path 2.90e-3).  Both stem from float32 sums in the
# BatchNorm-on-norms variance (PERF.md, PR 2 finding).
STEP_TOL = 3e-4
DEC_F64_TOL = 4e-3
FORWARD_KERNELS = ("vn_bn_leaky_fwd", "vn_layer_fused_fwd",
                   "vn_layer_fused_project_fwd", "chamfer_nn_one_sided")
SYMBOL = {"A": "vn_bn_leaky_fwd", "A'": "vn_bn_leaky_bwd",
          "S": "vn_layer_stats_fwd", "S'": "vn_layer_stats_bwd",
          "B": "vn_layer_fused_fwd", "B'": "vn_layer_fused_bwd",
          "C": "vn_layer_fused_project_fwd", "C'": "vn_layer_fused_project_bwd",
          "D": "chamfer_nn_one_sided"}


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
               work_bytes, work_ops, reps=20, plain_reps=5, repro=False):
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err, ok = compare(got, want)
        if repro:  # the same inputs again must give the same bits
            again = kernel_fn()
            same = all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
            print(f"[kernel {name}] second launch bitwise equal: {same}")
            ok = ok and same
            del again
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

    def rel_close(rel, exact=()):
        """Each output within rel x its max |plain|; outputs in ``exact``
        equal to the bit.  Returns the largest absolute error."""
        def cmp(got, want):
            err, ok = 0.0, True
            for k, (g, w) in enumerate(zip(got, want)):
                if w is None:
                    continue
                e = (g - w).abs().max().item()
                err = max(err, e)
                ok = ok and (e == 0.0 if k in exact else e <= rel * w.abs().max().item())
            return err, ok
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
            g_ = randn(BATCH, 3, c, 2048)
            err_b, ok_b = rel_close(1e-5, exact=(0, 1))(
                vn_fused.bn_leaky_bwd(p, d, a, b, g_, NS),
                vn_fused.reference_bn_leaky_bwd(p, d, a, b, g_, NS))
            print(f"[kernel A, A'] C=128 max_abs_err {err:.3e} (tolerance 1e-6), "
                  f"{err_b:.3e} (dp, dd exact; dA, dB 1e-5 x max)")
            if err > 1e-6 or not ok_b:
                raise AssertionError("kernel A or A' disagrees at C=128")
            continue
        vecs = BATCH * c * 2048
        record("A fused_bn_leaky", "vn_pointcloudcompletion_tpu_torch/csrc/vn_fused.cu",
               "vn_pointcloudcompletion_tpu/ops/vn_fused.py:189",
               lambda: vn_fused.fused_bn_leaky(p, d, a, b, NS),
               lambda: vn_fused.reference_bn_leaky_planes(p, d, a, b, NS),
               close(1e-6, 0.0), "atol 1e-6",
               nbytes(p, d, a, b) + nbytes(p), 32 * vecs)
    # A': the backward of A at second_conv.0 (C=1024), cotangent g
    g_ = randn(BATCH, 3, 1024, 2048)
    vecs = BATCH * 1024 * 2048
    record("A' fused_bn_leaky backward", "vn_pointcloudcompletion_tpu_torch/csrc/vn_fused.cu",
           "vn_pointcloudcompletion_tpu/ops/vn_fused.py:214",
           lambda: vn_fused.bn_leaky_bwd(p, d, a, b, g_, NS),
           lambda: vn_fused.reference_bn_leaky_bwd(p, d, a, b, g_, NS),
           rel_close(1e-5, exact=(0, 1)), "dp, dd exact; dA, dB 1e-5 x max",
           nbytes(p, d, a, b, g_) + 2 * nbytes(p) + 2 * 4 * 1024, 80 * vecs,
           repro=True)
    del p, d, g_

    # S, S': the train-mode statistics of decoder final_conv.1 (256 -> 256)
    # and, checked only, of final_conv.0 (2 -> 256, per-sample bias)
    n = 16384
    x2 = randn(BATCH, 3, 2, n, scale=0.3)
    w2 = uniform(-0.02, 0.02, 256, 2)
    pb2 = randn(BATCH, 3, 256, 1)
    got = vn_layer_fused.stats_fwd(x2, w2, pb2)
    want = vn_layer_fused.reference_stats(x2, w2, pb2)
    c1, c2 = randn(256, scale=1e-4), randn(256, scale=1e-5)
    err_s, ok_s = rel_close(1e-5)(got, want)
    err_b, ok_b = rel_close(1e-4)(vn_layer_fused.stats_bwd(x2, w2, pb2, c1, c2),
                                  vn_layer_fused.reference_stats_bwd(x2, w2, pb2, c1, c2))
    print(f"[kernel S, S'] final_conv.0 shapes (Cin 2, bias): max_abs_err {err_s:.3e}, "
          f"{err_b:.3e} (tolerance 1e-5, 1e-4 x max)")
    if not (ok_s and ok_b):
        raise AssertionError("kernel S or S' disagrees at final_conv.0 shapes")
    x = randn(BATCH, 3, 256, n)
    w = uniform(-1 / 16, 1 / 16, 256, 256)
    vecs = BATCH * 256 * n
    prod = 2 * 3 * vecs * 256  # one (256 x 256) map over all planes and points
    record("S vn_layer_stats", "vn_pointcloudcompletion_tpu_torch/csrc/vn_layer_bwd.cu",
           "vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py:278",
           lambda: vn_layer_fused.stats_fwd(x, w, None),
           lambda: vn_layer_fused.reference_stats(x, w, None),
           rel_close(1e-5), "1e-5 x max", nbytes(x, w) + 2 * 4 * 256,
           prod + 9 * vecs, reps=10, repro=True)
    record("S' vn_layer_stats backward",
           "vn_pointcloudcompletion_tpu_torch/csrc/vn_layer_bwd.cu",
           "vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py:325",
           lambda: vn_layer_fused.stats_bwd(x, w, None, c1, c2),
           lambda: vn_layer_fused.reference_stats_bwd(x, w, None, c1, c2),
           rel_close(1e-4), "1e-4 x max", 2 * nbytes(x) + 2 * nbytes(w) + 2 * 4 * 256,
           3 * prod + 15 * vecs, reps=10, plain_reps=3, repro=True)
    del x

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

    # B': the backward of B at final_conv.0 (Cin 2, Cout 256, per-sample bias)
    x = randn(BATCH, 3, 2, n, scale=0.3)
    w, wd = uniform(-0.02, 0.02, c_out, 2), uniform(-0.02, 0.02, c_out, 2)
    g_ = randn(BATCH, 3, c_out, n, scale=1e-4)
    record("B' vn_layer_fused backward",
           "vn_pointcloudcompletion_tpu_torch/csrc/vn_layer_bwd.cu",
           "vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py:594",
           lambda: vn_layer_fused.layer_bwd(x, w, wd, pb, db, a, b, g_, NS),
           lambda: vn_layer_fused.reference_layer_bwd(x, w, wd, pb, db, a, b, g_, NS),
           rel_close(1e-4), "1e-4 x max",
           2 * nbytes(x, w, wd, pb, db, a, b) + nbytes(g_),
           6 * 2 * 3 * vecs * 2 + (80 + 6) * vecs, repro=True)
    del g_

    # C': the backward of C at final_conv.1 + final_conv.2 (256 -> 256 -> 1)
    x = randn(BATCH, 3, 256, n)
    w, wd = uniform(-1 / 16, 1 / 16, 256, 256), uniform(-1 / 16, 1 / 16, 256, 256)
    g_ = randn(BATCH, 3, 1, n, scale=1e-4)
    record("C' vn_layer_fused_project backward",
           "vn_pointcloudcompletion_tpu_torch/csrc/vn_layer_bwd.cu",
           "vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py:878",
           lambda: vn_layer_fused.layer_project_bwd(x, w, wd, None, None, a, b, w_out, g_, NS),
           lambda: vn_layer_fused.reference_layer_project_bwd(
               x, w, wd, None, None, a, b, w_out, g_, NS),
           rel_close(1e-4), "1e-4 x max",
           2 * nbytes(x, w, wd, a, b, w_out) + nbytes(g_),
           6 * prod + 90 * vecs, reps=5, plain_reps=3, repro=True)
    del x, g_

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


def _smoke_config(**extra):
    """The flagship at full width, batch 8, synthetic data."""
    from vn_pointcloudcompletion_tpu_torch.utils.config import Config

    return Config.from_dict({
        "name": "smoke", "enc_type": "vn_pointnet", "dec_type": "vn_foldingnet",
        "num_coarse": 1024, "latent_dim": 2048, "only_coarse": False,
        "batch_size": BATCH, "dataset": "synthetic", "num_workers": 4, "seed": 0,
        "synthetic_n_partial": 2048, "synthetic_n_complete": 16384, **extra,
    })


def serve_path(dev):
    """Phase 4: predict + test at full width through the CLI, counted."""
    import numpy as np
    import torch

    from vn_pointcloudcompletion_tpu_torch import __main__ as cli
    from vn_pointcloudcompletion_tpu_torch.data.ply import read_ply_points, write_ply_points
    from vn_pointcloudcompletion_tpu_torch.data.synthetic import SyntheticCompletionDataset
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
    from vn_pointcloudcompletion_tpu_torch.training.checkpoint import save_model
    from vn_pointcloudcompletion_tpu_torch.utils.config import store_config

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    exp_dir = os.path.join(work, "experiments", "smoke")
    os.makedirs(os.path.join(exp_dir, "models"))
    config = _smoke_config(test_rotation="so3", synthetic_test_samples=2 * BATCH)
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
    print(f"[serve path] predict 8 clouds: {t1 - t0:.3f} s; test 2 batches of "
          f"{BATCH}: {t2 - t1:.3f} s (host clock, first call, build included "
          "if any)")
    print(f"[serve path] launches: {json.dumps(counts)}")
    missing = [k for k in FORWARD_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serving path: {missing}")

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
    print(f"[serve path] forward kernels vs plain: coarse max_abs_err {err_c:.3e} "
          f"(tolerance 0: the encoder's kernel A is bit-exact), fine max_abs_err "
          f"{err_f:.3e} (tolerance 1e-4 x max|fine| = {tol_f:.3e})")
    if err_c != 0.0 or err_f > tol_f or fine_k.shape != (BATCH, 16384, 3):
        raise AssertionError("full forward: kernels disagree with the plain path")
    shutil.rmtree(work, ignore_errors=True)


def train_path(dev):
    """Phase 5: overfit + train --resume at full width through the CLI,
    counted."""
    import math

    import torch

    from vn_pointcloudcompletion_tpu_torch import __main__ as cli
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib

    work = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # The train-mode loss of one repeated batch jumps by +-30% from step to
    # step at any lr (the argmax pools switch points as the weights move);
    # at 3x the reference's lr its fall outruns that within 16 steps, and
    # the check is that the last epoch ends below the untrained first one.
    config = _smoke_config(name="smoke_train", lr=3e-4, rotation="so3",
                           val_rotation="so3", log_frequency=1)
    with open(os.path.join(work, "config.json"), "w") as f:
        json.dump(config.to_dict(), f)
    os.environ["OUTPUT_DIR"] = os.path.join(work, "experiments")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        summary = cli.main(["-n", "smoke_train", "-epochs", str(TRAIN_EPOCHS - 1),
                            "overfit"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = cuda_lib.launch_counts()
        (run,) = os.listdir(os.environ["OUTPUT_DIR"])
        exp_dir = os.path.join(os.environ["OUTPUT_DIR"], run)
        resumed = cli.main(["-n", run, "--resume", "-epochs", str(TRAIN_EPOCHS), "train"])
        t2 = time.perf_counter()
    finally:
        os.chdir(cwd)
    print(f"[train path] overfit {TRAIN_EPOCHS} epochs of one step + one validation "
          f"batch: {t1 - t0:.3f} s; resume 1 epoch: {t2 - t1:.3f} s (host clock, "
          "checkpoint writes included)")
    print(f"[train path] launches: {json.dumps(counts)}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the training path: {missing}")
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train = [r["value"] for r in rows if r["split"] == "train" and r["tag"] == "Loss/Epoch/Total"]
    val = [r["value"] for r in rows if r["split"] == "val" and r["tag"] == "Loss/Epoch/Total"]
    print(f"[train path] train total loss per epoch (x1e3): {train}; validation: {val}")
    if not all(math.isfinite(v) for r in rows for v in [r["value"]]):
        raise AssertionError("non-finite logged loss")
    if len(train) != TRAIN_EPOCHS + 1 or not train[TRAIN_EPOCHS - 1] < train[0]:
        raise AssertionError(f"training loss did not fall: {train}")
    if summary["epochs_run"] != TRAIN_EPOCHS or resumed["epochs_run"] != 1:
        raise AssertionError(f"epochs run: {summary} then {resumed}")
    for sub, stem in (("models", "model"), ("optimizer", "optim")):
        for name in ("best", "last"):
            if not os.path.exists(os.path.join(exp_dir, sub, f"{stem}_{name}.pth")):
                raise AssertionError(f"missing {sub}/{stem}_{name}.pth")
    with open(os.path.join(exp_dir, "train.log")) as f:
        if "[RESUME INFO] resume ckpts @ %d epoch" % (TRAIN_EPOCHS - 1) not in f.read():
            raise AssertionError("train --resume did not continue the run")
    shutil.rmtree(work, ignore_errors=True)
    return counts


def rel_errs(got, want):
    """max |got - want| / max |want| of each tensor of ``want``."""
    out = {}
    for name, w in want.items():
        scale = w.abs().max().item()
        e = (got[name].to(w.dtype) - w).abs().max().item()
        out[name] = e / scale if scale > 0 else (float("inf") if e > 0 else 0.0)
    return out


def step_agreement(model, plain, config, partial, complete):
    """One guarded train step (the rotation from seed 1) of ``model``
    through the kernels and of ``plain``, the same weights through the
    plain path: the losses' and the running statistics' largest relative
    errors, and each gradient's max|dg| / max|g|."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.training import steps
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state

    out = []
    for m in (model, plain):
        metrics = steps.train_step(create_train_state(m, config, 1), partial, complete,
                                   torch.Generator().manual_seed(1))
        if metrics["skipped"].item():
            raise AssertionError("the train step was skipped")
        # the pools' direction maps feed only an argmax: they get no gradient
        out.append((torch.stack([metrics["coarse"], metrics["dense"]]),
                    {k: p.grad for k, p in m.named_parameters() if p.grad is not None},
                    dict(m.named_buffers())))
    (lk, gk, bk), (lp, gp, bp) = out
    if set(gk) != set(gp):
        raise AssertionError("the two paths gave gradients of different parameters")
    loss_err = ((lk - lp).abs() / lp.abs()).max().item()
    stat_err = max(((bk[k] - b).abs() / b.abs().clamp_min(1e-12)).max().item()
                   for k, b in bp.items())
    return loss_err, stat_err, rel_errs(gk, gp)


def small_step_case(dev, batch: int):
    """The card test's train step (tests/test_torch_port_kernels.py): the
    flagship at num_coarse 256 (dense 4096, all nine kernels on the path),
    through the kernels and, with the same weights, the plain path, on
    ``batch`` synthetic samples.  Returns (model, plain, config, partial,
    complete)."""
    import numpy as np
    import torch

    from vn_pointcloudcompletion_tpu_torch.data.synthetic import SyntheticCompletionDataset
    from vn_pointcloudcompletion_tpu_torch.models.composer import PCNNet, init_weights_
    from vn_pointcloudcompletion_tpu_torch.utils.config import Config

    model = init_weights_(PCNNet(num_coarse=256), 0).to(dev)
    plain = init_weights_(PCNNet(num_coarse=256), 0).to(dev).use_kernels_(False)
    ds = SyntheticCompletionDataset(batch, seed=3, n_partial=2048, n_complete=4096)
    partial, complete = (torch.from_numpy(np.stack([ds[i][k] for i in range(batch)])).to(dev)
                         for k in (0, 1))
    config = Config.from_dict({"num_coarse": 256, "rotation": "so3"})
    return model, plain, config, partial, complete


def decoder_grads(decoder, coarse, feature_global, rot, cot, dtype):
    """Gradients of ``sum(fine * cot)`` w.r.t. the decoder's parameters and
    inputs, on a copy of the decoder in ``dtype`` (float64 takes the plain
    path: the kernels are float32)."""
    import copy

    dec = copy.deepcopy(decoder).to(dtype).train()
    if dtype != coarse.dtype:
        for m in dec.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = False
    c = coarse.detach().to(dtype).requires_grad_()
    f = feature_global.detach().to(dtype).requires_grad_()
    fine = dec(c, f, rot.to(dtype))
    (fine * cot.to(dtype)).sum().backward()
    out = {f"decoder.{k}": p.grad for k, p in dec.named_parameters()}
    out.update(coarse=c.grad, feature_global=f.grad)
    return out


def train_step_kernels_vs_plain(dev, smi: str):
    """Phase 5b: the decoder's backward through the kernels and through the
    plain path against float64; one train step's losses, gradients and
    running statistics through both; both step times; a profile of the
    kernels'."""
    import copy

    import numpy as np
    import torch

    from vn_pointcloudcompletion_tpu_torch.data.synthetic import SyntheticCompletionDataset
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.ops.rotations import random_rotations, rotate_points
    from vn_pointcloudcompletion_tpu_torch.training import steps
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state

    config = _smoke_config(lr=1e-4, rotation="so3")
    model = build_model(config).to(dev)
    plain = copy.deepcopy(model).use_kernels_(False)
    ds = SyntheticCompletionDataset(BATCH, seed=3)
    partial, complete = (torch.from_numpy(np.stack([ds[i][k] for i in range(BATCH)])).to(dev)
                         for k in (0, 1))

    def worst(errs, k=3):
        return ", ".join(f"{n} {v:.3e}" for n, v in sorted(errs.items(), key=lambda kv: -kv[1])[:k])

    # The decoder alone (no argmax: float64 is a true reference) for a fixed
    # cotangent of the dense output, from the train-mode encoder output of
    # this batch (on a copy: the model's running statistics stay as built).
    rot = random_rotations(torch.Generator().manual_seed(1), BATCH).to(dev)
    with torch.no_grad():
        coarse, fg = copy.deepcopy(model.encoder).train()(rotate_points(partial, rot))
    cot = torch.randn(BATCH, coarse.shape[1] * 16, 3, generator=torch.Generator(
        device=dev).manual_seed(2), device=dev) * 1e-4
    ref = decoder_grads(model.decoder, coarse, fg, rot, cot, torch.float64)
    dec_k = rel_errs(decoder_grads(model.decoder, coarse, fg, rot, cot, torch.float32), ref)
    dec_p = rel_errs(decoder_grads(plain.decoder, coarse, fg, rot, cot, torch.float32), ref)
    print(f"[train step] decoder backward against float64, max|dg| / max|g|: kernels "
          f"{worst(dec_k)} (tolerance {DEC_F64_TOL}); plain, for comparison, {worst(dec_p)}")

    loss_err, stat_err, step_errs = step_agreement(model, plain, config, partial, complete)
    torch.cuda.synchronize()
    print(f"[train step] kernels vs plain at batch {BATCH}: losses rel err {loss_err:.3e} "
          f"(tolerance 1e-4); running statistics rel err {stat_err:.3e} (tolerance 1e-4); "
          f"gradients max|dg| / max|g|, largest: {worst(step_errs)} (tolerance {STEP_TOL})")
    if not (loss_err <= 1e-4 and stat_err <= 1e-4 and max(step_errs.values()) <= STEP_TOL
            and max(dec_k.values()) <= DEC_F64_TOL):
        raise AssertionError("train step: kernels disagree with the plain path")

    for b in (4, 8):  # the card test's shapes, for its bounds
        _, _, errs = step_agreement(*small_step_case(dev, b))
        print(f"[train step] num_coarse 256, batch {b}: gradients max|dg| / max|g|, "
              f"largest: {worst(errs, 1)}")

    def step_ms(m):
        state = create_train_state(m, config, 1)
        gen = torch.Generator().manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: steps.train_step(state, partial, complete, gen), 5)
        return ms, torch.cuda.max_memory_allocated() / 2**30

    k_ms, k_gib = step_ms(model)
    p_ms, p_gib = step_ms(plain)
    k2_ms, _ = step_ms(model)
    print(f"[train step] {smi}: median of 5 steps after 2 warm-up (CUDA events, one "
          f"host read per step): kernels {k_ms:.3f} ms then {k2_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms; peak memory kernels {k_gib:.2f} GiB, plain {p_gib:.2f} GiB")
    profile_steps(model, config, partial, complete)


def profile_steps(model, config, partial, complete, steps_n: int = 3):
    """torch.profiler over a few train steps through the kernels: the device
    time by kernel and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vn_pointcloudcompletion_tpu_torch.training import steps
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state

    state = create_train_state(model, config, 1)
    gen = torch.Generator().manual_seed(0)
    steps.train_step(state, partial, complete, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps_n):
            steps.train_step(state, partial, complete, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the CPU-side ops above them carry the same time
    kernels = sorted((e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")),
                     key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[profile] {steps_n} train steps: wall {wall_ms:.3f} ms (host clock), device "
          f"kernel time {total:.3f} ms, busy share {total / wall_ms:.3f}")
    for e in kernels[:20]:
        print(f"[profile] {e.self_device_time_total / 1e3 / steps_n:10.3f} ms/step "
              f"{e.count // steps_n:5d} launches/step  {e.key[:90]}")


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
    serve_path(dev)
    counts = train_path(dev)
    train_step_kernels_vs_plain(dev, smi)
    for rec in records:
        rec["launches"] = counts[SYMBOL[rec["name"].split()[0]]]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
