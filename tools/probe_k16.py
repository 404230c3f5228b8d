#!/usr/bin/env python3
"""The tensor cores' k16 step read back exactly, on one card:

    python3 tools/probe_k16.py [OUT.npz]

Builds ``tools/probe_k16.cu`` into ``build/kernels/`` (the port's loader,
``cuda_lib.build_source``) and runs D = C + A B (A 64 x K, B K x 64 bf16, C
float32 given) on crafted operands, each set isolating one property of the
step, after the method of Fasi, Higham, Mikaitis and Pranesh, "Numerical
behavior of NVIDIA tensor cores" (PeerJ Computer Science 7:e330, 2021):
random operands; exponents spread over +-2^16 (the alignment); sums that
cancel; an accumulator far above the products (does it take part in the
alignment); one product far above the rest; the two k8 halves at other
scales (a k16 step, or two k8 halves); products and accumulators at and
below float32's normal range (subnormals); zeros of either sign; and chains
of 4 and 16 steps on random and adversarial operands (every sum a few
float32 ulps from a bf16 midpoint).  Each set runs four ways: mma.sync
m16n8k16 and m16n8k8 steps, and wgmma.m64n64k16 with a stage's products in
one commit group (the kernels' way) and each alone.

Prints, for each set, how many float32 accumulators differ in bits
between the ways and from the plain model of the step
(``ops/vn_layer_fused.py::k16_sum``), and writes every operand and result
to OUT.npz (default ``build/probe_k16.npz``) so that the model can be
refitted off the card.  Exits 1 unless the model and the card agree on
every accumulator of every set.  Run it from the root of a checkout; needs
a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = str(ROOT / "tools" / "probe_k16.cu")


def _pow2(rng, lo, hi, shape):
    return np.ldexp(1.0, rng.integers(lo, hi + 1, shape))


def _sig(rng, shape):
    """Random signs times significands in [1, 2)."""
    return rng.choice([-1.0, 1.0], shape) * rng.uniform(1.0, 2.0, shape)


def problem_sets(seed: int = 0):
    """name -> (A (P, K, 64) as [k][m], B (P, K, 64) as [k][n], C (P, 64,
    64)) in float64, A and B bf16-exact once rounded, C float32-exact once
    rounded."""
    rng = np.random.default_rng(seed)
    sets = {}

    def add(name, a, b, c):
        sets[name] = (a, b, c)

    n = lambda *s: rng.standard_normal(s)  # noqa: E731
    add("random", n(48, 16, 64), n(48, 16, 64), n(48, 64, 64) * _pow2(rng, -12, 12, (48, 64, 64)))
    a = _sig(rng, (48, 16, 64)) * _pow2(rng, -16, 16, (48, 16, 64))
    b = _sig(rng, (48, 16, 64)) * _pow2(rng, -16, 16, (48, 16, 64))
    c = _sig(rng, (48, 64, 64)) * _pow2(rng, -40, 40, (48, 64, 64))
    a[rng.random(a.shape) < 0.1] = 0.0
    c[rng.random(c.shape) < 0.1] = 0.0
    add("spread", a, b, c)
    # sums that cancel: C minus the products' float64 sum, nudged
    a, b = n(32, 16, 64), n(32, 16, 64)
    exact = np.einsum("pkm,pkn->pmn", _bf16(a), _bf16(b))
    nudge = 1.0 + rng.choice([-1.0, 1.0], exact.shape) * _pow2(rng, -24, -4, exact.shape)
    nudge[rng.random(exact.shape) < 0.25] = 1.0
    add("cancel", a, b, -exact * nudge)
    add("acc_big", n(32, 16, 64), n(32, 16, 64),
        _sig(rng, (32, 64, 64)) * _pow2(rng, 4, 30, (32, 64, 64)))
    a = n(32, 16, 64)
    big = rng.integers(0, 16, 32)
    a[np.arange(32), big] *= _pow2(rng, 8, 30, (32, 1))
    add("one_big", a, n(32, 16, 64), n(32, 64, 64))
    a = n(48, 16, 64)
    a[:, :8] *= _pow2(rng, -20, 20, (48, 1, 1))
    a[:, 8:] *= _pow2(rng, -20, 20, (48, 1, 1))
    add("halves", a, n(48, 16, 64), n(48, 64, 64) * _pow2(rng, -20, 20, (48, 1, 1)))
    a = _sig(rng, (16, 16, 64)) * _pow2(rng, -75, -55, (16, 16, 64))
    b = _sig(rng, (16, 16, 64)) * _pow2(rng, -75, -55, (16, 16, 64))
    c = _sig(rng, (16, 64, 64)) * _pow2(rng, -149, -110, (16, 64, 64))
    c[rng.random(c.shape) < 0.2] = 0.0
    add("tiny", a, b, c)
    a, b = n(8, 16, 64), n(8, 16, 64)
    a[rng.random(a.shape) < 0.5] = 0.0
    a[:4, :, :32] = 0.0  # whole rows of zero products
    c = n(8, 64, 64)
    c[:, :, :32] = rng.choice([-0.0, 0.0], (8, 64, 32))
    add("zeros", a, b, c)
    # every product -0 (+0 times a negative) onto an accumulator of -0 or +0
    c = np.zeros((8, 64, 64))
    c[:4] = -0.0
    add("negative_zeros", np.zeros((8, 16, 64)), -np.abs(n(8, 16, 64)) - 0.5, c)
    # subnormal bf16 operands (below 2^-126) against normal ones
    a = _sig(rng, (16, 16, 64)) * _pow2(rng, -133, -120, (16, 16, 64))
    add("subnormal_operands", a, _sig(rng, (16, 16, 64)) * _pow2(rng, 0, 20, (16, 16, 64)),
        _sig(rng, (16, 64, 64)) * _pow2(rng, -120, -100, (16, 64, 64)))
    for k in (64, 256):
        w = rng.uniform(-1, 1, (8, k, 64)) / np.sqrt(k)
        add(f"chain{k}_random", w, n(8, k, 64), np.zeros((8, 64, 64)))
        add(f"chain{k}_adversarial", *_adversarial(rng, k))
    return sets


def _adversarial(rng, k):
    """Adversarial operands as one problem set (as
    tests/test_torch_port_wide.py::_k16_inputs builds them): product 0 a
    power of two t0, product 1 t0 2^-8 (together the midpoint between two
    bf16 values), the other k - 2 products ~2^-25 t0 of either sign."""
    lead_w = np.ldexp(rng.choice([-1.0, 1.0], (8, 1, 64)), rng.integers(-2, 3, (8, 1, 64)))
    lead_x = np.ldexp(rng.choice([-1.0, 1.0], (8, 1, 64)), rng.integers(-2, 3, (8, 1, 64)))
    small = lambda *s: rng.choice([-1.0, 1.0], s) * np.ldexp(rng.uniform(1, 2, s), -13)  # noqa
    w = np.concatenate([lead_w, lead_w * 2.0 ** -8, lead_w * small(8, k - 2, 64)], 1)
    x = np.concatenate([lead_x, lead_x, lead_x * small(8, k - 2, 64)], 1)
    return w, x, np.zeros((8, 64, 64))


def _bf16(a):
    """float64 -> the nearest bf16 values (ties to even), as float64."""
    import torch

    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).double().numpy()


def run(sets, device):
    """name -> dict of the operands' bits and the four ways' results."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops.cuda_lib import CudaKernel

    args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    mma = CudaKernel(SOURCE, "probe_mma", args, counted=False)
    wg = CudaKernel(SOURCE, "probe_wgmma", args, counted=False)
    out = {}
    for name, (a, b, c) in sets.items():
        ta = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).to(device)
        tb = torch.from_numpy(np.asarray(b, np.float32)).to(torch.bfloat16).to(device)
        tc = torch.from_numpy(np.asarray(c, np.float32)).to(device)
        p, k = ta.shape[:2]
        res = {}
        for way, kern, flag in (("mma16", mma, 0), ("mma8", mma, 1), ("wgmma", wg, 1),
                                ("wgmma_alone", wg, 0)):
            d = torch.full_like(tc, float("nan"))
            kern(ta, ta.data_ptr(), tb.data_ptr(), tc.data_ptr(), d.data_ptr(), p, k, flag)
            res[way] = d.cpu().numpy()
        torch.cuda.synchronize(device)
        res.update(a=ta.view(torch.int16).cpu().numpy(), b=tb.view(torch.int16).cpu().numpy(),
                   c=tc.cpu().numpy())
        out[name] = res
    return out


def differ(x, y) -> int:
    """Elements whose float32 bits differ."""
    return int((np.asarray(x, np.float32).view(np.int32)
                != np.asarray(y, np.float32).view(np.int32)).sum())


def model_of(res):
    """The plain model's float32 D for one set's operands."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused as vlf

    a = torch.from_numpy(res["a"]).view(torch.bfloat16)  # (P, K, 64): [k][m]
    b = torch.from_numpy(res["b"]).view(torch.bfloat16)
    c = torch.from_numpy(res["c"])
    # k16_sum(w (P, M, K), x (P, K, N), acc (P, M, N))
    return vlf.k16_sum(a.transpose(1, 2), b, c).numpy()


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_k16: needs a CUDA card", file=sys.stderr)
        return 1
    dest = Path(argv[0]) if argv else ROOT / "build" / "probe_k16.npz"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    results = run(problem_sets(), torch.device("cuda"))
    bad = 0
    for name, res in results.items():
        model = model_of(res)
        line = {"set": name, "K": res["a"].shape[1], "outputs": res["c"].size,
                "mma16_vs_wgmma": differ(res["mma16"], res["wgmma"]),
                "mma16_vs_mma8": differ(res["mma16"], res["mma8"]),
                "wgmma_vs_alone": differ(res["wgmma"], res["wgmma_alone"]),
                "model_vs_wgmma": differ(model, res["wgmma"]),
                "model_vs_mma16": differ(model, res["mma16"])}
        bad += line["model_vs_wgmma"] + line["model_vs_mma16"]
        print("probe_k16", line)
    dest.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(dest, **{f"{name}/{key}": v for name, res in results.items()
                                 for key, v in res.items()})
    print(f"probe_k16: {'model == card on every accumulator' if bad == 0 else f'{bad} differ'}; "
          f"operands and results in {os.path.relpath(dest, ROOT)}")
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
