#!/usr/bin/env python3
"""The wide bf16 pass 1 of kernels S, S' and C' on one card, pass by pass,
and the share of p, d elements that C''s certified pass 1 sums again in
input-channel order:

    python3 tools/certificate_share.py

1. At 256 -> 256 (N 16384) and 256 -> 128 (N 14336), batch 8: each pass's
   device time of the bf16 S, S' and C' calls (``chip_smoke.pass_ms``:
   torch.profiler's kernel durations over whole calls) and the whole
   call's (``chip_smoke.graph_ms``), in the parent designs
   (``chip_smoke.parent_designs``: pass 1 on mma.sync or FMAs) and in
   ``pass1_bf16_design``'s, with ``torch.bmm`` of pass 1's products (bf16
   W, and Wd for C', times x, float32 out) back to back beside them as a
   yardstick (never on the port's path).
2. C''s certified design (``pass1_bf16_design`` "certified") on (a)
   synthetic inputs (x ~ N(0, 1), w ~ U(+-1/16), the bf16 rows of
   ``chip_smoke.py`` phase 3) at both shapes, (b) adversarial ones (every
   p, d a few float32 ulps from a bf16 midpoint) and (c) the inputs of
   every C' call in one bf16 train step of the flagship (256 -> 256) and of
   ``vn_pointr_448`` (256 -> 128), seed 0, caught at the call: the share of
   p, d elements it summed again (its ``resums`` count), and its outputs
   against the parent design's, which must be equal in bits.

Needs a CUDA card; imports nothing of JAX.  The first line is the card's
name and power limit; the last, every reading as one JSON object.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def captured_c_bwd(cs, path, dev):
    """The arguments of every C' call in one bf16 train step of ``path``
    (``chip_smoke.PATHS``) at full width, seed 0."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.nn.precision import compute_dtype_scope
    from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state
    from vn_pointcloudcompletion_tpu_torch.training.steps import train_step

    config = cs._smoke_config(path)
    partial, complete = cs.synthetic_batch(dev, cs.BATCH)
    torch.manual_seed(0)
    state = create_train_state(build_model(config).to(dev), config, 1)
    seen, real = [], vn_layer_fused.layer_project_bwd

    def catch(*args, **kw):
        seen.append(tuple(t.detach().clone() if torch.is_tensor(t) else t for t in args))
        return real(*args, **kw)

    vn_layer_fused.layer_project_bwd = catch
    try:
        with compute_dtype_scope(torch.bfloat16):
            train_step(state, partial, complete, torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
    finally:
        vn_layer_fused.layer_project_bwd = real
    del state
    return seen


def resum_share(cs, tag, args):
    """C''s certified design on ``args`` (layer_project_bwd's): the share of
    p, d elements its pass 1 summed again, and its outputs equal in bits to
    the parent design's (raises otherwise)."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused as vlf

    x, w = args[0], args[1]
    count = torch.zeros(1, dtype=torch.int32, device=x.device)
    got, designs = cs.launched_designs(lambda: vlf.layer_project_bwd(*args, resums=count))
    with cs.parent_designs():
        want = vlf.layer_project_bwd(*args)
    same = all(torch.equal(a, b) for a, b in zip(got, want) if a is not None)
    total = 2 * x.shape[0] * 3 * w.shape[0] * x.shape[3]
    row = {"inputs": tag, "design": "/".join(designs), "elements": total,
           "resummed": int(count.item()), "share": int(count.item()) / total,
           "equal_to_parent": same}
    print(f"[share] {tag}: {row['design']} re-summed {row['share']:.4%} of {total} p, d "
          f"elements; outputs bitwise equal to the parent design's: {same}", flush=True)
    if not same or designs != ["certified"]:
        raise AssertionError(f"{tag}: the certified design differs from the parent's")
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("certificate_share: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
    from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused as vlf

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cuda_lib.build_all()
    dev = torch.device("cuda")
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape, scale=1.0: torch.randn(*shape, generator=g, device=dev) * scale  # noqa: E731
    uniform = lambda lo, hi, *shape: torch.rand(*shape, generator=g, device=dev) * (hi - lo) + lo  # noqa: E731

    rows = []
    for c_out, n in ((256, 16384), (128, 14336)):
        x = randn(cs.BATCH, 3, 256, n).to(bf)
        w, wd = uniform(-1 / 16, 1 / 16, c_out, 256), uniform(-1 / 16, 1 / 16, c_out, 256)
        c1, c2 = randn(c_out, scale=1e-4), randn(c_out, scale=1e-5)
        a, b = uniform(0.5, 1.5, c_out), randn(c_out, scale=0.3)
        w_out = uniform(-1 / 16, 1 / 16, c_out)
        gc = randn(cs.BATCH, 3, 1, n, scale=1e-4).to(bf)
        planes = cs.BATCH * 3
        x3 = x.reshape(planes, 256, n)
        calls = {
            "S": (lambda: vlf.stats_fwd(x, w, None), [w]),
            "S'": (lambda: vlf.stats_bwd(x, w, None, c1, c2), [w]),
            "C'": (lambda: vlf.layer_project_bwd(x, w, wd, None, None, a, b, w_out, gc, cs.NS),
                   [w, wd]),
        }
        for name, (fn, mats) in calls.items():
            wst = torch.cat(mats, 0).to(bf).expand(planes, -1, -1).contiguous()
            try:
                mm = lambda: torch.bmm(wst, x3, out_dtype=torch.float32)  # noqa: E731
                mm()
                out = "float32"
            except (TypeError, RuntimeError):  # no bf16 -> float32 product: bf16 out
                mm = lambda: torch.bmm(wst, x3)  # noqa: E731
                out = "bf16"
            mat = cs.stream_ms(mm, 10)
            for ctx in (cs.parent_designs, contextlib.nullcontext):
                with ctx():
                    _, designs = cs.launched_designs(fn)
                    split = cs.pass_ms(fn)
                    whole = cs.graph_ms(fn, 10)
                row = {"kernel": f"{name} bf16", "shape": f"256 -> {c_out}, N {n}",
                       "design": "/".join(designs), "passes": split, "graph_ms": whole,
                       "pass1_matmul_ms": mat, "matmul_out": out}
                print(f"[passes] {smi}: {row['kernel']} {row['shape']} {row['design']}: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                      + f"; the whole call {whole:.4f} ms on the device; torch.bmm of pass 1's "
                      f"products ({out} out) {mat:.4f} ms back to back", flush=True)
                rows.append(row)
            del wst
        rows.append(resum_share(cs, f"(a) synthetic 256 -> {c_out}, N {n}",
                                (x, w, wd, None, None, a, b, w_out, gc, cs.NS)))
        del x, x3, gc
    args = cs.adversarial_c_inputs(dev, cs.BATCH, 256, 128, 4096, 9)
    rows.append(resum_share(cs, "(b) adversarial 256 -> 128, N 4096", (*args, cs.NS)))
    del args
    for path in ("flagship", "vn_pointr_448"):
        for i, args in enumerate(captured_c_bwd(cs, path, dev)):
            x, w = args[0], args[1]
            tag = f"(c) {path} C' call {i}, {x.shape[2]} -> {w.shape[0]}, N {x.shape[3]}"
            rows.append(resum_share(cs, tag, args))
            del args, x, w
            torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
