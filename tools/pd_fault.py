#!/usr/bin/env python3
"""How far kernel C''s bf16 pass 1 takes its backward from the p, d that
the forward kernel C formed, and the bf16 C' pass by pass, on one card:

    python3 tools/pd_fault.py

1. The inputs of every C' call in one bf16 train step of the flagship
   (256 -> 256, N 16384) and of ``vn_pointr_448`` (256 -> 128, N 14336),
   seed 0, caught at the call (``certificate_share.captured_c_bwd``).  For
   each, the forward C on the same inputs hands out its p, d
   (``chip_smoke.forward_planes``), and C' runs in the design the wrapper
   chooses ("certified" there: pass 1 with the plain version's in-order
   bits), handing out the p, d its pass 1 formed (its ``pd_out``): the
   share of elements that differ from the forward's, the
   vectors whose leaky side (``<q, d> >= 0``) differs (``chip_smoke.pd_fault``),
   and the RMS distance over the norm of dx, dW and dWd from the plain C'
   at the forward's p, d.
2. C' bf16 at 256 -> 256 (N 16384) and 256 -> 128 (N 14336), batch 8, on
   ``chip_smoke.py`` phase 3's synthetic inputs, in that design: a call,
   back to back and on the device (``chip_smoke.cuda_ms``, ``stream_ms``,
   ``graph_ms``), each pass's device time (``chip_smoke.pass_ms``), and
   ``torch.bmm`` of pass 1's two products (bf16 W and Wd times x, float32
   out) back to back, a yardstick never on the port's path; and S's p
   against the in-order p there (the share that differs).

Needs a CUDA card; imports nothing of JAX.  The first line is the card's
name and power limit; the last, every reading as one JSON object.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fault_row(cs, tag, args):
    """Part 1 for one C' call's arguments (layer_project_bwd's, before the
    negative slope)."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused as vlf

    x, w, wd, pb, db, a, b, w_out, g = args[:9]
    group = args[10] if len(args) > 10 else 0
    fwd = cs.forward_planes(x, w, wd, pb, db, a, b, w_out, group)
    at_fwd = vlf.reference_layer_project_bwd(x, w, wd, pb, db, a, b, w_out, g, cs.NS, group,
                                             planes=fwd.unbind(0))
    pd = torch.empty_like(fwd)
    out, designs = cs.launched_designs(
        lambda: vlf.layer_project_bwd(x, w, wd, pb, db, a, b, w_out, g, cs.NS, group,
                                      pd_out=pd))
    row = {"inputs": tag, "design": "/".join(designs), **cs.pd_fault(fwd, pd, a, b),
           "rms_dx_dw_dwd": [cs.bf16_rms(o, want) for o, want in zip(out[:3], at_fwd[:3])]}
    print(f"[fault] {tag}: {row['design']}: {row['pd_differs']:.4%} of p, d differ from the "
          f"forward C's, {row['side_flips']} vectors ({row['side_flip_share']:.4%}) take the "
          f"other leaky side; dx, dW, dWd RMS from the plain C' at the forward's p, d "
          f"{row['rms_dx_dw_dwd']}", flush=True)
    del fwd, at_fwd, pd, out
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pd_fault: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
    from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused as vlf

    spec = importlib.util.spec_from_file_location(
        "certificate_share", os.path.join(ROOT, "tools", "certificate_share.py"))
    share = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(share)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cuda_lib.build_all()
    dev = torch.device("cuda")
    rows = []
    for path in ("flagship", "vn_pointr_448"):
        for i, args in enumerate(share.captured_c_bwd(cs, path, dev)):
            tag = f"{path} C' call {i}, {args[0].shape[2]} -> {args[1].shape[0]}, N " \
                  f"{args[0].shape[3]}"
            rows.append(fault_row(cs, tag, args))
            del args
            torch.cuda.empty_cache()

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape, scale=1.0: torch.randn(*shape, generator=g, device=dev) * scale  # noqa: E731
    uniform = lambda lo, hi, *shape: torch.rand(*shape, generator=g, device=dev) * (hi - lo) + lo  # noqa: E731
    for c_out, n in ((256, 16384), (128, 14336)):
        x = randn(cs.BATCH, 3, 256, n).to(bf)
        w, wd = uniform(-1 / 16, 1 / 16, c_out, 256), uniform(-1 / 16, 1 / 16, c_out, 256)
        a, b = uniform(0.5, 1.5, c_out), randn(c_out, scale=0.3)
        w_out = uniform(-1 / 16, 1 / 16, c_out)
        gc = randn(cs.BATCH, 3, 1, n, scale=1e-4).to(bf)
        fn = lambda: vlf.layer_project_bwd(x, w, wd, None, None, a, b, w_out, gc, cs.NS)  # noqa: E731
        planes = cs.BATCH * 3
        wst = torch.cat([w, wd], 0).to(bf).expand(planes, -1, -1).contiguous()
        x3 = x.reshape(planes, 256, n)
        try:
            mm = lambda: torch.bmm(wst, x3, out_dtype=torch.float32)  # noqa: E731
            mm()
            out = "float32"
        except (TypeError, RuntimeError):  # no bf16 -> float32 product: bf16 out
            mm = lambda: torch.bmm(wst, x3)  # noqa: E731
            out = "bf16"
        mat = cs.stream_ms(mm, 10)
        p_s = torch.empty(cs.BATCH, 3, c_out, n, device=dev, dtype=bf)
        vlf.stats_fwd(x, w, None, p_out=p_s)
        s_share = float((p_s != vlf._products(w, x, None)).float().mean())
        row = {"shape": f"256 -> {c_out}, N {n}", "pass1_bmm_ms": mat, "bmm_out": out,
               "s_p_differs_from_in_order": s_share}
        _, designs = cs.launched_designs(fn)
        row.update({"design": "/".join(designs), "ms": cs.cuda_ms(fn, 10),
                    "stream_ms": cs.stream_ms(fn, 10), "graph_ms": cs.graph_ms(fn, 10),
                    "passes": cs.pass_ms(fn)})
        print(f"[passes] {smi}: C' bf16 {row['shape']} {row['design']}: a call {row['ms']:.4f}, "
              f"back to back {row['stream_ms']:.4f}, device {row['graph_ms']:.4f} ms; "
              + ", ".join(f"{k} {v:.4f}" for k, v in row["passes"].items())
              + f"; torch.bmm of pass 1's products ({out} out) {mat:.4f}", flush=True)
        print(f"[S] {row['shape']}: S's p against the in-order p: {s_share:.4%} of elements "
              "differ", flush=True)
        rows.append(row)
        del x, x3, wst, gc, p_s
    print(json.dumps({"card": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
