#!/usr/bin/env python3
"""Whether kernel C''s bf16 pass 1 takes its backward at the p, d that the
forward kernel C formed, and the bf16 C' pass by pass, on one card:

    python3 tools/pd_fault.py

1. The inputs of every C' call in one bf16 train step of the flagship
   (256 -> 256, N 16384) and of ``vn_pointr_448`` (256 -> 128, N 14336),
   seed 0, caught at the call (``captured_c_bwd``).  For each, the forward
   C on the same inputs hands out its p, d (``chip_smoke.forward_planes``),
   and C' runs in the design the wrapper chooses ("wgmma_p" there: p, d in
   the tensor cores' k16 steps, as C forms them), handing out the p, d its
   pass 1 formed (its ``pd_out``): the share of elements that differ from
   the forward's, the vectors whose leaky side (``<q, d> >= 0``) differs
   (``chip_smoke.pd_fault``), the elements of the forward's p, d that
   differ from the plain k16 model's (``_products(order="k16")``), and the
   RMS distance over the norm of dx, dW and dWd from the plain C' at the
   forward's p, d.  Exits 1 unless every count is 0.
2. C' bf16 at 256 -> 256 (N 16384) and 256 -> 128 (N 14336), batch 8, on
   ``chip_smoke.py`` phase 3's synthetic inputs, in that design: a call,
   back to back and on the device (``chip_smoke.cuda_ms``, ``stream_ms``,
   ``graph_ms``), each pass's device time (``chip_smoke.pass_ms``), and
   ``torch.bmm`` of pass 1's two products (bf16 W and Wd times x, float32
   out) back to back, a yardstick never on the port's path; and S's p
   against the in-order p there (the share that differs).
3. C' bf16 on ``chip_smoke.adversarial_c_inputs`` (every p, d a few
   float32 ulps from a bf16 midpoint; the cotangent ~1e-4) at the two
   widths of part 2, output by output (``adversarial_row``): the largest
   difference from the plain C' in k16 order beside the bound the ``gpu``
   tests hold it to (one bf16 ulp of the largest dx; 1e-4 of the largest
   float32 output), and, for dx, dW, dWd and dw_out, the kernel's and the
   plain version's largest distance from float64 sums of the same bf16
   operands.  A reading, not a check: it does not change the exit code.

Needs a CUDA card; imports nothing of JAX.  The first line is the card's
name and power limit; the last, every reading as one JSON object.
"""

from __future__ import annotations

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
    order = vlf.launch_order("C", x, w.shape[0], group)
    model = torch.stack([vlf._products(w, x, pb, group, order),
                         vlf._products(wd, x, db, group, order)])
    row = {"inputs": tag, "design": "/".join(designs), **cs.pd_fault(fwd, pd, a, b),
           "pd_elements_differing": int((pd.view(torch.int16) != fwd.view(torch.int16)).sum()),
           "model_elements_differing": int((model.view(torch.int16)
                                            != fwd.view(torch.int16)).sum()),
           "rms_dx_dw_dwd": [cs.bf16_rms(o, want) for o, want in zip(out[:3], at_fwd[:3])]}
    print(f"[fault] {tag}: {row['design']}: {row['pd_elements_differing']} elements "
          f"({row['pd_differs']:.4%}) of p, d differ from the forward C's, {row['side_flips']} "
          f"vectors take the other leaky side; the forward's p, d against the k16 model's: "
          f"{row['model_elements_differing']} differ; dx, dW, dWd RMS from the plain C' at the "
          f"forward's p, d {row['rms_dx_dw_dwd']}", flush=True)
    del fwd, at_fwd, pd, out, model
    return row


def adversarial_row(cs, tag, args):
    """Part 3 for one set of C' arguments (layer_project_bwd's, before the
    negative slope; no bias)."""
    import math

    import torch

    from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused as vlf
    from vn_pointcloudcompletion_tpu_torch.ops.vn_fused import (reference_bn_leaky_bwd,
                                                                reference_bn_leaky_planes)

    x, w, wd, pb, db, a, b, w_out, g = args
    got = vlf.layer_project_bwd(*args, cs.NS)
    order = vlf.launch_order("C'", x, w.shape[0])
    want = vlf.reference_layer_project_bwd(*args, cs.NS, order=order)
    # float64 sums of the operands both take: the bf16 dp, dd (the bf16
    # mode's dx, dW operands) and the float32 <o, g> terms
    p, d = vlf._planes(w, x, pb, 0, order), vlf._planes(wd, x, db, 0, order)
    dp, dd, _, _ = reference_bn_leaky_bwd(p, d, a, b, w_out[None, None, :, None] * g.float(),
                                          cs.NS)
    dp, dd, xd = dp.to(torch.bfloat16).double(), dd.to(torch.bfloat16).double(), x.double()
    exact = {"dx": torch.matmul(w.double().t(), dp) + torch.matmul(wd.double().t(), dd),
             "dw": torch.einsum("bjcn,bjkn->ck", dp, xd),
             "dwd": torch.einsum("bjcn,bjkn->ck", dd, xd),
             "dw_out": (reference_bn_leaky_planes(p, d, a, b, cs.NS) * g.float()).sum(1)
             .double().sum((0, 2))}
    del p, d, dp, dd, xd
    row = {"adversarial": tag,
           "design": vlf.launch_design("C'", x.shape[2], w.shape[0], x.shape[3], True, True)}
    names = ("dx", "dw", "dwd", "dpbias", "ddbias", "da", "db", "dw_out")
    for name, k, p_ in zip(names, got, want):
        if p_ is None:
            continue
        top = p_.float().abs().max().item()
        bound = (2.0 ** (math.floor(math.log2(top)) - 7) if p_.dtype == torch.bfloat16
                 else 1e-4 * top)
        out = {"max": top, "err": (k.float() - p_.float()).abs().max().item(), "bound": bound}
        if name in exact:
            out.update(kernel_vs_float64=(k.double() - exact[name]).abs().max().item(),
                       plain_vs_float64=(p_.double() - exact[name]).abs().max().item())
        row[name] = out
    print(f"[adversarial] {tag}: " + "; ".join(
        f"{n} {json.dumps(v)}" for n, v in row.items() if isinstance(v, dict)), flush=True)
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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cuda_lib.build_all()
    dev = torch.device("cuda")
    rows = []
    for path in ("flagship", "vn_pointr_448"):
        for i, args in enumerate(captured_c_bwd(cs, path, dev)):
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
    for c_out, n in ((256, 16384), (128, 14336)):
        args = cs.adversarial_c_inputs(dev, cs.BATCH, 256, c_out, n, 5)
        rows.append(adversarial_row(cs, f"256 -> {c_out}, N {n}", args))
        del args
        torch.cuda.empty_cache()
    faults = sum(r["pd_elements_differing"] + r["side_flips"] + r["model_elements_differing"]
                 for r in rows if "inputs" in r)
    verdict = ("none: every captured C' call takes its backward at the forward C's p, d"
               if faults == 0 else f"{faults} elements and flips")
    print(f"[fault] {verdict}", flush=True)
    print(json.dumps({"card": smi, "rows": rows}))
    return 0 if faults == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
