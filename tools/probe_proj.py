#!/usr/bin/env python3
"""Device times of kernel C's bf16 designs (csrc/vn_layer_fused.cu: the
parent "wide" design, proj_wide_mma with its W^T transpose and proj_sum;
the "wgmma" design, proj_wgmma) split into their phases, on one card:

    python3 tools/probe_proj.py [VARIANT ...]

A variant is a ``+``-joined list of phases to take out of one kernel.  Of
proj_wide_mma: ``loads`` (no cp.async staging: the stages keep whatever
they hold), ``mma`` (no mma.sync: the fragments are still read by
ldmatrix), ``frag`` (neither ldmatrix nor mma.sync), ``epilogue`` (no bias,
BN-leaky or w_out contraction: the accumulators summed into the
projection).  Of proj_wgmma: ``wg_loads`` (no TMA loads: the producer
arrives on the stages' barriers itself), ``wg_mma`` (no wgmma),
``wg_epilogue`` (the epilogue warpgroups skip their rounds).  Example:
``epilogue loads+epilogue wg_epilogue wg_loads+wg_mma``.  Each variant's
copy of ``vn_layer_fused.cu`` is built beside the checkout's build (nvcc,
the same flags, all at once) and stands in for the library while C runs
through its wrapper in the design whose kernel the variant changes (the
"wide" design held by ``chip_smoke.parent_designs``), at 256 -> 256 -> 1
(N 16384) and 256 -> 128 -> 1 (N 14336), batch 8, group 0, no bias.  A
variant's results are wrong and are not checked; one that leaves the
epilogue's inputs unset (zero or stale) times its slow paths as well.  For
the checkout's own build it prints each design's call
(``chip_smoke.cuda_ms``), back to back (``stream_ms``) and device
(``graph_ms``) times, each kernel of a call by torch.profiler (the
transpose, the product kernel, proj_sum), and ``torch.bmm`` of the call's
two products (W x and Wd x, bf16 operands, float32 out, back to back): the
yardstick, never on the port's path.  Prints the card and one line per
shape.  Run it from the root of a checkout; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
import sys

_EPILOGUE_START = "  // The epilogue on the fragments:"
_EPILOGUE_END = "  // the warp's eight channel rows"
_EPILOGUE_STUB = """  float proj[3][2][2];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = 0.f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int r = 0; r < 2; ++r) s += accp[j][mt][nt][2 * r + e] + accd[j][mt][nt][2 * r + e];
        proj[j][nt][e] = s;
      }
"""
# what each phase's removal replaces in proj_wide_mma (each must occur once)
PHASES = {
    "loads": [("    T* st = sm + s * P::kStage;\n",
               "    if (kt >= 0) return;\n    T* st = sm + s * P::kStage;\n")],
    "mma": [("""          mma_bf16(accp[j][mt][0], fw[mt], fx[0], fx[1]);
          mma_bf16(accp[j][mt][1], fw[mt], fx[2], fx[3]);
          mma_bf16(accd[j][mt][0], fd[mt], fx[0], fx[1]);
          mma_bf16(accd[j][mt][1], fd[mt], fx[2], fx[3]);
""", "")],
    "frag": [("for (int ks = 0; ks < P::kKs; ks += 16) {\n      unsigned fw[2][4], fd[2][4];",
              "for (int ks = 0; ks < 0; ks += 16) {\n      unsigned fw[2][4], fd[2][4];")],
}
# ... and in proj_wgmma (the "wgmma" design)
PHASES.update({
    "wg_loads": [("""              mbar_expect_tx(&x_full[kc], 3 * P::kBox);
              for (int j = 0; j < 3; ++j)
                tma_load(xs + (kc * 3 + j) * P::kBox, &tm_x, &x_full[kc], n0, kc * kWgDepth,
                         bi * 3 + j);
""", "              mbar_arrive(&x_full[kc]);\n"),
                 ("""            mbar_expect_tx(&w_full[s], P::kStage);
            unsigned char* st = ws + s * P::kStage;
            tma_load(st, &tm_wt, &w_full[s], cb * kWgDepth, kc * kWgDepth, 0);
            tma_load(st + P::kBox, &tm_wt, &w_full[s], cb * kWgDepth, kc * kWgDepth, 1);
""", "            mbar_arrive(&w_full[s]);\n")],
    "wg_mma": [("      wgmma_m64n64k16_tt(acc[j], da, gmma_desc(xc + j * ProjWg::kBox + kk * 2048, "
                "ProjWg::kBox,\n                                               1024));\n",
                "      (void)da;\n")],
    "wg_epilogue": [("""        proj_wg_round(pd, abw, rb, 2 * (v / 8), v, lane, one_minus_ns);
        proj_wg_round(pd, abw, rb, 2 * (v / 8) + 1, v, lane, one_minus_ns);
""", "")],
})

def variant_source(src: str, spec: str) -> str:
    for phase in spec.split("+"):
        if phase == "epilogue":
            if src.count(_EPILOGUE_START) != 1 or src.count(_EPILOGUE_END) != 1:
                raise ValueError("vn_layer_fused.cu has no proj_wide_mma of the expected shape")
            i, j = src.index(_EPILOGUE_START), src.index(_EPILOGUE_END)
            src = src[:i] + _EPILOGUE_STUB + src[j:]
            continue
        for old, new in PHASES[phase]:
            if src.count(old) != 1:
                raise ValueError(f"vn_layer_fused.cu has no proj_wide_mma of the expected "
                                 f"shape ({phase})")
            src = src.replace(old, new)
    return src


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_proj: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
    from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused as vlf

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cuda_lib.build_all()
    src = (cuda_lib.CSRC / "vn_layer_fused.cu").read_text()
    out = cuda_lib.BUILD_DIR.parent / "probe_proj"
    out.mkdir(parents=True, exist_ok=True)
    for header in cuda_lib.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    procs = {}
    for i, spec in enumerate(sys.argv[1:]):
        cu, so = out / f"vn_layer_fused_{i}.cu", out / f"vn_layer_fused_{i}.so"
        cu.write_text(variant_source(src, spec))
        procs[spec] = (so, subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so),
                                             str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {"build": cuda_lib._library("vn_layer_fused.cu")}
    for spec, (so, proc) in procs.items():
        if len({p.startswith("wg_") for p in spec.split("+")}) > 1:
            raise ValueError(f"{spec}: phases of one kernel a variant")
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {spec}:\n{text}")
        lib = ctypes.CDLL(str(so))
        lib.vnk_error_string.argtypes = [ctypes.c_int]
        lib.vnk_error_string.restype = ctypes.c_char_p
        libs[spec] = lib

    def use(lib):  # the wrappers of vn_layer_fused.cu launch from `lib`
        cuda_lib._libs["vn_layer_fused.cu"] = lib
        for k in cuda_lib.KERNELS:
            if k.source == "vn_layer_fused.cu":
                k._fn = None

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    for c_out, n in ((256, 16384), (128, 14336)):
        x = torch.randn(cs.BATCH, 3, 256, n, generator=g, device=dev).to(bf)
        w, wd = ((torch.rand(c_out, 256, generator=g, device=dev) - 0.5) / 8 for _ in range(2))
        a = torch.rand(c_out, generator=g, device=dev) + 0.5
        b = torch.randn(c_out, generator=g, device=dev) * 0.3
        w_out = (torch.rand(c_out, generator=g, device=dev) - 0.5) / 8
        fn = lambda: vlf.vn_layer_fused_project(x, w, wd, None, None, a, b, w_out, cs.NS)  # noqa: E731
        use(libs["build"])
        parts, line = {}, []
        for design in ("wide", "wgmma"):
            with cs.parent_designs() if design == "wide" else contextlib.nullcontext():
                got, designs = cs.launched_designs(fn)
                if designs != [design]:
                    raise AssertionError(f"C bf16 took {designs}, not the {design} design")
                call = cs.cuda_ms(fn, 20), cs.stream_ms(fn, 20), cs.graph_ms(fn)
                line.append(f"the {design} design: a call {call[0]:.4f} ms, back to back "
                            f"{call[1]:.4f}, device {call[2]:.4f}")
                parts[design] = cs.kernel_ms(fn, cs.PROJ_KERNELS)
                for spec, lib in libs.items():
                    if spec != "build" and spec.startswith("wg_") == (design == "wgmma"):
                        use(lib)
                        parts[spec] = cs.kernel_ms(fn, cs.PROJ_KERNELS)
                use(libs["build"])
        x1 = x.reshape(cs.BATCH * 3, 256, n)
        w1 = torch.cat([w, wd], 0).to(bf).expand(cs.BATCH * 3, -1, -1).contiguous()
        bmm = cs.stream_ms(lambda: torch.bmm(w1, x1, out_dtype=torch.float32), 20)
        print(f"C bf16 256 -> {c_out} -> 1, N {n}, batch {cs.BATCH}: " + "; ".join(line)
              + "; by kernel (device ms, torch.profiler): "
              + "; ".join(f"{spec}: " + ", ".join(f"{k} {v:.4f}" for k, v in p.items() if v)
                          for spec, p in parts.items())
              + f"; torch.bmm of W x and Wd x (float32 out, back to back) {bmm:.4f}",
              flush=True)
        del x, x1, w1, got
    return 0


if __name__ == "__main__":
    sys.exit(main())
