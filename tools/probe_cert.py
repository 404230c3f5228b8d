#!/usr/bin/env python3
"""Device times of C''s certified pass 1 (csrc/vn_layer_bwd.cu pd_cert) with
its phases taken out, on one card:

    python3 tools/probe_cert.py [VARIANT ...]

A variant is a ``+``-joined list of phases to take out of pd_cert:
``resum`` (the uncertain elements keep their tensor-core value),
``epilogue`` (no dp, dd or partials), ``mma`` (no products: every element
certified at 0).  Example: ``resum epilogue resum+epilogue
mma+resum+epilogue``.  Each variant's copy of ``vn_layer_bwd.cu`` is built
beside the checkout's build (nvcc, the same flags, all at once) and stands
in for the library while C' runs through its wrapper at 256 -> 256 (N
16384) and 256 -> 128 (N 14336), batch 8, on the bf16 inputs of
``chip_smoke.py`` phase 3; pass 1's device time is torch.profiler's
(``chip_smoke.pass_ms``), beside the checkout's certified design and its
parent ("wgmma": pd_wide_fma).  A variant's results are wrong and are not
checked; the checkout's are held to the parent's bits.  Prints the card
and one line of times in ms per shape.  Run it from the root of a
checkout; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

# what each phase's removal replaces in pd_cert (each must occur once)
PHASES = {
    "resum": [("    resum(mine);\n  };", "  };"),
              ("  if (lane < queued) resum(queue[lane]);\n", "\n")],
    "epilogue": [("  pd_epilogue<kProjBwd, kSplit, 2, T, true>(args, accp, accd, t, bi, c0, n0);",
                  "  if (accp[0][0][0] == 12345.f && accd[0][0][0] == 1.f) args.partial[0] = 0.f;")],
    "mma": [("    steps(j);\n", "\n")],
}


def variant_source(src: str, spec: str) -> str:
    for phase in spec.split("+"):
        for old, new in PHASES[phase]:
            if src.count(old) != 1:
                raise ValueError(f"vn_layer_bwd.cu has no pd_cert of the expected shape ({phase})")
            src = src.replace(old, new)
    return src


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_cert: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib
    from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused as vlf

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cuda_lib.build_all()
    src = (cuda_lib.CSRC / "vn_layer_bwd.cu").read_text()
    out = cuda_lib.BUILD_DIR.parent / "probe_cert"
    out.mkdir(parents=True, exist_ok=True)
    for header in cuda_lib.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    procs = {}
    for i, spec in enumerate(sys.argv[1:]):
        cu, so = out / f"vn_layer_bwd_{i}.cu", out / f"vn_layer_bwd_{i}.so"
        cu.write_text(variant_source(src, spec))
        procs[spec] = (so, subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so),
                                             str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {"certified": cuda_lib._library("vn_layer_bwd.cu")}
    for spec, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {spec}:\n{text}")
        lib = ctypes.CDLL(str(so))
        lib.vnk_error_string.argtypes = [ctypes.c_int]
        lib.vnk_error_string.restype = ctypes.c_char_p
        libs[spec] = lib

    def use(lib):  # the wrappers of vn_layer_bwd.cu launch from `lib`
        cuda_lib._libs["vn_layer_bwd.cu"] = lib
        for k in cuda_lib.KERNELS:
            if k.source == "vn_layer_bwd.cu":
                k._fn = None

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for c_out, n in ((256, 16384), (128, 14336)):
        x = torch.randn(cs.BATCH, 3, 256, n, generator=g, device=dev).to(torch.bfloat16)
        w, wd = ((torch.rand(c_out, 256, generator=g, device=dev) - 0.5) / 8 for _ in range(2))
        a = torch.rand(c_out, generator=g, device=dev) + 0.5
        b = torch.randn(c_out, generator=g, device=dev) * 0.3
        w_out = (torch.rand(c_out, generator=g, device=dev) - 0.5) / 8
        gc = (torch.randn(cs.BATCH, 3, 1, n, generator=g, device=dev) * 1e-4).to(torch.bfloat16)
        fn = lambda: vlf.layer_project_bwd(x, w, wd, None, None, a, b, w_out, gc, cs.NS)  # noqa: E731
        use(libs["certified"])
        with cs.parent_designs():
            want = fn()
            parent = cs.pass_ms(fn)["pass1"]
        if not all(torch.equal(u, v) for u, v in zip(fn(), want) if u is not None):
            raise AssertionError("the certified design differs from the parent's")
        times = [f"parent (pd_wide_fma) {parent:.4f}"]
        for spec, lib in libs.items():
            use(lib)
            times.append(f"{spec} {cs.pass_ms(fn)['pass1']:.4f}")
        use(libs["certified"])
        print(f"C' bf16 256 -> {c_out}, N {n}, pass 1 device ms: " + ", ".join(times), flush=True)
        del x, gc
    return 0


if __name__ == "__main__":
    sys.exit(main())
