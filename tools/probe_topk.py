#!/usr/bin/env python3
"""Device times of variants of kernel K1's stream design on one card:

    python3 tools/probe_topk.py [VARIANT ...]

A variant is a comma-separated list of ``NAME=VALUE`` settings of the
design's constants in ``csrc/knn.cu`` (``kTopkLanes``, ``kTopkCols``,
``kTopkStages``), or ``floor``: the design with its selection taken out
(each lane folds its values into one minimum, so the time is that of the
copies and the scan alone; its results are wrong and are not checked).
Example: ``kTopkStages=2 kTopkLanes=2 kTopkCols=32,kTopkStages=4 floor``.
Each variant's copy of ``knn.cu`` is built beside the checkout's build
(nvcc, the same flags, all at once) and its K1 entry timed by CUDA-graph
replay (``chip_smoke.graph_ms``), beside the checkout's stream and warp
designs and ``torch.topk``, over the (8, 2048, M) distance matrices of the
main path's rotated partial scans (M 2048 at k 16, 40 and 64, M 4096 at
k 16 and 64) and a uniform random (8, 2048, 2048) matrix at k 16; every
result but the floor's must equal the plain version's.  Prints the card,
each variant's registers (ptxas) and one line of times in ms per matrix.
Run it from the root of a checkout; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

OFFERS = """          sel.offer(x[u].x, j);
          sel.offer(x[u].y, j + 1);
          sel.offer(x[u].z, j + 2);
          sel.offer(x[u].w, j + 3);"""


def variant_source(src: str, spec: str) -> str:
    if spec == "floor":
        fold = "          acc = fminf(acc, fminf(fminf(x[u].x, x[u].y), fminf(x[u].z, x[u].w)));"
        decl = "  BufferedSelect<K, kTopkLanes> sel(bufv, bufi);\n"
        tail = "  sel.flush();\n  const int64_t row = row0 + r;"
        for part in (OFFERS, decl, tail):
            if part not in src:
                raise ValueError("knn.cu has no stream design of the expected shape")
        return (src.replace(OFFERS, fold).replace(decl, decl + "  float acc = INFINITY;\n")
                .replace(tail, "  sel.offer(acc, 0);\n" + tail))
    for setting in spec.split(","):
        name, value = setting.split("=")
        src, n = re.subn(rf"constexpr int {name} = [^;]*;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise ValueError(f"no constant {name} in knn.cu")
    return src


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_topk: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib, knn_pallas
    from vn_pointcloudcompletion_tpu_torch.ops.rotations import rotate_points

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cuda_lib.build_all()
    src = (cuda_lib.CSRC / "knn.cu").read_text()
    out = cuda_lib.BUILD_DIR.parent / "probe_topk"
    out.mkdir(parents=True, exist_ok=True)
    for header in cuda_lib.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    procs = {}
    for i, spec in enumerate(sys.argv[1:]):
        cu, so = out / f"knn_{i}.cu", out / f"knn_{i}.so"
        cu.write_text(variant_source(src, spec))
        procs[spec] = (so, subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so),
                                             str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    entries = {"stream": ctypes.CDLL(str(cuda_lib.library_path(cuda_lib.CSRC / "knn.cu")))}
    for spec, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {spec}:\n{text}")
        lines = text.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "topk_min_stream" in line:
                used = next((x for x in lines[i + 1:i + 6] if "Used" in x), "").strip()
                print(f"[{spec}] K {re.search(r'ILi(\d+)E', line).group(1)}: "
                      f"{used.split(':', 1)[-1].strip()}")
        entries[spec] = ctypes.CDLL(str(so))
    for lib in entries.values():
        lib.topk_min.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.topk_min.restype = ctypes.c_int

    dev = torch.device("cuda")
    partial, complete, rot = cs.main_path_batch(dev)
    q = rotate_points(partial, rot)
    mats = {"scans 2048": knn_pallas.pairwise_sqdist(q, q),
            "scans 4096": knn_pallas.pairwise_sqdist(q, rotate_points(complete[:, :4096], rot)),
            "uniform 2048": torch.rand(8, 2048, 2048, device=dev,
                                       generator=torch.Generator(device=dev).manual_seed(0))}
    for what, k in (("scans 2048", 16), ("uniform 2048", 16), ("scans 2048", 40),
                    ("scans 2048", 64), ("scans 4096", 16), ("scans 4096", 64)):
        d = mats[what]
        b, n, m = d.shape
        want = knn_pallas.reference_topk_min(d, k)
        vals = torch.empty((b, n, k), device=dev)
        idx = torch.empty((b, n, k), device=dev, dtype=torch.int32)
        times = []
        for name, lib in [("warp", entries["stream"]), *entries.items()]:
            design = knn_pallas.TOPK_DESIGNS.index("warp" if name == "warp" else "stream")

            def launch(lib=lib, design=design):
                err = lib.topk_min(d.data_ptr(), vals.data_ptr(), idx.data_ptr(), b * n, m, k,
                                   design, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"topk_min: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            if name != "floor" and not (torch.equal(vals, want[0]) and torch.equal(idx, want[1])):
                raise AssertionError(f"{name} disagrees with the plain version on {what}, k {k}")
            times.append(f"{name} {cs.graph_ms(launch):.4f}")
        bound = (d.numel() * 4 + b * n * k * 8) / cs.PEAK_BYTES * 1e3
        library = cs.graph_ms(lambda: torch.topk(d, k, dim=-1, largest=False))
        print(f"(8, 2048, {m}) {what.split()[0]}, k {k}: bound {bound:.4f}; "
              + ", ".join(times) + f"; torch.topk {library:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
