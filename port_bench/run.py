"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (kernels built or loaded from ``build/kernels/``, weights and the
data pool made from the seed, the cell's shapes warmed up) is timed from
the start of this script; then the window runs for ``--seconds``; with
``--trace 1`` a few more steps run under the profiler.  After the window
the program's state is freed and its outputs are judged against the plain
reference.  The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error.  Exits non-zero, printing no result, without a CUDA card or when
JAX or the JAX package has been loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
          "TRITON_CACHE_DIR": ROOT / "build" / "triton"}
# One host thread for PyTorch's and the BLAS libraries' CPU work: with the
# default eight, the completions per second of three runs of a serve cell
# ranged over 16-21% of their median, and over 1-3% on one thread (one
# H100, 700 W).
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)
    os.environ.update(THREADS)
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)

    from port_bench import harness
    from port_bench.tracing import stamp

    stamp("imports", start=T0)
    chips = next(w["chips"] for w in harness.benchmark()["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    stamp("CUDA context")
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), device, T0)
    print(f"[card] {card_line()}", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"port_bench: modules loaded that the benchmark forbids: {bad}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"[compared] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
