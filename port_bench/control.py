"""The control of a cell's comparison: the plain reference put in the
program's place, computed a step below the precision the configuration
states (float32 products in TF32), judged by the same comparison against
the reference in full float32, at the cell's own sizes.  It has to come out
as not correct.  ``--fault half_batch`` reads the fault of a step that
leaves half of the batch out, planted in the reference put in the program's
place: a train step takes the mean over the rest; a served batch answers
its second half with its first half's completions and scores.

    python3 port_bench/control.py --workload <cell> --seeds 11 12 13 [--fault half_batch]

One JSON line per seed on standard output: the numbers and the cell's
limits.  The benchmark's own runs never run this; it imports nothing of the
program.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3


def stage(arrays, device):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def readings(name: str, seed: int, device: torch.device, fault: str = "tf32") -> dict:
    from port_bench import check, harness, traffic, weights
    from port_bench.reference import matmul_precision, strict_float32
    from port_bench.reference import steps as reference

    _, work, config = harness.cell(harness.benchmark(), name)
    off = work["seed_offsets"]
    spec = reference.model(config).param_spec(config)
    w0 = weights.make(spec, seed + off["weights"], device)
    pool = traffic.pool(seed + off["data"], work["pool"], work["batch"], config["n_partial"],
                        config["n_dense"])
    if work["mode"] == "train":
        batches = [stage(pool[i], device) for i in range(STEPS)]
        with strict_float32():
            ref = reference.train_steps(config, w0, batches, work["lr"], STEPS)
        if fault == "half_batch":
            half = [(p[: len(p) // 2], c[: len(c) // 2]) for p, c in batches]
            with strict_float32():
                ctl = reference.train_steps(config, w0, half, work["lr"], STEPS)
        else:
            with matmul_precision(True):
                ctl = reference.train_steps(config, w0, batches, work["lr"], STEPS)
        return check.compare_train(ctl, ref, w0)
    rots = traffic.rotations(seed + off["rotation"], work["rotation"], work["pool"], work["batch"])
    kept, refs, scored = [], [], []
    for i in range(work["check_batches"] + 1):  # as many batches as a run keeps
        p, c = stage(pool[i % len(pool)], device)
        r = rots[i % len(pool)]
        r = None if r is None else torch.from_numpy(r).to(device)
        with strict_float32():
            refs.append(reference.serve(config, w0, p, c, r))
        if fault == "half_batch":
            kept.append(repeat_first_half(refs[-1]))
        else:
            with matmul_precision(True):
                kept.append(reference.serve(config, w0, p, c, r))
        with strict_float32():
            scored.append(reference.score(kept[-1]["dense"], c, r))
    return check.compare_serve(kept, refs, scored)


def repeat_first_half(out: dict) -> dict:
    """A served batch's outputs with its second half replaced by its first."""
    n = len(out["dense"])
    return {k: torch.cat([v[: n // 2], v[: n - n // 2]]) for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default="tf32", choices=("tf32", "half_batch"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from port_bench import harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA card (TF32 exists only there)", file=sys.stderr)
        return 2
    limits = harness.cell(harness.benchmark(), args.workload)[1]["limits"]
    for seed in args.seeds:
        out = readings(args.workload, seed, torch.device("cuda", 0), args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.fault,
                          "readings": out, "limits": limits,
                          "fails": any(out[k] > v for k, v in limits.items())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
