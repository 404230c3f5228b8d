#!/usr/bin/env python3
"""Which kernel moves the flagship's bf16 train-step gradients away from
their plain versions, on one card:

    python3 tools/step_attribution.py

``chip_smoke.py`` phase 13 holds the flagship's bf16 step through the
kernels (A, A', S, S', B, B', C, C') against the same step with every
kernel's plain version in its place (``chip_smoke.kernels_as_plain``: the
kernels' dispatch, rounding points and summation orders in plain PyTorch),
gradient by gradient, as the RMS distance over the norm.  This script takes
that step (full width, batch 8, phase 13's batch and rotation, random
weights, one ``DecisionTape`` replayed into every run) and swaps one kernel
at a time:

- ``only``: the step with that kernel alone in its plain version, against
  the step through every kernel (the distance that kernel adds);
- ``all_but``: the step with every plain version but that kernel's,
  against the step with every plain version (the distance that kernel adds
  on the plain path).

Each reading names the largest gradient and gives ``watch`` (phase 13's
largest, ``encoder.first_conv.0.map_to_feat.weight``).  Both for the
weights of seeds 0 and 1, so that one model's reading is not taken for all.
Needs a CUDA card; imports nothing of JAX.  The first line is the card's
name and power limit; the last, every reading as one JSON object.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WATCH = "encoder.first_conv.0.map_to_feat.weight"


def reading(cs, got, want):
    """{largest gradient, its distance, WATCH's distance}."""
    d = cs.rms_errs(got, want)
    top = max(d, key=d.get)
    return {"largest": top, "rms": d[top], "watch": d[WATCH]}


def attribute(cs, dev, seed, partial, complete):
    """The readings of one model (weights from ``seed``)."""
    import torch

    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model

    config = cs._smoke_config(lr=1e-4, rotation="so3", seed=seed)  # phase 13's at seed 0
    model = build_model(config).to(dev)

    def run(only=(), everything=False):
        with cs.kernels_as_plain(None if everything else only):
            return cs.bf16_step_grads(model, config, partial, complete, torch.bfloat16)[2]

    with cs.DecisionTape() as tape:
        tape.run()
        kern = run()
        picks = {k: v for k, v in tape.rec.items() if k[0] != "mask"}  # as phase 13
        tape.run(picks)
        plain = run(everything=True)
        rows = {"all": reading(cs, kern, plain)}
        print(f"[seed {seed}] every kernel against every plain version: {rows['all']}",
              flush=True)
        names = list(cs.PLAIN_SWAPS)
        for name in names:
            t0 = time.time()
            tape.run(picks)
            only = reading(cs, run((name,)), kern)
            tape.run(picks)
            all_but = reading(cs, run(tuple(k for k in names if k != name)), plain)
            rows[name] = {"only": only, "all_but": all_but}
            print(f"[seed {seed}] {name}: alone in its plain version, against every kernel "
                  f"{only}; every plain version but {name}'s, against every plain version "
                  f"{all_but} ({time.time() - t0:.1f} s)", flush=True)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("step_attribution: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cuda_lib.build_all()
    dev = torch.device("cuda")
    partial, complete, _ = cs.main_path_batch(dev)
    out = {"card": smi, "watch": WATCH,
           "seeds": {seed: attribute(cs, dev, seed, partial, complete) for seed in (0, 1)}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
