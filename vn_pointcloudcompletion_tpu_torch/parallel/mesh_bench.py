"""Data-parallel scaling probe (port of ``parallel/mesh_bench.py``).

Runs the data-parallel train step (``parallel/train_parallel.py``) on 1, 2,
4 and 8 ranks of this host at a fixed GLOBAL batch of 8 and reports train
steps per second per size.  The point is the shape of the scaling curve (do
the collectives and the per-rank split scale?), not absolute speed.  By
default the ranks are NCCL processes, one card each (``cuda:{rank}``; the
sizes default to those the visible cards allow, and a size beyond them is
refused).  ``--device cpu`` runs JAX's probe as it is: gloo processes
sharing the host's cores, each with ``cores // size`` intra-op threads.
The model is the JAX probe's small flagship (``vn_pointnet`` +
``vn_foldingnet``, 256 coarse points, latent 512, coarse only, no
rotation); each size's rate is the best of 2-step chunks, to damp scheduler
noise.

Usage: ``python -m vn_pointcloudcompletion_tpu_torch.parallel.mesh_bench
[--device cuda|cpu] [--sizes 1 2 ...]`` prints ONE JSON line:
``{"steps_per_sec": {"1": ..., "2": ...}, "speedup_vs_1": {...},
"global_batch": 8, "platform": "gpu-nccl" or "cpu-gloo", "host_cores": N}``.
"""

from __future__ import annotations

import json
import os
import time
from datetime import timedelta
from typing import Optional

BATCH = 8
CHUNK = 2
SIZES = (1, 2, 4, 8)
PLATFORMS = {"cuda": "gpu-nccl", "cpu": "cpu-gloo"}


def _rank_bench(rank, world, init, device, iters, warmup, timeout, rates):
    """One rank: ``warmup`` steps, then the best rate of ``iters // CHUNK``
    chunks; rank 0 reports it."""
    import numpy as np
    import torch

    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.parallel.mesh import (
        data_sharding,
        destroy_mesh,
        make_mesh,
    )
    from vn_pointcloudcompletion_tpu_torch.parallel.train_parallel import (
        make_parallel_steps,
        shard_state,
    )
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state
    from vn_pointcloudcompletion_tpu_torch.utils.config import Config

    if device == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = make_mesh(rank, world, init, device, timeout=timeout)
    try:
        config = Config.from_dict(dict(
            enc_type="vn_pointnet", dec_type="vn_foldingnet", num_coarse=256,
            latent_dim=512, only_coarse=True, batch_size=BATCH, lr=1e-4, rotation="none"))
        state = shard_state(create_train_state(build_model(config).to(mesh.device), config,
                                               100), mesh)
        train_step, _ = make_parallel_steps(config, mesh)
        rng = np.random.default_rng(0)
        partial, complete = (data_sharding(mesh, torch.from_numpy(
            (rng.standard_normal((BATCH, n, 3)) * 0.2).astype(np.float32))).to(mesh.device)
            for n in (512, 2048))
        gen = torch.Generator().manual_seed(1)
        for _ in range(warmup):
            float(train_step(state, partial, complete, gen)["total"])
        best = 0.0
        # max(1, ...): iters < CHUNK still times one chunk
        for _ in range(max(1, iters // CHUNK)):
            t0 = time.perf_counter()
            for _ in range(CHUNK):
                metrics = train_step(state, partial, complete, gen)
            float(metrics["total"])
            best = max(best, CHUNK / (time.perf_counter() - t0))
    finally:
        destroy_mesh()
    if rank == 0:
        rates.put(best)


def main(sizes=None, iters: int = 6, warmup: int = 2,
         deadline: Optional[float] = None, device: str = "cuda") -> dict:
    """Time each size, print the JSON line and return it as a dict.
    ``device`` "cuda": NCCL ranks, one card each; "cpu": gloo ranks on the
    host.  ``sizes`` default to 1, 2, 4, 8 (on the card, those the visible
    cards allow).  ``deadline``: each size's, in seconds, its collectives'
    timeout too."""
    import torch
    import torch.multiprocessing as mp

    from vn_pointcloudcompletion_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT, spawn_ranks

    if device not in PLATFORMS:
        raise ValueError(f"device {device!r}: cuda or cpu")
    cards = torch.cuda.device_count() if device == "cuda" else 0
    if sizes is None:
        sizes = SIZES if device == "cpu" else tuple(s for s in SIZES if s <= cards)
    if device == "cuda" and (not sizes or max(sizes) > cards):
        raise RuntimeError(f"sizes {tuple(sizes)} need one card a rank; {cards} visible "
                           "(--device cpu runs gloo ranks on the host)")
    timeout = DEFAULT_TIMEOUT if deadline is None else timedelta(seconds=deadline)
    results = {}
    for world in sizes:
        rates = mp.get_context("spawn").SimpleQueue()
        spawn_ranks(_rank_bench, world, device, iters, warmup, timeout, rates,
                    deadline=deadline)
        results[str(world)] = round(rates.get(), 3)
    base = results[str(sizes[0])]
    out = {
        "steps_per_sec": results,
        "speedup_vs_1": {k: round(v / base, 2) for k, v in results.items()},
        "global_batch": BATCH,
        "platform": PLATFORMS[device],
        "host_cores": os.cpu_count(),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=sorted(PLATFORMS), default="cuda",
                        help="cuda (default): NCCL ranks, one card each; cpu: gloo ranks")
    parser.add_argument("--sizes", type=int, nargs="+", default=None,
                        help="the world sizes to time (default 1 2 4 8, on the card those "
                             "the visible cards allow)")
    args = parser.parse_args()
    main(sizes=args.sizes, device=args.device)
