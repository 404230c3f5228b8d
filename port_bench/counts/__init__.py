"""The benchmark's own count of a step's work, from shapes.

Each configuration has a module here (``config['counts']``) whose
``forward(config, batch)`` lists the model's operations as :class:`Work`
items: the products' floating-point operations (two a multiply-add), the
elementwise float32 operations, and the bytes the operation needs to read
once and write once (float32 activations and weights).  Operations are
counted as the model defines them, never by which kernel or design runs
them.  ``step`` builds a train or serve step from them:

- train: the forward, the backward as twice the forward's products and
  bytes, the two Chamfer-L1 losses and Adam over the trainable parameters;
- serve: the rotation, the forward, the Chamfer distances of the dense
  cloud to the complete one, the F-score and the voxel IoU.

``least_s`` sums, over the items, the frozen ``bound``: max(bytes at the
HBM rate, products at the configuration's product rate plus elementwise
work at the FP32 rate).  ``flops`` is the products alone (``mfu``), plus
the Chamfer sweep's pair operations in a serve step.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import List

from port_bench.frozen.roofline import PEAK_BF16, PEAK_FP32, bound

F32 = 4
PAIR_OPS = 8  # a squared distance of two 3-D points: 3 subtractions, 3 products, 2 sums


@dataclass
class Work:
    name: str
    flops: float = 0.0  # products (tensor-core or FMA pipe)
    ew: float = 0.0  # elementwise float32 operations
    nbytes: float = 0.0


def product_peak(config: dict) -> float:
    return PEAK_BF16 if config.get("dtype") == "bfloat16" else PEAK_FP32


def model(config: dict):
    return importlib.import_module(f"port_bench.counts.{config['counts']}")


def chamfer(name: str, b: int, n: int, m: int) -> Work:
    """Both directions' nearest neighbours of (b, n) and (b, m) clouds: every
    pair's distance once, the clouds read and the distances, indices written."""
    return Work(name, ew=PAIR_OPS * b * n * m, nbytes=F32 * b * (3 * (n + m) + 2 * (n + m)))


def adam(params: int) -> Work:
    """p, g, m, v read, p, m, v written; about 12 operations a parameter."""
    return Work("adam", ew=12 * params, nbytes=7 * F32 * params)


def step(config: dict, mode: str, batch: int) -> dict:
    mod = model(config)
    fwd: List[Work] = mod.forward(config, batch)
    items: List[Work] = []
    if mode == "train":
        items += fwd
        items += [Work(w.name + ".bwd", 2 * w.flops, 2 * w.ew, 2 * w.nbytes) for w in fwd]
        nc, nd = mod.cloud_sizes(config)
        items += [chamfer("chamfer.coarse", batch, nc, config["n_dense"]),
                  chamfer("chamfer.dense", batch, nd, config["n_dense"]), adam(mod.params(config))]
        flops = 3 * sum(w.flops for w in fwd)
    elif mode == "serve":
        nd = mod.cloud_sizes(config)[1]
        n = config["n_partial"] + config["n_dense"]
        items.append(Work("rotate", flops=2 * 9 * batch * n, nbytes=2 * F32 * 3 * batch * n))
        items += fwd
        sweep = chamfer("chamfer.dense", batch, nd, config["n_dense"])
        items += [sweep,
                  Work("fscore", ew=6 * batch * (nd + config["n_dense"]),
                       nbytes=F32 * batch * (nd + config["n_dense"])),
                  Work("voxel_iou", ew=20 * batch * (nd + config["n_dense"]),
                       nbytes=F32 * 3 * batch * (nd + config["n_dense"]))]
        flops = items[0].flops + sum(w.flops for w in fwd) + sweep.ew
    else:
        raise ValueError(f"no count for mode {mode!r}")
    peak = product_peak(config)
    least = sum(bound(w.nbytes, w.flops, peak, w.ew)[0] for w in items) * 1e-3
    return {"flops": flops, "least_s": least, "peak": peak, "items": items}
