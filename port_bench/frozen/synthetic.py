"""Synthetic completion dataset — procedural shapes with partial views.

Frozen copy of ``vn_pointcloudcompletion_tpu_torch/data/synthetic.py`` at
commit 15a5d0c (the benchmark's traffic generator; later changes to the
program do not move the yardstick).  The point counts are the PCN ones
(2048 partial, 16384 complete) unless the caller gives others.

Not in the reference (it assumes the PCN dataset on disk); used here so the
full train/eval harness, benchmarks, and tests run end-to-end without the
28 GB ShapeNet-PCN download.  Samples watertight primitives (box / sphere /
cylinder surfaces), takes a half-space cut as the "partial scan", and
normalises into the PCN value range (~[-0.35, 0.35], see train.py:234).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

N_PARTIAL = 2048
N_COMPLETE = 16384


def _sample_surface(kind: int, n: int, rng: np.random.Generator) -> np.ndarray:
    if kind == 0:  # sphere
        v = rng.standard_normal((n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
        return v
    if kind == 1:  # box surface
        face = rng.integers(0, 6, n)
        uv = rng.uniform(-1, 1, (n, 2))
        pts = np.empty((n, 3))
        axis = face % 3
        sign = np.where(face < 3, 1.0, -1.0)
        for a in range(3):
            m = axis == a
            others = [i for i in range(3) if i != a]
            pts[m, a] = sign[m]
            pts[np.ix_(m, others)] = uv[m]
        return pts
    # cylinder surface (with caps)
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-1, 1, n)
    pts = np.stack([np.cos(theta), np.sin(theta), z], axis=1)
    caps = rng.random(n) < 0.2
    r = np.sqrt(rng.random(caps.sum()))
    th = rng.uniform(0, 2 * np.pi, caps.sum())
    pts[caps] = np.stack(
        [r * np.cos(th), r * np.sin(th), np.sign(rng.standard_normal(caps.sum()))],
        axis=1,
    )
    return pts


class SyntheticCompletionDataset:
    """Deterministic per-index synthetic (partial, complete) pairs."""

    def __init__(self, num_samples: int = 64, seed: int = 0,
                 n_partial: int = N_PARTIAL, n_complete: int = N_COMPLETE):
        self.num_samples = num_samples
        self.seed = seed
        self.n_partial = n_partial
        self.n_complete = n_complete

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100003 + index)
        kind = int(rng.integers(0, 3))
        scale = rng.uniform(0.15, 0.3, 3)
        complete = _sample_surface(kind, self.n_complete, rng) * scale

        # partial view: keep points on one side of a random plane
        normal = rng.standard_normal(3)
        normal /= np.linalg.norm(normal)
        side = complete @ normal
        keep = side > np.quantile(side, 0.45)
        part = complete[keep]
        idx = rng.integers(0, len(part), self.n_partial)
        partial = part[idx]
        return partial.astype(np.float32), complete.astype(np.float32)
