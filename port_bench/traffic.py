"""The one traffic generator: a pool of distinct synthetic batches and their
rotations, made on the host from the run's seed during set-up and cycled
through the window.

A cell's workload file gives the batch, the pool's size, the point counts
(from its configuration) and the rotation mode; the data come from the
frozen copy of the program's synthetic generator, the rotations from a
NumPy generator of their own.  The same seed gives the same pool.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from port_bench.frozen.synthetic import SyntheticCompletionDataset

SEED_MOD = 2 ** 63


def quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
    """Unit quaternions (..., 4) [w, x, y, z] -> rotations (..., 3, 3)."""
    w, x, y, z = np.moveaxis(q, -1, 0)
    m = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                  2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                  2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1)
    return m.reshape(q.shape[:-1] + (3, 3))


def rotations(seed: int, mode: str, count: int, batch: int) -> List[Optional[np.ndarray]]:
    """``count`` batches of row-vector rotations (batch, 3, 3) float32:
    uniform over SO(3) for ``so3`` (normalised Gaussian quaternions), None
    for ``none``."""
    if mode == "none":
        return [None] * count
    if mode != "so3":
        raise ValueError(f"rotation mode {mode!r}: the generator draws 'so3' or 'none'")
    q = np.random.default_rng(seed % SEED_MOD).standard_normal((count, batch, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True) + 1e-12
    return [m.astype(np.float32) for m in quaternion_to_matrix(q)]


def pool(seed: int, count: int, batch: int, n_partial: int,
         n_complete: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``count`` batches of (partial (batch, n_partial, 3), complete (batch,
    n_complete, 3)) float32, every sample distinct."""
    data = SyntheticCompletionDataset(count * batch, seed=seed % SEED_MOD,
                                      n_partial=n_partial, n_complete=n_complete)
    out = []
    for i in range(count):
        items = [data[i * batch + j] for j in range(batch)]
        out.append((np.stack([it[0] for it in items]), np.stack([it[1] for it in items])))
    return out
