"""Chamfer distance: bidirectional nearest-neighbour squared distances.

Port of ``vn_pointcloudcompletion_tpu/ops/chamfer.py::chamfer_distance``,
forward only (its gradient arrives with training).  3-D clouds with enough
pairs take :func:`nn_bidirectional`, which is kernel D on the card, exactly
where the JAX package takes its Pallas kernel on a TPU (chamfer.py:102);
everything else takes the plain diff-form version, any dimension.
"""

from __future__ import annotations

import torch

from vn_pointcloudcompletion_tpu_torch.ops.chamfer_pallas_bidir import (
    nn_bidirectional,
    nn_bidirectional_reference,
)


def _use_kernel(x: torch.Tensor, y: torch.Tensor) -> bool:
    return (
        x.dtype == torch.float32 and x.shape[-1] == 3
        and x.shape[1] * y.shape[1] >= 256 * 256
    )


def chamfer_distance(x: torch.Tensor, y: torch.Tensor):
    """x (B, N, D), y (B, M, D) -> (dist1 (B, N), dist2 (B, M), idx1, idx2):
    squared distances and int32 indices of the nearest neighbours."""
    ct = torch.promote_types(torch.promote_types(x.dtype, y.dtype), torch.float32)
    x, y = x.to(ct), y.to(ct)
    if _use_kernel(x, y):
        d1, i1, d2, i2 = nn_bidirectional(x, y)
    else:
        d1, i1, d2, i2 = nn_bidirectional_reference(x, y)
    return d1, d2, i1, i2
