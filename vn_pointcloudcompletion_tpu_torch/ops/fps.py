"""Furthest point sampling and its gathers (port of ``ops/fps.py``).

:func:`furthest_point_sample` takes kernel F (``ops/fps_pallas.py``) where
the JAX package takes its Pallas kernel on a TPU (``fps_pallas.eligible``)
and the plain version elsewhere; ``use_kernels=False`` takes the plain
version everywhere.  Gathers along the point axis index with a (B, S) array;
their backward is a sort-based ``index_put_``, so a repeated index (FPS of
a cloud with fewer distinct points than samples) sums in a fixed order.
"""

from __future__ import annotations

import torch

from vn_pointcloudcompletion_tpu_torch.ops import fps_pallas


def furthest_point_sample(xyz: torch.Tensor, num_samples: int,
                          use_kernels: bool = True) -> torch.Tensor:
    """Greedy furthest-point sampling from index 0: xyz (B, N, 3) -> (B, S)
    int32."""
    b, n, _ = xyz.shape
    if use_kernels and fps_pallas.eligible(b, n, num_samples):
        return fps_pallas.furthest_point_sample_kernel(xyz, num_samples)
    return fps_pallas.reference_furthest_point_sample(xyz, num_samples)


def take_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along the last axis: x (B, ..., N), idx (B, S) -> (B, ..., S)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x.movedim(-1, 1)[rows, idx.long()].movedim(1, -1)


def concat_points(coarse: torch.Tensor, sampled: torch.Tensor) -> torch.Tensor:
    """The coarse points with the sampled input points appended, in the
    wider of their dtypes (``jnp.concatenate``'s promotion: bf16 coarse
    points with float32 FPS points give float32)."""
    ct = torch.promote_types(coarse.dtype, sampled.dtype)
    return torch.cat([coarse.to(ct), sampled.to(ct)], dim=1)


def fps(pc: torch.Tensor, num_samples: int, use_kernels: bool = True) -> torch.Tensor:
    """Subsample a cloud: pc (B, N, 3) -> (B, S, 3)."""
    idx = furthest_point_sample(pc, num_samples, use_kernels)
    return take_points(pc.transpose(1, 2), idx).transpose(1, 2)
