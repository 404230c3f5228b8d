"""Rotation sampling and application, driven by a ``torch.Generator``.

Port of ``vn_pointcloudcompletion_tpu/ops/rotations.py``.  Conventions match
pytorch3d as the reference uses it: rotations act on row-vector points,
``p_out = p @ R``; uniform SO(3) comes from normalised Gaussian quaternions.
The two frameworks draw different numbers from the same seed, so tests hand
both sides the same matrices.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) [w, x, y, z] -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    m = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
            2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
            2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def random_rotations(generator: torch.Generator, batch: int) -> torch.Tensor:
    """Uniform SO(3) rotation matrices (batch, 3, 3), float32 on the CPU."""
    q = torch.randn(batch, 4, generator=generator)
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    return quaternion_to_matrix(q)


def random_z_rotations(generator: torch.Generator, batch: int) -> torch.Tensor:
    """Uniform rotations about the Z axis (batch, 3, 3), float32 on the CPU."""
    ang = torch.rand(batch, generator=generator) * (2 * math.pi)
    c, s = torch.cos(ang), torch.sin(ang)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    m = torch.stack([c, -s, zero, s, c, zero, zero, zero, one], dim=-1)
    return m.reshape(batch, 3, 3)


def rotate_points(points: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Row-vector rotation: points (B, N, 3) or (N, 3), rot (B, 3, 3) ->
    (B, N, 3)."""
    if points.ndim == 2:
        return torch.einsum("nd,bde->bne", points, rot)
    return torch.einsum("bnd,bde->bne", points, rot)


def sample_rotation(generator: torch.Generator, mode: str,
                    batch: int) -> Optional[torch.Tensor]:
    """Rotation matrices for an augmentation mode, or None.

    ``mode`` in {'none', 'canonical', 'z', 'so3'}; 'canonical' is a no-op, as
    in the reference.
    """
    if mode == "z":
        return random_z_rotations(generator, batch)
    if mode == "so3":
        return random_rotations(generator, batch)
    return None
