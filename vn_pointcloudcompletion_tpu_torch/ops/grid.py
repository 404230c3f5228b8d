"""Folding seed grids (port of ``vn_pointcloudcompletion_tpu/ops/grid.py``).

The first coordinate varies fastest, as ``torch.linspace(...).view(1, g)
.expand(g, g)`` in the reference decoders.
"""

from __future__ import annotations

import torch


def folding_grid_2d(grid_size: int, extent: float = 0.05) -> torch.Tensor:
    """(2, grid_size**2) 2-D folding seed in [-extent, extent]^2."""
    lin = torch.linspace(-extent, extent, grid_size, dtype=torch.float32)
    a = lin[None, :].expand(grid_size, grid_size).reshape(-1)
    b = lin[:, None].expand(grid_size, grid_size).reshape(-1)
    return torch.stack([a, b], dim=0)


def folding_grid_3d(grid_size: int, extent: float = 0.05) -> torch.Tensor:
    """(3, grid_size**2) seed on the z=0 plane."""
    ab = folding_grid_2d(grid_size, extent)
    return torch.cat([ab, torch.zeros(1, grid_size * grid_size)], dim=0)
