"""Evaluation metrics (port of ``metrics/metrics.py``; reference
``metrics/metric.py`` + ``utils/voxel_util.py``).

- ``l1_cd`` / ``l2_cd``: batch sums of per-sample Chamfer distance;
- ``f_score``: F-score at a euclidean (not squared) distance threshold;
- ``voxel_iou``: 64^3 occupancy IoU in a per-cloud cubic bounding box.

The EMD metric is not part of the port yet.
"""

from __future__ import annotations

import torch

from vn_pointcloudcompletion_tpu_torch.ops.chamfer import chamfer_distance


def l2_cd(pcs1, pcs2):
    d1, d2, _, _ = chamfer_distance(pcs1, pcs2)
    return torch.sum(d1.mean(1) + d2.mean(1))


def l1_cd(pcs1, pcs2):
    d1, d2, _, _ = chamfer_distance(pcs1, pcs2)
    return torch.sum(torch.sqrt(d1).mean(1) + torch.sqrt(d2).mean(1)) / 2


def f_score_from_dists(d1, d2, threshold: float = 0.01):
    """Per-sample F-score from the two chamfer directions' squared distances."""
    precision = (torch.sqrt(d1) < threshold).float().mean(1)
    recall = (torch.sqrt(d2) < threshold).float().mean(1)
    denom = precision + recall
    f = 2 * precision * recall / torch.where(denom == 0, 1.0, denom)
    return torch.where(denom == 0, 0.0, f)


def f_score(pred, gt, threshold: float = 0.01):
    """Per-sample F-score at a euclidean distance threshold. (B, N, 3) -> (B,)."""
    d1, d2, _, _ = chamfer_distance(pred, gt)
    return f_score_from_dists(d1, d2, threshold)


def points_to_voxels(points: torch.Tensor, size_grid: int = 64) -> torch.Tensor:
    """Occupancy voxelisation in a per-cloud cubic bounding box.

    PyntCloud's regular voxel grid, as the reference uses it: the bounding
    box is widened symmetrically on its short axes to a cube, and a point
    exactly on an interior voxel boundary goes to the lower voxel
    (``ceil(rel * n) - 1``).  points (..., N, 3) -> bool (..., n, n, n).
    """
    pts = points.to(torch.promote_types(points.dtype, torch.float32))
    lo = pts.amin(-2, keepdim=True)
    hi = pts.amax(-2, keepdim=True)
    side = (hi - lo).amax(-1, keepdim=True)
    center = (hi + lo) / 2
    lo_c = center - side / 2
    rel = (pts - lo_c) / torch.where(side == 0, 1.0, side)
    idx = (torch.ceil(rel * size_grid).to(torch.int64) - 1).clamp(0, size_grid - 1)
    flat = (idx[..., 0] * size_grid + idx[..., 1]) * size_grid + idx[..., 2]
    batch = flat.shape[:-1]
    flat = flat.reshape(-1, flat.shape[-1])
    cells = size_grid ** 3
    offset = torch.arange(flat.shape[0], device=flat.device)[:, None] * cells
    grid = torch.zeros(flat.shape[0] * cells, dtype=torch.bool, device=flat.device)
    grid[(flat + offset).reshape(-1)] = True
    return grid.reshape(batch + (size_grid,) * 3)


def voxel_iou(pred_pc, gt_pc, size_grid: int = 64):
    """IoU of occupancy grids: (..., N, 3), (..., M, 3) -> (...)."""
    pv = points_to_voxels(pred_pc, size_grid)
    gv = points_to_voxels(gt_pc, size_grid)
    dims = (-3, -2, -1)
    inter = (pv & gv).sum(dims)
    union = (pv | gv).sum(dims)
    return inter / union.clamp(min=1)
