"""Point-cloud geometry of the reference: rotations, nearest neighbours and
the Chamfer losses, F-score, voxel IoU, furthest-point sampling and kNN.

Distances are the difference form ``(x - y)^2`` summed over x, y, z, never
the expanded ``|x|^2 + |y|^2 - 2 x.y`` (which loses the small distances to
cancellation).  Nearest neighbours are searched without autograd, one
sample and one block of rows at a time so that (32, 16384)^2 fits; the
differentiable distance is then formed from the matched point, which is the
gradient of a minimum.
"""

from __future__ import annotations

import torch

ROWS = 4096  # rows of one block of the nearest-neighbour search


def rotate_points(points: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Row-vector rotation ``p @ R``: points (B, N, 3) or (N, 3), rot (B, 3, 3)."""
    if points.ndim == 2:
        return torch.einsum("nd,bde->bne", points, rot)
    return torch.einsum("bnd,bde->bne", points, rot)


def _sq_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(r, 3), (m, 3) -> (r, m) squared distances in difference form."""
    return ((x[:, None, 0] - y[None, :, 0]) ** 2 + (x[:, None, 1] - y[None, :, 1]) ** 2
            + (x[:, None, 2] - y[None, :, 2]) ** 2)


@torch.no_grad()
def nearest_index(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """For each point of x (B, N, 3) the index of its nearest point in y
    (B, M, 3): (B, N) int64."""
    out = torch.empty(x.shape[:2], dtype=torch.int64, device=x.device)
    for b in range(x.shape[0]):
        for s in range(0, x.shape[1], ROWS):
            out[b, s:s + ROWS] = _sq_dist(x[b, s:s + ROWS], y[b]).argmin(1)
    return out


def chamfer(x: torch.Tensor, y: torch.Tensor):
    """Squared distances of each point to its nearest neighbour in the other
    cloud, both directions: (d1 (B, N), d2 (B, M)), differentiable."""
    i1 = nearest_index(x, y)
    i2 = nearest_index(y, x)
    y1 = torch.gather(y, 1, i1[..., None].expand(-1, -1, 3))
    x2 = torch.gather(x, 1, i2[..., None].expand(-1, -1, 3))
    return ((x - y1) ** 2).sum(-1), ((y - x2) ** 2).sum(-1)


def sqrt0(d: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero gradient at exactly zero distances."""
    pos = d > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, d, 1.0)), 0.0)


def cd_loss_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Chamfer-L1 training loss: (mean sqrt d1 + mean sqrt d2) / 2 over the
    batch (the reference repo's ``metrics/loss.py``)."""
    d1, d2 = chamfer(x, y)
    return (sqrt0(d1).mean() + sqrt0(d2).mean()) / 2


def f_score(d1: torch.Tensor, d2: torch.Tensor, threshold: float = 0.01) -> torch.Tensor:
    """Per-sample F-score at a euclidean distance threshold."""
    precision = (torch.sqrt(d1) < threshold).float().mean(1)
    recall = (torch.sqrt(d2) < threshold).float().mean(1)
    denom = precision + recall
    return torch.where(denom == 0, 0.0, 2 * precision * recall / torch.where(denom == 0, 1.0, denom))


def voxels(points: torch.Tensor, size: int = 64) -> torch.Tensor:
    """Occupancy of a per-cloud cubic bounding box split into size^3 cells,
    as PyntCloud's regular grid (the reference repo's ``voxel_util.py``):
    the box widened to a cube about its centre, a point on an interior cell
    boundary in the lower cell.  (B, N, 3) -> bool (B, size^3)."""
    lo = points.amin(1, keepdim=True)
    hi = points.amax(1, keepdim=True)
    side = (hi - lo).amax(-1, keepdim=True)
    rel = (points - ((hi + lo) / 2 - side / 2)) / torch.where(side == 0, 1.0, side)
    idx = (torch.ceil(rel * size).long() - 1).clamp(0, size - 1)
    flat = (idx[..., 0] * size + idx[..., 1]) * size + idx[..., 2]
    grid = torch.zeros(points.shape[0], size ** 3, dtype=torch.bool, device=points.device)
    grid.scatter_(1, flat, True)
    return grid


def voxel_iou(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    pv, gv = voxels(pred), voxels(gt)
    return (pv & gv).sum(1) / (pv | gv).sum(1).clamp(min=1)


def completion_metrics(pred: torch.Tensor, gt: torch.Tensor) -> dict:
    """Per-sample L1-CD, L2-CD, F-Score@0.01 and IoU@64^3 (the reference
    repo's ``test.py``)."""
    with torch.no_grad():
        d1, d2 = chamfer(pred, gt)
        return {"l1": (torch.sqrt(d1).mean(1) + torch.sqrt(d2).mean(1)) / 2,
                "l2": d1.mean(1) + d2.mean(1),
                "f": f_score(d1, d2),
                "iou": voxel_iou(pred, gt)}


@torch.no_grad()
def furthest_point_indices(xyz: torch.Tensor, s: int) -> torch.Tensor:
    """Greedy furthest-point sampling from point 0: (B, N, 3) -> (B, s)."""
    b, n, _ = xyz.shape
    idx = torch.zeros(b, s, dtype=torch.int64, device=xyz.device)
    dist = torch.full((b, n), float("inf"), device=xyz.device, dtype=xyz.dtype)
    rows = torch.arange(b, device=xyz.device)
    last = torch.zeros(b, dtype=torch.int64, device=xyz.device)
    for i in range(1, s):
        p = xyz[rows, last]  # (B, 3)
        d = ((xyz[..., 0] - p[:, None, 0]) ** 2 + (xyz[..., 1] - p[:, None, 1]) ** 2
             + (xyz[..., 2] - p[:, None, 2]) ** 2)
        dist = torch.minimum(dist, d)
        last = dist.argmax(1)
        idx[:, i] = last
    return idx


@torch.no_grad()
def knn_indices(q: torch.Tensor, r: torch.Tensor, k: int) -> torch.Tensor:
    """The k nearest points of r (B, M, D) to each of q (B, N, D), nearest
    first: (B, N, k).  Distances summed over D in the difference form."""
    out = torch.empty(q.shape[0], q.shape[1], k, dtype=torch.int64, device=q.device)
    for b in range(q.shape[0]):
        d = ((q[b, :, None, :] - r[b, None, :, :]) ** 2).sum(-1)
        out[b] = d.topk(k, dim=1, largest=False, sorted=True).indices
    return out
