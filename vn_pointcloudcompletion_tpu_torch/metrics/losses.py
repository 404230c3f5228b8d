"""Training losses (port of ``metrics/losses.py``; reference
``metrics/loss.py``): ``cd_loss_l1``, ``cd_loss_l2`` and ``calc_cd``.

EMD (``emd_loss``) and the density-aware ``calc_dcd`` are not ported yet
(ROADMAP.md, queue 1, item 5).
"""

from __future__ import annotations

import torch

from vn_pointcloudcompletion_tpu_torch.ops.chamfer import chamfer_distance


def _sqrt0(d: torch.Tensor) -> torch.Tensor:
    """``sqrt`` with a zero (not inf) gradient at exactly-zero distances: a
    predicted point that lands exactly on a ground-truth point exerts no
    pull, where ``sqrt``'s own gradient would be inf and NaN the step."""
    pos = d > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, d, 1.0)), 0.0)


def cd_loss_l1(pcs1: torch.Tensor, pcs2: torch.Tensor) -> torch.Tensor:
    """L1 Chamfer: (mean sqrt d1 + mean sqrt d2) / 2."""
    d1, d2, _, _ = chamfer_distance(pcs1, pcs2)
    return (_sqrt0(d1).mean() + _sqrt0(d2).mean()) / 2.0


def cd_loss_l2(pcs1: torch.Tensor, pcs2: torch.Tensor) -> torch.Tensor:
    """L2 Chamfer: mean d1 + mean d2."""
    d1, d2, _, _ = chamfer_distance(pcs1, pcs2)
    return d1.mean() + d2.mean()


def calc_cd(output, gt, calc_f1: bool = False, return_raw: bool = False,
            separate: bool = False):
    """Per-sample CD statistics (reference ``metrics/loss.py:58-75``), with
    the reference's argument order: distances are ``chamfer(gt, output)``,
    so dist1 runs over the ground-truth points."""
    dist1, dist2, idx1, idx2 = chamfer_distance(gt, output)
    s1, s2 = _sqrt0(dist1).mean(1), _sqrt0(dist2).mean(1)
    if separate:
        res = [torch.stack([s1, s2]), torch.stack([dist1.mean(1), dist2.mean(1)])]
    else:
        res = [(s1 + s2) / 2, dist1.mean(1) + dist2.mean(1)]
    if calc_f1:
        p1 = (dist1 < 1e-4).float().mean(1)
        p2 = (dist2 < 1e-4).float().mean(1)
        denom = p1 + p2
        res.append(torch.where(denom == 0, 0.0, 2 * p1 * p2 / torch.where(denom == 0, 1.0, denom)))
    if return_raw:
        res.extend([dist1, dist2, idx1, idx2])
    return res
