"""Training losses (port of ``metrics/losses.py``; reference
``metrics/loss.py``): ``cd_loss_l1``, ``cd_loss_l2``, ``emd_loss``,
``calc_cd`` and the density-aware ``calc_dcd``.
"""

from __future__ import annotations

import torch

from vn_pointcloudcompletion_tpu_torch.ops.chamfer import chamfer_distance
from vn_pointcloudcompletion_tpu_torch.ops.emd import (
    earth_mover_distance,
    earth_mover_distance_blocked,
)


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


def emd_loss(pcs1: torch.Tensor, pcs2: torch.Tensor) -> torch.Tensor:
    """Mean approx-EMD over the batch: the dense match up to 2048 x 2048
    pairs, the streamed trainable form (kernel E on the card) above, with
    the same cost and gradients (JAX losses.py:50-64)."""
    if pcs1.shape[1] * pcs2.shape[1] > 2048 * 2048:
        return earth_mover_distance_blocked(pcs1, pcs2).mean()
    return earth_mover_distance(pcs1, pcs2).mean()


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


def _match_counts(idx: torch.Tensor, bins: int) -> torch.Tensor:
    """How often each of ``bins`` targets is some point's nearest neighbour:
    idx (B, P) int -> (B, bins) int64, per sample, by sorting (exact, no
    atomics)."""
    srt = torch.sort(idx.long(), dim=1).values
    edges = torch.arange(bins + 1, device=idx.device).expand(idx.shape[0], -1).contiguous()
    pos = torch.searchsorted(srt, edges)
    return pos[:, 1:] - pos[:, :-1]


def calc_dcd(x, gt, alpha: float = 1000, n_lambda: float = 1, return_raw: bool = False,
             non_reg: bool = False):
    """Density-aware Chamfer distance (reference ``metrics/loss.py:77-118``;
    JAX losses.py:100-137): each direction's ``mean(1 - exp(-alpha d) /
    (count ** n_lambda + 1e-6) * frac)``, count the number of points whose
    nearest neighbour is the same target.  Returns [loss, cd_p, cd_t]
    per sample, and the raw chamfer outputs with ``return_raw``."""
    ct = torch.promote_types(torch.promote_types(x.dtype, gt.dtype), torch.float32)
    x, gt = x.to(ct), gt.to(ct)
    n_x, n_gt = x.shape[1], gt.shape[1]
    if non_reg:
        frac_12, frac_21 = max(1.0, n_x / n_gt), max(1.0, n_gt / n_x)
    else:
        frac_12, frac_21 = n_x / n_gt, n_gt / n_x
    cd_p, cd_t, dist1, dist2, idx1, idx2 = calc_cd(x, gt, return_raw=True)

    def side(idx, dist, bins, frac):
        count = torch.gather(_match_counts(idx, bins), 1, idx.long()).to(ct)
        weight = (count ** n_lambda + 1e-6) ** (-1.0) * frac
        return (-torch.exp(-dist * alpha) * weight + 1.0).mean(1)

    loss = (side(idx1, dist1, n_x, frac_21) + side(idx2, dist2, n_gt, frac_12)) / 2
    res = [loss, cd_p, cd_t]
    if return_raw:
        res.extend([dist1, dist2, idx1, idx2])
    return res
