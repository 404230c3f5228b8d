"""Approximate Earth Mover's Distance, Fan's annealed soft matching (port of
``vn_pointcloudcompletion_tpu/ops/emd.py``; reference
``extensions/earth_movers_distance``).

Ten annealing rounds (level ``-4^j`` for j = 7..-1, then 0) alternately
normalise the row supplies and the column capacities of a soft assignment.
Two forms, as in JAX:

- :func:`approx_match` / :func:`earth_mover_distance`: the dense (B, M, N)
  match, for small clouds (the coarse EMD loss); the distance in JAX's
  expansion form ``|q|^2 + |r|^2 - 2 q.r``;
- :func:`earth_mover_distance_blocked`: the cost alone, O(N + M) memory,
  trainable.  Its forward is :func:`_emd_blocked_impl`, which takes kernel E
  (``ops/emd_pallas.py``) on a CUDA tensor where ``fused_eligible(n, m)``
  holds, as the JAX package takes its Pallas kernel on a TPU
  (emd.py:99-105), and the plain streamed version elsewhere.

Gradients follow the reference: the match is a constant.  The dense form
detaches it and differentiates the cost contraction; the blocked form's
backward is ``2 g (x s - t)`` from the match moments (JAX emd.py:219-224),
plain PyTorch as plain jnp in JAX.  Both public entries compute in float32
whatever the input (JAX emd.py:92-93, :288-289).
"""

from __future__ import annotations

import numpy as np
import torch

from vn_pointcloudcompletion_tpu_torch.ops import emd_pallas
from vn_pointcloudcompletion_tpu_torch.ops.emd_pallas import LEVELS, capacities
from vn_pointcloudcompletion_tpu_torch.ops.knn_pallas import pairwise_sqdist


def approx_match(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Annealed soft assignment: xyz1 (B, N, 3), xyz2 (B, M, 3) -> match
    (B, M, N) (the reference's layout, ``match[l, k]``)."""
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    multi_l, multi_r = capacities(n, m)
    d = pairwise_sqdist(xyz1, xyz2)  # (B, N, M)
    match = torch.zeros_like(d)
    remain_l = torch.full((b, n), multi_l, dtype=d.dtype, device=d.device)
    remain_r = torch.full((b, m), multi_r, dtype=d.dtype, device=d.device)
    for level in LEVELS:
        w = torch.exp(level * d)
        # the sums over points as reduced elementwise products (no TF32)
        suml = (w * remain_r[:, None, :]).sum(2) + 1e-9
        ratio_l = remain_l / suml
        sumr = (w * ratio_l[:, :, None]).sum(1) * remain_r
        ratio_r = torch.clamp_max(remain_r / (sumr + 1e-9), 1.0) * remain_r
        remain_r = torch.clamp_min(remain_r - sumr, 0.0)
        delta = w * ratio_l[:, :, None] * ratio_r[:, None, :]
        match = match + delta
        remain_l = torch.clamp_min(remain_l - delta.sum(2), 0.0)
    return match.transpose(1, 2)


def earth_mover_distance(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Approximate EMD per sample (B,): ``sum_{l,k} match[l, k] |xyz1_k -
    xyz2_l|^2`` with the match held constant under differentiation."""
    xyz1, xyz2 = xyz1.float(), xyz2.float()
    with torch.no_grad():
        match = approx_match(xyz1, xyz2)  # (B, M, N)
    d = pairwise_sqdist(xyz1, xyz2)  # (B, N, M), differentiable
    return (match.transpose(1, 2) * d).sum((1, 2))


def _emd_blocked_impl(xyz1: torch.Tensor, xyz2: torch.Tensor, use_kernels: bool = True):
    """Streamed approx-EMD in float32: (cost (B,), s_n (B, N), t_n (B, N, 3),
    s_m (B, M), t_m (B, M, 3)).  Kernel E where eligible (on a CUDA tensor,
    with ``use_kernels``), else its plain version, which is the streamed
    path."""
    x1, x2 = xyz1.float(), xyz2.float()
    if use_kernels and emd_pallas.fused_eligible(x1.shape[1], x2.shape[1]):
        return emd_pallas.emd_rounds_kernel(x1, x2)
    return emd_pallas.reference_emd_rounds(x1, x2)


class _EMDBlocked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2, use_kernels):
        cost, s_n, t_n, s_m, t_m = _emd_blocked_impl(xyz1, xyz2, use_kernels)
        ctx.save_for_backward(xyz1, xyz2, s_n, t_n, s_m, t_m)
        return cost

    @staticmethod
    def backward(ctx, g):
        xyz1, xyz2, s_n, t_n, s_m, t_m = ctx.saved_tensors
        gb = g.float()[:, None, None]
        g1 = 2.0 * gb * (xyz1.float() * s_n[..., None] - t_n)
        g2 = 2.0 * gb * (xyz2.float() * s_m[..., None] - t_m)
        return g1.to(xyz1.dtype), g2.to(xyz2.dtype), None


def earth_mover_distance_blocked(xyz1: torch.Tensor, xyz2: torch.Tensor,
                                 use_kernels: bool = True) -> torch.Tensor:
    """Approximate EMD per sample (B,) in O(N + M) memory, trainable: the
    gradient is ``d cost / d xyz1[k] = 2 (xyz1[k] s_k - t_k)`` with the match
    moments of the forward (the reference's match-constant convention), and
    the same for xyz2.  ``use_kernels=False`` takes the plain version on the
    card too."""
    return _EMDBlocked.apply(xyz1, xyz2, use_kernels)


def approx_match_reference(xyz1, xyz2) -> np.ndarray:
    """NumPy float64 oracle of the annealed matching (copied from JAX
    ``ops/emd.py::approx_match_reference``, a transliteration of the
    reference's ``emd_kernel.cu:26-158``): match (B, M, N)."""
    xyz1 = np.asarray(xyz1, np.float64)
    xyz2 = np.asarray(xyz2, np.float64)
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    multi_l, multi_r = capacities(n, m)
    match = np.zeros((b, m, n), np.float64)
    for i in range(b):
        diff = xyz1[i][:, None, :] - xyz2[i][None, :, :]
        d = np.sum(diff * diff, axis=-1)  # (n, m)
        remain_l = np.full(n, multi_l)
        remain_r = np.full(m, multi_r)
        for level in LEVELS:
            w = np.exp(level * d)
            suml = 1e-9 + w @ remain_r
            ratio_l = remain_l / suml
            sumr = (w.T @ ratio_l) * remain_r
            consumption = np.minimum(remain_r / (sumr + 1e-9), 1.0)
            ratio_r = consumption * remain_r
            remain_r = np.maximum(0.0, remain_r - sumr)
            delta = w * ratio_l[:, None] * ratio_r[None, :]
            match[i] += delta.T
            remain_l = np.maximum(0.0, remain_l - delta.sum(axis=1))
    return match


def earth_mover_distance_reference(xyz1, xyz2) -> np.ndarray:
    """NumPy float64 oracle of the cost (the reference's ``matchcost``)."""
    match = approx_match_reference(xyz1, xyz2)  # (B, M, N)
    xyz1 = np.asarray(xyz1, np.float64)
    xyz2 = np.asarray(xyz2, np.float64)
    diff = xyz1[:, :, None, :] - xyz2[:, None, :, :]
    d = np.sum(diff * diff, axis=-1)  # (B, N, M)
    return np.einsum("bmn,bnm->b", match, d)
