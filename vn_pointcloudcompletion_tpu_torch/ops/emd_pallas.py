"""The annealing rounds of the approximate EMD without the (N, M) match:
kernel E.

Port of ``vn_pointcloudcompletion_tpu/ops/emd_pallas.py`` (the module keeps
that name so the two are easy to pair).  For clouds x1 (B, N, 3) and x2
(B, M, 3) it returns ``(cost (B,), s_n (B, N), t_n (B, N, 3), s_m (B, M),
t_m (B, M, 3))``: the cost of the soft match after ten annealing rounds and
its moments ``s_n[i] = sum_j match[i, j]``, ``t_n[i] = sum_j match[i, j] *
x2[j]`` (and the column-side pair), which the gradient needs.  That is the
contract of JAX ``ops/emd.py::_emd_blocked_impl``: the same rounds, levels,
``1e-9`` epsilons, clamps and integer-ratio capacities.

:func:`emd_rounds_kernel` launches ``csrc/emd.cu`` on a CUDA tensor (the
design is explained there) and takes the plain version
:func:`reference_emd_rounds` on a CPU tensor.  The plain version runs the
kernel's schedule: the squared distance in the difference form, the same
bits in the row and column passes (the level -4^7 amplifies any skew
between the two), the next round's supply summed in the row pass, the cost
summed per row over the rounds and then over the rows.  Its sums over points
are elementwise products reduced in float (never a matrix product, which
the card may run in TF32), in blocks of rows that keep a (B, rows, M)
tensor near 64 MB; float64 inputs stay float64, so on the card it is also
the float64 oracle.
"""

from __future__ import annotations

import ctypes

import torch

from vn_pointcloudcompletion_tpu_torch.ops.cuda_lib import CudaKernel, check_cuda

_MAX_PTS = 16384
_MAX_SPLITS = 8  # spans of the other cloud a pass of the kernel may take (csrc kMaxSplits)
_BLOCK_ELEMS = 1 << 24  # entries of one (B, rows, M) tensor of the plain version
_KERNEL = CudaKernel("emd.cu", "emd_rounds",
                     [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p])

# level -4^j for j = 7..-1, then 0 (emd_kernel.cu:46-50 of the reference)
LEVELS = [-(4.0 ** j) for j in range(7, -2, -1)] + [0.0]


def fused_eligible(n: int, m: int) -> bool:
    """Where the JAX package takes its Pallas kernel (emd_pallas.py:108):
    below 2^20 pairs the streamed path is cheap, above 16384 points the TPU
    kernel's tile outgrows its memory."""
    return n <= _MAX_PTS and m <= _MAX_PTS and n * m >= 1 << 20


def capacities(n: int, m: int):
    """(multi_l, multi_r): the supply of every row and column, by integer
    ratio (emd_kernel.cu:29-35 of the reference)."""
    return (1.0, float(n // m)) if n >= m else (float(m // n), 1.0)


def _sqdist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """x1 (B, R, 3), x2 (B, M, 3) -> (B, R, M): ``dx*dx + dy*dy + dz*dz``
    with ``d = x1 - x2``, summed in that order (the kernel's form)."""
    d = None
    for k in range(3):
        diff = x1[:, :, None, k] - x2[:, None, :, k]
        sq = diff * diff
        d = sq if d is None else d + sq
    return d


@torch.no_grad()
def reference_emd_rounds(x1: torch.Tensor, x2: torch.Tensor):
    """Plain version of kernel E: x1 (B, N, 3), x2 (B, M, 3) ->
    (cost, s_n, t_n, s_m, t_m), in at least float32."""
    ct = torch.promote_types(torch.promote_types(x1.dtype, x2.dtype), torch.float32)
    x1, x2 = x1.to(ct), x2.to(ct)
    b, n, _ = x1.shape
    m = x2.shape[1]
    multi_l, multi_r = capacities(n, m)
    rows = max(1, _BLOCK_ELEMS // max(b * m, 1))

    def new(*shape, value=0.0):
        return torch.full(shape, value, dtype=ct, device=x1.device)

    remain_l, remain_r = new(b, n, value=multi_l), new(b, m, value=multi_r)
    costrow, s_n, t_n, s_m, t_m = new(b, n), new(b, n), new(b, n, 3), new(b, m), new(b, m, 3)

    def supply(w, rr):  # sum_j w_ij remain_r_j
        return (w * rr[:, None, :]).sum(-1)

    # round 0's supply pass
    sup = torch.cat([supply(torch.exp(LEVELS[0] * _sqdist(x1[:, s:s + rows], x2)), remain_r)
                     for s in range(0, n, rows)], 1)
    ratio_l = remain_l / (sup + 1e-9)
    for r, level in enumerate(LEVELS):
        v4 = torch.cat([ratio_l[..., None], ratio_l[..., None] * x1], -1)  # (B, N, 4)
        # column pass: z_j = sum_i w_ij v4_i, the rows in blocks
        z = new(b, m, 4)
        for s in range(0, n, rows):
            w = torch.exp(level * _sqdist(x1[:, s:s + rows], x2))
            z = z + torch.stack([(w * v4[:, s:s + rows, k, None]).sum(1) for k in range(4)], -1)
        sumr = z[..., 0] * remain_r
        ratio_r = torch.clamp_max(remain_r / (sumr + 1e-9), 1.0) * remain_r
        remain_r = torch.clamp_min(remain_r - sumr, 0.0)
        s_m = s_m + ratio_r * z[..., 0]
        t_m = t_m + ratio_r[..., None] * z[..., 1:]
        u4 = torch.cat([ratio_r[..., None], ratio_r[..., None] * x2], -1)  # (B, M, 4)

        # row pass: moments, cost, and the next round's supply
        last = r + 1 == len(LEVELS)
        ys, cs, sups = [], [], []
        for s in range(0, n, rows):
            d = _sqdist(x1[:, s:s + rows], x2)
            w = torch.exp(level * d)
            ys.append(torch.stack([(w * u4[:, None, :, k]).sum(-1) for k in range(4)], -1))
            cs.append(((w * d) * ratio_r[:, None, :]).sum(-1))
            if not last:
                sups.append(supply(torch.exp(LEVELS[r + 1] * d), remain_r))
        y, c = torch.cat(ys, 1), torch.cat(cs, 1)
        costrow = costrow + ratio_l * c
        s_n = s_n + ratio_l * y[..., 0]
        t_n = t_n + ratio_l[..., None] * y[..., 1:]
        remain_l = torch.clamp_min(remain_l - ratio_l * y[..., 0], 0.0)
        if not last:
            ratio_l = remain_l / (torch.cat(sups, 1) + 1e-9)
    return costrow.sum(1), s_n, t_n, s_m, t_m


def emd_rounds_kernel(x1: torch.Tensor, x2: torch.Tensor):
    """Kernel E on a CUDA tensor, its plain version on a CPU tensor:
    x1 (B, N, 3), x2 (B, M, 3) float32 -> (cost, s_n, t_n, s_m, t_m)."""
    if not x1.is_cuda:
        return reference_emd_rounds(x1, x2)
    if x1.ndim != 3 or x2.ndim != 3 or x1.shape[2] != 3 or x2.shape[2] != 3 \
            or x1.shape[0] != x2.shape[0]:
        raise ValueError(f"emd_rounds: bad shapes {tuple(x1.shape)} {tuple(x2.shape)}")
    x1, x2 = x1.contiguous(), x2.contiguous()
    check_cuda("emd_rounds", "float32 clouds", (x1, torch.float32), (x2, torch.float32))
    b, n, m = x1.shape[0], x1.shape[1], x2.shape[1]

    def empty(*shape):
        return torch.empty(shape, device=x1.device, dtype=torch.float32)

    cost, s_n, t_n, s_m, t_m = empty(b), empty(b, n), empty(b, n, 3), empty(b, m), empty(b, m, 3)
    # v4, u4, remain_l, remain_r, cost rows; then the passes' span partials
    scratch = empty(5 * b * (n + m) + 6 * _MAX_SPLITS * b * max(n, m))
    _KERNEL(x1, x1.data_ptr(), x2.data_ptr(), cost.data_ptr(), s_n.data_ptr(),
            t_n.data_ptr(), s_m.data_ptr(), t_m.data_ptr(), scratch.data_ptr(), b, n, m)
    return cost, s_n, t_n, s_m, t_m
