"""Exact nearest neighbours in both chamfer directions (kernel D).

Port of ``vn_pointcloudcompletion_tpu/ops/chamfer_pallas_bidir.py`` (the
module keeps that name so the two are easy to pair).  For clouds x (B, N, 3)
and y (B, M, 3) it returns the squared distance and index of every point's
nearest neighbour in the other cloud, in the diff form ``sum_k (x_k - y_k)^2``
with ties to the lowest index.

On a CUDA tensor :func:`nn_bidirectional` launches the kernel of
``csrc/chamfer_bidir.cu`` once for both directions: one sweep that forms
each distance once and folds it into both minima, the blocks' candidates
combined as 64-bit keys ``(float bits of d) << 32 | index`` by an integer
atomicMin (the design is explained there).  On a CPU tensor it takes the
plain version :func:`nn_bidirectional_reference`, which works through the
rows in chunks so that a 16384 x 16384 pair of clouds never needs its whole
distance matrix.
"""

from __future__ import annotations

import ctypes

import torch

from vn_pointcloudcompletion_tpu_torch.ops.cuda_lib import (
    CudaKernel,
    check_cuda,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_KERNEL = CudaKernel(
    "chamfer_bidir.cu", "chamfer_nn_bidir", [_P] * 7 + [_I] * 3 + [_P])

_CHUNK_ELEMS = 1 << 26  # distances held at once by the plain version (256 MB)


def nn_one_sided_reference(x: torch.Tensor, y: torch.Tensor):
    """For each point of x (B, N, D): min squared distance to y (B, M, D) and
    its index (int32), the coordinates summed in order."""
    bsz, n, dim = x.shape
    m = y.shape[1]
    rows = max(1, _CHUNK_ELEMS // max(bsz * m, 1))
    dists, idxs = [], []
    for s in range(0, n, rows):
        xc = x[:, s : s + rows]
        dist = None
        for k in range(dim):
            diff = xc[:, :, k, None] - y[:, None, :, k]
            sq = diff * diff
            dist = sq if dist is None else dist + sq
        best, arg = torch.min(dist, dim=2)
        dists.append(best)
        idxs.append(arg.to(torch.int32))
    return torch.cat(dists, 1), torch.cat(idxs, 1)


def nn_bidirectional_reference(x: torch.Tensor, y: torch.Tensor):
    """Plain version of kernel D: (d_xy, i_xy, d_yx, i_yx)."""
    d_xy, i_xy = nn_one_sided_reference(x, y)
    d_yx, i_yx = nn_one_sided_reference(y, x)
    return d_xy, i_xy, d_yx, i_yx


def nn_bidirectional(x: torch.Tensor, y: torch.Tensor):
    """Both chamfer directions: x (B, N, 3), y (B, M, 3) ->
    (d_xy (B, N), i_xy (B, N), d_yx (B, M), i_yx (B, M))."""
    if not x.is_cuda:
        return nn_bidirectional_reference(x, y)
    if x.ndim != 3 or y.ndim != 3 or x.shape[2] != 3 or y.shape[2] != 3 \
            or x.shape[0] != y.shape[0]:
        raise ValueError(f"nn_bidirectional: bad shapes {tuple(x.shape)} {tuple(y.shape)}")
    x, y = x.contiguous(), y.contiguous()
    check_cuda("nn_bidirectional", "float32 clouds", (x, torch.float32), (y, torch.float32))
    bsz, n, m = x.shape[0], x.shape[1], y.shape[1]
    out = [torch.empty((bsz, rows), device=x.device, dtype=dtype)
           for rows in (n, m) for dtype in (torch.float32, torch.int32)]
    keys = torch.empty((bsz, n + m), device=x.device, dtype=torch.int64)  # scratch
    _KERNEL(x, x.data_ptr(), y.data_ptr(), *[t.data_ptr() for t in out], keys.data_ptr(),
            bsz, n, m)
    return out[0], out[1], out[2], out[3]
