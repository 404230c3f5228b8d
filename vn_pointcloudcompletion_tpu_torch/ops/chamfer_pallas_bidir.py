"""Exact nearest neighbours in both chamfer directions (kernel D).

Port of ``vn_pointcloudcompletion_tpu/ops/chamfer_pallas_bidir.py`` (the
module keeps that name so the two are easy to pair).  For clouds x (B, N, 3)
and y (B, M, 3) it returns the squared distance and index of every point's
nearest neighbour in the other cloud, in the diff form ``sum_k (x_k - y_k)^2``
with ties to the lowest index.

On a CUDA tensor :func:`nn_bidirectional` launches the one-sided kernel of
``csrc/chamfer_bidir.cu`` once per direction (the design is explained
there); on a CPU tensor it takes the plain version
:func:`nn_bidirectional_reference`, which works through the rows in chunks so
that a 16384 x 16384 pair of clouds never needs its whole distance matrix.
"""

from __future__ import annotations

import ctypes

import torch

from vn_pointcloudcompletion_tpu_torch.ops.cuda_lib import (
    CudaKernel,
    check_cuda_f32,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_KERNEL = CudaKernel(
    "chamfer_bidir.cu", "chamfer_nn_one_sided", [_P] * 4 + [_I] * 3 + [_P])

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
    check_cuda_f32("nn_bidirectional", x, y)
    bsz, n, m = x.shape[0], x.shape[1], y.shape[1]
    out = []
    for src, dst, rows, cols in ((x, y, n, m), (y, x, m, n)):
        d = torch.empty((bsz, rows), device=x.device, dtype=torch.float32)
        i = torch.empty((bsz, rows), device=x.device, dtype=torch.int32)
        _KERNEL(x, src.data_ptr(), dst.data_ptr(), d.data_ptr(), i.data_ptr(),
                bsz, rows, cols)
        out += [d, i]
    return out[0], out[1], out[2], out[3]
