"""k-nearest neighbours and EdgeConv features (port of ``ops/knn.py``).

:func:`knn` dispatches as the JAX package does on a TPU
(``ops/knn.py:53-66``): kernel K2 where ``fused_eligible(M, k, D)``, else
the distance matrix and kernel K1 where ``eligible(M, k)``, else the plain
selection over the matrix.  The matrix is formed as JAX forms it there
(:func:`pairwise_sqdist_einsum`: one batched product in full float32).
``use_kernels=False`` keeps that dispatch and takes each kernel's plain
version, so the two paths pick the same neighbours.  Indices are (B, N, K)
int32; the gathers index with them (their backward is a sort-based
``index_put_``, no float atomics).
"""

from __future__ import annotations

import torch

from vn_pointcloudcompletion_tpu_torch.ops import knn_pallas

__all__ = ["pairwise_sqdist_einsum", "knn", "gather_neighbors", "gather_planes",
           "graph_feature", "vn_graph_feature_planes", "vn_graph_feature"]


def pairwise_sqdist_einsum(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """JAX's ``ops/knn.py::pairwise_sqdist``, the einsum form: q (B, N, D),
    r (B, M, D) -> (B, N, M) ``(|q|^2 + |r|^2) - 2 q.r^T``, the cross term
    one batched product (``baddbmm``, the subtraction in its epilogue) in
    full float32, never TF32, whatever the caller set (float64 inputs stay
    float64).  The kernels' in-order form is ``knn_pallas.pairwise_sqdist``."""
    ct = torch.promote_types(torch.promote_types(q.dtype, torch.float32), r.dtype)
    q, r = q.to(ct), r.to(ct)
    sq = (q * q).sum(-1)[:, :, None] + (r * r).sum(-1)[:, None, :]
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.baddbmm(sq, q, r.transpose(1, 2), alpha=-2.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def knn(query: torch.Tensor, ref: torch.Tensor, k: int, use_kernels: bool = True):
    """k nearest neighbours of each query within ``ref``: query (B, N, D),
    ref (B, M, D) -> (squared distances, idx), each (B, N, k), ascending,
    ties to the lowest index; distances in at least float32."""
    m, dim = ref.shape[1], ref.shape[2]
    if knn_pallas.fused_eligible(m, k, dim):
        if use_kernels:
            return knn_pallas.knn_min(query, ref, k)
        return knn_pallas.reference_knn_min(query, ref, k)
    d = pairwise_sqdist_einsum(query, ref)
    if knn_pallas.eligible(m, k):
        if use_kernels:
            return knn_pallas.topk_min(d, k)
        return knn_pallas.reference_topk_min(d, k)
    return knn_pallas.select_k_min(d, k)


def gather_neighbors(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, M, C), idx (B, N, K) -> (B, N, K, C)."""
    rows = torch.arange(feats.shape[0], device=feats.device)[:, None, None]
    return feats[rows, idx.long()]


def gather_planes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbour columns of planes: x (B, 3, C, N), idx (B, Nq, K) ->
    (B, 3, C, Nq*K) (the JAX ``mode='take'`` form)."""
    b, nq, k = idx.shape
    rows = torch.arange(b, device=x.device)[:, None]
    return x.permute(0, 3, 1, 2)[rows, idx.reshape(b, nq * k).long()].permute(0, 2, 3, 1)


def graph_feature(x_q: torch.Tensor, x_k: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Scalar EdgeConv feature ``concat([neighbour - centre, centre])``:
    x_q (B, C, Nq), x_k (B, C, Nk), idx (B, Nq, K) -> (B, 2C, Nq, K)."""
    nbr = gather_neighbors(x_k.transpose(1, 2), idx).permute(0, 3, 1, 2)
    ctr = x_q[:, :, :, None].expand_as(nbr)
    return torch.cat([nbr - ctr, ctr], dim=1)


def vn_graph_feature_planes(x_q: torch.Tensor, x_k: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """Plane-layout VN EdgeConv feature with the neighbour axis flattened:
    x_q (B, 3, C, Nq), x_k (B, 3, C, Nk), idx (B, Nq, K) -> (B, 3, 2C, Nq*K)."""
    b, _, c, nk = x_k.shape
    nq, k = idx.shape[1], idx.shape[2]
    flatk = x_k.permute(0, 3, 1, 2).reshape(b, nk, 3 * c)
    nbr = gather_neighbors(flatk, idx).reshape(b, nq, k, 3, c).permute(0, 3, 4, 1, 2)
    ctr = x_q[:, :, :, :, None].expand_as(nbr)
    return torch.cat([nbr - ctr, ctr], dim=2).reshape(b, 3, 2 * c, nq * k)


def vn_graph_feature(x_q: torch.Tensor, x_k: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Vec-layout VN EdgeConv feature ``concat([neighbour - centre, centre])``
    over the channels: x_q (B, C, 3, Nq), x_k (B, C, 3, Nk), idx (B, Nq, K)
    -> (B, 2C, 3, Nq, K) (JAX ops/knn.py:153-170)."""
    b, c, _, nk = x_k.shape
    nq, k = idx.shape[1], idx.shape[2]
    flatk = x_k.permute(0, 3, 1, 2).reshape(b, nk, c * 3)
    nbr = gather_neighbors(flatk, idx).reshape(b, nq, k, c, 3).permute(0, 3, 4, 1, 2)
    ctr = x_q[:, :, :, :, None].expand_as(nbr)
    return torch.cat([nbr - ctr, ctr], dim=1)
