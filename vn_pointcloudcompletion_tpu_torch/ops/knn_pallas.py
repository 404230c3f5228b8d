"""k smallest distances per row: kernels K1, K2, K3.

Port of ``vn_pointcloudcompletion_tpu/ops/knn_pallas.py``:

- :func:`topk_min` (kernel K1): the k smallest entries of each row of a
  given (B, N, M) matrix;
- :func:`knn_min` (kernel K2): the k nearest references of each query, the
  squared distances computed in the kernel;
- :func:`edge_knn_gather` (kernel K3): the kNN of K2 over the columns of
  ``xflat`` (B, D, N), then ``out[b, :, kk, q] = u[b, :, idx[q, kk]] +
  v[b, :, q]`` in the (B, C3, k, N) layout, the front of a VN EdgeConv stage.

All three return the k smallest ascending, ties to the lowest index.  The
distance is ``(|q|^2 + |r|^2) - 2 q.r`` with each sum taken over the
coordinates in order, unclamped; the plain versions (``reference_*``) do the
kernels' operations in the kernels' order, so on the card the two pick the
same indices.  Distances are taken in at least float32 (float64 inputs stay
float64 in the plain versions; the kernels take float32, and K2's wrapper
upcasts bf16 points exactly).  K1 runs one of two designs of
``csrc/knn.cu``, chosen in :func:`topk_design` and counted by name:
``stream`` (M a multiple of 4, 16-byte aligned rows: the rows streamed
through shared memory, a few lanes a row) and ``warp`` (the parent design,
one warp a row).  K2 runs one of two designs of
``csrc/knn.cu``, chosen by shape in :func:`knn_design` and counted by name:
``coords`` (D <= 4: the sample's references staged in shared memory, a few
lanes a query, q and r read at their own strides) and ``warp`` (the parent
design, over references the wrapper copies to (B, D, M)).  K3 has a bf16
mode for the bfloat16 compute
policy: bf16 features u and v (and bf16 or float32 ``xflat``, read as
float32), the exact gather, and the centre add ``bf16(float(u[idx]) +
float(v))``; its launches count under ``edge_knn_gather[bf16]``.  K3 runs
one of three designs of ``csrc/knn.cu``, chosen by shape in
:func:`edge_design` and counted by name (``cuda_lib.variant_counts``):
``coords`` and ``tiled`` (a selection, then a gather that streams the
output over the whole card), ``warp`` (the parent design) where they do not
reach.

Each is a ``torch.autograd.Function``: on a CUDA tensor its forward launches
the kernel of ``csrc/knn.cu``, on a CPU tensor it takes the plain version.
The backward rules are those of the JAX package (plain jnp there, plain
PyTorch here): K1 puts the values' cotangent back on the selected entries;
K2 gives ``dq = 2 sum_k g (q - r_idx)`` and scatters ``-2 g (q - r_idx)``
onto the references; K3 gives ``dv = sum_k ct``, scatters ``ct`` onto the
selected columns of ``u``, and ``xflat`` none.  The scatters are
``index_put_(..., accumulate=True)``, sort-based on the card, so a train
step gives the same bits on every run.
"""

from __future__ import annotations

import ctypes

import torch

from vn_pointcloudcompletion_tpu_torch.ops.cuda_lib import CudaKernel, check_cuda

_MAX_M = 4096  # row length cap of the TPU kernels (knn_pallas.py:30)
_MAX_D = 512   # feature width cap of the fused kernel (knn_pallas.py:148)
_MAX_K = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_TOPK = CudaKernel("knn.cu", "topk_min", [_P] * 3 + [_I] * 4 + [_P])
_I64 = ctypes.c_int64
_KNN = CudaKernel("knn.cu", "knn_min", [_P] * 4 + [_I] * 6 + [_I64] * 6 + [_P])
_EDGE = CudaKernel("knn.cu", "edge_knn_gather", [_P] * 5 + [_I] * 6 + [_P])
_EDGE_BF16 = CudaKernel("knn.cu", "edge_knn_gather_bf16", [_P] * 5 + [_I] * 7 + [_P],
                        "edge_knn_gather[bf16]")
EDGE_TAKES = ("float32 xflat, u and v, or (its bf16 mode) bf16 u and v with bf16 "
              "or float32 xflat")


def eligible(m: int, k: int) -> bool:
    """Where the JAX package takes K1 on a TPU (knn_pallas.py:34)."""
    return m <= _MAX_M and k <= _MAX_K


def fused_eligible(m: int, k: int, d: int) -> bool:
    """Where the JAX package takes K2 on a TPU (knn_pallas.py:154)."""
    return m <= _MAX_M and k <= _MAX_K and d <= _MAX_D


def edge_gather_eligible(n: int, d: int, k: int, c3: int) -> bool:
    """Where the JAX package takes K3 on a TPU (knn_pallas.py:283)."""
    return (n <= 2048 and d <= _MAX_D and k in (16, 32) and c3 <= 1536
            and n * c3 <= 512 * 1536)


TOPK_DESIGNS = ("warp", "stream")  # csrc/knn.cu TopkDesign, in its order
KNN_DESIGNS = ("warp", "coords")  # csrc/knn.cu KnnDesign, in its order
EDGE_DESIGNS = ("warp", "coords", "tiled")  # csrc/knn.cu EdgeDesign, in its order
_GATHER_THREADS = 256  # the gather's block (csrc knn.cu kThreads)
_COORDS_MAX_D = 4
_TILED_MAX_N = 512


def gather_slots(n: int, k: int, bf16: bool) -> int:
    """Neighbour slots each thread of K3's gather takes (csrc
    ``gather_kpt``): a thread owns one 16-byte run of queries (4 float32
    or 8 bf16) and ``k / (256 / runs)`` consecutive slots, which must be 1,
    2, 4 or 8; 0 where the shape does not fit (N not whole runs, more than
    256 runs, or k not split evenly)."""
    vec = 8 if bf16 else 4
    runs = n // vec
    if n % vec or runs > _GATHER_THREADS:
        return 0
    share = _GATHER_THREADS // runs
    kpt = k // share
    return kpt if k % share == 0 and kpt in (1, 2, 4, 8) else 0


def topk_design(m: int, k: int, aligned: bool) -> str:
    """Which design kernel K1 runs over rows of M values, k smallest, at any
    number of rows: ``"stream"`` where M is a multiple of 4 and the rows
    start 16-byte ``aligned`` (a block streams 64 rows through shared
    memory by 16-byte copies and gives each row 4 lanes that buffer the
    values passing a row bound, as K2's coords design does; every K-padded
    list, 16, 32 or 64, splits over the 4 lanes), ``"warp"`` (one warp a
    row: the parent design) elsewhere.  Both give the same indices and
    bits; a CUDA launch takes the one chosen here or raises.  k outside
    [1, min(64, M)] and M > 4096 are refused."""
    if not (0 < k <= min(_MAX_K, m) and m <= _MAX_M):
        raise ValueError(f"topk_min: no design takes M={m}, k={k}")
    return "stream" if m % 4 == 0 and aligned else "warp"


def knn_design(m: int, d: int, k: int) -> str:
    """Which design kernel K2 runs against M references of D coordinates,
    k neighbours, at any number of queries: ``"coords"`` at D <= 4 and
    M <= 4096 (a block stages the sample's references and their |r|^2 in
    shared memory, 80 KB at most beside 30 KB of candidate buffers, and
    gives each query 4 lanes), ``"warp"`` (one warp a query over the
    references transposed to (B, D, M): the parent design) elsewhere.
    Both give the same indices and bits; a CUDA launch takes the one chosen
    here or raises.  k outside [1, min(64, M)] and D outside [1, 512] are
    refused."""
    if not (0 < k <= min(_MAX_K, m) and 0 < d <= _MAX_D):
        raise ValueError(f"knn_min: no design takes M={m}, D={d}, k={k}")
    return "coords" if d <= _COORDS_MAX_D and m <= _MAX_M else "warp"


def edge_design(n: int, d: int, k: int, bf16: bool) -> str:
    """Which design kernel K3 runs at N points, D distance coordinates,
    k neighbours, bf16 features or float32: ``"coords"`` at D <= 4 (each
    distance formed as a query's lanes scan the staged planes) and
    ``"tiled"`` at D > 4 and N <= 512 a multiple of 8 (a register-tiled
    product fills a distance tile in shared memory, then the lanes select
    from it), both followed by the gather over the whole card, which needs
    k <= 32 and :func:`gather_slots`; ``"warp"`` (one warp a query, then
    the block's gather: the parent design) elsewhere.  Every design gives
    the same indices and bits; a CUDA launch takes the one chosen here or
    raises."""
    if k > 32 or gather_slots(n, k, bf16) == 0:
        return "warp"
    if d <= _COORDS_MAX_D:
        return "coords"
    return "tiled" if n <= _TILED_MAX_N and n % 8 == 0 else "warp"


def _ct(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def select_k_min(d: torch.Tensor, k: int):
    """The k smallest of each row of d (..., M), ascending, ties to the
    lowest index (a stable sort keeps equal values in index order):
    (values, int32 indices)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """sum_e x[..., e]^2 over the last axis, in order."""
    acc = x[..., 0] * x[..., 0]
    for e in range(1, x.shape[-1]):
        acc = acc + x[..., e] * x[..., e]
    return acc


def pairwise_sqdist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """q (B, N, D), r (B, M, D) -> (B, N, M): ``(|q|^2 + |r|^2) - 2 q.r``,
    each sum over the coordinates in order, in at least float32 (the order
    of the kernels K2 and K3)."""
    ct = torch.promote_types(_ct(q), r.dtype)
    q, r = q.to(ct), r.to(ct)
    cross = q[:, :, None, 0] * r[:, None, :, 0]
    for e in range(1, q.shape[2]):
        cross = cross + q[:, :, None, e] * r[:, None, :, e]
    return (sq_norms(q)[:, :, None] + sq_norms(r)[:, None, :]) - 2.0 * cross


def reference_topk_min(d: torch.Tensor, k: int):
    """Plain version of K1: d (B, N, M) -> (vals, idx) (B, N, k)."""
    return select_k_min(d.to(_ct(d)), k)


def reference_knn_min(q: torch.Tensor, r: torch.Tensor, k: int):
    """Plain version of K2: q (B, N, D), r (B, M, D) -> (vals, idx)."""
    return select_k_min(pairwise_sqdist(q, r), k)


def gather_columns(u: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """u (B, C, N), idx (B, Q, k) -> (B, C, k, Q) with
    ``out[b, :, kk, q] = u[b, :, idx[b, q, kk]]``."""
    b = u.shape[0]
    rows = torch.arange(b, device=u.device)[:, None, None]
    return u.transpose(1, 2)[rows, idx.transpose(1, 2).long()].permute(0, 3, 1, 2)


def reference_edge_knn_gather(xflat: torch.Tensor, u: torch.Tensor,
                              v: torch.Tensor, k: int):
    """Plain version of K3: (out (B, C3, k, N), idx (B, N, k)).  The
    centre add is taken in at least float32 and rounded once to u's dtype
    (bf16 features: the bf16 mode's ``bf16(float(u[idx]) + float(v))``)."""
    pts = xflat.transpose(1, 2)
    _, idx = reference_knn_min(pts, pts, k)
    ct = _ct(u)
    out = gather_columns(u, idx).to(ct) + v.to(ct)[:, :, None, :]
    return out.to(u.dtype), idx


def _exact_f32(t: torch.Tensor) -> torch.Tensor:
    """bf16 values upcast to float32, which holds them exactly; other
    dtypes as they are."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _check_k(name: str, k: int, m: int) -> None:
    if not 0 < k <= min(_MAX_K, m):
        raise ValueError(f"{name}: k={k} must be in [1, min(64, {m})]")


def topk_min_fwd(d: torch.Tensor, k: int):
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if not d.is_cuda:
        return reference_topk_min(d, k)
    if d.ndim != 3:
        raise ValueError(f"topk_min: d must be (B, N, M), got {tuple(d.shape)}")
    b, n, m = d.shape
    d = d.contiguous()
    check_cuda("topk_min", "a float32 matrix", (d, torch.float32))
    design = topk_design(m, k, d.data_ptr() % 16 == 0)
    vals = torch.empty((b, n, k), device=d.device, dtype=torch.float32)
    idx = torch.empty((b, n, k), device=d.device, dtype=torch.int32)
    _TOPK(d, d.data_ptr(), vals.data_ptr(), idx.data_ptr(), b * n, m, k,
          TOPK_DESIGNS.index(design), variant=design)
    return vals, idx


def knn_min_fwd(q: torch.Tensor, r: torch.Tensor, k: int):
    """K2 on a CUDA tensor, its plain version on a CPU tensor."""
    if not q.is_cuda:
        return reference_knn_min(q, r, k)
    if q.ndim != 3 or r.ndim != 3 or q.shape[0] != r.shape[0] or q.shape[2] != r.shape[2]:
        raise ValueError(f"knn_min: bad shapes {tuple(q.shape)} {tuple(r.shape)}")
    b, n, dim = q.shape
    m = r.shape[1]
    design = knn_design(m, dim, k)
    # bf16 coordinates are upcast exactly, as JAX's kernel does in its body
    # (knn_pallas.py:159-160)
    q, r = _exact_f32(q), _exact_f32(r)
    check_cuda("knn_min", "float32 points (bf16 upcast exactly), any strides",
               (q, torch.float32), (r, torch.float32), contiguous=False)
    if design == "coords":  # read at their own strides
        qs, rs = q.stride(), r.stride()
    else:  # q packed, r packed as (B, D, M)
        q, r = q.contiguous(), r.transpose(1, 2).contiguous()
        qs, rs = (n * dim, dim, 1), (dim * m, 1, m)
    vals = torch.empty((b, n, k), device=q.device, dtype=torch.float32)
    idx = torch.empty((b, n, k), device=q.device, dtype=torch.int32)
    _KNN(q, q.data_ptr(), r.data_ptr(), vals.data_ptr(), idx.data_ptr(), b, n, m, dim, k,
         KNN_DESIGNS.index(design), *qs, *rs, variant=design)
    return vals, idx


def edge_knn_gather_fwd(xflat: torch.Tensor, u: torch.Tensor, v: torch.Tensor, k: int):
    """K3 on a CUDA tensor, its plain version on a CPU tensor:
    (out (B, C3, k, N), idx (B, N, k))."""
    if not xflat.is_cuda:
        return reference_edge_knn_gather(xflat, u, v, k)
    b, dim, n = xflat.shape
    if u.ndim != 3 or u.shape[0] != b or u.shape[2] != n or v.shape != u.shape:
        raise ValueError(f"edge_knn_gather: bad shapes {tuple(xflat.shape)} "
                         f"{tuple(u.shape)} {tuple(v.shape)}")
    _check_k("edge_knn_gather", k, n)
    if dim > _MAX_D:
        raise ValueError(f"edge_knn_gather: D={dim} > {_MAX_D}")
    c3 = u.shape[1]
    xflat, u, v = xflat.contiguous(), u.contiguous(), v.contiguous()
    bf16 = u.dtype == torch.bfloat16
    dt = torch.bfloat16 if bf16 else torch.float32
    xdt = torch.bfloat16 if bf16 and xflat.dtype == torch.bfloat16 else torch.float32
    check_cuda("edge_knn_gather", EDGE_TAKES, (xflat, xdt), (u, dt), (v, dt))
    design = edge_design(n, dim, k, bf16)
    if design != "warp":  # the new designs copy whole rows by cp.async (16-byte aligned)
        xflat, u, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (xflat, u, v))
    out = torch.empty((b, c3, k, n), device=u.device, dtype=dt)
    idx = torch.empty((b, n, k), device=u.device, dtype=torch.int32)
    ptrs = (xflat.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), idx.data_ptr(),
            b, n, dim, c3, k)
    code = EDGE_DESIGNS.index(design)
    if bf16:
        _EDGE_BF16(u, *ptrs, int(xdt == torch.bfloat16), code, variant=design)
    else:
        _EDGE(u, *ptrs, code, variant=design)
    return out, idx


def scatter_rows(values: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """values (B, E, C) summed onto rows idx (B, E) of a (B, n_rows, C) zero
    tensor; sort-based ``index_put_`` (no float atomics)."""
    b, e, c = values.shape
    rows = idx.long() + torch.arange(b, device=idx.device)[:, None] * n_rows
    out = torch.zeros(b * n_rows, c, dtype=values.dtype, device=values.device)
    out.index_put_((rows.reshape(-1),), values.reshape(b * e, c), accumulate=True)
    return out.reshape(b, n_rows, c)


class _TopkMin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, k):
        vals, idx = topk_min_fwd(d, k)
        ctx.save_for_backward(idx)
        ctx.m = d.shape[2]
        ctx.mark_non_differentiable(idx)
        return vals.to(_ct(d)), idx

    @staticmethod
    def backward(ctx, g, _gi):
        (idx,) = ctx.saved_tensors
        b, n, _ = idx.shape
        dd = torch.zeros((b, n, ctx.m), dtype=g.dtype, device=g.device)
        return dd.scatter_(2, idx.long(), g), None  # indices of a row are distinct


class _KnnMin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, r, k):
        vals, idx = knn_min_fwd(q, r, k)
        ctx.save_for_backward(q, r, idx)
        ctx.mark_non_differentiable(idx)
        return vals.to(torch.promote_types(_ct(q), r.dtype)), idx

    @staticmethod
    def backward(ctx, g, _gi):
        q, r, idx = ctx.saved_tensors
        ct = torch.promote_types(_ct(q), r.dtype)
        qf, rf, g = q.to(ct), r.to(ct), g.to(ct)
        b, n, kk = idx.shape
        rows = torch.arange(b, device=q.device)[:, None, None]
        diff = qf[:, :, None, :] - rf[rows, idx.long()]  # (B, N, k, D): q_n - r_idx
        dq = 2.0 * (g[..., None] * diff).sum(2)
        dr = scatter_rows((-2.0 * g[..., None] * diff).reshape(b, n * kk, -1),
                          idx.reshape(b, n * kk), r.shape[1])
        return dq.to(q.dtype), dr.to(r.dtype), None


class _EdgeKnnGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xflat, u, v, k):
        out, idx = edge_knn_gather_fwd(xflat, u, v, k)
        ctx.save_for_backward(idx)
        return out

    @staticmethod
    def backward(ctx, ct):
        """JAX ``_ekg_bwd``: du and dv summed in at least float32 (bf16
        features: the k cotangents of a column are not added in bf16) and
        cast to the features' dtype once."""
        (idx,) = ctx.saved_tensors
        b, n, k = idx.shape
        ctf = ct.to(torch.promote_types(ct.dtype, torch.float32))
        dv = ctf.sum(2)
        # ct[b, :, kk, q] goes to column idx[b, q, kk] of u
        du = scatter_rows(ctf.permute(0, 2, 3, 1).reshape(b, k * n, -1),
                          idx.transpose(1, 2).reshape(b, k * n), n)
        return None, du.transpose(1, 2).to(ct.dtype), dv.to(ct.dtype), None


def topk_min(d: torch.Tensor, k: int):
    """d (B, N, M) -> (vals, idx) (B, N, k), differentiable in the values."""
    return _TopkMin.apply(d, k)


def knn_min(q: torch.Tensor, r: torch.Tensor, k: int):
    """q (B, N, D), r (B, M, D) -> (squared distances, idx) (B, N, k),
    differentiable in the distances w.r.t. q and r."""
    return _KnnMin.apply(q, r, k)


def edge_knn_gather(xflat: torch.Tensor, u: torch.Tensor, v: torch.Tensor, k: int):
    """xflat (B, D, N), u, v (B, C3, N) -> (B, C3, k, N), differentiable in
    u and v (the indices are piecewise constant in xflat)."""
    return _EdgeKnnGather.apply(xflat, u, v, k)
