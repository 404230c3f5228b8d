"""A whole VNLinearLeakyReLU layer in one pass, forward and backward
(``group = 0``).

Port of ``vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py``:

- :func:`vn_layer_stats` (kernel S, backward S'): per-channel sums of
  ``|p| + EPS`` and its square for ``p = W x (+ pbias)``, the train-mode
  BatchNorm moments of a layer whose pre-activation is never stored;
- :func:`vn_layer_fused` (kernel B, backward B'): ``bn_leaky(W x + pbias,
  Wd x + dbias)`` on (B, 3, C_in, N) planes, the decoder's first fold layer;
- :func:`vn_layer_fused_project` (kernel C, backward C'): the same layer
  followed by the contraction with a 1-channel ``w_out``, so the
  (B, 3, C_out, N) activation never exists; the decoder's ``final_conv.1``
  + ``final_conv.2``.

Each is a ``torch.autograd.Function`` that saves only its inputs; the
backward recomputes ``p`` and ``d`` from ``x``, as the JAX ops do, so no
(B, 3, C, N) residual is kept between forward and backward.  The matrix
products run inside the kernels (``csrc/vn_layer_fused.cu``,
``csrc/vn_layer_bwd.cu``).  A CPU tensor takes the plain versions
(``reference_*``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vn_pointcloudcompletion_tpu_torch.ops.cuda_lib import (
    CudaKernel,
    check_cuda_f32,
)
from vn_pointcloudcompletion_tpu_torch.ops.vn_fused import (
    EPS,
    plane_dot,
    reference_bn_leaky_bwd,
    reference_bn_leaky_planes,
    safe_sqrt,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LAYER = CudaKernel(
    "vn_layer_fused.cu", "vn_layer_fused_fwd",
    [_P] * 8 + [_I] * 4 + [ctypes.c_float, _P],
)
_PROJECT = CudaKernel(
    "vn_layer_fused.cu", "vn_layer_fused_project_fwd",
    [_P] * 9 + [_I] * 4 + [ctypes.c_float, _P],
)
_STATS = CudaKernel(
    "vn_layer_bwd.cu", "vn_layer_stats_fwd", [_P] * 5 + [_I] * 4 + [_P])
_STATS_BWD = CudaKernel(
    "vn_layer_bwd.cu", "vn_layer_stats_bwd", [_P] * 11 + [_I] * 5 + [_P])
_LAYER_BWD = CudaKernel(
    "vn_layer_bwd.cu", "vn_layer_fused_bwd",
    [_P] * 16 + [_I] * 5 + [ctypes.c_float, _P])
_PROJECT_BWD = CudaKernel(
    "vn_layer_bwd.cu", "vn_layer_fused_project_bwd",
    [_P] * 17 + [_I] * 5 + [ctypes.c_float, _P])
TILE = 64  # points per block of the layer kernels (kPts in csrc/vn_tile.cuh)


def layer_eligible(x: torch.Tensor, c_out: int,
                   share_nonlinearity: bool = False) -> bool:
    """Shapes where the JAX package takes its whole-layer Pallas kernel
    (vn_layer_fused.py:45): small channel counts, many points."""
    if share_nonlinearity or x.ndim != 4 or x.shape[1] != 3:
        return False
    c_in, n = x.shape[2], x.shape[3]
    aligned = c_out % 128 == 0 or c_out <= 128
    return aligned and c_in <= 512 and c_out <= 512 and n >= 4096


def _products(w, x, bias):
    """(C_out, C_in) map over the planes of x (B, 3, C_in, N), plus bias."""
    p = torch.matmul(w, x)
    return p if bias is None else p + bias


def _weight_grad(g, x):
    """sum over samples, planes and points of g x^T: (C_out, C_in)."""
    return torch.einsum("bjcn,bjkn->ck", g, x)


def reference_layer_fused(x, w, wd, pbias, dbias, a, b, negative_slope: float):
    """Plain version of kernel B: separate products, then the epilogue."""
    return reference_bn_leaky_planes(
        _products(w, x, pbias), _products(wd, x, dbias), a, b, negative_slope)


def reference_layer_fused_project(x, w, wd, pbias, dbias, a, b, w_out,
                                  negative_slope: float):
    """Plain version of kernel C: the layer, then the 1-channel VNLinear."""
    out = reference_layer_fused(x, w, wd, pbias, dbias, a, b, negative_slope)
    return torch.matmul(w_out.reshape(1, -1), out)


def reference_stats(x, w, pbias):
    """Plain version of kernel S: (s1, s2), the sums over samples and points
    of ``|p| + EPS`` and its square per output channel."""
    p = _products(w, x, pbias)
    norm_e = safe_sqrt(plane_dot(p, p)) + EPS  # (B, C, N)
    return norm_e.sum((0, 2)), (norm_e * norm_e).sum((0, 2))


def reference_stats_bwd(x, w, pbias, c1, c2):
    """Plain version of kernel S': (dx, dw, dpbias) from the cotangents
    (c1, c2) of (s1, s2); dpbias is None without a bias."""
    p = _products(w, x, pbias)
    pnorm = safe_sqrt(plane_dot(p, p))
    norm_e = pnorm + EPS
    inv = torch.where(pnorm > 0, 1.0 / torch.clamp_min(pnorm, 1e-30), 0.0)
    scale = (c1[None, :, None] + 2.0 * c2[None, :, None] * norm_e) * inv
    dp = scale[:, None] * p
    dpb = None if pbias is None else dp.sum(3, keepdim=True)
    return torch.matmul(w.t(), dp), _weight_grad(dp, x), dpb


def reference_layer_bwd(x, w, wd, pbias, dbias, a, b, g, negative_slope: float):
    """Plain version of kernel B': (dx, dw, dwd, dpbias, ddbias, da, db) for
    the cotangent g (B, 3, C_out, N); the bias gradients are None without
    biases."""
    p, d = _products(w, x, pbias), _products(wd, x, dbias)
    dp, dd, da, db = reference_bn_leaky_bwd(p, d, a, b, g, negative_slope)
    dx = torch.matmul(w.t(), dp) + torch.matmul(wd.t(), dd)
    dpb = ddb = None
    if pbias is not None:
        dpb, ddb = dp.sum(3, keepdim=True), dd.sum(3, keepdim=True)
    return dx, _weight_grad(dp, x), _weight_grad(dd, x), dpb, ddb, da, db


def reference_layer_project_bwd(x, w, wd, pbias, dbias, a, b, w_out, g,
                                negative_slope: float):
    """Plain version of kernel C': as :func:`reference_layer_bwd` for the
    cotangent g (B, 3, 1, N) of the projected output, plus d w_out."""
    g_full = w_out[None, None, :, None] * g
    dx, dw, dwd, dpb, ddb, da, db = reference_layer_bwd(
        x, w, wd, pbias, dbias, a, b, g_full, negative_slope)
    o = reference_layer_fused(x, w, wd, pbias, dbias, a, b, negative_slope)
    dwo = plane_dot(o, g).sum((0, 2))
    return dx, dw, dwd, dpb, ddb, da, db, dwo


# ------------------------------------------------------------- launches


def _prepare(name, x, w, wd=None, pbias=None, dbias=None, a=None, b=None,
             w_out=None, g=None):
    """Check shapes, make the tensors contiguous float32 on one card."""
    bsz, three, c_in, n = x.shape
    c_out = w.shape[0]
    if three != 3 or w.shape != (c_out, c_in) or (wd is not None and wd.shape != w.shape):
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    for t in (a, b, w_out):
        if t is not None and t.shape != (c_out,):
            raise ValueError(f"{name}: a, b, w_out must be ({c_out},)")
    if wd is not None and (pbias is None) != (dbias is None):
        raise ValueError(f"{name}: pass both biases or neither")
    for t in (pbias, dbias):
        if t is not None and t.shape != (bsz, 3, c_out, 1):
            raise ValueError(f"{name}: biases must be ({bsz}, 3, {c_out}, 1)")
    if g is not None and g.shape != (bsz, 3, 1 if w_out is not None else c_out, n):
        raise ValueError(f"{name}: bad cotangent shape {tuple(g.shape)}")
    args = [None if t is None else t.contiguous()
            for t in (x, w, wd, pbias, dbias, a, b, w_out, g)]
    check_cuda_f32(name, *[t for t in args if t is not None])
    return args, (bsz, c_in, c_out, n)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _empty(x, *shape):
    return torch.empty(shape, device=x.device, dtype=torch.float32)


def _split_k(x, c_in, c_out, n_points):
    """Chunks of the point axis for the weight-gradient pass: enough blocks
    to cover the card four times over."""
    tiles = -(-c_out // TILE) * -(-c_in // TILE)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return max(1, min(-(-n_points // 16), -(-4 * sms // tiles)))


def _launch(kernel: CudaKernel, x, w, wd, pbias, dbias, a, b, w_out,
            negative_slope: float):
    (x, w, wd, pbias, dbias, a, b, w_out, _), (bsz, c_in, c_out, n) = _prepare(
        kernel.symbol, x, w, wd, pbias, dbias, a, b, w_out)
    out = _empty(x, bsz, 3, c_out if w_out is None else 1, n)
    kernel(x, *[_ptr(t) for t in (x, w, wd, pbias, dbias, a, b)],
           *([] if w_out is None else [w_out.data_ptr()]),
           out.data_ptr(), bsz, c_in, c_out, n, 1 - negative_slope)
    return out


def stats_fwd(x, w, pbias):
    """Kernel S on a CUDA tensor, its plain version on a CPU tensor."""
    if not x.is_cuda:
        return reference_stats(x, w, pbias)
    (x, w, _, pbias, *_), (bsz, c_in, c_out, n) = _prepare(
        "vn_layer_stats", x, w, pbias=pbias)
    s12 = _empty(x, 2, c_out)
    partial = _empty(x, 2, bsz, -(-n // TILE), c_out)
    _STATS(x, x.data_ptr(), w.data_ptr(), _ptr(pbias), s12.data_ptr(),
           partial.data_ptr(), bsz, c_in, c_out, n)
    return s12[0], s12[1]


def stats_bwd(x, w, pbias, c1, c2):
    """Kernel S' on a CUDA tensor, its plain version on a CPU tensor:
    (dx, dw, dpbias)."""
    if not x.is_cuda:
        return reference_stats_bwd(x, w, pbias, c1, c2)
    (x, w, _, pbias, _, c1, c2, *_), (bsz, c_in, c_out, n) = _prepare(
        "vn_layer_stats backward", x, w, pbias=pbias, a=c1, b=c2)
    s = _split_k(x, c_in, c_out, bsz * 3 * n)
    dx, dw = torch.empty_like(x), _empty(x, c_out, c_in)
    dpb = None if pbias is None else _empty(x, 3, bsz, c_out)
    dp = _empty(x, bsz, 3, c_out, n)
    partial = None if pbias is None else _empty(x, 3, bsz, -(-n // TILE), c_out)
    dw_part = _empty(x, s, c_out, c_in)
    _STATS_BWD(x, *[_ptr(t) for t in (x, w, pbias, c1, c2, dx, dw, dpb, dp,
                                      partial, dw_part)],
               bsz, c_in, c_out, n, s)
    if dpb is not None:
        dpb = dpb.permute(1, 0, 2)[..., None]
    return dx, dw, dpb


def _layer_bwd_launch(kernel, x, w, wd, pbias, dbias, a, b, w_out, g,
                      negative_slope):
    """Kernels B' and C': (dx, dw, dwd, dpbias, ddbias, da, db[, dwo])."""
    (x, w, wd, pbias, dbias, a, b, w_out, g), (bsz, c_in, c_out, n) = _prepare(
        kernel.symbol, x, w, wd, pbias, dbias, a, b, w_out, g)
    s = _split_k(x, c_in, c_out, bsz * 3 * n)
    nqc = 2 if w_out is None else 3
    dx, dw2, sums = torch.empty_like(x), _empty(x, 2, c_out, c_in), _empty(x, nqc, c_out)
    dpdb = None if pbias is None else _empty(x, 6, bsz, c_out)
    dp, dd = _empty(x, bsz, 3, c_out, n), _empty(x, bsz, 3, c_out, n)
    partial = _empty(x, nqc + 6, bsz, -(-n // TILE), c_out)
    dw_part = _empty(x, 2, s, c_out, c_in)
    ptrs = [_ptr(t) for t in (x, w, wd, pbias, dbias, a, b)]
    if w_out is not None:
        ptrs.append(w_out.data_ptr())
    ptrs += [_ptr(t) for t in (g, dx, dw2, sums, dpdb, dp, dd, partial, dw_part)]
    kernel(x, *ptrs, bsz, c_in, c_out, n, s, 1 - negative_slope)
    dpb = ddb = None
    if dpdb is not None:
        dpdb = dpdb.reshape(2, 3, bsz, c_out).permute(0, 2, 1, 3)[..., None]
        dpb, ddb = dpdb[0], dpdb[1]
    return (dx, dw2[0], dw2[1], dpb, ddb, *sums.unbind(0))


def layer_bwd(x, w, wd, pbias, dbias, a, b, g, negative_slope: float):
    """Kernel B' on a CUDA tensor, its plain version on a CPU tensor."""
    if not x.is_cuda:
        return reference_layer_bwd(x, w, wd, pbias, dbias, a, b, g, negative_slope)
    return _layer_bwd_launch(_LAYER_BWD, x, w, wd, pbias, dbias, a, b, None, g,
                             negative_slope)


def layer_project_bwd(x, w, wd, pbias, dbias, a, b, w_out, g,
                      negative_slope: float):
    """Kernel C' on a CUDA tensor, its plain version on a CPU tensor."""
    if not x.is_cuda:
        return reference_layer_project_bwd(
            x, w, wd, pbias, dbias, a, b, w_out, g, negative_slope)
    return _layer_bwd_launch(_PROJECT_BWD, x, w, wd, pbias, dbias, a, b, w_out,
                             g, negative_slope)


# ------------------------------------------------------------- autograd


class _LayerStats(torch.autograd.Function):
    """Kernel S forward, S' backward; saves only (x, w, pbias)."""

    @staticmethod
    def forward(ctx, x, w, pbias):
        ctx.save_for_backward(x, w, pbias)
        return stats_fwd(x, w, pbias)

    @staticmethod
    def backward(ctx, c1, c2):
        x, w, pbias = ctx.saved_tensors
        c_out = w.shape[0]
        c1 = torch.zeros(c_out, device=x.device, dtype=w.dtype) if c1 is None else c1
        c2 = torch.zeros(c_out, device=x.device, dtype=w.dtype) if c2 is None else c2
        return stats_bwd(x, w, pbias, c1, c2)


class _LayerFused(torch.autograd.Function):
    """Kernel B forward, B' backward; saves only the inputs."""

    @staticmethod
    def forward(ctx, x, w, wd, pbias, dbias, a, b, negative_slope):
        ctx.save_for_backward(x, w, wd, pbias, dbias, a, b)
        ctx.negative_slope = negative_slope
        if not x.is_cuda:
            return reference_layer_fused(x, w, wd, pbias, dbias, a, b, negative_slope)
        return _launch(_LAYER, x, w, wd, pbias, dbias, a, b, None, negative_slope)

    @staticmethod
    def backward(ctx, g):
        return (*layer_bwd(*ctx.saved_tensors, g, ctx.negative_slope), None)


class _LayerFusedProject(torch.autograd.Function):
    """Kernel C forward, C' backward; saves only the inputs."""

    @staticmethod
    def forward(ctx, x, w, wd, pbias, dbias, a, b, w_out, negative_slope):
        ctx.save_for_backward(x, w, wd, pbias, dbias, a, b, w_out)
        ctx.negative_slope = negative_slope
        if not x.is_cuda:
            return reference_layer_fused_project(
                x, w, wd, pbias, dbias, a, b, w_out, negative_slope)
        return _launch(_PROJECT, x, w, wd, pbias, dbias, a, b, w_out, negative_slope)

    @staticmethod
    def backward(ctx, g):
        return (*layer_project_bwd(*ctx.saved_tensors, g, ctx.negative_slope), None)


def vn_layer_stats(x, w, pbias: Optional[torch.Tensor] = None):
    """x: (B, 3, C_in, N); w: (C_out, C_in); pbias: (B, 3, C_out, 1) or None.
    Returns (s1, s2): (C_out,) sums over samples and points of ``|p| + EPS``
    and ``(|p| + EPS)^2``; the BN moments are ``s1 / (B N)``, ``s2 / (B N)``."""
    return _LayerStats.apply(x, w, pbias)


def vn_layer_fused(x, w, wd, pbias: Optional[torch.Tensor],
                   dbias: Optional[torch.Tensor], a, b, negative_slope: float):
    """x: (B, 3, C_in, N); w, wd: (C_out, C_in); pbias, dbias: per-sample
    (B, 3, C_out, 1) or both None; a, b: (C_out,) folded BN affine.
    Returns (B, 3, C_out, N)."""
    return _LayerFused.apply(x, w, wd, pbias, dbias, a, b, negative_slope)


def vn_layer_fused_project(x, w, wd, pbias: Optional[torch.Tensor],
                           dbias: Optional[torch.Tensor], a, b, w_out,
                           negative_slope: float):
    """The layer of :func:`vn_layer_fused` contracted with ``w_out``
    (C_out,) over its output channels.  Returns (B, 3, 1, N)."""
    return _LayerFusedProject.apply(x, w, wd, pbias, dbias, a, b, w_out,
                                    negative_slope)
