"""A whole VNLinearLeakyReLU layer in one pass, forward and backward.

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

The biases come per sample (``group = 0``: (B, 3, C_out, 1)) or per run of
``group`` points (``group = S``: (B, 3, C_out, N // S), column ``n // S`` at
point ``n``): the attention decoder's pair fold adds its per-centre feature
contraction that way, expanded in the kernel, never in device memory
(JAX ``vn_layer_fused.py:74-116``).  Their gradients are ``dp`` summed over
each column's points.  As in JAX, ``S`` divides N and 512.

Kernels B, C, S, S', C' and B' run one of two or three designs, chosen
from the layer's widths and counted by name (``cuda_lib.variant_counts``):
C by :func:`project_fwd_design` (:func:`forward_design`, and
:func:`fwd_bf16_design` in bf16) and C' by :func:`project_bwd_design`
(:func:`backward_design`, and :func:`pass1_bf16_design` in bf16), the wide
design at C_in, C_out >= 16 (final_conv.1, vn_folding{1,2}.1), the narrow
one below; S by :func:`stats_design` and S' by :func:`stats_bwd_design`,
one pass that walks the channels at C_in <= 2 (final_conv.0, conv1, the
pair folds; S's "stream", S''s "fused"), else the wide or narrow design of
C'; B by :func:`layer_fwd_design`, a store stream at C_in <= 2, the narrow
tile above; B' by :func:`layer_bwd_design`, one fused pass at C_in <= 2,
the narrow passes above.  Every design of a kernel computes the same
function (``csrc/vn_layer_fused.cu``, ``csrc/vn_layer_bwd.cu``).

Each is a ``torch.autograd.Function`` that saves only its inputs; the
backward recomputes ``p`` and ``d`` from ``x``, as the JAX ops do, so no
(B, 3, C, N) residual is kept between forward and backward.  JAX's one
``_compute_pd`` gives its backward the forward's bits of p and d; so
does the port: C' sums them in the order its forward C did at every shape
(:func:`summation_order`), in the tensor cores' k16 steps at the wide bf16
shapes.  The matrix products run inside the kernels
(``csrc/vn_layer_fused.cu``, ``csrc/vn_layer_bwd.cu``).  A CPU tensor takes
the plain versions (``reference_*``), in input-channel order; given
``order="k16"``, the plain versions of S, S', C and C' sum p, d as the
tensor cores do (:func:`k16_sum`), so that on the card each can be held to
its kernel at the order its launch takes (:func:`launch_order`).

Every kernel has a bf16 mode, taken when x is bfloat16 (the bfloat16
compute policy; JAX's ``bf16=True``): bf16 x, biases and cotangent,
products of bf16-rounded weights summed in float32, p and d rounded through
bf16 before the float32 epilogue (or its backward), outputs in bf16 (C: the
unrounded epilogue projected, then rounded).  The backwards (S', B', C')
form dp and dd in float32, sum the per-channel and bias gradients from
those, and round them to bf16 only as operands of the dx and dW products
(JAX ``vn_layer_fused.py:204-209``, ``:440-457``, ``:733-750``); dx is
bf16, dW and the sums float32, the bias gradients rounded once to the
biases' dtype.  Launches count under ``<symbol>[bf16]`` and
``<symbol>[group,bf16]``.  The model layers pass bf16 x under the bf16
policy (``nn/vn.py``, ``models/pcn.py``: ``activation_dtype``), so the
mode follows the policy as JAX's ``compute_dtype() == bfloat16`` does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vn_pointcloudcompletion_tpu_torch.ops.cuda_lib import CudaKernel, check_cuda
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
    [_P] * 8 + [_I] * 6 + [ctypes.c_float, _P],
)
_PROJECT = CudaKernel(
    "vn_layer_fused.cu", "vn_layer_fused_project_fwd",
    [_P] * 12 + [_I] * 7 + [ctypes.c_float, _P],
)
_STATS = CudaKernel(
    "vn_layer_bwd.cu", "vn_layer_stats_fwd", [_P] * 7 + [_I] * 6 + [_P])
_STATS_BWD = CudaKernel(
    "vn_layer_bwd.cu", "vn_layer_stats_bwd", [_P] * 13 + [_I] * 8 + [_P])
_LAYER_BWD = CudaKernel(
    "vn_layer_bwd.cu", "vn_layer_fused_bwd",
    [_P] * 16 + [_I] * 7 + [ctypes.c_float, _P])
_PROJECT_BWD = CudaKernel(
    "vn_layer_bwd.cu", "vn_layer_fused_project_bwd",
    [_P] * 19 + [_I] * 8 + [ctypes.c_float, _P])
# The same entry points in group=S mode, counted apart (launch_counts()
# keys "<symbol>[group]"): the attention decoder's pair folds.
_GROUPED = {k.symbol: CudaKernel(k.source, k.symbol, k.argtypes, f"{k.symbol}[group]")
            for k in (_LAYER, _PROJECT, _STATS, _STATS_BWD, _LAYER_BWD, _PROJECT_BWD)}
# The bf16 modes (entry points <symbol>_bf16), counted under
# "<symbol>[bf16]" and, in group=S mode, "<symbol>[group,bf16]".
_BF16 = {(k.symbol, grouped): CudaKernel(
    k.source, f"{k.symbol}_bf16", k.argtypes,
    f"{k.symbol}[group,bf16]" if grouped else f"{k.symbol}[bf16]")
    for k in (_LAYER, _PROJECT, _STATS, _STATS_BWD, _LAYER_BWD, _PROJECT_BWD)
    for grouped in (False, True)}
TAKES = ("x, the biases and the cotangent float32 or (the bf16 mode) bf16, with "
         "float32 w, wd, a, b, w_out and c1, c2")
TILE = 64  # points per block of the layer kernels (kPts in csrc/vn_tile.cuh)
GROUP_TILE = 512  # the TPU kernels' point tile: a group must divide it (TN)


def layer_eligible(x: torch.Tensor, c_out: int,
                   share_nonlinearity: bool = False) -> bool:
    """Shapes where the JAX package takes its whole-layer Pallas kernel
    (vn_layer_fused.py:45): small channel counts, many points."""
    if share_nonlinearity or x.ndim != 4 or x.shape[1] != 3:
        return False
    c_in, n = x.shape[2], x.shape[3]
    aligned = c_out % 128 == 0 or c_out <= 128
    return aligned and c_in <= 512 and c_out <= 512 and n >= 4096


def expand_bias(bias, group: int):
    """A bias at every point: (B, 3, C, G) columns each repeated ``group``
    times along the points -> (B, 3, C, G * group); ``group == 0`` keeps the
    per-sample (B, 3, C, 1) column, which broadcasts."""
    if bias is None or group == 0:
        return bias
    b, _, c, g = bias.shape
    return bias[..., None].expand(b, 3, c, g, group).reshape(b, 3, c, g * group)


def bias_grad(dp, group: int):
    """The gradient of a bias from that of the pre-activation dp (B, 3, C,
    N): dp summed over the points of each column."""
    if group == 0:
        return dp.sum(3, keepdim=True)
    b, _, c, n = dp.shape
    return dp.reshape(b, 3, c, n // group, group).sum(-1)


ORDERS = ("in_order", "k16")  # the summation orders of p = W x (summation_order)


def _products(w, x, bias, group: int = 0, order: str = "in_order"):
    """(C_out, C_in) map over the planes of x (B, 3, C_in, N), plus bias.

    bf16 x (the bf16 mode; JAX ``_compute_pd`` with ``bf16=True``): the
    products of bf16-rounded w and x (each exact in float32) summed in
    float32 in ``order``, the bias added in float32, then one rounding to
    bf16.  ``order`` "in_order": one product at a time in input-channel
    order, as the kernels' FMA designs sum them (and JAX's ``bf16=True``
    kernels in interpret mode, to their bound); "k16": the tensor cores'
    steps (:func:`k16_sum`), as the kernels' tensor-core designs sum them,
    to the bit.  (A matrix product would sum in yet another order and move
    p by one bf16 step where it lies at a rounding boundary; C's 256-channel
    projection turns that into several ulps of its output.)  float32 x sums
    in a matrix product and takes "in_order" only."""
    if order not in ORDERS or (order == "k16" and x.dtype != torch.bfloat16):
        raise ValueError(f"order {order!r}: one of {ORDERS}, k16 in the bf16 mode only")
    if x.dtype == torch.bfloat16:
        wf, xf = w.to(torch.bfloat16).float(), x.float()
        if order == "k16":
            p = k16_sum(wf, xf)
        else:
            p = torch.zeros(x.shape[:2] + (w.shape[0], x.shape[3]), dtype=torch.float32,
                            device=x.device)
            for k in range(w.shape[1]):
                p.addcmul_(wf[:, k:k + 1], xf[:, :, k:k + 1])
        if bias is not None:
            p = p + expand_bias(bias, group).float()
        return p.to(torch.bfloat16)
    p = torch.matmul(w, x)
    return p if bias is None else p + expand_bias(bias, group)


# ---------------------------------------- the tensor cores' k16 step, exactly
#
# Established on an H100 (tools/probe_k16.py: mma.sync m16n8k16 and
# wgmma.m64n64k16, which give the same bits, on crafted operands read back
# as float32; PERF.md §6): a step adds 16 exact products to its float32
# accumulator as one fused sum (not two k8 halves: m16n8k8 steps round
# otherwise).  The 17 addends are aligned to E, the largest of the
# accumulator's exponent and the products' exponents taken as the sums of
# their operands' exponents (before the product's own normalisation; an
# exponent is floor(log2 |v|), at least -126: a subnormal counts at the
# least normal exponent); each addend is truncated toward zero to a multiple
# of 2^(E - 25); the aligned addends are summed exactly; the sum is
# truncated toward zero to float32.

K16_STEP = 16  # products a step adds to its accumulator (m16n8k16, wgmma k16)
K16_BITS = 25  # each addend keeps the multiples of 2^(E - K16_BITS)
K16_EMIN = -126  # the least exponent an addend counts with (float32's, bf16's normal range)
K16_CHUNK = 1 << 23  # float64 products of one step held at once: 64 MB


def _trunc_to_f32(y):
    """float64 -> the float32 next to it toward zero."""
    f = y.float()
    over = f.double().abs() > y.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _pow2(e):
    """2^e (float64) for integer tensors e in float64's normal range, built
    from its bits: exact on any device (torch.ldexp multiplies by a power
    that a card may not form exactly)."""
    return ((e.long() + 1023) << 52).view(torch.float64)


def _exponent(v):
    """floor(log2 |v|) of float64 ``v``, at least K16_EMIN; -2^20 at 0 (an
    addend of 0 takes no part in the alignment)."""
    _, e = torch.frexp(v)
    return torch.where(v == 0, torch.full_like(e, -(1 << 20)), (e - 1).clamp_min(K16_EMIN))


def k16_step(acc, prods, exps):
    """One step of the tensor cores: ``acc`` (...) float32 plus the exact
    products ``prods`` (16, ...) float64, ``exps`` (16, ...) their
    exponents as the sums of their operands' (:func:`_exponent`).  Returns
    the float32 accumulator after the step (see above).  The float64 sum is
    exact: each aligned addend is an integer multiple of 2^(E - 25) below
    2^(E + 2), so the 17 of them sum below 2^32 such units."""
    a = acc.double()
    # all 17 addends zero: any E gives +0
    e = torch.maximum(exps.amax(0), _exponent(a)).clamp_min(2 * K16_EMIN)
    up = _pow2(K16_BITS - e)  # the aligned addends as integers
    total = torch.trunc(a * up) + torch.trunc(prods * up).sum(0)
    return _trunc_to_f32(total * _pow2(e - K16_BITS))


def k16_sum(w, x, acc=None):
    """sum_k w[..., m, k] x[..., k, n] for bf16-exact w (..., M, K) and x
    (..., K, N) as the tensor cores sum it: from the float32 accumulator
    ``acc`` (..., M, N) (None: +0), steps of K16_STEP input channels in
    ascending order (:func:`k16_step`; the last one short).  Exact, in
    chunks of the points that keep a full-width call within a few hundred
    MB.  Returns float32 (..., M, N)."""
    wf, xf = w.double(), x.double()
    ew, ex = _exponent(wf), _exponent(xf)
    m, k, n = wf.shape[-2], wf.shape[-1], xf.shape[-1]
    lead = torch.broadcast_shapes(wf.shape[:-2], xf.shape[:-2])
    out = torch.zeros(lead + (m, n), dtype=torch.float32, device=x.device)
    if acc is not None:
        out.copy_(acc.expand(lead + (m, n)))
    per = max(1, K16_CHUNK // (K16_STEP * m * max(1, lead.numel())))
    for n0 in range(0, n, per):
        cols = slice(n0, n0 + per)
        a = out[..., cols]
        for k0 in range(0, k, K16_STEP):
            ks = slice(k0, k0 + K16_STEP)
            prods = (wf[..., :, ks, None] * xf[..., None, ks, cols]).movedim(-2, 0)
            exps = (ew[..., :, ks, None] + ex[..., None, ks, cols]).movedim(-2, 0)
            a = k16_step(a, prods, torch.where(prods == 0, -(1 << 20), exps))
        out[..., cols] = a
    return out


def _planes(w, x, bias, group: int = 0, order: str = "in_order"):
    """p (or d) as the epilogue and its backward read them, in at least
    float32: in the bf16 mode the bf16-rounded planes of :func:`_products`
    summed in ``order``, as float32."""
    return _products(w, x, bias, group, order).to(torch.promote_types(x.dtype, torch.float32))


def _operand(t, x):
    """A factor of a backward product: in the bf16 mode (bf16 x) rounded to
    bf16 and read as float32, JAX's ``w16``, ``dp16``, ``x16`` (the products
    exact, summed in float32); otherwise ``t`` itself."""
    return t.to(torch.bfloat16).float() if x.dtype == torch.bfloat16 else t


def _input_grad(x, *pairs):
    """dx = sum over the (w, dp) pairs of w^T dp, in x's dtype."""
    dx = sum(torch.matmul(_operand(w, x).t(), _operand(dp, x)) for w, dp in pairs)
    return dx.to(x.dtype)


def _weight_grad(g, x):
    """sum over samples, planes and points of g x^T: (C_out, C_in), float32
    sums of the bf16 operands in the bf16 mode."""
    return torch.einsum("bjcn,bjkn->ck", _operand(g, x), _operand(x, x))


def reference_layer_fused(x, w, wd, pbias, dbias, a, b, negative_slope: float,
                          group: int = 0):
    """Plain version of kernel B: separate products, the biases expanded and
    added (the kernel's one addition), then the epilogue."""
    return reference_bn_leaky_planes(
        _products(w, x, pbias, group), _products(wd, x, dbias, group), a, b,
        negative_slope)


def reference_layer_fused_project(x, w, wd, pbias, dbias, a, b, w_out,
                                  negative_slope: float, group: int = 0,
                                  order: str = "in_order"):
    """Plain version of kernel C: the layer (p, d summed in ``order``,
    :func:`_products`), then the 1-channel VNLinear.  The projection reads
    the layer's epilogue unrounded (in at least float32, as JAX's fused C
    does) and rounds once to x's dtype."""
    ct = torch.promote_types(x.dtype, torch.float32)
    o = reference_bn_leaky_planes(
        _products(w, x, pbias, group, order), _products(wd, x, dbias, group, order), a, b,
        negative_slope, out_dtype=ct)
    if x.dtype == torch.bfloat16:
        wide = forward_design(x.shape[2], w.shape[0]) == "wide"
        return _project_in_kernel_order(w_out, o, wide).to(torch.bfloat16)
    return torch.matmul(w_out.to(ct).reshape(1, -1), o).to(x.dtype)


def _project_in_kernel_order(w_out, o, wide: bool = False):
    """sum_c w_out[c] o[:, :, c] (B, 3, C, N) -> (B, 3, 1, N) in the order
    of kernel C's bf16 mode, each product rounded (the epilogue's channels
    cancel in this sum, so another order rounds differently by several bf16
    ulps of the (small) result).  The narrow design: each of 16 channel
    groups sums its channels c0 + 4 g + i (c0 in steps of 64, then i =
    0..3) in turn, then the 16 group sums in turn.  The wide design: see
    :func:`_project_wide_order`."""
    prods = w_out.float()[None, None, :, None] * o
    if wide:
        return _project_wide_order(prods)
    c = o.shape[2]
    acc = torch.zeros(o.shape[:2] + (16, o.shape[3]), dtype=o.dtype, device=o.device)
    for c0 in range(0, c, TILE):
        for i in range(4):
            chans = c0 + 4 * torch.arange(16) + i
            g = chans < c
            acc[:, :, g] = acc[:, :, g] + prods[:, :, chans[g].to(o.device)]
    out = torch.zeros_like(acc[:, :, :1])
    for g in range(16):
        out = out + acc[:, :, g:g + 1]
    return out


def _project_wide_order(prods):
    """The bf16 wide C's contraction order (``csrc/vn_layer_fused.cu``
    proj_wide_mma) over prods (B, 3, C, N): channel cb 64 + wm 32 + mt 16 +
    8 r + grp is element (mt, r) of the lane of row grp in the channel warp
    wm of channel block cb.  A lane sums its four channels in (mt, r) order;
    the warp's eight rows add pairwise, neighbours first (a shuffle tree);
    then the two channel warps; then the channel blocks in turn."""
    b, _, c, n = prods.shape
    blocks = -(-c // WIDE_BF16_BLOCK)
    pad = blocks * WIDE_BF16_BLOCK - c
    if pad:
        prods = torch.cat([prods, prods.new_zeros(b, 3, pad, n)], 2)
    t = prods.reshape(b, 3, blocks, 2, 2, 2, 8, n)  # (cb, wm, mt, r, grp)
    s = ((t[:, :, :, :, 0, 0] + t[:, :, :, :, 0, 1]) + t[:, :, :, :, 1, 0]) + t[:, :, :, :, 1, 1]
    for _ in range(3):  # (..., grp, n): pairs of neighbouring rows
        s = s[..., 0::2, :] + s[..., 1::2, :]
    s = s[:, :, :, 0] + s[:, :, :, 1]  # the channel warps: (B, 3, blocks, 1, N)
    out = torch.zeros_like(s[:, :, 0])
    for k in range(blocks):
        out = out + s[:, :, k]
    return out


def reference_stats(x, w, pbias, group: int = 0, order: str = "in_order"):
    """Plain version of kernel S: (s1, s2), the sums over samples and points
    of ``|p| + EPS`` and its square per output channel (p summed in
    ``order``, :func:`_products`)."""
    p = _planes(w, x, pbias, group, order)
    norm_e = safe_sqrt(plane_dot(p, p)) + EPS  # (B, C, N)
    return norm_e.sum((0, 2)), (norm_e * norm_e).sum((0, 2))


def reference_stats_bwd(x, w, pbias, c1, c2, group: int = 0, order: str = "in_order"):
    """Plain version of kernel S': (dx, dw, dpbias) from the cotangents
    (c1, c2) of (s1, s2); dpbias is None without a bias.  The bias
    gradient sums the float32 dp (JAX ``:218-225``), dx and dw take it
    rounded in the bf16 mode; p summed in ``order`` (:func:`_products`)."""
    p = _planes(w, x, pbias, group, order)
    pnorm = safe_sqrt(plane_dot(p, p))
    norm_e = pnorm + EPS
    inv = torch.where(pnorm > 0, 1.0 / torch.clamp_min(pnorm, 1e-30), 0.0)
    scale = (c1[None, :, None] + 2.0 * c2[None, :, None] * norm_e) * inv
    dp = scale[:, None] * p
    dpb = None if pbias is None else bias_grad(dp, group).to(pbias.dtype)
    return _input_grad(x, (w, dp)), _weight_grad(dp, x), dpb


def _given_planes(planes, w, wd, x, pbias, dbias, group, order="in_order"):
    """(p, d) as a backward's epilogue reads them: ``planes`` (p, d), the
    bf16 (or float32) planes (B, 3, C_out, N) at which to take it, in at
    least float32; or, ``planes`` None, :func:`_planes`'s, recomputed in
    ``order``."""
    if planes is None:
        return _planes(w, x, pbias, group, order), _planes(wd, x, dbias, group, order)
    ct = torch.promote_types(x.dtype, torch.float32)
    return tuple(t.to(ct) for t in planes)


def reference_layer_bwd(x, w, wd, pbias, dbias, a, b, g, negative_slope: float,
                        group: int = 0, planes=None):
    """Plain version of kernel B': (dx, dw, dwd, dpbias, ddbias, da, db) for
    the cotangent g (B, 3, C_out, N); the bias gradients are None without
    biases.  dp and dd stay float32 for dA, dB and the bias sums; the bf16
    mode rounds them only as operands of dx, dw and dwd (JAX ``:440-457``).
    ``planes``: None (p, d recomputed here, in input-channel order), or the
    (p, d) at which to take the backward, as a forward formed them (JAX's
    ``_compute_pd`` gives its backward the bits its forward used; on the
    card kernel C's ``pd_out``)."""
    p, d = _given_planes(planes, w, wd, x, pbias, dbias, group)
    dp, dd, da, db = reference_bn_leaky_bwd(p, d, a, b, g, negative_slope)
    dpb = ddb = None
    if pbias is not None:
        dpb, ddb = bias_grad(dp, group).to(pbias.dtype), bias_grad(dd, group).to(dbias.dtype)
    return (_input_grad(x, (w, dp), (wd, dd)), _weight_grad(dp, x), _weight_grad(dd, x),
            dpb, ddb, da, db)


def reference_layer_project_bwd(x, w, wd, pbias, dbias, a, b, w_out, g,
                                negative_slope: float, group: int = 0, planes=None,
                                order: str = "in_order"):
    """Plain version of kernel C': as :func:`reference_layer_bwd` for the
    cotangent g (B, 3, 1, N) of the projected output, plus d w_out: the
    layer's cotangent ``w_out * g`` and ``<o, g>`` (o the unrounded
    epilogue) formed in at least float32 (JAX ``:678-684``).  ``planes``:
    as :func:`reference_layer_bwd`'s (the CPU path never passes it); else p,
    d recomputed in ``order`` (:func:`_products`)."""
    ct = torch.promote_types(x.dtype, torch.float32)
    g = g.to(ct)
    p, d = _given_planes(planes, w, wd, x, pbias, dbias, group, order)
    dx, dw, dwd, dpb, ddb, da, db = reference_layer_bwd(
        x, w, wd, pbias, dbias, a, b, w_out.to(ct)[None, None, :, None] * g,
        negative_slope, group, planes=(p, d))
    o = reference_bn_leaky_planes(p, d, a, b, negative_slope)
    dwo = plane_dot(o, g).sum((0, 2))
    return dx, dw, dwd, dpb, ddb, da, db, dwo


# ------------------------------------------------------------- launches


def check_group(name, n: int, group: int, pbias) -> None:
    """A bias group must divide N and the TPU kernels' 512-point tile, and
    comes with a bias (JAX vn_layer_fused.py:266, :523)."""
    if group < 0 or (group and (n % group or GROUP_TILE % group or pbias is None)):
        raise ValueError(f"{name}: group={group} must divide N={n} and {GROUP_TILE} "
                         "and come with a bias")


def _prepare(name, x, w, wd=None, pbias=None, dbias=None, a=None, b=None,
             w_out=None, g=None, group=0):
    """Check shapes and types, make the tensors contiguous on one card:
    float32, or in the bf16 mode (bf16 x) x, the biases and the cotangent
    in bf16."""
    bsz, three, c_in, n = x.shape
    c_out = w.shape[0]
    if three != 3 or w.shape != (c_out, c_in) or (wd is not None and wd.shape != w.shape):
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    for t in (a, b, w_out):
        if t is not None and t.shape != (c_out,):
            raise ValueError(f"{name}: a, b, w_out must be ({c_out},)")
    if wd is not None and (pbias is None) != (dbias is None):
        raise ValueError(f"{name}: pass both biases or neither")
    check_group(name, n, group, pbias)
    cols = n // group if group else 1
    for t in (pbias, dbias):
        if t is not None and t.shape != (bsz, 3, c_out, cols):
            raise ValueError(f"{name}: biases must be ({bsz}, 3, {c_out}, {cols})")
    if g is not None and g.shape != (bsz, 3, 1 if w_out is not None else c_out, n):
        raise ValueError(f"{name}: bad cotangent shape {tuple(g.shape)}")
    args = [None if t is None else t.contiguous()
            for t in (x, w, wd, pbias, dbias, a, b, w_out, g)]
    act = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    check_cuda(name, TAKES, *[(t, act if i in (0, 3, 4, 8) else torch.float32)
                              for i, t in enumerate(args) if t is not None])
    return args, (bsz, c_in, c_out, n)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _empty(x, *shape, dtype=torch.float32):
    return torch.empty(shape, device=x.device, dtype=dtype)


def _split_k(x, c_in, c_out, n_points):
    """Chunks of the point axis for the narrow weight-gradient pass: enough
    blocks to cover the card four times over."""
    tiles = -(-c_out // TILE) * -(-c_in // TILE)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return max(1, min(-(-n_points // 16), -(-4 * sms // tiles)))


WIDE_MIN_CHANNELS = 16  # one m16n8k16 product's depth
FUSED_MAX_CIN = 2  # the widest input of the channel walk (S, S', B') and B's stream (csrc)
# The code of each design name in the entry points of csrc/vn_layer_bwd.cu
# (S, S', C', B'; its enum Design): the channel walk is S's "stream" and
# S''s and B''s "fused"
DESIGN_CODES = {"narrow": 0, "wide": 1, "stream": 2, "fused": 2, "wgmma": 3, "wgmma_p": 4}
WGMMA_DESIGNS = ("wgmma", "wgmma_p")  # the designs with the wgmma passes 2, 3
WIDE_F32_BLOCK = 32  # channels a block of the float32 wide C (csrc ProjFma::kBC)
WIDE_BF16_BLOCK = 64  # ... of the bf16 one (csrc ProjMma::kBC)


def forward_design(c_in: int, c_out: int) -> str:
    """Which design kernel C runs at (c_in, c_out): ``"wide"`` (a
    cp.async ring over a W^T scratch; FP32 FMAs in float32, the tensor
    cores in bf16; the channel blocks of a point tile run together, their
    projections summed by a second pass) where both are matrix work, c_in
    and c_out >= 16; ``"narrow"`` (one block walks all channels of its
    point tile with vn_tile.cuh's FMA loop) below that.  A wide bf16 C
    runs the design of :func:`fwd_bf16_design` ("wgmma" or the wide one),
    in the same order of summation.  Either is a hand-written kernel; a
    CUDA launch takes the one chosen here or raises."""
    return "wide" if min(c_in, c_out) >= WIDE_MIN_CHANNELS else "narrow"


PROJ_WGMMA_MAX_CIN = 256  # the deepest x tile proj_wgmma keeps resident (csrc ProjWg)


def fwd_bf16_design(c_in: int, c_out: int, n: int, aligned: bool = True,
                    group: int = 0) -> str:
    """Which design a wide bf16 C (:func:`forward_design` "wide") runs:
    ``"wgmma"`` (csrc proj_wgmma: persistent blocks, a 64-point tile's x
    resident in shared memory for all of its channel blocks, p and d on
    Hopper's warpgroup products fed by TMA, the channel blocks' projections
    summed in registers in order, no second pass; proj_wide_mma's bits)
    where its tiles fit: c_in and c_out multiples of 64, c_in at most
    PROJ_WGMMA_MAX_CIN, every point row of x 16-byte aligned (n % 8 == 0
    and an ``aligned`` base) and a bias column covering whole 64-point
    tiles (group 0 or a multiple of 64) (final_conv.1's 256 -> 256,
    vn_folding{1,2}.1's 256 -> 128); else ``"wide"`` (proj_wide_mma,
    mma.sync, and proj_sum).
    Either is a hand-written kernel; a CUDA launch takes the one chosen
    here or raises."""
    fits = (c_in % WGMMA_CHANNELS == 0 and c_out % WGMMA_CHANNELS == 0 and 0 < c_in
            <= PROJ_WGMMA_MAX_CIN and c_out > 0 and n % 8 == 0 and group % TILE == 0)
    return "wgmma" if fits and aligned else "wide"


def proj_wgmma_grid(bsz: int, n: int, sms: int) -> int:
    """Persistent blocks of proj_wgmma: one an SM (its shared memory
    allows no second), no more than the (sample, 64-point tile) tiles they
    walk; block k takes tiles k, k + grid, ..."""
    return max(1, min(bsz * -(-n // TILE), sms))


def proj_wgmma_smem(c_in: int) -> int:
    """Bytes of shared memory of a proj_wgmma block (csrc ProjWg::bytes):
    1024 of alignment slack, the resident x (3 planes of c_in / 64 boxes of
    64 x 64 bf16), a ring of 4 stages of W^T and Wd^T boxes, the staged p
    and d (2 x 3 x 64 rows of 72 bf16), the two halves' projections of two
    blocks (2 x 2 x 3 x 64 floats), the staged block's A, B and w_out (3 x
    64 floats) and the barriers (two a chunk and two a stage)."""
    box = WGMMA_CHANNELS * TILE * 2
    chunks, stages = c_in // WGMMA_CHANNELS, 4
    return (1024 + chunks * 3 * box + stages * 2 * box + 2 * 3 * WGMMA_CHANNELS * (TILE + 8) * 2
            + (2 * 2 * 3 * TILE + 3 * WGMMA_CHANNELS) * 4 + (2 * chunks + 2 * stages) * 8)


def stats_design(c_in: int, c_out: int) -> str:
    """Which pass kernel S runs at (c_in, c_out): ``"stream"`` (csrc
    channel_walk: each block walks all channels of its 64-point tile, each
    thread forming p at its four points from the one or two input channels;
    no product tile; pd_pass's operations in pd_pass's order, so the narrow
    S's bits) at c_in <= 2, where the product is one or two channels deep
    (final_conv.0's 2 -> 256, conv1's 2 -> 32, the pair folds' 1 -> 256);
    above that ``"wide"`` (pass 1 of the wide S' without its dp store: a
    cp.async ring over a W^T scratch, FP32 FMAs in float32, the tensor
    cores in bf16) where p = W x is matrix work, c_in and c_out >= 16
    (final_conv.1's 256 -> 256, vn_folding{1,2}.1's 256 -> 128), and
    ``"narrow"`` (pd_pass, vn_tile.cuh's FMA loop) between.  Every layer's S
    walks its channels exactly where its S' does (:func:`stats_bwd_design`
    ``"fused"``).  Each is a hand-written kernel; a CUDA launch takes the
    one chosen here or raises."""
    return "stream" if c_in <= FUSED_MAX_CIN else backward_design(c_in, c_out)


def stats_bwd_design(c_in: int, c_out: int) -> str:
    """Which passes kernel S' runs at (c_in, c_out): ``"fused"`` (csrc
    channel_walk, B''s fused pass without g or d: each block walks all
    channels of its 64-point tile, recomputes p, forms dp in registers and
    sums dx, dW and the bias gradients there, with no dp scratch and no
    dx_gemm or dw_gemm) at c_in <= FUSED_MAX_CIN (final_conv.0's 2 -> 256,
    conv1's 2 -> 32, the pair folds' 1 -> 256); :func:`backward_design`
    above."""
    return "fused" if c_in <= FUSED_MAX_CIN else backward_design(c_in, c_out)


def projection_blocks(c_out: int, bf16: bool) -> int:
    """Channel blocks of the wide C, each writing one projection partial
    per (sample, plane, point)."""
    return -(-c_out // (WIDE_BF16_BLOCK if bf16 else WIDE_F32_BLOCK))


def layer_fwd_design(c_in: int) -> str:
    """Which design kernel B runs: ``"stream"`` (no product tile: each
    thread forms p and d of its points from the one or two input channels,
    runs the epilogue and streams the output out in 16- or 8-byte stores;
    the narrow design's operations in its order, so its bits) at c_in <= 2,
    where the output write bounds the layer (final_conv.0's 2 -> 256,
    conv1's 2 -> 32, the pair folds' 1 -> 256); ``"narrow"`` (vn_tile.cuh's
    product tile, 64 channels x 64 points a block) above.  Either is a
    hand-written kernel; a CUDA launch takes the one chosen here or
    raises."""
    return "stream" if c_in <= FUSED_MAX_CIN else "narrow"


def layer_bwd_design(c_in: int) -> str:
    """Which passes kernel B' runs: ``"fused"`` (one pass that recomputes
    p and d, reads g once and sums dx, dW, dWd, dA, dB and the bias
    gradients in registers, with no dp/dd scratch) at c_in <= 2, where each
    product is one or two channels deep (final_conv.0's 2 -> 256, the pair
    folds' 1 -> 256); ``"narrow"`` (pd_pass, dx_gemm, dw_gemm over a dp/dd
    scratch) above."""
    return "fused" if c_in <= FUSED_MAX_CIN else "narrow"


def fused_weight_partials(bsz: int, n: int, c_in: int, c_out: int, grads: int = 2) -> int:
    """Floats of the weight partials of the fused B' (``grads`` 2: dW and
    dWd) or S' (1: dW): one (C_out, C_in) partial per 64-point tile of each
    sample and gradient, which ``vnk_reduce_rows`` sums in order."""
    return grads * bsz * -(-n // TILE) * c_out * c_in


def backward_design(c_in: int, c_out: int) -> str:
    """Which passes kernel C' (and S' above c_in 2, :func:`stats_bwd_design`)
    runs at (c_in, c_out): ``"wide"`` (cp.async rings; in the bf16 mode p,
    C''s d, dx and dW on the tensor cores) where both are matrix work, c_in and
    c_out >= 16; ``"narrow"`` (pd_pass, dx_gemm and dw_gemm on the CUDA
    cores over a dp/dd scratch) below that.  Either is a hand-written
    kernel; a CUDA launch takes the one chosen here or raises."""
    return "wide" if min(c_in, c_out) >= WIDE_MIN_CHANNELS else "narrow"


WGMMA_CHANNELS = 64  # the wgmma passes' stage depth (csrc vn_wgmma.cuh kWgDepth)
WGMMA_TILE = 128  # ... and their output tile's rows and columns (kWgTile)
# Split-K partials that csrc common.cuh's vnk_reduce_rows sums one thread a
# column, in order (its kReduceFewRows, where the rows have kReduceFewCols
# = 4096 columns or more, as every wgmma dW of 64 x 64 or wider has; a
# column of more rows takes its tree over 256 threads: ~24x slower on the
# card at the wide design's 66 splits of S''s 256 x 256 gradient).  The gpu
# test test_wgmma_split_k_takes_the_one_thread_reduction holds the two
# sides together.
REDUCE_FEW_ROWS = 64


def wide_bf16_design(c_in: int, c_out: int, n: int, aligned: bool = True) -> str:
    """Which passes 2 and 3 (dx; dW, dWd) a wide bf16 S' or C' runs:
    ``"wgmma"`` (Hopper's warpgroup products fed by TMA loads into a ring of
    128-byte swizzled stages, csrc vn_wgmma.cuh) where its tiles fit: c_in
    and c_out multiples of 64 and every point row of x, dp and dd 16-byte
    aligned (n % 8 == 0 and ``aligned`` bases), as the tensor maps need
    (final_conv.1's 256 -> 256, vn_folding{1,2}.1's 256 -> 128); else the
    wide design's ``mma.sync`` passes (``"wide"``).  Pass 1 is the wide
    design's (pd_wide_mma) in both; :func:`pass1_bf16_design` moves it to
    wgmma where it fits.  Either is a hand-written kernel; a
    CUDA launch takes the one chosen here or raises."""
    fits = c_in % WGMMA_CHANNELS == 0 and c_out % WGMMA_CHANNELS == 0 and n % 8 == 0
    return "wgmma" if fits and aligned else "wide"


def pass1_bf16_design(kernel: str, c_in: int, c_out: int, n: int, aligned: bool = True,
                      group: int = 0) -> str:
    """The design of a wide bf16 S, S' or C' (``kernel`` "S", "S'" or
    "C'"), by its pass 1, where :func:`wide_bf16_design` gives the wgmma
    passes: ``"wgmma_p"`` (p, and C''s d, on wgmma fed by TMA, csrc
    pd_wgmma; S' and C' then the wgmma passes 2 and 3) for S and S' where a
    bias column covers whole 64-point tiles (group 0 or >= 64), for C'
    where kernel C takes its "wgmma" design (:func:`fwd_bf16_design`: C'
    chooses as C does).  Elsewhere S takes ``"wide"`` (pd_wide_mma), S' and
    C' the design of :func:`wide_bf16_design` (pass 1 pd_wide_mma).  Every
    one sums p and d in the tensor cores' k16 steps in ascending order, as
    kernel C does, so C''s p, d are the forward's and S's p is S''s, bit for
    bit (:func:`summation_order`).  Each is a hand-written kernel; a CUDA
    launch takes the one chosen here or raises."""
    passes = wide_bf16_design(c_in, c_out, n, aligned)
    if passes != "wgmma":
        return "wide"
    if kernel == "C'":
        return "wgmma_p" if fwd_bf16_design(c_in, c_out, n, aligned, group) == "wgmma" else passes
    if group and group < TILE:
        return "wide" if kernel == "S" else passes
    return "wgmma_p"


# How each design forms p = W x (and d = Wd x) before the bias: "in_order",
# fmaf over the input channels in ascending order from 0 (csrc
# vn_tile.cuh's loop, the channel walks, pd_wide_fma, proj_wide_fma), or
# "k16", the tensor cores' steps of 16 input channels in ascending order
# chained through one float32 accumulator from 0 (mma.sync in pd_wide_mma
# and proj_wide_mma, wgmma in pd_wgmma and proj_wgmma; k16_sum).  Both then
# add the bias and, in bf16, round once.  Every float32 design sums in
# order; the bf16 designs of each kernel below.  Kernels whose designs
# share an order form one p, d to the bit: S and S', and C and C', at every
# shape, as JAX's one _compute_pd gives its forward's bits to its backward.
BF16_SUMMATION_ORDER = {
    "C": {"narrow": "in_order", "wide": "k16", "wgmma": "k16"},
    "C'": {"narrow": "in_order", "wide": "k16", "wgmma": "k16", "wgmma_p": "k16"},
    "S": {"stream": "in_order", "narrow": "in_order", "wide": "k16", "wgmma_p": "k16"},
    "S'": {"fused": "in_order", "narrow": "in_order", "wide": "k16", "wgmma": "k16",
           "wgmma_p": "k16"},
}


def summation_order(kernel: str, design: str, bf16: bool) -> str:
    """The order in which ``kernel`` ("C", "C'", "S" or "S'") sums p in
    ``design`` (:data:`BF16_SUMMATION_ORDER`)."""
    return BF16_SUMMATION_ORDER[kernel][design] if bf16 else "in_order"


def project_fwd_design(c_in: int, c_out: int, n: int, bf16: bool, aligned: bool = True,
                       group: int = 0) -> str:
    """The design a launch of kernel C takes: :func:`forward_design`, a wide
    bf16 C then :func:`fwd_bf16_design`'s."""
    design = forward_design(c_in, c_out)
    if design == "wide" and bf16:
        return fwd_bf16_design(c_in, c_out, n, aligned, group)
    return design


def project_bwd_design(c_in: int, c_out: int, n: int, bf16: bool, aligned: bool = True,
                       group: int = 0) -> str:
    """The design a launch of kernel C' takes: :func:`backward_design`, a
    wide bf16 C' then :func:`pass1_bf16_design`'s."""
    design = backward_design(c_in, c_out)
    if design == "wide" and bf16:
        return pass1_bf16_design("C'", c_in, c_out, n, aligned, group)
    return design


def launch_design(kernel: str, c_in: int, c_out: int, n: int, bf16: bool,
                  aligned: bool = True, group: int = 0) -> str:
    """The design a CUDA launch of ``kernel`` ("S", "S'", "C" or "C'") takes
    at these shapes: the chooser its wrapper calls."""
    if kernel == "C":
        return project_fwd_design(c_in, c_out, n, bf16, aligned, group)
    if kernel == "C'":
        return project_bwd_design(c_in, c_out, n, bf16, aligned, group)
    design = (stats_design if kernel == "S" else stats_bwd_design)(c_in, c_out)
    if design == "wide" and bf16:
        return pass1_bf16_design(kernel, c_in, c_out, n, aligned, group)
    return design


def launch_order(kernel: str, x, c_out: int, group: int = 0) -> str:
    """The order (:func:`summation_order`) in which a CUDA launch of
    ``kernel`` on x (B, 3, C_in, N) with C_out output channels sums p:
    what its plain version takes to give the kernel's p, d."""
    bf16 = _bf16(x)
    design = launch_design(kernel, x.shape[2], c_out, x.shape[3], bf16, _aligned(x), group)
    return summation_order(kernel, design, bf16)


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def wide_stage_points(bf16: bool, design: str = "wide") -> int:
    """Points per pass-3 stage of the wide passes (csrc DwF32 / DwBf16) or
    the wgmma ones (DwWg: 64, one 128-byte row of bf16)."""
    if design == "wgmma":
        return WGMMA_CHANNELS
    return 32 if bf16 else 16


def wide_split(c_in: int, c_out: int, bsz: int, n: int, two: bool, bf16: bool,
               sms: int, design: str = "wide"):
    """(splits, chunk) of the wide weight-gradient pass: its reduction runs
    over the B*3 planes' ceil(n / stage) stages of ``wide_stage_points``
    points each, stage t of plane t // ceil(n / stage); split s takes the
    ``chunk`` stages from s * chunk.  Splits enough for two blocks of 128
    (64 for C', ``two``) x 128 output tiles on every SM (the wgmma design:
    one block of 128 x 128, its shared memory a block an SM, and at most
    REDUCE_FEW_ROWS splits), none empty."""
    stages = bsz * 3 * -(-n // wide_stage_points(bf16, design))
    if design == "wgmma":
        tiles = -(-c_out // WGMMA_TILE) * -(-c_in // WGMMA_TILE)
        splits = max(1, min(stages, -(-sms // tiles), REDUCE_FEW_ROWS))
    else:
        tiles = -(-c_out // (64 if two else 128)) * -(-c_in // 128)
        splits = max(1, min(stages, -(-2 * sms // tiles)))
    chunk = -(-stages // splits)
    return -(-stages // chunk), chunk


def _design_args(x, design, c_in, c_out, bsz, n, two):
    """(W^T scratch of the wide passes or None, dw_part's splits, pass 3's
    stages a split (0 for the narrow passes)) for S' (``two`` False) or C'
    in ``design`` ("wide", "narrow" or one of WGMMA_DESIGNS) at these widths."""
    if design == "narrow":
        return None, _split_k(x, c_in, c_out, bsz * 3 * n), 0
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    passes = "wgmma" if design in WGMMA_DESIGNS else design
    s, chunk = wide_split(c_in, c_out, bsz, n, two, _bf16(x), sms, passes)
    wt = _empty(x, 2 if two else 1, c_in, c_out, dtype=x.dtype)  # W^T (and Wd^T)
    return wt, s, chunk


def _bias_rows(n: int, group: int):
    """(bias partials per tile, bias gradient columns the kernels write):
    a group of at least a tile (or group 0) sums whole tiles; a smaller one
    splits each tile into TILE // group columns (the last tile's spare ones
    are cut off by the caller)."""
    tiles = -(-n // TILE)
    if group == 0:
        return 1, 1
    if group >= TILE:
        return 1, n // group
    return TILE // group, tiles * (TILE // group)


def _bf16(x) -> bool:
    """Whether a launch takes its kernel's bf16 mode: x is bf16."""
    return x.dtype == torch.bfloat16


def _counted(kernel: CudaKernel, group: int, bf16: bool) -> CudaKernel:
    if bf16:
        return _BF16[(kernel.symbol, bool(group))]
    return _GROUPED[kernel.symbol] if group else kernel


def _launch(kernel: CudaKernel, x, w, wd, pbias, dbias, a, b, w_out,
            negative_slope: float, group: int, pd_out=None):
    """Kernel B or C, in the mode of x's dtype (float32 or bf16); B in the
    design of :func:`layer_fwd_design`, C in that of
    :func:`project_fwd_design`; ``pd_out``: :func:`project_fwd`'s."""
    (x, w, wd, pbias, dbias, a, b, w_out, _), (bsz, c_in, c_out, n) = _prepare(
        kernel.symbol, x, w, wd, pbias, dbias, a, b, w_out, group=group)
    out = _empty(x, bsz, 3, c_out if w_out is None else 1, n, dtype=x.dtype)
    ptrs = [_ptr(t) for t in (x, w, wd, pbias, dbias, a, b)]
    launch = _counted(kernel, group, _bf16(x))
    if w_out is None:
        design = layer_fwd_design(c_in)
        launch(x, *ptrs, out.data_ptr(), bsz, c_in, c_out, n, group, int(design == "stream"),
               1 - negative_slope, variant=design)
        return out
    design = launch_design("C", c_in, c_out, n, _bf16(x), _aligned(x), group)
    wt = part = None
    ctas = 0
    if design != "narrow":  # W^T and Wd^T
        wt = _empty(x, 2, c_in, c_out, dtype=x.dtype)
    if design == "wide":  # the channel blocks' projections
        part = _empty(x, projection_blocks(c_out, _bf16(x)), bsz, 3, n)
    elif design == "wgmma":
        ctas = proj_wgmma_grid(bsz, n, torch.cuda.get_device_properties(x.device)
                               .multi_processor_count)
    launch(x, *ptrs, w_out.data_ptr(), out.data_ptr(), _ptr(wt), _ptr(part),
           _pd_out(pd_out, x, c_out), bsz, c_in, c_out, n, group, DESIGN_CODES[design], ctas,
           1 - negative_slope, variant=design)
    return out


def project_fwd(x, w, wd, pbias, dbias, a, b, w_out, negative_slope: float, group: int = 0,
                pd_out=None):
    """Kernel C on a CUDA tensor, its plain version on a CPU tensor.
    ``pd_out`` (the card only; no path passes it): a tensor (2, B, 3,
    C_out, N) of x's dtype that every design of C fills with the p and d
    its epilogue reads (p first), so that a test can hold C''s recomputed
    planes to the forward's."""
    if not x.is_cuda:
        return reference_layer_fused_project(x, w, wd, pbias, dbias, a, b, w_out,
                                             negative_slope, group)
    return _launch(_PROJECT, x, w, wd, pbias, dbias, a, b, w_out, negative_slope, group,
                   pd_out)


def _planes_out(name, out, x, c_out, lead=(), dtype=torch.bfloat16):
    """The pointer of an optional test output of planes: None, or a
    contiguous ``dtype`` tensor ``lead`` + (B, 3, C_out, N) on x's card (S's
    and S''s ``p_out``: bf16 p; C's and C''s ``pd_out``: (2,) p and d of x's
    dtype)."""
    shape = tuple(lead) + (x.shape[0], 3, c_out, x.shape[3])
    if out is not None and (out.dtype != dtype or out.device != x.device or
                            out.shape != shape or not out.is_contiguous()):
        raise ValueError(f"{name}: a contiguous {dtype} {shape} tensor on the card of x")
    return _ptr(out)


def _p_out(p_out, x, c_out):
    return _planes_out("p_out", p_out, x, c_out)


def _pd_out(pd_out, x, c_out):
    return _planes_out("pd_out", pd_out, x, c_out, (2,), x.dtype)


def stats_fwd(x, w, pbias, group: int = 0, p_out=None):
    """Kernel S on a CUDA tensor, its plain version on a CPU tensor.
    ``p_out`` (the card only; no path passes it): a tensor that the wgmma
    pass 1 (design "wgmma_p") fills with p, bf16, so that a test can hold
    S's p to S''s; the other designs leave it."""
    if not x.is_cuda:
        return reference_stats(x, w, pbias, group)
    (x, w, _, pbias, *_), (bsz, c_in, c_out, n) = _prepare(
        "vn_layer_stats", x, w, pbias=pbias, group=group)
    design = launch_design("S", c_in, c_out, n, _bf16(x), _aligned(x), group)
    s12 = _empty(x, 2, c_out)
    partial = _empty(x, 2, bsz, -(-n // TILE), c_out)
    wt = None if design in ("narrow", "stream") else _empty(x, c_in, c_out, dtype=x.dtype)  # W^T
    _counted(_STATS, group, _bf16(x))(x, x.data_ptr(), w.data_ptr(), _ptr(pbias),
                                      s12.data_ptr(), partial.data_ptr(), _ptr(wt),
                                      _p_out(p_out, x, c_out), bsz, c_in, c_out, n, group,
                                      DESIGN_CODES[design], variant=design)
    return s12[0], s12[1]


def _bias_grads(out, nq: int, bsz: int, c_out: int, n: int, group: int, dtype):
    """The kernels' float32 (nq, B, G', C_out) bias sums -> nq tensors (B,
    3, C_out, cols) of ``dtype`` (nq = 3: one bias; 6: two), the first cols
    = N // group columns."""
    cols = n // group if group else 1
    out = out.reshape(nq // 3, 3, bsz, -1, c_out)[:, :, :, :cols]
    return out.permute(0, 2, 1, 4, 3).to(dtype).unbind(0)


def stats_bwd(x, w, pbias, c1, c2, group: int = 0, p_out=None):
    """Kernel S' on a CUDA tensor, its plain version on a CPU tensor:
    (dx, dw, dpbias).  ``p_out``: as :func:`stats_fwd`'s."""
    if not x.is_cuda:
        return reference_stats_bwd(x, w, pbias, c1, c2, group)
    (x, w, _, pbias, _, c1, c2, *_), (bsz, c_in, c_out, n) = _prepare(
        "vn_layer_stats backward", x, w, pbias=pbias, a=c1, b=c2, group=group)
    design = launch_design("S'", c_in, c_out, n, _bf16(x), _aligned(x), group)
    spt, cols = _bias_rows(n, group)
    dx, dw = torch.empty_like(x), _empty(x, c_out, c_in)
    dpb = None if pbias is None else _empty(x, 3, bsz, cols, c_out)
    partial = None if pbias is None else _empty(x, 3, bsz, -(-n // TILE) * spt, c_out)
    if design == "fused":  # no dp; the weight partials (B, T, C_out, C_in)
        wt, s, chunk, dp = None, 0, 0, None
        dw_part = _empty(x, fused_weight_partials(bsz, n, c_in, c_out, grads=1))
    else:
        wt, s, chunk = _design_args(x, design, c_in, c_out, bsz, n, two=False)
        dp = _empty(x, bsz, 3, c_out, n, dtype=x.dtype)  # scratch: bf16 in the bf16 mode
        dw_part = _empty(x, s, c_out, c_in)
    _counted(_STATS_BWD, group, _bf16(x))(
        x, *[_ptr(t) for t in (x, w, pbias, c1, c2, dx, dw, dpb, dp, partial, dw_part, wt)],
        _p_out(p_out, x, c_out), bsz, c_in, c_out, n, s, chunk, group, DESIGN_CODES[design],
        variant=design)
    if dpb is not None:
        (dpb,) = _bias_grads(dpb, 3, bsz, c_out, n, group, pbias.dtype)
    return dx, dw, dpb


def _layer_bwd_launch(kernel, x, w, wd, pbias, dbias, a, b, w_out, g,
                      negative_slope, group, pd_out=None):
    """Kernels B' and C': (dx, dw, dwd, dpbias, ddbias, da, db[, dwo]);
    ``pd_out`` (C'): None, or a (2, B, 3, C_out, N) tensor of x's dtype
    that pass 1 fills with the p and d its epilogue backward reads."""
    (x, w, wd, pbias, dbias, a, b, w_out, g), (bsz, c_in, c_out, n) = _prepare(
        kernel.symbol, x, w, wd, pbias, dbias, a, b, w_out, g, group)
    project = w_out is not None
    if project:  # C' chooses its passes (wide, wgmma, wgmma_p or narrow), B' fused or narrow
        design = launch_design("C'", c_in, c_out, n, _bf16(x), _aligned(x), group)
        wt, s, chunk = _design_args(x, design, c_in, c_out, bsz, n, two=True)
    else:
        design = layer_bwd_design(c_in)
        s = 0 if design == "fused" else _split_k(x, c_in, c_out, bsz * 3 * n)
    nqc = 3 if project else 2
    tiles = -(-n // TILE)
    spt, cols = _bias_rows(n, group)
    dx, dw2, sums = torch.empty_like(x), _empty(x, 2, c_out, c_in), _empty(x, nqc, c_out)
    dpdb = None if pbias is None else _empty(x, 6, bsz, cols, c_out)
    # the per-channel sums (nqc, B, T, C_out), then the bias sums (6, B, T * spt, C_out)
    partial = _empty(x, (nqc + (0 if pbias is None else 6 * spt)) * bsz * tiles * c_out)
    if design == "fused":  # no dp, dd; the weight partials (2, B, T, C_out, C_in)
        dp = dd = None
        dw_part = _empty(x, fused_weight_partials(bsz, n, c_in, c_out))
    else:  # the dp, dd scratch: bf16 in the bf16 mode (JAX's dp16, dd16)
        dp, dd = (_empty(x, bsz, 3, c_out, n, dtype=x.dtype) for _ in range(2))
        dw_part = _empty(x, 2, s, c_out, c_in)
    ptrs = [_ptr(t) for t in (x, w, wd, pbias, dbias, a, b)]
    if project:
        ptrs.append(w_out.data_ptr())
    ptrs += [_ptr(t) for t in (g, dx, dw2, sums, dpdb, dp, dd, partial, dw_part)]
    if project:
        _counted(kernel, group, _bf16(x))(
            x, *ptrs, _ptr(wt), _pd_out(pd_out, x, c_out), bsz, c_in, c_out, n, s, chunk, group,
            DESIGN_CODES[design], 1 - negative_slope, variant=design)
    else:
        _counted(kernel, group, _bf16(x))(x, *ptrs, bsz, c_in, c_out, n, s, group,
                                          DESIGN_CODES[design], 1 - negative_slope,
                                          variant=design)
    dpb = ddb = None
    if dpdb is not None:
        dpb, ddb = _bias_grads(dpdb, 6, bsz, c_out, n, group, pbias.dtype)
    return (dx, dw2[0], dw2[1], dpb, ddb, *sums.unbind(0))


def layer_bwd(x, w, wd, pbias, dbias, a, b, g, negative_slope: float, group: int = 0):
    """Kernel B' on a CUDA tensor, its plain version on a CPU tensor."""
    if not x.is_cuda:
        return reference_layer_bwd(x, w, wd, pbias, dbias, a, b, g, negative_slope, group)
    return _layer_bwd_launch(_LAYER_BWD, x, w, wd, pbias, dbias, a, b, None, g,
                             negative_slope, group)


def layer_project_bwd(x, w, wd, pbias, dbias, a, b, w_out, g,
                      negative_slope: float, group: int = 0, pd_out=None):
    """Kernel C' on a CUDA tensor, its plain version on a CPU tensor.
    ``pd_out``: see :func:`_layer_bwd_launch` (the card only; no path
    passes it)."""
    if not x.is_cuda:
        return reference_layer_project_bwd(
            x, w, wd, pbias, dbias, a, b, w_out, g, negative_slope, group)
    return _layer_bwd_launch(_PROJECT_BWD, x, w, wd, pbias, dbias, a, b, w_out,
                             g, negative_slope, group, pd_out)


# ------------------------------------------------------------- autograd


class _LayerStats(torch.autograd.Function):
    """Kernel S forward, S' backward; saves only (x, w, pbias)."""

    @staticmethod
    def forward(ctx, x, w, pbias, group):
        ctx.save_for_backward(x, w, pbias)
        ctx.group = group
        return stats_fwd(x, w, pbias, group)

    @staticmethod
    def backward(ctx, c1, c2):
        x, w, pbias = ctx.saved_tensors
        c_out = w.shape[0]
        c1 = torch.zeros(c_out, device=x.device, dtype=w.dtype) if c1 is None else c1
        c2 = torch.zeros(c_out, device=x.device, dtype=w.dtype) if c2 is None else c2
        return (*stats_bwd(x, w, pbias, c1, c2, ctx.group), None)


class _LayerFused(torch.autograd.Function):
    """Kernel B forward, B' backward; saves only the inputs."""

    @staticmethod
    def forward(ctx, x, w, wd, pbias, dbias, a, b, negative_slope, group):
        ctx.save_for_backward(x, w, wd, pbias, dbias, a, b)
        ctx.negative_slope, ctx.group = negative_slope, group
        if not x.is_cuda:
            return reference_layer_fused(x, w, wd, pbias, dbias, a, b, negative_slope, group)
        return _launch(_LAYER, x, w, wd, pbias, dbias, a, b, None, negative_slope, group)

    @staticmethod
    def backward(ctx, g):
        return (*layer_bwd(*ctx.saved_tensors, g, ctx.negative_slope, ctx.group),
                None, None)


class _LayerFusedProject(torch.autograd.Function):
    """Kernel C forward, C' backward; saves only the inputs."""

    @staticmethod
    def forward(ctx, x, w, wd, pbias, dbias, a, b, w_out, negative_slope, group):
        ctx.save_for_backward(x, w, wd, pbias, dbias, a, b, w_out)
        ctx.negative_slope, ctx.group = negative_slope, group
        return project_fwd(x, w, wd, pbias, dbias, a, b, w_out, negative_slope, group)

    @staticmethod
    def backward(ctx, g):
        return (*layer_project_bwd(*ctx.saved_tensors, g, ctx.negative_slope, ctx.group),
                None, None)


def vn_layer_stats(x, w, pbias: Optional[torch.Tensor] = None, group: int = 0):
    """x: (B, 3, C_in, N); w: (C_out, C_in); pbias: (B, 3, C_out, 1), or
    (B, 3, C_out, N // group) with ``group``, or None.
    Returns (s1, s2): (C_out,) sums over samples and points of ``|p| + EPS``
    and ``(|p| + EPS)^2``; the BN moments are ``s1 / (B N)``, ``s2 / (B N)``."""
    return _LayerStats.apply(x, w, pbias, group)


def vn_layer_fused(x, w, wd, pbias: Optional[torch.Tensor],
                   dbias: Optional[torch.Tensor], a, b, negative_slope: float,
                   group: int = 0):
    """x: (B, 3, C_in, N); w, wd: (C_out, C_in); pbias, dbias: per-sample
    (B, 3, C_out, 1), per-group (B, 3, C_out, N // group) with ``group``, or
    both None; a, b: (C_out,) folded BN affine.  Returns (B, 3, C_out, N)."""
    return _LayerFused.apply(x, w, wd, pbias, dbias, a, b, negative_slope, group)


def vn_layer_fused_project(x, w, wd, pbias: Optional[torch.Tensor],
                           dbias: Optional[torch.Tensor], a, b, w_out,
                           negative_slope: float, group: int = 0):
    """The layer of :func:`vn_layer_fused` contracted with ``w_out``
    (C_out,) over its output channels.  Returns (B, 3, 1, N)."""
    return _LayerFusedProject.apply(x, w, wd, pbias, dbias, a, b, w_out,
                                    negative_slope, group)
