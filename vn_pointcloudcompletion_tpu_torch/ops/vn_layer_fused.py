"""A whole VNLinearLeakyReLU layer in one pass (forward, no group bias).

Port of ``vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py``:

- :func:`vn_layer_fused` (kernel B): ``bn_leaky(W x + pbias, Wd x + dbias)``
  on (B, 3, C_in, N) planes, the decoder's first fold layer;
- :func:`vn_layer_fused_project` (kernel C): the same layer followed by the
  contraction with a 1-channel ``w_out``, so the (B, 3, C_out, N) activation
  never exists; the decoder's ``final_conv.1`` + ``final_conv.2``.

The matrix products run inside the kernels (``csrc/vn_layer_fused.cu``).  A
CPU tensor takes the plain versions :func:`reference_layer_fused` and
:func:`reference_layer_fused_project`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vn_pointcloudcompletion_tpu_torch.ops.cuda_lib import (
    CudaKernel,
    check_cuda_f32,
)
from vn_pointcloudcompletion_tpu_torch.ops.vn_fused import reference_bn_leaky_planes

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


def layer_eligible(x: torch.Tensor, c_out: int,
                   share_nonlinearity: bool = False) -> bool:
    """Shapes where the JAX package takes its whole-layer Pallas kernel
    (vn_layer_fused.py:45): small channel counts, many points."""
    if share_nonlinearity or x.ndim != 4 or x.shape[1] != 3:
        return False
    c_in, n = x.shape[2], x.shape[3]
    aligned = c_out % 128 == 0 or c_out <= 128
    return aligned and c_in <= 512 and c_out <= 512 and n >= 4096


def reference_layer_fused(x, w, wd, pbias, dbias, a, b, negative_slope: float):
    """Plain version of kernel B: separate products, then the epilogue."""
    p = torch.matmul(w, x)
    d = torch.matmul(wd, x)
    if pbias is not None:
        p = p + pbias
        d = d + dbias
    return reference_bn_leaky_planes(p, d, a, b, negative_slope)


def reference_layer_fused_project(x, w, wd, pbias, dbias, a, b, w_out,
                                  negative_slope: float):
    """Plain version of kernel C: the layer, then the 1-channel VNLinear."""
    out = reference_layer_fused(x, w, wd, pbias, dbias, a, b, negative_slope)
    return torch.matmul(w_out.reshape(1, -1), out)


def _launch(kernel: CudaKernel, x, w, wd, pbias, dbias, a, b, w_out,
            negative_slope: float):
    bsz, three, c_in, n = x.shape
    c_out = w.shape[0]
    name = kernel.symbol
    if three != 3 or w.shape != (c_out, c_in) or wd.shape != (c_out, c_in):
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)} w {tuple(w.shape)} wd {tuple(wd.shape)}")
    if a.shape != (c_out,) or b.shape != (c_out,):
        raise ValueError(f"{name}: a, b must be ({c_out},)")
    if w_out is not None and w_out.shape != (c_out,):
        raise ValueError(f"{name}: w_out must be ({c_out},)")
    if (pbias is None) != (dbias is None):
        raise ValueError(f"{name}: pass both biases or neither")
    if pbias is not None and (pbias.shape != (bsz, 3, c_out, 1) or dbias.shape != pbias.shape):
        raise ValueError(f"{name}: biases must be ({bsz}, 3, {c_out}, 1)")
    args = [x, w, wd, pbias, dbias, a, b] + ([w_out] if w_out is not None else [])
    args = [None if t is None else t.contiguous() for t in args]
    check_cuda_f32(name, *[t for t in args if t is not None])
    out = torch.empty((bsz, 3, c_out if w_out is None else 1, n),
                      device=x.device, dtype=torch.float32)
    kernel(x, *[None if t is None else t.data_ptr() for t in args],
           out.data_ptr(), bsz, c_in, c_out, n, 1 - negative_slope)
    return out


def vn_layer_fused(x, w, wd, pbias: Optional[torch.Tensor],
                   dbias: Optional[torch.Tensor], a, b, negative_slope: float):
    """x: (B, 3, C_in, N); w, wd: (C_out, C_in); pbias, dbias: per-sample
    (B, 3, C_out, 1) or both None; a, b: (C_out,) folded BN affine.
    Returns (B, 3, C_out, N)."""
    if not x.is_cuda:
        return reference_layer_fused(x, w, wd, pbias, dbias, a, b, negative_slope)
    return _launch(_LAYER, x, w, wd, pbias, dbias, a, b, None, negative_slope)


def vn_layer_fused_project(x, w, wd, pbias: Optional[torch.Tensor],
                           dbias: Optional[torch.Tensor], a, b, w_out,
                           negative_slope: float):
    """The layer of :func:`vn_layer_fused` contracted with ``w_out``
    (C_out,) over its output channels.  Returns (B, 3, 1, N)."""
    if not x.is_cuda:
        return reference_layer_fused_project(
            x, w, wd, pbias, dbias, a, b, w_out, negative_slope)
    return _launch(_PROJECT, x, w, wd, pbias, dbias, a, b, w_out, negative_slope)
