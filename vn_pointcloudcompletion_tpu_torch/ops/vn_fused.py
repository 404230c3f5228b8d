"""Folded norm-BatchNorm + VN leaky reflection on plane-layout features.

Port of ``vn_pointcloudcompletion_tpu/ops/vn_fused.py`` (forward only).
Tensors are coordinate planes (B, 3, C, N).  BatchNorm on the vector norms is
folded to a per-channel affine ``norm_bn = A * (|p| + EPS) + B`` computed
outside; per vector (p, d):

    norm_e = |p| + EPS;  s = A + B / norm_e;  q = p * s
    dot = <q, d>;  z = <d, d> + EPS
    out = q - (1 - ns) * [dot < 0] * (dot / z) * d

:func:`fused_bn_leaky` runs kernel A (``csrc/vn_fused.cu``) on a CUDA tensor
and its plain version :func:`reference_bn_leaky_planes` on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from vn_pointcloudcompletion_tpu_torch.ops.cuda_lib import (
    CudaKernel,
    check_cuda_f32,
)

EPS = 1e-6  # models/vn_layers.py:10 of the reference

_P = ctypes.c_void_p
_KERNEL = CudaKernel(
    "vn_fused.cu", "vn_bn_leaky_fwd",
    [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, _P],
)


def _channel_tile(c: int) -> int:
    """The TPU kernel's channel tile; 0 where it does not take the shape."""
    if c % 128 == 0:
        return 128
    if c <= 128 and c % 16 == 0:
        return c
    return 0


def eligible(p: torch.Tensor) -> bool:
    """Shapes where the JAX package takes its Pallas kernel (vn_fused.py:151)."""
    return (
        p.ndim == 4 and p.shape[1] == 3
        and _channel_tile(p.shape[2]) > 0 and p.shape[3] >= 512
    )


def safe_sqrt(sq: torch.Tensor) -> torch.Tensor:
    """sqrt whose gradient is 0, not NaN, at 0 (``nn/vn.py::safe_norm``)."""
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)


def plane_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """<u, v> over the plane axis of (B, 3, ...), summed in plane order."""
    return u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1] + u[:, 2] * v[:, 2]


def reference_bn_leaky_planes(p, d, a, b, negative_slope: float):
    """Plain PyTorch version of kernel A on (B, 3, C, N) planes.

    Written in the kernel's operation order, so that the two agree to the bit
    on the card; float64 inputs stay float64.
    """
    ct = torch.promote_types(p.dtype, torch.float32)
    p32, d32 = p.to(ct), d.to(ct)
    a = a.to(ct)[None, :, None]
    b = b.to(ct)[None, :, None]
    norm_e = safe_sqrt(plane_dot(p32, p32)) + EPS  # (B, C, N)
    s = (a + b / norm_e)[:, None]
    q = p32 * s
    dot = plane_dot(q, d32)[:, None]
    z = plane_dot(d32, d32)[:, None] + EPS
    coef = torch.where(dot >= 0, 0.0, (1 - negative_slope) * dot / z)
    return (q - coef * d32).to(p.dtype)


def fused_bn_leaky(p, d, a, b, negative_slope: float):
    """p, d: (B, 3, C, N) planes; a, b: (C,) -> out (B, 3, C, N).

    A CUDA tensor launches kernel A (float32 only); a CPU tensor takes the
    plain version.
    """
    if not p.is_cuda:
        return reference_bn_leaky_planes(p, d, a, b, negative_slope)
    bsz, three, c, n = p.shape
    if three != 3 or d.shape != p.shape or a.shape != (c,) or b.shape != (c,):
        raise ValueError(f"fused_bn_leaky: bad shapes {p.shape} {d.shape} {a.shape} {b.shape}")
    p, d = p.contiguous(), d.contiguous()
    a, b = a.contiguous(), b.contiguous()
    check_cuda_f32("fused_bn_leaky", p, d, a, b)
    out = torch.empty_like(p)
    _KERNEL(p, p.data_ptr(), d.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), bsz, c, n, 1 - negative_slope)
    return out
