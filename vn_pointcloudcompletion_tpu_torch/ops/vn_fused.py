"""Folded norm-BatchNorm + VN leaky reflection on plane-layout features.

Port of ``vn_pointcloudcompletion_tpu/ops/vn_fused.py``, forward and
backward.  Tensors are coordinate planes (B, 3, C, N).  BatchNorm on the
vector norms is folded to a per-channel affine ``norm_bn = A * (|p| + EPS) +
B`` computed outside; per vector (p, d):

    norm_e = |p| + EPS;  s = A + B / norm_e;  q = p * s
    dot = <q, d>;  z = <d, d> + EPS
    out = q - (1 - ns) * [dot < 0] * (dot / z) * d

and, for the cotangent g of ``out`` (the JAX module's docstring, l.26-31):

    c1 = (1-ns) [dot < 0];  dq = g - (c1 / z) <d, g> d
    dd = -c1 (r g + (<d, g>/z) q - (2 r <d, g>/z) d),  r = dot / z
    dp = s dq - (B / norm_e^2) (<dq, p>/|p|) p   (0 where |p| = 0)
    dA = sum <dq, p>;  dB = sum <dq, p> / norm_e

:func:`fused_bn_leaky` is a ``torch.autograd.Function``: on a CUDA tensor its
forward is kernel A and its backward kernel A' (``csrc/vn_fused.cu``); on a
CPU tensor they are the plain versions :func:`reference_bn_leaky_planes` and
:func:`reference_bn_leaky_bwd`.  Both kernels have a bf16 mode for bf16
planes (the bfloat16 compute policy), counted under ``<symbol>[bf16]``:
read bf16, compute in float32, store bf16 (A': dp and dd; its dA, dB sums
are float32, summed from the float32 values).  A's bf16 mode runs one of
two designs, chosen in :func:`fwd_design` and counted by name
(``cuda_lib.variant_counts``): ``run8`` (a thread owns 8 consecutive points
of a row: 16-byte loads and stores) or ``vector`` (one thread a vector,
the parent design); the float32 mode has the vector design only.
"""

from __future__ import annotations

import ctypes

import torch

from vn_pointcloudcompletion_tpu_torch.ops.cuda_lib import CudaKernel, check_cuda

EPS = 1e-6  # models/vn_layers.py:10 of the reference

_P = ctypes.c_void_p
_KERNEL = CudaKernel(
    "vn_fused.cu", "vn_bn_leaky_fwd",
    [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, _P],
)
_KERNEL_BF16 = CudaKernel(
    "vn_fused.cu", "vn_bn_leaky_fwd_bf16", _KERNEL.argtypes[:-1] + [ctypes.c_int, _P],
    "vn_bn_leaky_fwd[bf16]")
FWD_DESIGNS = ("vector", "run8")  # csrc/vn_fused.cu FwdDesign, in its order
TAKES = "p, d float32 or (its bf16 mode) bf16, and float32 a, b"
_BWD = CudaKernel(
    "vn_fused.cu", "vn_bn_leaky_bwd",
    [_P] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float, _P],
)
_BWD_BF16 = CudaKernel("vn_fused.cu", "vn_bn_leaky_bwd_bf16", _BWD.argtypes,
                       "vn_bn_leaky_bwd[bf16]")
BWD_TAKES = "p, d and g float32 or (its bf16 mode) bf16, and float32 a, b"
BWD_TILE = 1024  # points per block of kernel A' (kBwdPts in csrc/vn_fused.cu)


def _channel_tile(c: int) -> int:
    """The TPU kernel's channel tile; 0 where it does not take the shape."""
    if c % 128 == 0:
        return 128
    if c <= 128 and c % 16 == 0:
        return c
    return 0


def fwd_design(n: int, aligned: bool = True) -> str:
    """Which design kernel A's bf16 mode runs at N points: ``"run8"`` with
    N a multiple of 8 and planes that start 16-byte aligned (``aligned``:
    p and d do; the output is allocated so), each thread 8 consecutive
    points of one (sample, channel) row by 16-byte loads and stores;
    ``"vector"`` (one thread a vector: the parent design) otherwise.  Both
    give the same bits; a CUDA launch takes the one chosen here or raises.
    The float32 mode has the vector design only."""
    return "run8" if n % 8 == 0 and aligned else "vector"


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


def reference_bn_leaky_planes(p, d, a, b, negative_slope: float,
                              out_dtype=None):
    """Plain PyTorch version of kernel A on (B, 3, C, N) planes.

    Written in the kernel's operation order, so that the two agree to the bit
    on the card; float64 inputs stay float64.  bf16 planes (the bf16 mode)
    are computed in float32 and the output rounded once to bf16, unless
    ``out_dtype`` asks for another (kernel C's unrounded epilogue).
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
    return (q - coef * d32).to(out_dtype or p.dtype)


def reference_bn_leaky_bwd(p, d, a, b, g, negative_slope: float):
    """Plain version of kernel A': (dp, dd, dA, dB) for the cotangent g.

    Written from the formulas above in the kernel's operation order (one
    rounding per operation), so dp and dd agree with the kernel to the bit
    on the card; float64 inputs stay float64, bf16 ones (the bf16 mode)
    are computed in float32 with dp and dd rounded once to bf16 and dA, dB
    float32.  The zero-norm guard is that of :func:`safe_sqrt`: the
    ``p / |p|`` factor is 0 at |p| = 0.
    """
    ct = torch.promote_types(p.dtype, torch.float32)
    p0, p1, p2 = p.to(ct).unbind(1)
    d0, d1, d2 = d.to(ct).unbind(1)
    g0, g1, g2 = g.to(ct).unbind(1)
    a = a.to(ct)[None, :, None]
    b = b.to(ct)[None, :, None]
    pnorm = safe_sqrt(p0 * p0 + p1 * p1 + p2 * p2)
    norm_e = pnorm + EPS
    s = a + b / norm_e
    q0, q1, q2 = p0 * s, p1 * s, p2 * s
    dot = q0 * d0 + q1 * d1 + q2 * d2
    z = d0 * d0 + d1 * d1 + d2 * d2 + EPS
    r = dot / z
    c1 = torch.where(dot >= 0, 0.0, 1.0 - negative_slope).to(ct)
    dg = d0 * g0 + d1 * g1 + d2 * g2
    k1 = c1 * dg / z
    dq0, dq1, dq2 = g0 - k1 * d0, g1 - k1 * d1, g2 - k1 * d2
    k2 = c1 * r
    k3 = 2.0 * k1 * r
    dd = torch.stack([-(k2 * g0 + k1 * q0 - k3 * d0),
                      -(k2 * g1 + k1 * q1 - k3 * d1),
                      -(k2 * g2 + k1 * q2 - k3 * d2)], 1)
    dqp = dq0 * p0 + dq1 * p1 + dq2 * p2
    inv_pnorm = torch.where(pnorm > 0, 1.0 / torch.clamp_min(pnorm, 1e-30), 0.0)
    coef_p = b * dqp * inv_pnorm / (norm_e * norm_e)
    dp = torch.stack([s * dq0 - coef_p * p0, s * dq1 - coef_p * p1,
                      s * dq2 - coef_p * p2], 1)
    da = dqp.sum((0, 2))
    db = (dqp / norm_e).sum((0, 2))
    return dp.to(p.dtype), dd.to(d.dtype), da, db


def _check_shapes(name, p, d, a, b):
    bsz, three, c, n = p.shape
    if three != 3 or d.shape != p.shape or a.shape != (c,) or b.shape != (c,):
        raise ValueError(f"{name}: bad shapes {p.shape} {d.shape} {a.shape} {b.shape}")


def bn_leaky_fwd(p, d, a, b, negative_slope: float):
    """Kernel A on a CUDA tensor, its plain version on a CPU tensor."""
    if not p.is_cuda:
        return reference_bn_leaky_planes(p, d, a, b, negative_slope)
    _check_shapes("fused_bn_leaky", p, d, a, b)
    bsz, _, c, n = p.shape
    p, d, a, b = (t.contiguous() for t in (p, d, a, b))
    dt = torch.bfloat16 if p.dtype == torch.bfloat16 else torch.float32
    check_cuda("fused_bn_leaky", TAKES, (p, dt), (d, dt), (a, torch.float32),
               (b, torch.float32))
    out = torch.empty_like(p)
    args = (p.data_ptr(), d.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, c, n,
            1 - negative_slope)
    if dt == torch.bfloat16:
        design = fwd_design(n, p.data_ptr() % 16 == 0 and d.data_ptr() % 16 == 0)
        _KERNEL_BF16(p, *args, FWD_DESIGNS.index(design), variant=design)
    else:
        _KERNEL(p, *args)
    return out


def bn_leaky_bwd(p, d, a, b, g, negative_slope: float):
    """Kernel A' on a CUDA tensor, its plain version on a CPU tensor:
    (dp, dd, dA, dB)."""
    if not p.is_cuda:
        return reference_bn_leaky_bwd(p, d, a, b, g, negative_slope)
    _check_shapes("fused_bn_leaky backward", p, d, a, b)
    if g.shape != p.shape:
        raise ValueError(f"fused_bn_leaky backward: cotangent {g.shape} != {p.shape}")
    bsz, _, c, n = p.shape
    p, d, a, b, g = (t.contiguous() for t in (p, d, a, b, g))
    dt = torch.bfloat16 if p.dtype == torch.bfloat16 else torch.float32
    check_cuda("fused_bn_leaky backward", BWD_TAKES, (p, dt), (d, dt), (g, dt),
               (a, torch.float32), (b, torch.float32))
    dp, dd = torch.empty_like(p), torch.empty_like(p)
    dadb = torch.empty((2, c), device=p.device, dtype=torch.float32)
    tiles = -(-n // BWD_TILE)
    partial = torch.empty((2, bsz, tiles, c), device=p.device, dtype=torch.float32)
    (_BWD_BF16 if dt == torch.bfloat16 else _BWD)(
        p, p.data_ptr(), d.data_ptr(), a.data_ptr(), b.data_ptr(), g.data_ptr(),
        dp.data_ptr(), dd.data_ptr(), dadb.data_ptr(), partial.data_ptr(), bsz, c, n,
        1 - negative_slope)
    return dp, dd, dadb[0], dadb[1]


class _FusedBnLeaky(torch.autograd.Function):
    """Kernel A forward, kernel A' backward; saves only (p, d, a, b)."""

    @staticmethod
    def forward(ctx, p, d, a, b, negative_slope):
        ctx.save_for_backward(p, d, a, b)
        ctx.negative_slope = negative_slope
        return bn_leaky_fwd(p, d, a, b, negative_slope)

    @staticmethod
    def backward(ctx, g):
        p, d, a, b = ctx.saved_tensors
        dp, dd, da, db = bn_leaky_bwd(p, d, a, b, g, ctx.negative_slope)
        return dp, dd, da.to(a.dtype), db.to(b.dtype), None


def fused_bn_leaky(p, d, a, b, negative_slope: float):
    """p, d: (B, 3, C, N) planes; a, b: (C,) float32 -> out (B, 3, C, N)
    in p's dtype, with the gradient of kernel A'.  bf16 planes take the
    kernels' bf16 modes (counted under ``vn_bn_leaky_fwd[bf16]`` and
    ``vn_bn_leaky_bwd[bf16]``)."""
    return _FusedBnLeaky.apply(p, d, a, b, negative_slope)
