"""Greedy furthest-point sampling: kernel F.

Port of ``vn_pointcloudcompletion_tpu/ops/fps_pallas.py``.  From xyz
(B, N, 3) it picks S indices per sample: index 0 first, then each time the
first point of largest running minimum of the squared distance to the
points picked so far, in the difference form ``d0*d0 + d1*d1 + d2*d2``.

:func:`furthest_point_sample_kernel` launches ``csrc/fps.cu`` on a CUDA
tensor and takes the plain version :func:`reference_furthest_point_sample`
on a CPU tensor.  The plain version does the kernel's operations in the
kernel's order (float64 inputs stay float64), so on the card the two pick
the same indices.  bfloat16 coordinates (the bfloat16 compute policy) are
upcast exactly to float32 first, as the JAX kernel casts its input.  The output is integer: FPS has no gradient.
The kernel reads xyz at its own strides (``fps_downsample`` hands it the
transposed view of (B, 3, N) coordinates), so no copy precedes the launch;
its one design counts under ``furthest_point_sample/single_barrier``
(``cuda_lib.variant_counts``).
"""

from __future__ import annotations

import ctypes

import torch

from vn_pointcloudcompletion_tpu_torch.ops.cuda_lib import CudaKernel, check_cuda

_MAX_N = 16384
DESIGN = "single_barrier"  # csrc/fps.cu: one block barrier a step
_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
_KERNEL = CudaKernel("fps.cu", "furthest_point_sample", _ARGS)
# the same launch without the per-point arithmetic: F's dependency floor, on no path
_CHAIN = CudaKernel("fps.cu", "furthest_point_sample_chain", _ARGS, counted=False)


def eligible(b: int, n: int, s: int) -> bool:
    """Where the JAX package takes its Pallas kernel on a TPU
    (fps_pallas.py:33)."""
    return b * n <= 512 * 1024 and n <= _MAX_N and s <= 4096


@torch.no_grad()
def reference_furthest_point_sample(xyz: torch.Tensor, s: int) -> torch.Tensor:
    """Plain version of kernel F: xyz (B, N, 3) -> idx (B, S) int32."""
    x = xyz.to(torch.promote_types(xyz.dtype, torch.float32))
    x0, x1, x2 = (c.contiguous() for c in x.unbind(-1))
    b, n = x0.shape
    min_d = torch.full((b, n), float("inf"), dtype=x.dtype, device=x.device)
    sel = torch.zeros((b, 1), dtype=torch.long, device=x.device)
    picks = [sel]
    for _ in range(1, s):
        d0 = x0 - x0.gather(1, sel)
        d1 = x1 - x1.gather(1, sel)
        d2 = x2 - x2.gather(1, sel)
        min_d = torch.minimum(min_d, d0 * d0 + d1 * d1 + d2 * d2)
        sel = min_d.argmax(1, keepdim=True)  # the first of equal maxima
        picks.append(sel)
    return torch.cat(picks, 1).to(torch.int32)


def _launch(kernel: CudaKernel, xyz: torch.Tensor, s: int, variant: str = "") -> torch.Tensor:
    if xyz.ndim != 3 or xyz.shape[2] != 3:
        raise ValueError(f"furthest_point_sample: xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    b, n, _ = xyz.shape
    if not 0 < n <= _MAX_N:
        raise ValueError(f"furthest_point_sample: N={n} outside [1, {_MAX_N}]")
    if xyz.dtype == torch.bfloat16:  # an exact upcast, as JAX's (fps_pallas.py:79)
        xyz = xyz.float()
    check_cuda("furthest_point_sample", "float32 coordinates (bf16 upcast exactly), any strides",
               (xyz, torch.float32), contiguous=False)
    idx = torch.empty((b, s), device=xyz.device, dtype=torch.int32)
    kernel(xyz, xyz.data_ptr(), idx.data_ptr(), b, n, s, *xyz.stride(), variant=variant)
    return idx


def furthest_point_sample_kernel(xyz: torch.Tensor, s: int) -> torch.Tensor:
    """Kernel F on a CUDA tensor, its plain version on a CPU tensor."""
    if not xyz.is_cuda:
        return reference_furthest_point_sample(xyz, s)
    return _launch(_KERNEL, xyz, s, DESIGN)


def furthest_point_sample_chain(xyz: torch.Tensor, s: int) -> torch.Tensor:
    """Kernel F's launch with its per-point arithmetic taken out: the
    chain of S - 1 steps alone (each a block barrier, two warp reductions
    on either side of it and the load of the new sample), whose time is
    F's dependency floor.  Its indices mean nothing; no counter, no path
    calls it (``chip_smoke.py`` times it beside F)."""
    return _launch(_CHAIN, xyz, s)
