"""Global compute-dtype control for the model compute path.

Port of ``vn_pointcloudcompletion_tpu/nn/precision.py``.  The VN pipelines
are bound by the bytes of their activations; storing activations in
bfloat16 (with float32 accumulation inside every matrix product, and
float32 norm and softmax statistics) halves that traffic.  The default is
float32: parity runs and tests run exact; benchmarks and production
training opt into bfloat16 through the config's ``dtype`` or
:func:`compute_dtype_scope`.

A process-global, read at forward time (JAX reads it at trace time), by
``nn/vn.py``, ``nn/attention.py`` and the decoders and encoders of
``models/``.  Parameters stay float32 under either policy and are cast at
their use.  Who sets it: ``bench``-style callers (the JAX package's
``bench.py`` sets bfloat16 for every entry, ``bench_infer`` and
``bench_eval_step`` included) and ``train``, from the config's ``dtype``
for the whole run (``training/trainer.py``).  The CLI's ``test`` and ``predict`` never set it, as the JAX
package's ``main.py`` does not, so they run float32 on any config.
"""

from __future__ import annotations

import contextlib

import torch

_COMPUTE_DTYPE = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check(dtype) -> torch.dtype:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
    return dtype


def set_compute_dtype(dtype) -> None:
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = _check(dtype)


def compute_dtype() -> torch.dtype:
    return _COMPUTE_DTYPE


@contextlib.contextmanager
def compute_dtype_scope(dtype):
    global _COMPUTE_DTYPE
    old = _COMPUTE_DTYPE
    _COMPUTE_DTYPE = _check(dtype)
    try:
        yield
    finally:
        _COMPUTE_DTYPE = old


def from_config_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def bf16_policy() -> bool:
    return _COMPUTE_DTYPE == torch.bfloat16


def activation_dtype(x: torch.Tensor) -> torch.Tensor:
    """Cast ``x`` down to the compute dtype when a low-precision policy is on.

    No-op under the default float32 policy (parity and float64 harnesses
    feed wider dtypes and must pass through untouched).  Used at decoder
    and encoder entries where constants (fold seeds, coarse layouts, input
    coordinates) are float32 by construction and would otherwise promote
    the whole bandwidth-bound fold chain: its kernel layers take their mode
    from ``x.dtype`` for every activation buffer.
    """
    if bf16_policy() and x.dtype in (torch.float32, torch.float64):
        return x.to(torch.bfloat16)
    return x


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul``; for two bf16 operands the product the bfloat16
    policy means (JAX's bf16 einsum, ``preferred_element_type=float32``
    where it says so): every term exact, float32 accumulation, one
    rounding of the sum to bf16.  On the card that is cuBLAS's bf16 GEMM
    (reduced-precision reduction off, ``utils/device.py``); on the CPU a
    float32 product of the bf16 values, since torch's CPU bf16 GEMM rounds
    elsewhere."""
    if a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16 and not a.is_cuda:
        return torch.matmul(a.float(), b.float()).to(torch.bfloat16)
    return torch.matmul(a, b)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands, rounded as :func:`matmul` rounds."""
    if a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16 and not a.is_cuda:
        return torch.einsum(eq, a.float(), b.float()).to(torch.bfloat16)
    return torch.einsum(eq, a, b)


def weak(value: float, like: torch.Tensor):
    """A Python scalar as JAX's weak typing takes it next to a tensor of
    ``like``'s dtype: rounded to bf16 beside a bf16 tensor (torch would
    apply it in float32), as it is otherwise."""
    if like.dtype == torch.bfloat16:
        return torch.tensor(value, dtype=torch.bfloat16, device=like.device)
    return value
