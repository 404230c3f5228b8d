"""The least time a piece of work needs on one H100.

Frozen copy of ``chip_smoke.py::bound`` with ``PEAK_FP32``, ``PEAK_BF16``
and ``PEAK_BYTES`` at commit 15a5d0c: bytes at the HBM rate, products at
the rate of the precision they run in, and elementwise float32 work at the
FP32 rate.  Published peaks of the H100 SXM part (dense, 700 W).
"""

from __future__ import annotations

PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def bound(nbytes: float, ops: float, peak_ops: float = PEAK_FP32, fp32_ops: float = 0.0):
    """Least time for the work on the card: (ms, what bounds it).  ``ops``
    at ``peak_ops`` (a bf16 kernel's products: the bf16 tensor-core rate),
    plus ``fp32_ops`` (its elementwise float32 work) at the FP32 rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (ops / peak_ops + fp32_ops / PEAK_FP32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
