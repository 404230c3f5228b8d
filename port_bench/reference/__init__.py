"""The benchmark's plain reference: float32 PyTorch written from the models'
equations, with no kernel, no cache and no batching tricks.

It imports neither JAX, nor the JAX package, nor anything of the PyTorch
port (``vn_pointcloudcompletion_tpu_torch``): it works out again every
neighbour, furthest-point sample, BatchNorm statistic and Adam moment from
the inputs and weights the benchmark made.  ``port_bench/tests`` holds it to
the port at small sizes on the CPU.  On the card it runs with TF32 switched
off (``strict_float32``), the precision the configurations state; the
control of ``port_bench/control.py`` runs it with TF32 on.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 products in full float32 (``tf32=False``) or in TF32 (the
    control), restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def strict_float32():
    return matmul_precision(False)
