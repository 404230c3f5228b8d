"""Device choice and numeric policy for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises when the card is asked for and there is none.

    Also sets the numeric policy of the matrix products: float32 ones and
    convolutions in full float32, never TF32; bfloat16 ones (the bfloat16
    compute policy, ``nn/precision.py``) accumulate in float32 throughout,
    as JAX's ``preferred_element_type=float32`` does, never in cuBLAS's
    reduced-precision split-K.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev
