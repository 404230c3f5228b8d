"""Device choice and numeric policy for the port's entry points."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device="cuda", local_rank: Optional[int] = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises when the card is asked for and there is none.
    ``local_rank`` (a data-parallel rank, ``parallel/mesh.py``): "cuda"
    means that rank's card ``cuda:{local_rank}``, which becomes the current
    card; an indexed card is taken as it is.

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
    if dev.type == "cuda" and local_rank is not None:
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank's card {dev} requested but only "
                               f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev
