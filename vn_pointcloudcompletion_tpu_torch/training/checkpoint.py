"""Model checkpoints as reference-layout ``state_dict`` files.

``<exp_dir>/models/model_{best,last}.pth``, the reference's own layout
(``train.py:255,268``), so its checkpoints load into the port and the port's
load into the JAX package through ``training/torch_interop.py``.  Writes are
atomic (temporary file + rename).  Optimizer state comes with training.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
from torch import nn


def model_path(exp_dir: str, name: str) -> str:
    return os.path.join(exp_dir, "models", f"model_{name}.pth")


def save_model(exp_dir: str, model: nn.Module, name: str) -> str:
    path = model_path(exp_dir, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(sd, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def load_model(exp_dir: str, model: nn.Module,
               names: Sequence[str] = ("best", "last")) -> str:
    """Load the first of ``model_{name}.pth`` that exists, strictly; returns
    its path.  The reference's BatchNorm ``num_batches_tracked`` counters
    carry no weight and are dropped."""
    for name in names:
        path = model_path(exp_dir, name)
        if os.path.exists(path):
            sd = torch.load(path, map_location="cpu", weights_only=True)
            sd = {k: v for k, v in sd.items()
                  if not k.endswith("num_batches_tracked")}
            model.load_state_dict(sd, strict=True)
            return path
    raise FileNotFoundError(
        f"no model_{{{','.join(names)}}}.pth in {os.path.join(exp_dir, 'models')}")
