"""Checkpoints in the reference's layout (``train.py:72-87,252-277``).

``<exp_dir>/models/model_{name}.pth`` holds the model's ``state_dict``, so
reference checkpoints load into the port and the port's load into the JAX
package through ``training/torch_interop.py``;
``<exp_dir>/optimizer/optim_{name}.pth`` holds ``{epoch, optim_state_dict,
best_metrics, best_epoch}`` plus the count of accepted steps and the SHA-256
of the model file it was written with.  Both files of a pair are written to
temporary names first and then renamed, and a restore refuses a pair whose
model file is not the one its optimizer file was written with (a crash
between the two renames), as the JAX package's epoch markers do.

:func:`load_pretrained_encoder` reads an encoder pretrained elsewhere (the
reference's ``enc_pretrained``, ``models/model.py:29-39``) into a model, as
the JAX package's ``training/checkpoint.py:101-141`` does.
"""

from __future__ import annotations

import copy
import hashlib
import os
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from vn_pointcloudcompletion_tpu_torch.training.interop import encoder_state_dict_from_torch


def model_path(exp_dir: str, name: str) -> str:
    return os.path.join(exp_dir, "models", f"model_{name}.pth")


def optim_path(exp_dir: str, name: str) -> str:
    return os.path.join(exp_dir, "optimizer", f"optim_{name}.pth")


def _write_model(path: str, state_dict: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def save_model(exp_dir: str, model: nn.Module, name: str) -> str:
    path = model_path(exp_dir, name)
    _write_model(path + ".tmp", model.state_dict())
    os.replace(path + ".tmp", path)
    return path


def payload(state, copied: bool = False) -> dict:
    """What a checkpoint pair holds of a ``TrainState``; ``copied`` clones
    every tensor where it lies, so that later steps do not change it."""
    out = {"model": state.model.state_dict(), "optim": state.optimizer.state_dict(),
           "step": int(state.step)}
    return copy.deepcopy(out) if copied else out


def save_checkpoint(exp_dir: str, held: dict, epoch: int, best_metrics: float,
                    best_epoch: int, name: str) -> None:
    """Write the model/optimizer pair ``{model,optim}_{name}.pth`` from a
    :func:`payload`."""
    mpath, opath = model_path(exp_dir, name), optim_path(exp_dir, name)
    _write_model(mpath + ".tmp", held["model"])
    os.makedirs(os.path.dirname(opath), exist_ok=True)
    torch.save({
        "epoch": int(epoch),
        "optim_state_dict": held["optim"],
        "step": held["step"],
        "best_metrics": float(best_metrics),
        "best_epoch": int(best_epoch),
        "model_sha256": _sha256(mpath + ".tmp"),
    }, opath + ".tmp")
    os.replace(mpath + ".tmp", mpath)
    os.replace(opath + ".tmp", opath)


def restore_checkpoint(exp_dir: str, state,
                       name: str = "last") -> Optional[Tuple[object, int, float, int]]:
    """Load the pair ``{model,optim}_{name}.pth`` into ``state``; returns
    ``(state, epoch, best_metrics, best_epoch)``, or None when absent."""
    mpath, opath = model_path(exp_dir, name), optim_path(exp_dir, name)
    if not (os.path.exists(mpath) and os.path.exists(opath)):
        return None
    meta = torch.load(opath, map_location="cpu", weights_only=True)
    if meta.get("model_sha256") != _sha256(mpath):
        raise RuntimeError(
            f"checkpoint pair mismatch: {mpath} is not the model file that "
            f"{opath} (epoch {meta.get('epoch')}) was written with (crash "
            "between saves?); resume from 'best' or a numbered checkpoint")
    load_model(exp_dir, state.model, (name,))
    state.optimizer.load_state_dict(meta["optim_state_dict"])
    state.step = int(meta["step"])
    return (state, int(meta["epoch"]), float(meta["best_metrics"]),
            int(meta["best_epoch"]))


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


def load_pretrained_encoder(model: nn.Module, path: str,
                            enc_type: str = "vn_pointnet") -> List[str]:
    """Load a torch ``.pth``/``.pt`` state dict's encoder into
    ``model.encoder`` in place, non-strictly as the JAX package's
    ``load_pretrained_encoder`` merges it (``torch_interop.py:257-372``):
    every parameter and BatchNorm running statistic of the encoder comes
    from the file, but for the keys JAX's converters leave at their init
    (``interop.PRETRAINED_SKIPPED``: vn_pointr's coarse head and decoder
    stack); a missing key or another shape raises.  The file may hold a
    whole ``PCNNet`` (keys under ``encoder.``) or a bare encoder.  Returns
    the keys loaded.

    The JAX package also reads its own flax msgpack ``.ckpt`` files here;
    the port reads torch state dicts only."""
    if not path.endswith((".pth", ".pt")):
        raise ValueError(
            f"pretrained encoder {path!r}: the port reads a torch state dict "
            "(.pth or .pt: a reference or port checkpoint); the JAX package's "
            "flax msgpack .ckpt files are not read by the port")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    own = model.encoder.state_dict()
    loaded = encoder_state_dict_from_torch(
        sd, {k: v.shape for k, v in own.items()}, enc_type)
    with torch.no_grad():
        for k, t in loaded.items():
            own[k].copy_(t)
    return sorted(loaded)
