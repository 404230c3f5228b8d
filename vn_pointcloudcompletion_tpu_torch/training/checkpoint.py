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
the JAX package's ``training/checkpoint.py:101-141`` does: from a torch
state dict, or from one of the JAX package's own flax msgpack ``.ckpt``
files (``training/flax_msgpack.py``).
"""

from __future__ import annotations

import copy
import hashlib
import os
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from vn_pointcloudcompletion_tpu_torch.training import flax_msgpack
from vn_pointcloudcompletion_tpu_torch.training.interop import (
    encoder_state_dict_from_torch,
    state_dict_from_jax_variables,
)


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
    """Load a pretrained encoder from ``path`` into ``model.encoder`` in
    place; returns the keys loaded.  A missing key raises KeyError and
    another shape ValueError, each naming the key.

    - A torch ``.pth``/``.pt`` state dict, non-strictly as the JAX
      package's ``load_pretrained_encoder`` merges it
      (``torch_interop.py:257-372``): every parameter and BatchNorm running
      statistic of the encoder comes from the file, but for the keys JAX's
      converters leave at their init (``interop.PRETRAINED_SKIPPED``:
      vn_pointr's coarse head and decoder stack).  The file may hold a
      whole ``PCNNet`` (keys under ``encoder.``) or a bare encoder.
    - A flax msgpack ``.ckpt`` of the JAX package: a whole-model
      ``model_*.ckpt`` (``{params, batch_stats, epoch}``) or a bare encoder
      tree, as JAX reads it (``training/checkpoint.py:126-140``): the
      encoder's parameters ``params["encoder"]`` (or the whole ``params``),
      its running statistics from ``batch_stats["encoder"]`` where the file
      has them (else they keep theirs), carried to the port's keys by
      ``interop.state_dict_from_jax_variables``.  Every tensor of the
      encoder is loaded, strictly, as flax's ``from_state_dict`` does."""
    own = model.encoder.state_dict()
    if path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        loaded = encoder_state_dict_from_torch(
            sd, {k: v.shape for k, v in own.items()}, enc_type)
    elif path.endswith(".ckpt"):
        loaded = _encoder_from_flax(flax_msgpack.read_tree(path), own, enc_type)
    else:
        raise ValueError(
            f"pretrained encoder {path!r}: reads a torch state dict (.pth or .pt: a "
            "reference or port checkpoint) or a JAX package flax msgpack .ckpt")
    with torch.no_grad():
        for k, t in loaded.items():
            own[k].copy_(t)
    return sorted(loaded)


def _host_array(t):
    """A decoded leaf as numpy for the interop mappers (bf16 widened to
    float32, exactly)."""
    if isinstance(t, torch.Tensor):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return t


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _placeholder_stats(params):
    """A batch_stats tree shaped as ``params``' BatchNorms (``mean`` and
    ``var`` beside each ``BatchNorm_0``'s ``scale``), for a file that holds
    no statistics: the mappers then run, and the statistics are not
    loaded."""
    out = {}
    for k, v in params.items():
        if not isinstance(v, dict):
            continue
        if k == "BatchNorm_0":
            out[k] = {"mean": v["scale"], "var": v["scale"]}
        else:
            sub = _placeholder_stats(v)
            if sub:
                out[k] = sub
    return out


def _encoder_from_flax(blob, own: dict, enc_type: str) -> dict:
    """The port encoder's tensors from a decoded JAX checkpoint tree: its
    ``params["encoder"]`` (or the whole ``params`` of a bare encoder tree)
    and ``batch_stats["encoder"]`` where present, as JAX takes them."""
    params = blob["params"].get("encoder", blob["params"])
    stats = (blob.get("batch_stats") or {}).get("encoder")
    params = _tree_map(_host_array, params)
    has_stats = stats is not None
    stats = _tree_map(_host_array, stats) if has_stats else _placeholder_stats(params)
    try:
        sd = state_dict_from_jax_variables(
            {"params": {"encoder": params}, "batch_stats": {"encoder": stats}})
    except KeyError as e:
        raise KeyError(f"JAX {enc_type} encoder tree: no {e} where the mapping "
                       "reads it") from None
    sd = {k[len("encoder."):]: t for k, t in sd.items() if k.startswith("encoder.")}
    out = {}
    for k, t in own.items():
        if not has_stats and k.endswith(("running_mean", "running_var")):
            continue
        if k not in sd:
            raise KeyError(f"JAX {enc_type} encoder tree: no tensor for {k}")
        if tuple(sd[k].shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch in pretrained load: {k} {tuple(t.shape)} vs "
                             f"{tuple(sd[k].shape)}")
        out[k] = sd[k]
    return out
