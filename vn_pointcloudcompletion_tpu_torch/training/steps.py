"""One train step and one validation step (port of ``training/steps.py``;
reference ``train.py:127-186,205-250``).

A train step: the rotation augmentation (one rotation for partial and
complete, handed to the decoder), the forward in train mode (BatchNorm on
batch statistics, running buffers updated), ``cd_loss_l1`` on the coarse and
the dense clouds, the backward, and the optimiser update behind the
non-finite guard.  The guard reads one boolean from the card per step, the
only host read of the step; on a skipped step neither the parameters, the
BatchNorm running buffers, Adam's moments nor its count change.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from vn_pointcloudcompletion_tpu_torch.metrics.losses import calc_dcd, cd_loss_l1, emd_loss
from vn_pointcloudcompletion_tpu_torch.metrics.metrics import l1_cd
from vn_pointcloudcompletion_tpu_torch.ops.rotations import rotate_points, sample_rotation
from vn_pointcloudcompletion_tpu_torch.training.state import TrainState
from vn_pointcloudcompletion_tpu_torch.utils.config import Config


def all_finite(tensors: List[torch.Tensor]) -> torch.Tensor:
    """Scalar bool tensor: every entry of every tensor is finite."""
    if not tensors:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def _rotate(generator: torch.Generator, mode: str, partial, complete):
    rot = sample_rotation(generator, mode, partial.shape[0])
    if rot is None:
        return None, partial, complete
    rot = rot.to(partial.device)
    return rot, rotate_points(partial, rot), rotate_points(complete, rot)


def coarse_loss(config: Config, coarse, complete) -> torch.Tensor:
    if config.coarse_loss == "cd":
        return cd_loss_l1(coarse, complete)
    if config.coarse_loss == "emd":
        # EMD needs equal counts: the reference cuts the ground truth to the
        # coarse cloud's size (train.py:149)
        return emd_loss(coarse, complete[:, :coarse.shape[1]])
    if config.coarse_loss == "dcd":
        alpha = config.dcd_opts.get("alpha", 200)
        n_lambda = config.dcd_opts.get("lambda", 0.5)
        return calc_dcd(coarse, complete, alpha=alpha, n_lambda=n_lambda)[0].mean()
    raise ValueError(f"Not implemented loss {config.coarse_loss}")


def _losses(model, config: Config, partial, complete, rot):
    """Forward in the model's current mode: (coarse, dense, total) losses."""
    coarse, fine = model(partial, rot)
    loss1 = coarse_loss(config, coarse, complete)
    if config.only_coarse:
        return loss1, torch.zeros((), device=loss1.device), loss1
    loss2 = cd_loss_l1(fine, complete)
    return loss1, loss2, loss1 + loss2


def train_step(state: TrainState, partial: torch.Tensor, complete: torch.Tensor,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One guarded optimiser step; returns the step's metrics as tensors on
    the device (``total``, ``coarse``, ``dense``, ``skipped``)."""
    config, model = state.config, state.model
    rot, partial, complete = _rotate(generator, config.rotation, partial, complete)
    model.train()
    buffers = [b.detach().clone() for b in model.buffers()]
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        p.grad = None

    loss1, loss2, loss = _losses(model, config, partial, complete, rot)
    loss.backward()

    grads = [p.grad for p in params if p.grad is not None]
    ok = all_finite(grads) & torch.isfinite(loss)
    if bool(ok):
        state.apply_gradients()
    else:
        with torch.no_grad():
            for b, saved in zip(model.buffers(), buffers):
                b.copy_(saved)
    return {"total": loss.detach(), "coarse": loss1.detach(),
            "dense": loss2.detach(), "skipped": (~ok).float()}


@torch.no_grad()
def eval_step(model, config: Config, partial: torch.Tensor, complete: torch.Tensor,
              generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Validation: batch sums of ``l1_cd`` for the coarse and dense clouds,
    under ``val_rotation``, with the running statistics."""
    rot, partial, complete = _rotate(generator, config.val_rotation, partial, complete)
    model.eval()
    coarse, fine = model(partial, rot)
    out = {"coarse_sum": l1_cd(coarse, complete)}
    out["dense_sum"] = (torch.zeros((), device=coarse.device) if fine is None
                        else l1_cd(fine, complete))
    return out

