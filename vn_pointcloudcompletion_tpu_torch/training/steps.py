"""One train step and one validation step (port of ``training/steps.py``;
reference ``train.py:127-186,205-250``).

A train step: the rotation augmentation (one rotation for partial and
complete, handed to the decoder), the forward in train mode (BatchNorm on
batch statistics, running buffers updated), ``cd_loss_l1`` on the coarse and
the dense clouds, the backward, and the optimiser update behind the
non-finite guard.  The guard reads one boolean from the card per step, the
only host read of the step; on a skipped step neither the parameters, the
BatchNorm running buffers, Adam's moments nor its count change.

Under ``config.remat`` the whole forward is one checkpointed segment
(``torch.utils.checkpoint``, JAX's ``jax.checkpoint`` around the apply,
``training/steps.py:77-86``): its activations are dropped and the backward
runs it again; the losses stay outside.  The recomputation makes the same
discrete decisions (argmax pools, kNN, FPS) as the forward, since the plain
path and every kernel repeat their bits; the rotation is drawn before it.
It would update the BatchNorm running buffers a second time, so the step
puts back the forward's: the running statistics are those of one forward,
as JAX's ``mutated["batch_stats"]`` are.  The bf16 policy is read during
the recomputation too, so ``backward()`` runs inside the same
``compute_dtype_scope`` as the forward (the trainer holds it for the run).

Under a data-parallel ``mesh`` (``parallel/train_parallel.py``) each rank
runs these steps over its rows of the global batch: the rotations are drawn
for the global batch and the rank takes its rows, the gradients and losses
are averaged over ranks before the guard, and the validation sums are summed
over ranks.  Under ``remat`` the recomputed forward repeats the BatchNorm
all-reduces on every rank, in the same order.

On this port ``remat`` saves no peak memory: the one segment is the whole
forward, so the backward's first unpack recomputes all of it and every
saved activation is alive again before the first backward kernel.  It
costs one more train-mode forward, 36-65% of the step's time on an H100
(flagship float32 and the root ``config.json`` in bf16 at batch 8 and 16;
``chip_smoke.py`` phase 14, recorded in ``PERF.md``).  It is kept for
parity with JAX's option.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from vn_pointcloudcompletion_tpu_torch.metrics.losses import calc_dcd, cd_loss_l1, emd_loss
from vn_pointcloudcompletion_tpu_torch.metrics.metrics import l1_cd
from vn_pointcloudcompletion_tpu_torch.ops.rotations import rotate_points, sample_rotation
from vn_pointcloudcompletion_tpu_torch.parallel.mesh import (
    Mesh,
    check_step_mesh,
    data_sharding,
    mean_over_ranks,
)
from vn_pointcloudcompletion_tpu_torch.training.state import TrainState
from vn_pointcloudcompletion_tpu_torch.utils.config import Config


def all_finite(tensors: List[torch.Tensor]) -> torch.Tensor:
    """Scalar bool tensor: every entry of every tensor is finite."""
    if not tensors:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def _rotate(generator: torch.Generator, mode: str, partial, complete,
            mesh: Optional[Mesh] = None):
    """Rotate the batch; under a mesh the rotations are drawn for the global
    batch and the rank takes its rows (JAX ``parallel/train_parallel.py:8-11``)."""
    world = 1 if mesh is None else mesh.world
    rot = sample_rotation(generator, mode, partial.shape[0] * world)
    if rot is None:
        return None, partial, complete
    rot = data_sharding(mesh, rot).to(partial.device, partial.dtype)
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
    """Forward in the model's current mode: (coarse, dense, total) losses;
    in train mode under ``config.remat`` the forward is recomputed in the
    backward (see the module docstring for the running buffers)."""
    if config.remat and model.training:
        coarse, fine = checkpoint(model, partial, rot, use_reentrant=False)
    else:
        coarse, fine = model(partial, rot)
    loss1 = coarse_loss(config, coarse, complete)
    if config.only_coarse:
        return loss1, torch.zeros((), device=loss1.device), loss1
    loss2 = cd_loss_l1(fine, complete)
    return loss1, loss2, loss1 + loss2


def train_step(state: TrainState, partial: torch.Tensor, complete: torch.Tensor,
               generator: torch.Generator,
               mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """One guarded optimiser step; returns the step's metrics as tensors on
    the device (``total``, ``coarse``, ``dense``, ``skipped``).  Under a
    ``mesh`` (``parallel/train_parallel.py``) the batch is the rank's rows
    and the step is that of the global batch: the gradients and the losses
    are averaged over ranks before the guard."""
    check_step_mesh(mesh)
    config, model = state.config, state.model
    rot, partial, complete = _rotate(generator, config.rotation, partial, complete, mesh)
    model.train()
    buffers = [b.detach().clone() for b in model.buffers()]
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        p.grad = None

    loss1, loss2, loss = _losses(model, config, partial, complete, rot)
    forward_buffers = [b.detach().clone() for b in model.buffers()] if config.remat else None
    loss.backward()
    if forward_buffers is not None:  # undo the recomputation's BatchNorm update
        with torch.no_grad():
            for b, kept in zip(model.buffers(), forward_buffers):
                b.copy_(kept)

    grads = [p.grad for p in params if p.grad is not None]
    if mesh is not None:
        loss1, loss2, loss = mean_over_ranks(mesh, grads, (loss1, loss2, loss))
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
              generator: torch.Generator, mesh: Optional[Mesh] = None
              ) -> Tuple[Dict[str, torch.Tensor], Tuple[torch.Tensor, ...]]:
    """Validation: batch sums of ``l1_cd`` for the coarse and dense clouds,
    under ``val_rotation``, with the running statistics; under a ``mesh``
    summed over the ranks' rows.  Returns ``(sums, (partial, coarse, fine,
    complete))`` as JAX's ``eval_step`` does: the rotated clouds of the
    batch (the rank's rows under a ``mesh``), on the device; ``fine`` is
    None under ``only_coarse``."""
    check_step_mesh(mesh)
    rot, partial, complete = _rotate(generator, config.val_rotation, partial, complete, mesh)
    model.eval()
    coarse, fine = model(partial, rot)
    out = {"coarse_sum": l1_cd(coarse, complete)}
    out["dense_sum"] = (torch.zeros((), device=coarse.device) if fine is None
                        else l1_cd(fine, complete))
    if mesh is not None:
        sums = torch.stack([out["coarse_sum"], out["dense_sum"]])
        dist.all_reduce(sums)
        out = {"coarse_sum": sums[0], "dense_sum": sums[1]}
    return out, (partial, coarse, fine, complete)

