"""The epoch loop (port of ``training/trainer.py``; reference
``train.py:45-279``).

Per epoch: shuffled training batches (``set_epoch``), one guarded step each,
log lines in the JAX trainer's format every ``len(loader) // log_frequency``
steps and at the end of the epoch; then validation, ``l1_cd`` sums averaged
over the samples evaluated; then the checkpoints: ``best`` when the
validation total improves, ``last`` every ``checkpoint_last_every`` epochs
(and at the end), numbered ones every ``checkpoint_every`` epochs.

The scalars the JAX trainer writes with tensorboardX (``Loss/Batch/*``,
``Loss/Epoch/*``) go to ``<exp_dir>/metrics.jsonl``, one JSON object per
line: ``{"split", "tag", "step", "value"}``.  The per-epoch PNG of one
validation cloud is not drawn (ROADMAP.md, queue 1, item 7).  The step's
metrics stay on the card until the end of the epoch, apart from the log
points.
"""

from __future__ import annotations

import json
import logging
import os
import time

import torch

from vn_pointcloudcompletion_tpu_torch.data.pipeline import BatchLoader, device_prefetch
from vn_pointcloudcompletion_tpu_torch.data.shapenet import ShapeNetPCN
from vn_pointcloudcompletion_tpu_torch.data.synthetic import SyntheticCompletionDataset
from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
from vn_pointcloudcompletion_tpu_torch.nn.precision import compute_dtype_scope, from_config_dtype
from vn_pointcloudcompletion_tpu_torch.training.checkpoint import (
    payload,
    restore_checkpoint,
    save_checkpoint,
)
from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state
from vn_pointcloudcompletion_tpu_torch.training.steps import eval_step, train_step
from vn_pointcloudcompletion_tpu_torch.utils.config import Config
from vn_pointcloudcompletion_tpu_torch.utils.device import resolve_device

log = logging.getLogger("train")
log_dataset = logging.getLogger("dataset")


def build_datasets(config: Config):
    if config.dataset == "synthetic":
        kw = dict(n_partial=config.extra.get("synthetic_n_partial", 2048),
                  n_complete=config.extra.get("synthetic_n_complete", 16384))
        return (
            SyntheticCompletionDataset(config.extra.get("synthetic_train_samples", 64),
                                       seed=config.seed, **kw),
            SyntheticCompletionDataset(config.extra.get("synthetic_val_samples", 16),
                                       seed=config.seed + 1, **kw),
        )
    root = os.path.join(config.data_path, "PCN")
    return (ShapeNetPCN(root, "train", config.category, seed=config.seed),
            ShapeNetPCN(root, "valid", config.category, seed=config.seed))


def _check_ported(config: Config) -> None:
    if config.remat:
        raise NotImplementedError(
            "remat (recomputing the forward in the backward) is not ported yet "
            "(ROADMAP.md, queue 1, item 7)")
    if config.checkpoint:
        raise NotImplementedError(
            "branching a run from a numbered checkpoint (-from) is not ported "
            "yet (ROADMAP.md, queue 1, item 7)")


class _Scalars:
    """Appends the tensorboard scalars to ``<exp_dir>/metrics.jsonl``."""

    def __init__(self, exp_dir: str):
        self._f = open(os.path.join(exp_dir, "metrics.jsonl"), "a")

    def add(self, split: str, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"split": split, "tag": tag, "step": step,
                                  "value": float(value)}) + "\n")

    def close(self) -> None:
        self._f.close()


def train(config: Config, resume: bool = False, device="cuda") -> dict:
    """Run training; returns ``{best_epoch, best_cd, epochs_run}``.

    The whole run, validation included, runs under the compute policy of
    ``config.dtype`` (JAX sets it process-wide, ``training/trainer.py:74-77``);
    the caller's policy is restored on return.  Parameters, Adam's state
    and the checkpoints stay float32 under either."""
    _check_ported(config)
    with compute_dtype_scope(from_config_dtype(config.dtype)):
        return _train(config, resume, device)


def _train(config: Config, resume: bool, device) -> dict:
    dev = resolve_device(device)
    log_dataset.info("Loading Data...")
    train_dataset, val_dataset = build_datasets(config)
    train_loader = BatchLoader(train_dataset, config.batch_size, shuffle=True,
                               seed=config.seed, num_workers=config.num_workers)
    val_loader = BatchLoader(val_dataset, config.batch_size, shuffle=False,
                             num_workers=config.num_workers, drop_last=False)
    log_dataset.info("Dataset loaded!")

    model = build_model(config).to(dev)
    steps_per_epoch = config.steps_per_epoch or max(len(train_loader), 1)
    state = create_train_state(model, config, steps_per_epoch)
    generator = torch.Generator().manual_seed(config.seed)

    start_epoch, best_cd_l1, best_epoch_l1 = 0, 1e8, -1
    if resume:
        restored = restore_checkpoint(config.exp_dir, state, "last")
        if restored is not None:
            state, last_epoch, best_cd_l1, best_epoch_l1 = restored
            start_epoch = last_epoch + 1
            log.info(f"[RESUME INFO] resume ckpts @ {last_epoch} epoch"
                     f" (best_metrics = {best_cd_l1 * 1e3})")
        else:
            log.info("No checkpoint found; training from start")
    else:
        log.info(f"Start a brand new experiment: {config.run_name}")

    log.info(f"Model total params: {sum(p.numel() for p in model.parameters())}")
    log.info(f"Producing coarse only: {config.only_coarse}")
    log.info(f"Producing num of coarse points: {config.num_coarse}")

    end_epoch = config.max_epochs
    n_batches = len(train_loader)
    step_every = max(n_batches // max(config.log_frequency, 1), 1)
    last_every = max(config.checkpoint_last_every, 1)
    scalars = _Scalars(config.exp_dir)
    epochs_run = 0
    pending_best = None  # (payload, epoch) of a best model not written yet
    try:
        for epoch in range(start_epoch, end_epoch + 1):
            train_loader.set_epoch(epoch)
            t0 = time.time()
            step_metrics = []
            for i, (p, c) in enumerate(device_prefetch(train_loader, dev)):
                metrics = train_step(state, p, c, generator)
                step_metrics.append(metrics)
                if (i + 1) % step_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    log.info(
                        "Training Epoch [{:03d}/{:03d}] - Iteration [{:03d}/{:03d}]:"
                        " coarse loss = {:.6f}, dense loss = {:.6f}, total loss = {:.6f}".format(
                            epoch, end_epoch, i + 1, n_batches,
                            m["coarse"] * 1e3, m["dense"] * 1e3, m["total"] * 1e3))

            sums = {"coarse": 0.0, "dense": 0.0, "total": 0.0}
            n_skipped = 0
            for i, metrics in enumerate(step_metrics):
                m = {k: float(v) for k, v in metrics.items()}
                n_skipped += int(m["skipped"])
                for k in sums:
                    sums[k] += m[k]
                for k in ("Coarse", "Dense", "Total"):
                    scalars.add("train", f"Loss/Batch/{k}", m[k.lower()],
                                epoch * n_batches + i)
            denom = max(n_batches, 1)
            log.info(
                "Training Epoch [{:03d}/{:03d}]: Coarse = {:.6f}, Dense = {:.6f},"
                " Total = {:.6f} ({:.1f}s)".format(
                    epoch, end_epoch, sums["coarse"] / denom * 1e3,
                    sums["dense"] / denom * 1e3, sums["total"] / denom * 1e3,
                    time.time() - t0))
            for k in ("Coarse", "Dense", "Total"):
                scalars.add("train", f"Loss/Epoch/{k}", sums[k.lower()] / denom * 1e3, epoch)
            if n_skipped:
                log.warning(f"Epoch {epoch}: skipped {n_skipped}/{n_batches} updates "
                            "with non-finite gradients")
                scalars.add("train", "Loss/Epoch/SkippedSteps", n_skipped, epoch)

            val = {"coarse": 0.0, "dense": 0.0}
            n_evaluated = 0
            for p, c in device_prefetch(val_loader, dev):
                out = eval_step(model, config, p, c, generator)
                val["coarse"] += float(out["coarse_sum"])
                val["dense"] += float(out["dense_sum"])
                n_evaluated += p.shape[0]
            if n_evaluated == 0:
                log.warning("validation evaluated 0 batches; skipping the "
                            "best-checkpoint update")
            n_val = max(n_evaluated, 1)
            val_coarse, val_dense = val["coarse"] / n_val, val["dense"] / n_val
            # the reference's "total" adds the coarse and dense means
            val_total = val_coarse if config.only_coarse else val_coarse + val_dense
            for k, v in (("Coarse", val_coarse), ("Dense", val_dense), ("Total", val_total)):
                scalars.add("val", f"Loss/Epoch/{k}", v * 1e3, epoch)
            log.info(
                "Validate Epoch [{:03d}/{:03d}]: Coarse = {:.6f}, Dense = {:.6f},"
                " Total = {:.6f}".format(epoch, end_epoch, val_coarse * 1e3,
                                         val_dense * 1e3, val_total * 1e3))

            if n_evaluated > 0 and val_total < best_cd_l1:
                best_epoch_l1, best_cd_l1 = epoch, val_total
                if last_every > 1:
                    # written with the next "last", from a copy kept on the card
                    pending_best = (payload(state, copied=True), epoch)
                else:
                    save_checkpoint(config.exp_dir, payload(state), epoch, best_cd_l1,
                                    best_epoch_l1, "best")
                    log.info(f"Save checkpoint at {config.exp_dir}/models/model_best.pth")
            if epoch % last_every == 0 or epoch == end_epoch:
                if pending_best is not None:
                    held, b_epoch = pending_best
                    save_checkpoint(config.exp_dir, held, b_epoch, best_cd_l1,
                                    best_epoch_l1, "best")
                    log.info(f"Save checkpoint at {config.exp_dir}/models/model_best.pth"
                             f" (epoch {b_epoch}, deferred)")
                    pending_best = None
                save_checkpoint(config.exp_dir, payload(state), epoch, best_cd_l1,
                                best_epoch_l1, "last")
            if config.checkpoint_every and epoch % config.checkpoint_every == 0:
                save_checkpoint(config.exp_dir, payload(state), epoch, best_cd_l1,
                                best_epoch_l1, str(epoch))
            epochs_run += 1
    finally:
        scalars.close()

    log.info(f"Best l1 cd model in epoch {best_epoch_l1}, the minimum l1 cd is"
             f" {best_cd_l1 * 1e3}")
    return {"best_epoch": best_epoch_l1, "best_cd": best_cd_l1, "epochs_run": epochs_run}
