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
line: ``{"split", "tag", "step", "value"}``.  The step's metrics stay on
the card until the end of the epoch, apart from the log points.

Each epoch draws one validation sample and writes its clouds to
``<exp_dir>/visualizations/epoch_{epoch:03d}.png`` (Input, Coarse, Dense,
Ground Truth; no Dense under ``only_coarse``), as JAX does
(``training/trainer.py:187,249,259-264,290,347-365``): from
``np.random.default_rng(seed + 17)``, made anew by every run (``--resume``
and ``-from`` too), the validation batch before validation and the sample
within it at the save, so the port draws JAX's batch and sample epoch by
epoch.  Only that sample's rotated clouds (``eval_step``'s) are copied to
the host.  Where matplotlib is not installed (an optional host package:
the figure is the only thing that needs it) the run makes the same draws,
logs one warning naming the package and writes no PNG.

With a ``mesh`` (``--mesh``; ``parallel/``) the run is one rank of a
data-parallel group (JAX ``training/trainer.py:57-63,79-95,168-173``):
``batch_size`` is the global batch, and the rank loads its ``batch_size //
world`` rows of each global batch of the one-process run
(``data/pipeline.py``), as JAX on one host loads the global batch in its
one process and shards it over the devices.  So an epoch takes the steps
of the one-process epoch over the same batches, ShapeNet and synthetic
alike.  The validation loader drops its short last batch, and the
validation means divide by the global count of samples evaluated.  Every
rank restores ``--resume``, ``-from`` and ``enc_pretrained`` and then takes
rank 0's state (``shard_state``); only rank 0 writes checkpoints,
scalars and the figure.  JAX counts the ranks of one host as one process
holding the global batch, so it draws the figure's sample over the global
batch: every rank makes the same draws, and the rank holding the sample
broadcasts its clouds to rank 0.

Before the first epoch, in the JAX trainer's order
(``training/trainer.py:125-163``): a pretrained encoder
(``enc_pretrained``, frozen by ``training/state.py``) is loaded into the
new state; then ``--resume`` restores the run's ``last`` pair, or a run
branched with ``-from`` restores the numbered pair that
``utils/experiments.py::create_experiment`` copied into it and continues
at the epoch after it.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from vn_pointcloudcompletion_tpu_torch.data.pipeline import BatchLoader, device_prefetch
from vn_pointcloudcompletion_tpu_torch.data.shapenet import ShapeNetPCN
from vn_pointcloudcompletion_tpu_torch.data.synthetic import SyntheticCompletionDataset
from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
from vn_pointcloudcompletion_tpu_torch.nn.precision import compute_dtype_scope, from_config_dtype
from vn_pointcloudcompletion_tpu_torch.parallel.mesh import Mesh
from vn_pointcloudcompletion_tpu_torch.parallel.train_parallel import (
    check_batch,
    make_parallel_steps,
    shard_state,
)
from vn_pointcloudcompletion_tpu_torch.training.checkpoint import (
    load_pretrained_encoder,
    payload,
    restore_checkpoint,
    save_checkpoint,
)
from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state
from vn_pointcloudcompletion_tpu_torch.training.steps import eval_step, train_step
from vn_pointcloudcompletion_tpu_torch.utils.config import Config
from vn_pointcloudcompletion_tpu_torch.utils.device import resolve_device
from vn_pointcloudcompletion_tpu_torch.utils.experiments import get_num_params_total
from vn_pointcloudcompletion_tpu_torch.visualization import plot_pcd_one_view

log = logging.getLogger("train")
log_dataset = logging.getLogger("dataset")


def build_datasets(config: Config):
    """The train and validation sets.  The ranks of ``--mesh`` run on one
    host, which JAX counts as one process: ShapeNet's per-process shares
    (``process_count`` > 1, JAX's multi-host rule) are not taken here."""
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


class _Scalars:
    """Appends the tensorboard scalars to ``<exp_dir>/metrics.jsonl``; a
    rank other than 0 (``exp_dir`` None) writes nothing."""

    def __init__(self, exp_dir: Optional[str]):
        self._f = None if exp_dir is None else open(os.path.join(exp_dir, "metrics.jsonl"), "a")

    def add(self, split: str, tag: str, value: float, step: int) -> None:
        if self._f is not None:
            self._f.write(json.dumps({"split": split, "tag": tag, "step": step,
                                      "value": float(value)}) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


class _EpochFigure:
    """The per-epoch PNG of one validation sample, drawn as JAX draws it
    (see the module docstring)."""

    def __init__(self, config: Config, mesh: Optional[Mesh]):
        self.config, self.mesh = config, mesh
        self.rng = np.random.default_rng(config.seed + 17)
        self.dir = os.path.join(config.exp_dir, "visualizations")
        self.warned = False

    def draw_batch(self, n_batches: int) -> int:
        """The validation batch whose clouds the figure shows."""
        return int(self.rng.integers(0, max(n_batches, 1)))

    def save(self, epoch: int, clouds) -> None:
        """Draw the sample of the batch's ``clouds`` (``eval_step``'s, the
        rank's rows under a mesh); rank 0 writes its figure."""
        world = 1 if self.mesh is None else self.mesh.world
        local = clouds[0].shape[0]
        index = int(self.rng.integers(0, local * world))
        row = [None if c is None else c[index % local] for c in clouds]
        owner = index // local
        if owner:  # another rank's sample: it broadcasts the rows, every rank takes part
            shown = [c for c in row if c is not None]
            flat = torch.cat([c.reshape(-1) for c in shown])
            dist.broadcast(flat, owner)
            parts = iter(flat.split([c.numel() for c in shown]))
            row = [None if c is None else next(parts).view(c.shape) for c in row]
        if self.mesh is not None and not self.mesh.is_main:
            return
        partial, coarse, fine, complete = (None if c is None else c.cpu() for c in row)
        lims = dict(xlim=(-0.35, 0.35), ylim=(-0.35, 0.35), zlim=(-0.35, 0.35))
        if self.config.only_coarse or fine is None:
            pcds, titles = [partial, coarse, complete], ["Input", "Coarse", "Ground Truth"]
        else:
            pcds = [partial, coarse, fine, complete]
            titles = ["Input", "Coarse", "Dense", "Ground Truth"]
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"epoch_{epoch:03d}.png")
        try:
            plot_pcd_one_view(path, pcds, titles, **lims)
        except ModuleNotFoundError as e:
            if e.name != "matplotlib":
                raise
            if not self.warned:
                log.warning("matplotlib is not installed: no per-epoch PNG is written "
                            f"under {self.dir}")
                self.warned = True


def train(config: Config, resume: bool = False, device="cuda",
          mesh: Optional[Mesh] = None) -> dict:
    """Run training; returns ``{best_epoch, best_cd, epochs_run}``.
    ``mesh``: this process is one rank of a data-parallel group on
    ``mesh.device`` (``device`` is then not read).

    The whole run, validation included, runs under the compute policy of
    ``config.dtype`` (JAX sets it process-wide, ``training/trainer.py:74-77``);
    the caller's policy is restored on return.  Parameters, Adam's state
    and the checkpoints stay float32 under either."""
    with compute_dtype_scope(from_config_dtype(config.dtype)):
        return _train(config, resume, device, mesh)


def _train(config: Config, resume: bool, device, mesh: Optional[Mesh]) -> dict:
    if mesh is None:
        dev, rank, world = resolve_device(device), 0, 1
    else:  # fail on the batch before the datasets and the model are built
        dev, rank, world = mesh.device, mesh.rank, mesh.world
        check_batch(config, world)
    log_dataset.info("Loading Data...")
    train_dataset, val_dataset = build_datasets(config)
    train_loader = BatchLoader(train_dataset, config.batch_size, shuffle=True,
                               seed=config.seed, num_workers=config.num_workers,
                               shard=(rank, world))
    # a mesh's step needs every rank's batch whole; the validation means
    # divide by the samples evaluated
    val_loader = BatchLoader(val_dataset, config.batch_size, shuffle=False,
                             num_workers=config.num_workers, drop_last=mesh is not None,
                             shard=(rank, world))
    log_dataset.info("Dataset loaded!")

    model = build_model(config).to(dev)
    steps_per_epoch = config.steps_per_epoch or max(len(train_loader), 1)
    state = create_train_state(model, config, steps_per_epoch)
    generator = torch.Generator().manual_seed(config.seed)

    if config.enc_pretrained != "none":
        if not os.path.exists(config.enc_pretrained):
            # the optimiser freezes the encoder whenever enc_pretrained is
            # set: skipping a mistyped path would train a frozen random
            # encoder for the whole run
            raise FileNotFoundError(
                f"enc_pretrained checkpoint not found: {config.enc_pretrained}")
        load_pretrained_encoder(model, config.enc_pretrained, config.enc_type)
        log.info(f"Loaded pretrained encoder from {config.enc_pretrained}")

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
    elif config.checkpoint:
        # -from: create_experiment copied model_{N}/optim_{N} into this new
        # run dir (reference utils/experiments.py:154-166)
        restored = restore_checkpoint(config.exp_dir, state, str(config.checkpoint))
        if restored is None:
            raise FileNotFoundError(
                f"branch checkpoint {config.checkpoint} missing from {config.exp_dir}")
        state, last_epoch, best_cd_l1, best_epoch_l1 = restored
        start_epoch = last_epoch + 1
        log.info(f"[BRANCH INFO] new run {config.run_name} branched from epoch "
                 f"{last_epoch} checkpoint (best_metrics = {best_cd_l1 * 1e3})")
    else:
        log.info(f"Start a brand new experiment: {config.run_name}")

    if mesh is None:
        step_fn, eval_fn = train_step, eval_step
    else:
        step_fn, eval_fn = make_parallel_steps(config, mesh)
        state = shard_state(state, mesh)
    writes = mesh is None or mesh.is_main

    def save(held, epoch, name):
        if writes:  # rank 0 writes for the group
            save_checkpoint(config.exp_dir, held, epoch, best_cd_l1, best_epoch_l1, name)

    log.info(f"Model total params: {get_num_params_total(model)}")
    log.info(f"Producing coarse only: {config.only_coarse}")
    log.info(f"Producing num of coarse points: {config.num_coarse}")

    end_epoch = config.max_epochs
    n_batches = len(train_loader)
    step_every = max(n_batches // max(config.log_frequency, 1), 1)
    last_every = max(config.checkpoint_last_every, 1)
    scalars = _Scalars(config.exp_dir if writes else None)
    figure = _EpochFigure(config, mesh)
    epochs_run = 0
    pending_best = None  # (payload, epoch) of a best model not written yet
    try:
        for epoch in range(start_epoch, end_epoch + 1):
            train_loader.set_epoch(epoch)
            t0 = time.time()
            step_metrics = []
            for i, (p, c) in enumerate(device_prefetch(train_loader, dev)):
                metrics = step_fn(state, p, c, generator)
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
            rand_iter = figure.draw_batch(len(val_loader))
            viz = None
            n_evaluated = 0
            for i, (p, c) in enumerate(device_prefetch(val_loader, dev)):
                out, clouds = eval_fn(model, config, p, c, generator)
                val["coarse"] += float(out["coarse_sum"])
                val["dense"] += float(out["dense_sum"])
                n_evaluated += p.shape[0] * world
                if i == rand_iter:
                    viz = clouds
            if n_evaluated == 0:
                log.warning("validation evaluated 0 batches (dataset smaller than the "
                            "mesh-divisible batch size); skipping the best-checkpoint update")
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
            if viz is not None:
                figure.save(epoch, viz)

            if n_evaluated > 0 and val_total < best_cd_l1:
                best_epoch_l1, best_cd_l1 = epoch, val_total
                if last_every > 1:
                    # written with the next "last", from a copy kept on the card
                    pending_best = (payload(state, copied=True) if writes else None, epoch)
                else:
                    save(payload(state), epoch, "best")
                    log.info(f"Save checkpoint at {config.exp_dir}/models/model_best.pth")
            if epoch % last_every == 0 or epoch == end_epoch:
                if pending_best is not None:
                    held, b_epoch = pending_best
                    save(held, b_epoch, "best")
                    log.info(f"Save checkpoint at {config.exp_dir}/models/model_best.pth"
                             f" (epoch {b_epoch}, deferred)")
                    pending_best = None
                save(payload(state), epoch, "last")
            if config.checkpoint_every and epoch % config.checkpoint_every == 0:
                save(payload(state), epoch, str(epoch))
            epochs_run += 1
    finally:
        scalars.close()

    log.info(f"Best l1 cd model in epoch {best_epoch_l1}, the minimum l1 cd is"
             f" {best_cd_l1 * 1e3}")
    return {"best_epoch": best_epoch_l1, "best_cd": best_cd_l1, "epochs_run": epochs_run}
