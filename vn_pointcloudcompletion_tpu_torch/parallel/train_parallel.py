"""Data-parallel train and eval steps over ranks (port of
``parallel/train_parallel.py``).

JAX jits the single-device step with the state replicated and the batch
sharded on the ``data`` axis, so its sharded step is its single-device step
over the global batch.  The port runs the single-device step of
``training/steps.py`` on every rank over the rank's rows, and makes it the
step over the global batch:
- every train-mode BatchNorm normalises with the global batch's statistics
  (``parallel/mesh.py::global_sums``);
- the rotations are drawn for the global batch from the generator every
  rank holds in the same state, and each rank takes its rows
  (``training/steps.py::_rotate``), as JAX draws them from its replicated
  key;
- after the backward, one all-reduce averages the gradients and the losses
  over ranks: each rank's loss is the mean over an equal local batch, so the
  average is the global batch's mean (``parallel/mesh.py::mean_over_ranks``);
  the non-finite guard decides on the averaged values, so every rank takes
  the same decision, and every rank applies the same update;
- the validation sums are summed over ranks.

:func:`train_on_ranks` starts the ranks of one host (``--mesh``).
"""

from __future__ import annotations

import functools
import os
from datetime import timedelta
from typing import Optional

from vn_pointcloudcompletion_tpu_torch.parallel.mesh import (
    DEFAULT_TIMEOUT,
    Mesh,
    destroy_mesh,
    free_port,
    make_mesh,
    replicated,
    spawn_ranks,
)
from vn_pointcloudcompletion_tpu_torch.training.state import TrainState
from vn_pointcloudcompletion_tpu_torch.training.steps import eval_step, train_step
from vn_pointcloudcompletion_tpu_torch.utils.config import Config


def check_batch(config: Config, world: int) -> int:
    """The local batch ``batch_size // world``; raises as JAX does where the
    global batch does not divide over the ranks."""
    if config.batch_size % world != 0:
        raise ValueError(
            f"batch_size={config.batch_size} must be divisible by the mesh's "
            f"'data' axis size {world}")
    return config.batch_size // world


def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Give every rank rank 0's parameters, buffers, Adam state and count of
    accepted steps (JAX replicates the state over the mesh)."""
    import torch

    model, opt = state.model, state.optimizer
    tensors = [*model.parameters(), *model.buffers()]
    for p in (p for g in opt.param_groups for p in g["params"]):
        tensors += [t for _, t in sorted(opt.state.get(p, {}).items()) if torch.is_tensor(t)]
    step = torch.tensor([state.step], dtype=torch.int64)
    replicated(mesh, [*tensors, step])
    state.step = int(step)
    return state


def make_parallel_steps(config: Config, mesh: Mesh):
    """(train_step, eval_step) over the mesh's ranks, the arguments of
    ``training/steps.py``'s; raises where the batch does not divide."""
    check_batch(config, mesh.world)
    return (functools.partial(train_step, mesh=mesh),
            functools.partial(eval_step, mesh=mesh))


def train_on_ranks(config: Config, resume: bool, device: str, world: int,
                   log_path: Optional[str] = None, timeout: timedelta = DEFAULT_TIMEOUT,
                   deadline: Optional[float] = None) -> dict:
    """Train data-parallel on ``world`` ranks of this host: one process a
    card (``cuda:{rank}``), or gloo processes on the CPU; returns rank 0's
    summary.  ``timeout``: every collective's; ``deadline``: the whole
    run's, in seconds (none by default).  At world size 1 the group is set
    up in this process.  A rank that fails ends the others and raises
    here."""
    import torch.multiprocessing as mp

    from vn_pointcloudcompletion_tpu_torch.training.trainer import train

    check_batch(config, world)  # before any rank starts
    if world == 1:
        mesh = make_mesh(0, 1, f"tcp://localhost:{free_port()}", device, timeout=timeout)
        try:
            return train(config, resume, mesh=mesh)
        finally:
            destroy_mesh()
    summaries = mp.get_context("spawn").SimpleQueue()
    spawn_ranks(_rank_main, world, config, resume, device, log_path, timeout, summaries,
                deadline=deadline)
    return summaries.get()


def _rank_main(rank, world, init, config, resume, device, log_path, timeout, summaries):
    """One rank of :func:`train_on_ranks`: rank 0 logs (console and
    ``log_path``) and returns the summary; the others log warnings only."""
    import logging

    from vn_pointcloudcompletion_tpu_torch.training.trainer import train
    from vn_pointcloudcompletion_tpu_torch.utils.experiments import (
        LOGGERS,
        add_file_handler,
        configure_logging,
        remove_handler,
    )

    import torch

    if torch.device(device).type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    configure_logging()
    handler = None
    if rank == 0 and log_path:
        handler = add_file_handler(log_path)
    elif rank:
        for name in LOGGERS:
            logging.getLogger(name).setLevel(logging.WARNING)
    mesh = make_mesh(rank, world, init, device, timeout=timeout)
    try:
        summary = train(config, resume, mesh=mesh)
    finally:
        destroy_mesh()
        if handler is not None:
            remove_handler(handler)
    if rank == 0:
        summaries.put(summary)
