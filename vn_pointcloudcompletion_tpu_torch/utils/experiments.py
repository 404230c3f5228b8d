"""Experiment directories and logging (port of ``utils/experiments.py``;
reference ``utils/experiments.py:52-171``).

A new run gets ``<OUTPUT_DIR>/MM-DD_<name>_NNN/`` with ``models/``,
``optimizer/``, ``train/`` and ``val/``, numbered after the runs of the same
name and day that exist.  A run branched from another run's numbered
checkpoint (``-from``) starts with a copy of that checkpoint pair.
"""

from __future__ import annotations

import logging
import os
import shutil
import sys
from datetime import datetime
from typing import Iterable

from vn_pointcloudcompletion_tpu_torch.utils.config import Config, output_dir

FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
LOGGERS = ("train", "dataset", "test")


class _Console(logging.StreamHandler):
    """Console output to whatever ``sys.stderr`` is when a record comes."""

    def emit(self, record):
        self.stream = sys.stderr
        super().emit(record)


def configure_logging() -> None:
    """Console output at INFO for the named loggers, once per process."""
    for name in LOGGERS:
        log = logging.getLogger(name)
        log.setLevel(logging.INFO)
        log.propagate = False
        if not any(isinstance(h, _Console) for h in log.handlers):
            handler = _Console()
            handler.setFormatter(logging.Formatter(FORMAT))
            log.addHandler(handler)


def add_file_handler(log_path: str, names: Iterable[str] = LOGGERS) -> logging.Handler:
    """Also write the named loggers to ``log_path``; returns the handler, for
    :func:`remove_handler` when the command ends."""
    handler = logging.FileHandler(log_path)
    handler.setFormatter(logging.Formatter(FORMAT))
    for name in names:
        logging.getLogger(name).addHandler(handler)
    return handler


def remove_handler(handler: logging.Handler, names: Iterable[str] = LOGGERS) -> None:
    for name in names:
        logging.getLogger(name).removeHandler(handler)
    handler.close()


def get_num_params_total(module) -> int:
    """Total parameter count of a module (reference :299-302)."""
    return sum(p.numel() for p in module.parameters())


def get_num_params(model) -> dict:
    """Coarse/dense split by top-level submodule (reference :304-318): the
    encoder's share, and the whole model's."""
    total = get_num_params_total(model)
    decoder = getattr(model, "decoder", None)
    dense = 0 if decoder is None else get_num_params_total(decoder)
    return {"coarse": total - dense, "dense": total}


def create_experiment(config: Config) -> Config:
    """Create the next ``MM-DD_<name>_NNN`` run dir and point the config at it.

    When ``config.checkpoint`` is set (``-from N`` / ``-from best``), the
    pair ``models/model_{N}.pth`` and ``optimizer/optim_{N}.pth`` is copied
    from the source run (the ``config.exp_dir`` of its loaded snapshot) into
    the new run dir: the reference's branch-from-epoch (reference
    :154-166, JAX ``utils/experiments.py:80-123``)."""
    experiment_name = f"{datetime.now().strftime('%m-%d')}_{config.name}"
    out = output_dir()
    os.makedirs(out, exist_ok=True)
    prev = [-1]
    for entry in os.listdir(out):
        if entry[:-4] == experiment_name:  # strips "_NNN"
            try:
                prev.append(int(entry[len(experiment_name) + 1:]))
            except ValueError:
                pass
    run_name = f"{experiment_name}_{max(prev) + 1:03d}"
    exp_dir = os.path.join(out, run_name)
    pair = []
    if config.checkpoint:
        name = str(config.checkpoint)
        for sub, fname in (("models", f"model_{name}.pth"), ("optimizer", f"optim_{name}.pth")):
            src = os.path.join(config.exp_dir, sub, fname)
            if not os.path.isfile(src):
                raise FileNotFoundError(
                    f"-from {name}: {src} not found — numbered checkpoints are "
                    "written when the source run sets checkpoint_every > 0")
            pair.append((src, os.path.join(exp_dir, sub, fname)))
    for sub in ("", "models", "optimizer", "train", "val"):
        os.makedirs(os.path.join(exp_dir, sub), exist_ok=True)
    for src, dst in pair:
        shutil.copy(src, dst)
    config.run_name = run_name
    config.exp_dir = exp_dir
    return config
