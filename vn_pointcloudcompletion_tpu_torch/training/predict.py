"""Batch inference: raw partial PLYs in, dense completion PLYs out.

Port of ``training/predict.py``: point it at a ``.ply`` file or a directory
of them and it writes ``<stem>_completion.ply`` (and, on request,
``<stem>_coarse.ply``) for each input.  Inputs are resampled to the model's
2048-point contract with ``np.random.default_rng(config.seed)`` and run in
``batch_size`` chunks; the last chunk is padded to the full batch and the
padding rows are dropped on write.
"""

from __future__ import annotations

import logging
import os
from typing import List

import numpy as np
import torch

from vn_pointcloudcompletion_tpu_torch.data.ply import read_ply_points, write_ply_points
from vn_pointcloudcompletion_tpu_torch.data.shapenet import N_PARTIAL, random_sample
from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
from vn_pointcloudcompletion_tpu_torch.training.checkpoint import load_model
from vn_pointcloudcompletion_tpu_torch.utils.config import Config
from vn_pointcloudcompletion_tpu_torch.utils.device import resolve_device

log = logging.getLogger("test")


def _collect_inputs(input_path: str) -> List[str]:
    if os.path.isdir(input_path):
        return sorted(
            os.path.join(input_path, f)
            for f in os.listdir(input_path)
            if f.endswith(".ply")
        )
    return [input_path]


def predict(config: Config, input_path: str, output_dir: str,
            save_coarse: bool = False, device="cuda") -> List[str]:
    """Complete every partial cloud under ``input_path``; returns the list
    of written completion files."""
    dev = resolve_device(device)
    paths = _collect_inputs(input_path)
    if not paths:
        raise FileNotFoundError(f"no .ply inputs under {input_path}")
    os.makedirs(output_dir, exist_ok=True)

    model = build_model(config)
    load_model(config.exp_dir, model)
    model.to(dev).eval()

    rng = np.random.default_rng(config.seed)
    bs = config.batch_size
    written: List[str] = []
    for start in range(0, len(paths), bs):
        chunk = paths[start : start + bs]
        clouds = [
            random_sample(read_ply_points(p).astype(np.float32), N_PARTIAL, rng)
            for p in chunk
        ]
        n_real = len(clouds)
        clouds += [clouds[-1]] * (bs - n_real)
        with torch.no_grad():
            coarse, fine = model(torch.from_numpy(np.stack(clouds)).to(dev))
        pred = (coarse if fine is None else fine).cpu().numpy()
        coarse_np = coarse.cpu().numpy()
        for i in range(n_real):
            stem = os.path.splitext(os.path.basename(chunk[i]))[0]
            out = os.path.join(output_dir, f"{stem}_completion.ply")
            write_ply_points(out, pred[i])
            written.append(out)
            if save_coarse and fine is not None:
                write_ply_points(
                    os.path.join(output_dir, f"{stem}_coarse.ply"), coarse_np[i])
        log.info(f"completed {start + n_real}/{len(paths)}")
    return written
