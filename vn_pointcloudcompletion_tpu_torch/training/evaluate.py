"""Test harness: per-category metric tables (port of ``training/evaluate.py``;
reference ``test.py:33-203``).

For each category: L1-CD (x1e3), L2-CD (x1e4), F-Score@0.01 (%) and voxel
IoU@64^3 (%), averaged over the test split.  Each batch is rotated by
``test_rotation`` (drawn from a ``torch.Generator`` seeded with
``config.seed + 1000``; the JAX package draws other matrices from the same
seed), completed, and scored on the device.  The EMD column (``--emd``) is
not ported yet.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from vn_pointcloudcompletion_tpu_torch.data.pipeline import BatchLoader, device_prefetch
from vn_pointcloudcompletion_tpu_torch.data.ply import write_ply_points
from vn_pointcloudcompletion_tpu_torch.data.shapenet import (
    CATEGORIES_PCN,
    CATEGORIES_PCN_NOVEL,
    ShapeNetPCN,
)
from vn_pointcloudcompletion_tpu_torch.data.synthetic import SyntheticCompletionDataset
from vn_pointcloudcompletion_tpu_torch.metrics.metrics import f_score_from_dists, voxel_iou
from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
from vn_pointcloudcompletion_tpu_torch.ops.chamfer import chamfer_distance
from vn_pointcloudcompletion_tpu_torch.ops.rotations import rotate_points, sample_rotation
from vn_pointcloudcompletion_tpu_torch.training.checkpoint import load_model
from vn_pointcloudcompletion_tpu_torch.utils.config import Config
from vn_pointcloudcompletion_tpu_torch.utils.device import resolve_device

log = logging.getLogger("test")


@torch.no_grad()
def metric_step(model, partial, complete, rot: Optional[torch.Tensor]):
    """Rotate, complete and score one batch -> (per-sample metrics, pred)."""
    if rot is not None:
        partial = rotate_points(partial, rot)
        complete = rotate_points(complete, rot)
    coarse, fine = model(partial, rot)
    pred = coarse if fine is None else fine
    d1, d2, _, _ = chamfer_distance(pred, complete)
    out = {
        "l1": (torch.sqrt(d1).mean(1) + torch.sqrt(d2).mean(1)) / 2,
        "l2": d1.mean(1) + d2.mean(1),
        "f": f_score_from_dists(d1, d2, 0.01),
        "iou": voxel_iou(pred, complete),
    }
    return out, pred


def test_single_category(config: Config, model, category: str,
                         generator: torch.Generator, device: torch.device,
                         save_dir: Optional[str] = None) -> Dict[str, float]:
    if config.dataset == "synthetic":
        dataset = SyntheticCompletionDataset(
            config.extra.get("synthetic_test_samples", 16), seed=config.seed + 2,
            n_partial=config.extra.get("synthetic_n_partial", 2048),
            n_complete=config.extra.get("synthetic_n_complete", 16384),
        )
    else:
        split = "test_novel" if category in CATEGORIES_PCN_NOVEL else "test"
        dataset = ShapeNetPCN(os.path.join(config.data_path, "PCN"), split, category)
    loader = BatchLoader(dataset, config.batch_size, shuffle=False,
                         num_workers=config.num_workers, drop_last=False)
    totals: Dict[str, float] = {}
    count = 0
    for p, c in device_prefetch(loader, device):
        rot = sample_rotation(generator, config.test_rotation, p.shape[0])
        out, pred = metric_step(model, p, c, None if rot is None else rot.to(device))
        for key, val in out.items():
            totals[key] = totals.get(key, 0.0) + float(val.sum())
        if save_dir is not None:
            pred_np = pred.cpu().numpy()
            for j in range(pred_np.shape[0]):
                write_ply_points(
                    os.path.join(save_dir, f"{count + j:04d}.ply"), pred_np[j])
        count += p.shape[0]
    return {k: v / max(count, 1) for k, v in totals.items()}


def evaluate(config: Config, save: bool = False,
             categories: Optional[List[str]] = None, with_emd: bool = False,
             device="cuda") -> Dict[str, Dict[str, float]]:
    """Evaluate model_best (else model_last) over the test split and print
    the reference's table."""
    if with_emd:
        raise NotImplementedError(
            "the EMD metric (--emd) is not ported yet (ROADMAP.md, queue 1, item 5)")
    dev = resolve_device(device)
    model = build_model(config)
    load_model(config.exp_dir, model)
    model.to(dev).eval()
    generator = torch.Generator().manual_seed(config.seed + 1000)

    if categories is None:
        categories = (
            ["synthetic"] if config.dataset == "synthetic" else list(CATEGORIES_PCN)
        )
    results: Dict[str, Dict[str, float]] = {}
    header = "{:20s}{:>12s}{:>12s}{:>16s}{:>12s}".format(
        "Category", "L1_CD(1e-3)", "L2_CD(1e-4)", "FScore-0.01(%)", "iou(%)"
    )
    log.info(header)
    print(header)
    for category in categories:
        save_dir = None
        if save:
            save_dir = os.path.join(config.exp_dir, "test", category, "output")
            os.makedirs(save_dir, exist_ok=True)
        res = test_single_category(config, model, category, generator, dev, save_dir)
        if not res:
            log.info(f"{category:20s} (no test samples — skipped)")
            continue
        results[category] = res
        row = _format_row(category, res)
        log.info(row)
        print(row)

    if not results:
        raise FileNotFoundError("no test samples found for any category")
    keys = next(iter(results.values())).keys()
    avg = {k: float(np.mean([r[k] for r in results.values()])) for k in keys}
    results["average"] = avg
    row = _format_row("average", avg)
    log.info(row)
    print(row)
    return results


def _format_row(name: str, res: Dict[str, float]) -> str:
    return "{:20s}{:>12.4f}{:>12.4f}{:>16.4f}{:>12.4f}".format(
        name, res["l1"] * 1e3, res["l2"] * 1e4, res["f"] * 1e2, res["iou"] * 1e2
    )
