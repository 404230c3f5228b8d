"""ShapeNet-PCN dataset (port of ``data/shapenet.py``; reference
``dataset/shapenet.py:13-102``).

List-file driven: ``{split}.list`` holds ``category_id/model_id`` lines.
Training partials have 8 rendered views, one picked at random per access;
partial clouds are permutation-resampled to 2048 points, complete clouds to
16384 (short clouds padded by resampling).  Sampling draws from a generator
keyed on (seed, epoch, index), so it does not depend on worker order.
``process_index`` of ``process_count`` reads its own strided share of the
model list, truncated to equal shares (JAX's rule for the hosts of a
multi-host run).  The ranks of ``--mesh`` run on one host, one JAX
process: each reads the whole list and takes its rows of every global
batch (``data/pipeline.py``).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from vn_pointcloudcompletion_tpu_torch.data.ply import read_ply_points

CAT2ID = {
    # seen categories
    "airplane": "02691156",
    "cabinet": "02933112",
    "car": "02958343",
    "chair": "03001627",
    "lamp": "03636649",
    "sofa": "04256520",
    "table": "04379243",
    "vessel": "04530566",
    # aliases
    "boat": "04530566",
    "couch": "04256520",
    "dresser": "02933112",
    "watercraft": "04530566",
    # unseen categories
    "bus": "02924116",
    "bed": "02818832",
    "bookshelf": "02871439",
    "bench": "02828884",
    "guitar": "03467517",
    "motorbike": "03790512",
    "skateboard": "04225987",
    "pistol": "03948459",
}

CATEGORIES_PCN = [
    "airplane", "cabinet", "car", "chair", "lamp", "sofa", "table", "vessel",
]
CATEGORIES_PCN_NOVEL = [
    "bus", "bed", "bookshelf", "bench", "guitar", "motorbike", "skateboard",
    "pistol",
]

N_PARTIAL = 2048
N_COMPLETE = 16384


def random_sample(pc: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    """Permutation-sample to exactly n points, padding by resampling if short."""
    idx = rng.permutation(pc.shape[0])
    if idx.shape[0] < n:
        idx = np.concatenate([idx, rng.integers(0, pc.shape[0], n - idx.shape[0])])
    return pc[idx[:n]]


class ShapeNetPCN:
    """ShapeNet-PCN: 28974 train / 800 valid / 1200 test models."""

    def __init__(self, dataroot: str, split: str, category: str = "all",
                 seed: int = 0, process_index: int = 0, process_count: int = 1):
        if split not in ("train", "valid", "test", "test_novel"):
            raise ValueError(f"unknown split {split!r}")
        self.split = split
        self._seed = seed
        self._epoch = 0

        with open(os.path.join(dataroot, f"{split}.list")) as f:
            lines = f.read().splitlines()
        if category != "all":
            prefix = CAT2ID[category]
            lines = [ln for ln in lines if ln.startswith(prefix)]
        # one share a process, all of one size: a process with more batches
        # than the others would wait for them in a collective forever
        per_proc = len(lines) // max(process_count, 1)
        lines = lines[process_index::process_count][:per_proc]

        self.partial_paths: List[str] = []
        self.complete_paths: List[str] = []
        for line in lines:
            cat, model_id = line.split("/")
            name = model_id + ("_{}.ply" if split == "train" else ".ply")
            self.partial_paths.append(
                os.path.join(dataroot, split, "partial", cat, name))
            self.complete_paths.append(
                os.path.join(dataroot, split, "complete", cat, model_id + ".ply"))

    def __len__(self) -> int:
        return len(self.complete_paths)

    def set_epoch(self, epoch: int) -> None:
        """Advance the sampling stream (view pick / subsampling) per epoch."""
        self._epoch = epoch

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(
            (self._seed * 1_000_003 + self._epoch) * 2_654_435_761 + index
        )
        partial_path = self.partial_paths[index]
        if self.split == "train":
            partial_path = partial_path.format(int(rng.integers(0, 8)))
        partial = random_sample(read_ply_points(partial_path), N_PARTIAL, rng)
        complete = random_sample(
            read_ply_points(self.complete_paths[index]), N_COMPLETE, rng
        )
        return partial.astype(np.float32), complete.astype(np.float32)
