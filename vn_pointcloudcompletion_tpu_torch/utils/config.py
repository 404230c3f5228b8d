"""Config system — JSON file <-> dataclass with the reference's exact field names.

The port's own copy of ``vn_pointcloudcompletion_tpu/utils/config.py``: the
two packages read the same ``config.json`` fields.  Mirrors ``utils/experiments.py:17-49`` (load root ``config.json`` or
``<exp_dir>/config.json`` on resume) and ``:90-100`` (snapshot into the
experiment dir), plus the ``.env``-style ``OUTPUT_DIR`` / ``DATA_PATH``
environment overrides (``main.py:10``, ``utils/experiments.py:14,47``) —
identical field names so reference experiment configs are drop-in.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class Config:
    # model selection (config.json of the reference, README.md:45-66)
    enc_type: str = "vn_pointnet"
    dec_type: str = "vn_foldingnet"
    only_coarse: bool = False
    # PoinTr-proper rebuild: run vn_pointr's 8-block transformer decoder and
    # condition the fold on its refined query features (the reference builds
    # this stack but leaves it dead behind only_coarse=True, model.py:23-24)
    pointr_decoder: bool = False
    num_coarse: int = 1024
    latent_dim: int = 2048
    enc_pretrained: str = "none"
    freeze_encoder: bool = False
    freeze_decoder: bool = False

    # losses
    coarse_loss: str = "cd"  # cd | emd | dcd
    dcd_opts: Dict[str, float] = field(default_factory=lambda: {"alpha": 200, "lambda": 0.5})

    # rotation augmentation
    rotation: str = "none"  # none | canonical | z | so3
    val_rotation: str = "so3"
    test_rotation: str = "so3"

    # optimisation
    batch_size: int = 12
    lr: float = 1e-4
    max_epochs: int = 400
    # Global-norm gradient clipping, applied when > 0.  The reference ships
    # the field but comments the clipping call out (train.py:172), so its
    # effective behaviour — and our default — is 0 (off).  Unlike the
    # reference, a non-zero value here really clips (no silent no-op knobs).
    clip_gradient: float = 0.0

    # data
    category: str = "all"
    data_path: str = "./data/"
    data_type: str = "shapenet"
    num_workers: int = 8

    # bookkeeping
    # snapshot schema version: bumped to 2 when clip_gradient went live
    # (earlier snapshots carried a no-op default of 0.5; see load_config)
    config_version: int = 2
    name: str = "experiment"
    run_name: str = ""
    exp_dir: str = ""
    # branch-from-checkpoint: epoch number or "best"/"last" (reference
    # main.py:40-46 `-from`); 0 = off
    checkpoint: Any = 0
    # save numbered model_{epoch}/optim_{epoch} checkpoints every N epochs
    # (0 = only best/last, the reference's behaviour); numbered checkpoints
    # are what `-from <epoch>` branches from
    checkpoint_every: int = 0
    # save model_last/optim_last every N epochs (1 = reference parity,
    # train.py:268; raise on hosts where the device->host pull is slow)
    checkpoint_last_every: int = 1
    log_frequency: int = 10
    overfit: bool = False

    # accepted-but-unused reference fields, kept for config-file parity
    VN: bool = False
    model: str = ""
    device: str = "tpu"
    use_cuda: bool = False

    # TPU-native additions (absent fields default; reference configs still load)
    seed: int = 0
    dtype: str = "float32"  # compute dtype for model matmuls: float32 | bfloat16
    remat: bool = False  # recompute the forward in backward; the port saves no peak memory
    mesh_shape: Optional[Dict[str, int]] = None  # e.g. {"data": 8}
    steps_per_epoch: Optional[int] = None  # override for synthetic data
    dataset: str = "shapenet"  # shapenet | synthetic

    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in names and k != "extra"}
        extra = {k: v for k, v in d.items() if k not in names}
        cfg = cls(**known)
        cfg.extra = extra
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        extra = d.pop("extra", {})
        d.update(extra)
        return d

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def output_dir() -> str:
    return os.environ.get("OUTPUT_DIR", "./experiments/")


def load_config(experiment_name: Optional[str] = None, root: str = ".") -> Config:
    """Load root ``config.json`` (new run) or an experiment's snapshot (resume)."""
    if experiment_name is None:
        config_path = os.path.join(root, "config.json")
    else:
        config_path = os.path.join(root, output_dir(), experiment_name, "config.json")
    with open(config_path) as f:
        raw = json.load(f)
    cfg = Config.from_dict(raw)
    if (
        experiment_name is not None
        and "config_version" not in raw
        and raw.get("clip_gradient") == 0.5
    ):
        # Snapshot written while clip_gradient was an accepted-but-unused
        # field with default 0.5.  Resuming must not silently switch on
        # clipping mid-trajectory — coerce to the run's actual behaviour.
        import logging

        logging.getLogger("train").warning(
            "config.json snapshot predates live gradient clipping; "
            "clip_gradient=0.5 was a no-op when this run trained — "
            "coercing to 0.0 (set config_version>=2 to clip on resume)"
        )
        cfg.clip_gradient = 0.0
    if "DATA_PATH" in os.environ:
        cfg.data_path = os.environ["DATA_PATH"]
    return cfg


def store_config(config: Config) -> None:
    """Snapshot the config into its experiment dir (``utils/experiments.py:90-100``)."""
    with open(os.path.join(config.exp_dir, "config.json"), "w") as f:
        json.dump(config.to_dict(), f, indent=4, sort_keys=True)
