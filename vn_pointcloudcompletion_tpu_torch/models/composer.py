"""The composed completion model (port of ``models/composer.py``).

The port has the flagship pipeline only so far: ``enc_type='vn_pointnet'`` with
``dec_type='vn_foldingnet'``, in the float32 compute policy.  Every other
choice raises ``NotImplementedError`` naming the ROADMAP.md item that brings
it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vn_pointcloudcompletion_tpu_torch.models.pcn import VNFoldingNet, VNPointNet
from vn_pointcloudcompletion_tpu_torch.utils.config import Config

_LATER = {
    "dgcnn_fps": "the DGCNN family (ROADMAP.md, queue 1, item 3)",
    "vn_dgcnn_fps": "the DGCNN family (ROADMAP.md, queue 1, item 3)",
    "vn_pointr": "vn_pointr (ROADMAP.md, queue 1, item 4)",
    "foldingnet": "the DGCNN family (ROADMAP.md, queue 1, item 3)",
    "attention_vn_foldingnet": "vn_pointr (ROADMAP.md, queue 1, item 4)",
}


class PCNNet(nn.Module):
    """Encoder + decoder (reference models/model.py; JAX composer.py:32-122).

    ``forward(xyz, rot)`` returns ``(coarse, fine)``, at least float32;
    ``fine`` is None when ``only_coarse``.
    """

    def __init__(self, enc_type: str = "vn_pointnet",
                 dec_type: str = "vn_foldingnet", num_coarse: int = 1024,
                 latent_dim: int = 2048, only_coarse: bool = False):
        super().__init__()
        if enc_type != "vn_pointnet":
            raise NotImplementedError(
                f"enc_type={enc_type!r} is not ported yet: "
                f"{_LATER.get(enc_type, 'unknown encoder')}")
        self.encoder = VNPointNet(num_coarse)
        self.only_coarse = only_coarse
        if not only_coarse:
            if dec_type != "vn_foldingnet":
                raise NotImplementedError(
                    f"dec_type={dec_type!r} is not ported yet: "
                    f"{_LATER.get(dec_type, 'unknown decoder')}")
            self.decoder = VNFoldingNet(num_coarse, latent_dim)

    def forward(self, xyz, rot=None):
        def f32(t):
            return t.to(torch.promote_types(t.dtype, torch.float32))

        coarse, feature_global = self.encoder(xyz)
        if self.only_coarse:
            return f32(coarse), None
        fine = self.decoder(coarse, feature_global, rot)
        return f32(coarse), f32(fine)

    def use_kernels_(self, enabled: bool = True) -> "PCNNet":
        """Take the CUDA kernels where eligible (True) or the plain PyTorch
        chain everywhere (False); the two give the same function."""
        for m in self.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = enabled
        return self


def init_weights_(model: nn.Module, seed: int) -> nn.Module:
    """Redraw every linear map from ``seed``: torch's ``nn.Linear`` default,
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), from an explicit generator.  BatchNorm
    stays at its identity init."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, m in sorted(model.named_modules(), key=lambda kv: kv[0]):
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.weight.shape[1])
                m.weight.copy_(
                    torch.rand(m.weight.shape, generator=g) * (2 * bound) - bound)
    return model


def build_model(config: Config) -> PCNNet:
    """PCNNet from a reference-compatible config, weights drawn from
    ``config.seed``."""
    if config.dtype != "float32":
        raise NotImplementedError(
            f"dtype={config.dtype!r}: the port runs the float32 compute policy; "
            "the bfloat16 policy is not ported yet (ROADMAP.md, queue 1, item 7)"
        )
    if getattr(config, "pointr_decoder", False):
        raise NotImplementedError(
            "pointr_decoder needs vn_pointr (ROADMAP.md, queue 1, item 4)")
    model = PCNNet(config.enc_type, config.dec_type, config.num_coarse,
                   config.latent_dim, config.only_coarse)
    return init_weights_(model, config.seed)
