"""The composed completion model (port of ``models/composer.py``).

Encoders ``vn_pointnet``, ``vn_dgcnn_fps``, ``dgcnn_fps`` and ``vn_pointr``
(at ``num_coarse`` 448 only, as in JAX); decoders ``vn_foldingnet``,
``attention_vn_foldingnet`` and ``foldingnet``; ``num_coarse`` 448
included.  ``pointr_decoder`` raises ``NotImplementedError`` naming the
ROADMAP.md item that brings it.

The compute dtype is not the model's: the forward reads the process-global
policy of ``nn/precision.py`` (float32 by default, bfloat16 inside
``compute_dtype_scope(torch.bfloat16)``), and parameters stay float32 under
either.  ``build_model`` therefore accepts a config's ``dtype`` of
``bfloat16`` and sets nothing.  Who sets the policy: ``bench``-style
callers (``chip_smoke.py`` phase 12, as the JAX package's ``bench.py``
does for every entry) and ``train`` (``training/trainer.py``, from the
config's ``dtype``, as JAX ``trainer.py:77`` does).  The CLI's ``test`` and
``predict`` never set it, so they run float32 on such a config, as the JAX
package's ``main.py`` runs them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vn_pointcloudcompletion_tpu_torch.models.common import ConvCh
from vn_pointcloudcompletion_tpu_torch.models.dgcnn import DGCNNfps, TransformNet, VNDGCNNfps
from vn_pointcloudcompletion_tpu_torch.models.pcn import (
    AttentionVNFoldingNet,
    FoldingNet,
    VNFoldingNet,
    VNPointNet,
    _ScalarSplitFoldLayer,
)
from vn_pointcloudcompletion_tpu_torch.models.pointr import VNPCTransformer
from vn_pointcloudcompletion_tpu_torch.nn.precision import from_config_dtype
from vn_pointcloudcompletion_tpu_torch.utils.config import Config

ENCODERS = {"vn_pointnet": VNPointNet, "vn_dgcnn_fps": VNDGCNNfps, "dgcnn_fps": DGCNNfps}
VN_DECODERS = {"vn_foldingnet": VNFoldingNet, "attention_vn_foldingnet": AttentionVNFoldingNet}


class PCNNet(nn.Module):
    """Encoder + decoder (reference models/model.py; JAX composer.py:32-122).

    ``forward(xyz, rot)`` returns ``(coarse, fine)``, at least float32 (bf16
    under the bfloat16 policy promotes; float64 passes through);
    ``fine`` is None when ``only_coarse``.  At ``num_coarse == 448`` the
    decoder folds the 224 predicted points and ``coarse`` is those with the
    224 FPS points of the input appended.  The decoder's first layer takes
    the width of the encoder's global feature (the config's ``latent_dim``
    reaches no model: the JAX decoders ignore it too).
    """

    def __init__(self, enc_type: str = "vn_pointnet",
                 dec_type: str = "vn_foldingnet", num_coarse: int = 1024,
                 only_coarse: bool = False):
        super().__init__()
        if enc_type == "vn_pointr":  # JAX composer.py:71-76
            if num_coarse != 448:
                raise ValueError(
                    "enc_type='vn_pointr' requires num_coarse=448 (224 predicted + 224 FPS; "
                    "reference model.py:23-24 contract)")
            self.encoder = VNPCTransformer()
        elif enc_type in ENCODERS:
            self.encoder = ENCODERS[enc_type](num_coarse)
        else:
            raise ValueError(f"encoder type {enc_type} not supported")
        self.only_coarse = only_coarse
        if not only_coarse:
            glob = self.encoder.global_shape
            if dec_type in VN_DECODERS:
                if len(glob) != 2:
                    raise ValueError(f"dec_type={dec_type!r} needs a vector global "
                                     f"feature; enc_type={enc_type!r} gives {glob}")
                self.decoder = VN_DECODERS[dec_type](num_coarse, glob[0])
            elif dec_type == "foldingnet":
                self.decoder = FoldingNet(num_coarse, math.prod(glob))
            else:
                raise ValueError(f"decoder type {dec_type} not supported")

    def forward(self, xyz, rot=None):
        def f32(t):
            return t.to(torch.promote_types(t.dtype, torch.float32))

        coarse, feature_global = self.encoder(xyz)
        folded = coarse
        if self.encoder.fps_tail:
            folded, coarse = coarse
        if self.only_coarse:
            return f32(coarse), None
        fine = self.decoder(folded, feature_global, rot)
        return f32(coarse), f32(fine)

    def use_kernels_(self, enabled: bool = True) -> "PCNNet":
        """Take the CUDA kernels where eligible (True) or the plain PyTorch
        chain everywhere (False); the two give the same function."""
        for m in self.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = enabled
        return self


def init_weights_(model: nn.Module, seed: int) -> nn.Module:
    """Redraw every linear map and convolution from ``seed``: torch's
    default, weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), from an
    explicit generator.  Normalisation layers stay at their identity init.
    A ``TransformNet`` keeps its identity alignment (weight 0, bias the
    identity).  A ``vn_pointr`` encoder is then redrawn as the reference's
    ``_init_weights`` pass does (vn_pointr.py:541-553; JAX
    ``reinit_pointr_params``, training/state.py:86-93): every linear map
    trunc_normal(std 0.02) on +-2 std, from the same generator; it holds no
    bias, and its norms keep scale 1 and bias 0."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, m in sorted(model.named_modules(), key=lambda kv: kv[0]):
            if isinstance(m, (nn.Linear, ConvCh, _ScalarSplitFoldLayer)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                for p in (m.weight, m.bias):
                    if p is not None:
                        p.copy_(torch.rand(p.shape, generator=g) * (2 * bound) - bound)
        for m in model.modules():
            if isinstance(m, TransformNet):
                m.reset_transform()
        encoder = getattr(model, "encoder", None)
        if isinstance(encoder, VNPCTransformer):
            for _, m in sorted(encoder.named_modules(), key=lambda kv: kv[0]):
                if isinstance(m, nn.Linear):
                    nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=g)
    return model


def build_model(config: Config) -> PCNNet:
    """PCNNet from a reference-compatible config, weights drawn from
    ``config.seed``.  ``config.dtype`` (float32 or bfloat16) is checked and
    not applied: see the module docstring."""
    from_config_dtype(config.dtype)  # a KeyError for any other name
    if getattr(config, "pointr_decoder", False):
        raise NotImplementedError(
            "pointr_decoder (the vn_pointr decoder stack) is not ported yet "
            "(ROADMAP.md, queue 1, item 4b)")
    model = PCNNet(config.enc_type, config.dec_type, config.num_coarse, config.only_coarse)
    return init_weights_(model, config.seed)
