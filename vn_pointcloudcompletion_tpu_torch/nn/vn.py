"""Vector Neuron layers of the flagship path, as ``torch.nn`` modules.

Port of the parts of ``vn_pointcloudcompletion_tpu/nn/vn.py`` that the
``vn_pointnet`` + ``vn_foldingnet`` pipeline runs, in train and eval mode.  Feature tensors
carry 3-vector channels in one of two layouts:

- ``vec`` (B, C, 3, N...), the reference's;
- ``plane`` (B, 3, C, N), coordinate planes, for the wide layers: a channel
  map is one batched matrix product, and the fused kernels read aligned
  planes.

Submodule and parameter names follow the reference's ``state_dict`` layout
(``map_to_feat.weight``, ``batchnorm.bn.running_var``, ...), so reference
checkpoints load as they are.  BatchNorm follows ``module.training``: in
train mode it normalises with the batch statistics and updates its running
buffers (torch's semantics), in eval mode it uses the running buffers.

Layers that have a kernel carry ``use_kernels`` (default True): where it is
set and the JAX package would take its Pallas kernel for the shape, the
layer calls the kernel's wrapper (the kernel on a CUDA tensor, its plain
version on a CPU tensor); otherwise it runs the plain PyTorch chain.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vn_pointcloudcompletion_tpu_torch.ops import vn_fused, vn_layer_fused
from vn_pointcloudcompletion_tpu_torch.ops.vn_fused import safe_sqrt

EPS = 1e-6  # models/vn_layers.py:10 of the reference
# flax's BatchNorm momentum, the weight of the old running value (torch's 0.1)
BN_MOMENTUM = 0.9


def safe_norm(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """L2 norm with a gradient of 0 (not NaN) at exactly-zero vectors."""
    return safe_sqrt((x * x).sum(dim, keepdim=keepdim))


def channel_linear(w: torch.Tensor, x: torch.Tensor, layout: str) -> torch.Tensor:
    """Apply an (out, in) channel map: over axis 2 of (B, 3, C, N) planes or
    over axis 1 of (B, C, ...) vec tensors."""
    if layout == "plane":
        return torch.matmul(w, x)
    return torch.einsum("oc,bc...->bo...", w, x)


def _leaky_reflect(p, d, negative_slope: float, dim: int):
    """The VN leaky ReLU: keep p where <p, d> >= 0, else remove its
    component along d; blend with ``negative_slope`` (vn_layers.py:38-43)."""
    dotprod = (p * d).sum(dim, keepdim=True)
    mask = (dotprod >= 0).to(p.dtype)
    d_norm_sq = (d * d).sum(dim, keepdim=True)
    reflected = p - (dotprod / (d_norm_sq + EPS)) * d
    return negative_slope * p + (1 - negative_slope) * (
        mask * p + (1 - mask) * reflected
    )


class VNLinear(nn.Module):
    """Channel-mixing linear on vector features (vn_layers.py:12-22)."""

    def __init__(self, in_channels: int, out_channels: int, layout: str = "vec"):
        super().__init__()
        self.map_to_feat = nn.Linear(in_channels, out_channels, bias=False)
        self.layout = layout

    def forward(self, x):
        return channel_linear(self.map_to_feat.weight, x, self.layout)


class VNLeakyReLU(nn.Module):
    """Learned direction, reflect the negative half (vn_layers.py:25-43);
    vec layout."""

    def __init__(self, in_channels: int, share_nonlinearity: bool = False,
                 negative_slope: float = 0.2):
        super().__init__()
        out = 1 if share_nonlinearity else in_channels
        self.map_to_dir = nn.Linear(in_channels, out, bias=False)
        self.negative_slope = negative_slope

    def forward(self, x):
        d = channel_linear(self.map_to_dir.weight, x, "vec")
        return _leaky_reflect(x, d, self.negative_slope, dim=2)


class _NormAffine(nn.Module):
    """BatchNorm on vector norms, folded to a per-channel affine (A, B) with
    ``norm_bn = A * norm + B`` (JAX nn/vn.py:218-276).

    torch ``BatchNorm`` semantics: in train mode the batch statistics
    normalise (biased variance) and the running buffers take the unbiased
    variance, ``running = 0.9 * running + 0.1 * batch``; in eval mode the
    running buffers normalise.  The statistics come either from ``norm``
    (B, C, ...) or, on the whole-layer kernel path, from ``moments=(mean,
    biased var)`` with the reduction's element ``count``.
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps

    def forward(self, norm: Optional[torch.Tensor] = None, moments=None,
                count: Optional[int] = None):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            if moments is not None:
                mean, var = moments
                cnt = count
            else:
                dims = (0,) + tuple(range(2, norm.ndim))
                mean = norm.mean(dims)
                var = (norm * norm).mean(dims) - mean * mean
                cnt = norm.numel() // norm.shape[1]
            with torch.no_grad():
                unbiased = var * (cnt / max(cnt - 1, 1))
                m = BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * unbiased)
        a = self.weight * torch.rsqrt(var + self.eps)
        return a, self.bias - mean * a


class VNBatchNorm(nn.Module):
    """BatchNorm on vector norms, rescaling the vectors (vn_layers.py:107-127);
    vec layout (B, C, 3, N...)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.bn = _NormAffine(num_features)

    def forward(self, x):
        ct = torch.promote_types(x.dtype, torch.float32)
        norm = safe_norm(x.to(ct), dim=2) + EPS  # (B, C, N...)
        a, b = self.bn(norm)
        shape = (1, -1) + (1,) * (norm.ndim - 2)
        norm_bn = a.reshape(shape) * norm + b.reshape(shape)
        return x * (norm_bn / norm).to(x.dtype).unsqueeze(2)


def bn_leaky(p, d, a, b, negative_slope: float, use_kernels: bool):
    """Folded BN + leaky reflection on (B, 3, C, N) planes: kernel A where the
    JAX package takes its Pallas kernel, else the plain chain."""
    if use_kernels and vn_fused.eligible(p):
        return vn_fused.fused_bn_leaky(p, d, a, b, negative_slope)
    return vn_fused.reference_bn_leaky_planes(p, d, a, b, negative_slope)


def plane_norms(p: torch.Tensor) -> torch.Tensor:
    """``|p| + EPS`` of (B, 3, C, N) planes, at least float32: (B, C, N)."""
    return safe_norm(p.to(torch.promote_types(p.dtype, torch.float32)), dim=1) + EPS


def layer_moments(x, w, pbias, training: bool) -> dict:
    """Arguments of ``_NormAffine`` for the whole-layer path: in train mode
    the batch moments of ``|W x + pbias| + EPS`` from kernel S (JAX
    nn/vn.py:457-466), in eval mode none."""
    if not training:
        return {}
    s1, s2 = vn_layer_fused.vn_layer_stats(x, w, pbias)
    cnt = x.shape[0] * x.shape[3]
    mean = s1 / cnt
    return {"moments": (mean, s2 / cnt - mean * mean), "count": cnt}


class VNLinearLeakyReLU(nn.Module):
    """Linear + norm-BatchNorm + leaky reflection (vn_layers.py:46-74).

    The direction map reads the input ``x``; the nonlinearity acts on the
    normalised ``p``, the reference's wiring.  In plane layout the layer
    takes kernel B/C (whole layer, with kernel S for the train-mode
    statistics) where ``layer_eligible`` holds and kernel A (BN + reflection
    after the products) where ``vn_fused.eligible`` holds; each kernel's
    backward is its own kernel.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 share_nonlinearity: bool = False, negative_slope: float = 0.2,
                 layout: str = "vec"):
        super().__init__()
        self.map_to_feat = nn.Linear(in_channels, out_channels, bias=False)
        d_out = 1 if share_nonlinearity else out_channels
        self.map_to_dir = nn.Linear(in_channels, d_out, bias=False)
        self.batchnorm = VNBatchNorm(out_channels)
        self.share_nonlinearity = share_nonlinearity
        self.negative_slope = negative_slope
        self.layout = layout
        self.use_kernels = True

    def forward(self, x, project_out: Optional[torch.Tensor] = None):
        """``project_out``: optional (1, C_out) weight of a trailing
        1-channel VNLinear; the whole-layer kernel contracts it in-kernel."""
        w, wd = self.map_to_feat.weight, self.map_to_dir.weight
        if self.layout == "plane":
            if self.use_kernels and vn_layer_fused.layer_eligible(
                x, w.shape[0], self.share_nonlinearity
            ):
                a, b = self.batchnorm.bn(**layer_moments(x, w, None, self.training))
                if project_out is not None:
                    return vn_layer_fused.vn_layer_fused_project(
                        x, w, wd, None, None, a, b, project_out.reshape(-1),
                        self.negative_slope,
                    )
                return vn_layer_fused.vn_layer_fused(
                    x, w, wd, None, None, a, b, self.negative_slope
                )
            p = torch.matmul(w, x)
            d = torch.matmul(wd, x)
            if self.share_nonlinearity:
                d = d.expand_as(p)
            a, b = self.batchnorm.bn(plane_norms(p) if self.training else None)
            out = bn_leaky(p, d, a, b, self.negative_slope, self.use_kernels)
        else:
            pd = channel_linear(torch.cat([w, wd], dim=0), x, "vec")
            p, d = pd[:, : w.shape[0]], pd[:, w.shape[0]:]
            p = self.batchnorm(p)
            out = _leaky_reflect(p, d, self.negative_slope, dim=2)
        if project_out is not None:
            out = channel_linear(project_out, out, self.layout)
        return out


class VNLinearAndLeakyReLU(nn.Module):
    """Linear -> optional norm-BatchNorm -> VNLeakyReLU (vn_layers.py:77-104);
    vec layout."""

    def __init__(self, in_channels: int, out_channels: int,
                 share_nonlinearity: bool = False, use_batchnorm: str = "norm",
                 negative_slope: float = 0.2):
        super().__init__()
        self.linear = VNLinear(in_channels, out_channels)
        self.batchnorm = (
            VNBatchNorm(out_channels) if use_batchnorm != "none" else None
        )
        self.leaky_relu = VNLeakyReLU(
            out_channels, share_nonlinearity, negative_slope
        )

    def forward(self, x):
        x = self.linear(x)
        if self.batchnorm is not None:
            x = self.batchnorm(x)
        return self.leaky_relu(x)
