"""Scalar building blocks of the DGCNN encoder and the FoldingNet decoder
(port of ``models/common.py``), channel-first (B, C, N[, K]).

Parameter names and shapes follow the torch layers of the reference
(``Conv1d``/``Conv2d`` with kernel 1, ``BatchNorm1d``, ``GroupNorm``,
``Linear``), so reference checkpoints load as they are; the computation is
that of the JAX modules:

- :class:`BatchNormCh` is flax's ``nn.BatchNorm``, not torch's: the batch
  variance is ``E[x^2] - E[x]^2`` clipped at 0, and the running variance
  takes that BIASED variance (``ra = 0.9 ra + 0.1 var``).  The VN layers'
  ``_NormAffine`` differs on purpose (unbiased running variance).
- :class:`GroupNormCh` normalises with the biased variance, eps 1e-5.

Under the bfloat16 compute policy the kernel-1 convolutions are bf16 channel
maps (JAX ``ConvCh`` goes through ``_channel_linear``; bias cast to bf16);
the normalisations compute in float32 and, like flax's and jnp's promotion
with float32 parameters, hand float32 on; a dense layer meets a bf16 input
in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from vn_pointcloudcompletion_tpu_torch.nn.vn import BN_MOMENTUM, channel_linear


class ConvCh(nn.Module):
    """Kernel-1 convolution over axis 1 of (B, C, ...): ``weight`` is
    (out, in) followed by ``kernel_dims`` unit axes, as torch's Conv1d (1)
    or Conv2d (2) stores it."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 kernel_dims: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((out_channels, in_channels) + (1,) * kernel_dims))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def forward(self, x):
        w = self.weight.reshape(self.weight.shape[0], self.weight.shape[1])
        y = channel_linear(w, x, "vec")
        if self.bias is not None:
            y = y + self.bias.reshape((1, -1) + (1,) * (y.ndim - 2)).to(y.dtype)
        return y


class BatchNormCh(nn.Module):
    """BatchNorm over axis 1 with flax's ``nn.BatchNorm`` semantics (see the
    module docstring); train or eval from ``module.training``."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            dims = (0,) + tuple(range(2, x.ndim))
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean(dims)
            var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(torch.promote_types(x.dtype, torch.float32))


class GroupNormCh(nn.Module):
    """GroupNorm over axis 1 of (B, C, ...): per sample and group, mean and
    biased variance over the group's channels and every spatial axis."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        b, c = x.shape[:2]
        xg = x.reshape((b, self.num_groups, c // self.num_groups) + x.shape[2:])
        xg = xg.to(torch.promote_types(x.dtype, torch.float32))
        dims = tuple(range(2, xg.ndim))
        mean = xg.mean(dims, keepdim=True)
        var = ((xg - mean) ** 2).mean(dims, keepdim=True)
        xn = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape).to(x.dtype)
        shape = (1, c) + (1,) * (x.ndim - 2)
        return xn * self.weight.reshape(shape) + self.bias.reshape(shape)


class DenseTorch(nn.Linear):
    """torch-initialised dense layer over the last axis (JAX ``DenseTorch``);
    a bf16 input is promoted to the weight's float32 first."""

    def forward(self, x):
        return super().forward(x.to(torch.promote_types(x.dtype, self.weight.dtype)))
