"""VN transformer blocks (port of ``vn_pointcloudcompletion_tpu/nn/attention.py``).

``VNAttention`` and ``VNBlock`` (reference ``models/transformer.py:25-106``
and ``models/pointr/vn_pointr.py:112-145``, ``:366-412``), the blocks of the
``vn_pointr`` encoder and of the attention fold decoder, in VN layout (B, C,
3, N).  Between blocks the reference keeps a "scalar layout" (B, N, 3C) that
flattens (C, 3) row-major; :func:`to_vn` and :func:`to_scalar` are its exact
reshapes (``x.transpose(1, 2).view(bs, -1, 3, n)`` and the inverse).

The products are plain ``torch.matmul``, as the JAX package leaves them to
XLA (bf16 ones under the bfloat16 policy: float32 sums, one rounding,
``nn/precision.py::matmul``).  The softmax runs in float32 as in JAX and is
cast back to the scores' dtype (bf16 under the policy), and in float64 for
a float64 input (a reference run; JAX rounds it through float32 even
then).  Dropout
and drop-path are rate 0 in every reference instantiation and are left
out, as are the reference attention's scalar ``qkv``/``proj`` maps, which
its VN forward never calls.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vn_pointcloudcompletion_tpu_torch.nn.precision import matmul, weak
from vn_pointcloudcompletion_tpu_torch.nn.vn import (
    VNLayerNorm,
    VNLinear,
    VNLinearLeakyReLU,
    mean_pool,
)
from vn_pointcloudcompletion_tpu_torch.ops.knn import vn_graph_feature


def to_vn(x: torch.Tensor) -> torch.Tensor:
    """(B, N, 3C) scalar layout -> (B, C, 3, N) VN layout."""
    b, n, c3 = x.shape
    return x.transpose(1, 2).reshape(b, c3 // 3, 3, n)


def to_scalar(x: torch.Tensor) -> torch.Tensor:
    """(B, C, 3, N) VN layout -> (B, N, 3C) scalar layout."""
    b, c, _, n = x.shape
    return x.reshape(b, c * 3, n).transpose(1, 2)


class VNAttention(nn.Module):
    """Per-head VN q/k/v projections (C -> P channels), scaled dot products
    over the flattened head vectors, a softmax over the keys, and a VN
    projection back to ``out_channels``.  The scale is ``qk_scale`` or
    ``(P // H) ** -0.5`` (JAX nn/attention.py:48-82)."""

    def __init__(self, in_channels: int, attn_channels: int, out_channels: int,
                 num_heads: int = 8, qk_scale: Optional[float] = None):
        super().__init__()
        self.proj_vnq = VNLinear(in_channels, attn_channels)
        self.proj_vnk = VNLinear(in_channels, attn_channels)
        self.proj_vnv = VNLinear(in_channels, attn_channels)
        self.proj_vn = VNLinear(attn_channels, out_channels)
        self.num_heads = num_heads
        self.scale = qk_scale or (attn_channels // num_heads) ** -0.5

    def forward(self, vn_x):
        b, _, _, n = vn_x.shape
        p, h = self.proj_vnq.map_to_feat.weight.shape[0], self.num_heads

        def split_heads(t):  # (B, P, 3, N) -> (B, H, N, 3P/H)
            t = t.reshape(b, h, p // h, 3, n)
            return t.permute(0, 1, 4, 2, 3).reshape(b, h, n, (p // h) * 3)

        q = split_heads(self.proj_vnq(vn_x))
        k = split_heads(self.proj_vnk(vn_x))
        v = split_heads(self.proj_vnv(vn_x))
        attn = matmul(q, k.transpose(-1, -2))
        attn = attn * weak(self.scale, attn)
        attn = torch.softmax(attn.to(torch.promote_types(attn.dtype, torch.float32)),
                             dim=-1).to(q.dtype)
        out = matmul(attn, v)  # (B, H, N, 3P/H)
        # (B, H, N, P/H, 3) -> (B, N, P, 3) -> (B, P, 3, N)
        out = out.permute(0, 2, 1, 3).reshape(b, n, p, 3).permute(0, 2, 3, 1)
        return self.proj_vn(out)


class VNBlock(nn.Module):
    """Pre-norm VN transformer block (JAX nn/attention.py:85-116): attention,
    with ``with_knn`` a kNN edge branch (``vn_graph_feature`` -> ``conv1`` ->
    mean over K, concatenated and mapped back by ``conv2``), then a two-layer
    VN MLP (``conv3``, ``conv4``), each around a residual."""

    def __init__(self, channels: int, attn_channels: int, num_heads: int = 8,
                 qk_scale: Optional[float] = None, with_knn: bool = False):
        super().__init__()
        c = channels
        self.norm1 = VNLayerNorm(c)
        self.attn = VNAttention(c, attn_channels, c, num_heads, qk_scale)
        if with_knn:
            self.conv1 = VNLinearLeakyReLU(2 * c, c)
            self.conv2 = VNLinear(2 * c, c)
        self.norm2 = VNLayerNorm(c)
        self.conv3 = VNLinearLeakyReLU(c, 2 * c)
        self.conv4 = VNLinearLeakyReLU(2 * c, c)

    def forward(self, vn_x, knn_idx: Optional[torch.Tensor] = None):
        norm_x = self.norm1(vn_x)
        x_1 = self.attn(norm_x)
        if knn_idx is not None:
            knn_f = vn_graph_feature(norm_x, norm_x, knn_idx)  # (B, 2C, 3, N, K)
            knn_f = mean_pool(self.conv1(knn_f))  # over K
            x_1 = self.conv2(torch.cat([x_1, knn_f], dim=1))
        vn_x = vn_x + x_1
        return vn_x + self.conv4(self.conv3(self.norm2(vn_x)))
