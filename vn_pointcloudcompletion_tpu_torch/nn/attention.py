"""Transformer blocks (port of ``vn_pointcloudcompletion_tpu/nn/attention.py``).

The VN blocks ``VNAttention``, ``VNBlock`` and ``VNDecoderBlock``
(reference ``models/transformer.py:25-106`` and
``models/pointr/vn_pointr.py:112-145``, ``:250-326``, ``:366-412``), of the
``vn_pointr`` encoder, its decoder stack and the attention fold decoder, in
VN layout (B, C, 3, N); and the scalar PoinTr blocks ``Mlp``,
``ScalarAttention``, ``CrossAttention``, ``Block`` and ``DecoderBlock``
(``vn_pointr.py:93-248``, ``:328-364``) on (B, N, C).  Between blocks the
reference keeps a "scalar layout" (B, N, 3C) that flattens (C, 3)
row-major; :func:`to_vn` and :func:`to_scalar` are its exact reshapes
(``x.transpose(1, 2).view(bs, -1, 3, n)`` and the inverse).

The products are plain ``torch.matmul``, as the JAX package leaves them to
XLA (bf16 ones under the bfloat16 policy: float32 sums, one rounding,
``nn/precision.py::matmul``).  The softmax runs in float32 as in JAX and is
cast back to the scores' dtype (bf16 under the policy), and in float64 for
a float64 input (a reference run; JAX rounds it through float32 even
then).  The scalar maps are flax ``Dense`` and ``LayerNorm`` in JAX, whose
float32 parameters promote a bf16 input to float32: :class:`Dense` and
:class:`LayerNorm` do the same, so under the policy the scalar parts run
float32 as JAX's do, and only the VN layers' channel maps take bf16.
Dropout and drop-path are rate 0 in every reference instantiation and are
left out, as are the reference attention's scalar ``qkv``/``proj`` maps
inside the VN attention, which its VN forward never calls.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vn_pointcloudcompletion_tpu_torch.models.common import DenseTorch as Dense
from vn_pointcloudcompletion_tpu_torch.nn.precision import matmul, weak
from vn_pointcloudcompletion_tpu_torch.nn.vn import (
    VNLayerNorm,
    VNLinear,
    VNLinearLeakyReLU,
    VNMaxPool,
    mean_pool,
)
from vn_pointcloudcompletion_tpu_torch.ops.knn import gather_neighbors, vn_graph_feature


def to_vn(x: torch.Tensor) -> torch.Tensor:
    """(B, N, 3C) scalar layout -> (B, C, 3, N) VN layout."""
    b, n, c3 = x.shape
    return x.transpose(1, 2).reshape(b, c3 // 3, 3, n)


def to_scalar(x: torch.Tensor) -> torch.Tensor:
    """(B, C, 3, N) VN layout -> (B, N, 3C) scalar layout."""
    b, c, _, n = x.shape
    return x.reshape(b, c * 3, n).transpose(1, 2)


def attend(q, k, v, scale: float):
    """Scaled dot-product attention of (B, H, N, D) heads over (B, H, M, D)
    keys and values: the softmax in at least float32, cast back to q's
    dtype before the values' product (JAX nn/attention.py:77-79)."""
    attn = matmul(q, k.transpose(-1, -2))
    attn = attn * weak(scale, attn)
    attn = torch.softmax(attn.to(torch.promote_types(attn.dtype, torch.float32)),
                         dim=-1).to(q.dtype)
    return matmul(attn, v)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` over the last axis (the scalar blocks' norms):
    eps 1e-6, flax's default (torch's is 1e-5), statistics in at least
    float32, and the float32 scale and bias promote a bf16 input, so the
    result is float32 there as flax's is.  The variance is torch's, where
    flax takes E[x^2] - E[x]^2: the two agree to rounding on these O(1)
    activations (the float64 tests hold the blocks within 1e-8)."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-6)

    def forward(self, x):
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.eps)


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
        out = attend(q, k, v, self.scale)  # (B, H, N, 3P/H)
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


class Mlp(nn.Module):
    """GELU MLP (reference vn_pointr.py:93-109; JAX nn/attention.py:119-130):
    ``fc1``, tanh-approximate GELU (``jax.nn.gelu``'s default), ``fc2``."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features)
        self.fc2 = Dense(hidden_features, out_features)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class ScalarAttention(nn.Module):
    """Multi-head self-attention on (B, N, C) through one ``qkv`` map and a
    ``proj`` map with bias (reference vn_pointr.py:112-123; JAX
    nn/attention.py:133-154)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias)
        self.proj = Dense(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        out = attend(qkv[0], qkv[1], qkv[2], self.scale)  # (B, H, N, C/H)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class CrossAttention(nn.Module):
    """Multi-head cross-attention of (B, N, C) queries over (B, M, C) keys and
    values (reference vn_pointr.py:149-184; JAX nn/attention.py:157-182):
    ``q_map``, ``k_map``, ``v_map`` without bias, ``proj`` with bias."""

    def __init__(self, dim: int, out_dim: int, num_heads: int = 8,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (out_dim // num_heads) ** -0.5
        self.q_map = Dense(dim, out_dim, bias=qkv_bias)
        self.k_map = Dense(dim, out_dim, bias=qkv_bias)
        self.v_map = Dense(dim, out_dim, bias=qkv_bias)
        self.proj = Dense(out_dim, out_dim)

    def forward(self, q_in, v_in):
        b, n, _ = q_in.shape
        h = self.num_heads

        def heads(t):  # (B, M, C) -> (B, H, M, C/H)
            return t.reshape(b, t.shape[1], h, -1).transpose(1, 2)

        out = attend(heads(self.q_map(q_in)), heads(self.k_map(v_in)),
                     heads(self.v_map(v_in)), self.scale)
        return self.proj(out.transpose(1, 2).reshape(b, n, -1))


def scalar_graph_feature(x, idx, x_q=None):
    """``concat([neighbour - centre, centre])`` on scalar features: x (B, M,
    C) the neighbours' pool, idx (B, Nq, K), x_q (B, Nq, C) the centres (x
    itself when None) -> (B, Nq, K, 2C) (JAX nn/attention.py:185-195)."""
    nbr = gather_neighbors(x, idx)  # (B, Nq, K, C)
    ctr = (x if x_q is None else x_q)[:, :, None, :].expand_as(nbr)
    return torch.cat([nbr - ctr, ctr], dim=-1)


def _knn_map(dim: int) -> nn.Sequential:
    """The reference's ``knn_map``: Linear(2C, C) and LeakyReLU(0.2)."""
    return nn.Sequential(Dense(2 * dim, dim), nn.LeakyReLU(0.2))


def _knn_branch(knn_map: nn.Sequential, merge_map: Dense, x_1, feats, idx, centres=None):
    """The kNN fusion of the scalar blocks: the edge features through
    ``knn_map``, a max over K, concatenated to ``x_1`` and mapped back."""
    knn_f = knn_map(scalar_graph_feature(feats, idx, centres)).amax(2)
    return merge_map(torch.cat([x_1, knn_f], dim=-1))


class Block(nn.Module):
    """Scalar PoinTr encoder block (reference vn_pointr.py:328-364; JAX
    nn/attention.py:198-226): pre-norm self-attention, with ``with_knn`` the
    kNN branch (``knn_map`` over the graph of the normed input, max over K,
    ``merge_map``), then the MLP, each around a residual."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 2.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 with_knn: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = ScalarAttention(dim, num_heads, qkv_bias, qk_scale)
        if with_knn:
            self.knn_map = _knn_map(dim)
            self.merge_map = Dense(2 * dim, dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, knn_idx: Optional[torch.Tensor] = None):
        norm_x = self.norm1(x)
        x_1 = self.attn(norm_x)
        if knn_idx is not None:
            x_1 = _knn_branch(self.knn_map, self.merge_map, x_1, norm_x, knn_idx)
        x = x + x_1
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """Scalar PoinTr decoder block (reference vn_pointr.py:187-248; JAX
    nn/attention.py:229-266): self-attention of the queries (with
    ``with_knn`` the self kNN branch), cross-attention to the encoder's
    tokens (with ``with_knn`` the cross kNN branch, queries as centres over
    the tokens as neighbours), then the MLP, each around a residual."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 2.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 with_knn: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.self_attn = ScalarAttention(dim, num_heads, qkv_bias, qk_scale)
        self.norm_q = LayerNorm(dim)
        self.norm_v = LayerNorm(dim)
        self.attn = CrossAttention(dim, dim, num_heads, qkv_bias, qk_scale)
        if with_knn:
            self.knn_map = _knn_map(dim)
            self.merge_map = Dense(2 * dim, dim)
            self.knn_map_cross = _knn_map(dim)
            self.merge_map_cross = Dense(2 * dim, dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, q, v, self_knn_idx: Optional[torch.Tensor] = None,
                cross_knn_idx: Optional[torch.Tensor] = None):
        norm_q = self.norm1(q)
        q_1 = self.self_attn(norm_q)
        if self_knn_idx is not None:
            q_1 = _knn_branch(self.knn_map, self.merge_map, q_1, norm_q, self_knn_idx)
        q = q + q_1
        norm_q2, norm_v = self.norm_q(q), self.norm_v(v)
        q_2 = self.attn(norm_q2, norm_v)
        if cross_knn_idx is not None:
            q_2 = _knn_branch(self.knn_map_cross, self.merge_map_cross, q_2, norm_v,
                              cross_knn_idx, norm_q2)
        q = q + q_2
        return q + self.mlp(self.norm2(q))


class VNDecoderBlock(nn.Module):
    """VN PoinTr decoder block (reference vn_pointr.py:250-326, whose own
    version is dead code; JAX nn/attention.py:269-314 keeps its intent):
    scalar ``LayerNorm``s on the (B, Nq, 3C) queries, VN self-attention on
    them in VN layout, with ``with_knn`` the self kNN branch (``conv1`` over
    the VN edge features, ``pool1`` a VN max over K, ``conv2``), then scalar
    cross-attention to the (B, M, 3C) encoder tokens, with ``with_knn`` the
    cross branch (``conv3``, ``pool2``, ``conv4``), each around a residual.
    The kNN convolutions take vec layout, plain PyTorch as XLA runs them in
    JAX (its fused paths take plane layout only)."""

    def __init__(self, channels: int = 128, attn_channels: int = 384,
                 num_heads: int = 4, qk_scale: Optional[float] = None,
                 with_knn: bool = False):
        super().__init__()
        c = channels
        self.norm1 = LayerNorm(3 * c)
        self.self_attn = VNAttention(c, attn_channels, c, num_heads, qk_scale)
        self.norm_q = LayerNorm(3 * c)
        self.norm_v = LayerNorm(3 * c)
        self.attn = CrossAttention(3 * c, 3 * c, num_heads, qk_scale=qk_scale)
        if with_knn:
            self.conv1 = VNLinearLeakyReLU(2 * c, c)
            self.pool1 = VNMaxPool(c, layout="vec")
            self.conv2 = VNLinear(2 * c, c)
            self.conv3 = VNLinearLeakyReLU(2 * c, c)
            self.pool2 = VNMaxPool(c, layout="vec")
            self.conv4 = VNLinear(2 * c, c)

    def forward(self, q, v, self_knn_idx: Optional[torch.Tensor] = None,
                cross_knn_idx: Optional[torch.Tensor] = None):
        vq = to_vn(self.norm1(q))
        q_1 = self.self_attn(vq)
        if self_knn_idx is not None:
            knn_f = self.pool1(self.conv1(vn_graph_feature(vq, vq, self_knn_idx)))
            q_1 = self.conv2(torch.cat([q_1, knn_f], dim=1))
        q = q + to_scalar(q_1)

        norm_q2, norm_v = self.norm_q(q), self.norm_v(v)
        q_2 = to_vn(self.attn(norm_q2, norm_v))
        if cross_knn_idx is not None:
            knn_f = vn_graph_feature(to_vn(norm_q2), to_vn(norm_v), cross_knn_idx)
            knn_f = self.pool2(self.conv3(knn_f))
            q_2 = self.conv4(torch.cat([q_2, knn_f], dim=1))
        return q + to_scalar(q_2)
