"""The ``vn_pointr`` encoder: ``VNPCTransformer`` and its groupers.

Port of ``vn_pointcloudcompletion_tpu/models/pointr.py`` (reference
``models/pointr/vn_pointr.py:414-722``, ``utils/dgcnn_group.py``), every
arm: the VN grouper ``VNDGCNNGrouper`` or the scalar ``DGCNNGrouper``
(``dgcnn``), VN or scalar transformer blocks (``trans``), and with
``only_coarse=False`` the decoder stack that refines one query per coarse
point.  The composer builds the ``vn_dgcnn`` + ``vn_trans`` arm, the
construction of the reference's ``model.py:23-24``, with the stack where
the config sets ``pointr_decoder``.  It takes xyz (B, N, 3) and returns
``((coarse_224, concat(coarse_224, FPS(xyz, 224))), feature_global)``,
feature_global (B, 1024, 3, 1) (``trans`` arm: (B, 1024)), or with the
stack ``(..., (feature_global, q))`` with the refined queries q (B, 224,
embed_dim).  The coarse head emits 224 points, the JAX package's
deliberate divergence from the reference's 1024 (its
``models/pointr.py:13-17``).  Submodule names are the reference's
``state_dict`` keys that the JAX package's
``torch_interop.vn_pointr_from_state_dict`` reads; the JAX scans over the
encoder's and the decoder's tails are the blocks ``encoder.1`` ..
``encoder.5`` and ``decoder.1`` .. ``decoder.7`` here.

On the card the VN grouper takes kernels K2 (conv1's graph), B (conv1), F
(two downsamplings), K3 + A (conv4-6, dynamic feature-space graphs), the
scalar one K2 (four k=16 graphs) and F; the transformer takes K2 for its
k=8 proxy graph and, with the stack, for the decoder's self (224 vs 224)
and cross (224 vs 128) graphs, and F for the 224 FPS points, exactly where
the JAX package takes its Pallas kernels on a TPU; the VN layers in vec
layout and the attention products are plain PyTorch there too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vn_pointcloudcompletion_tpu_torch.models.common import BatchNormCh, ConvCh, DenseTorch
from vn_pointcloudcompletion_tpu_torch.models.dgcnn import (
    ScalarEdgeTrunk,
    _edge_vn_planes,
    _pool_edge_planes,
    fps_downsample,
    vn_edge_layer,
)
from vn_pointcloudcompletion_tpu_torch.nn.attention import (
    Block,
    DecoderBlock,
    VNBlock,
    VNDecoderBlock,
    to_scalar,
    to_vn,
)
from vn_pointcloudcompletion_tpu_torch.nn.precision import activation_dtype
from vn_pointcloudcompletion_tpu_torch.nn.vn import (
    VNLeakyReLU,
    VNLinear,
    VNLinearAndLeakyReLU,
    VNLinearLeakyReLU,
    VNMaxPool,
)
from vn_pointcloudcompletion_tpu_torch.ops.fps import concat_points, fps
from vn_pointcloudcompletion_tpu_torch.ops.knn import knn

PROXY_K = 8  # neighbours of the proxy graph on the centres (vn_pointr.py:17-29)


class VNDGCNNGrouper(nn.Module):
    """VN grouper (JAX models/pointr.py:68-115): conv1 over the coordinate
    graph of all points, FPS to 512, conv4 and conv5 over dynamic graphs of
    the flattened features, FPS to 128, conv6.  Returns coor (B, 3, 128) and
    features (B, 128, 3, 128), vec layout."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.ModuleList([VNLinearLeakyReLU(2, 32, layout="plane")])
        self.conv4 = VNLinearLeakyReLU(64, 64, layout="plane")
        self.conv5 = VNLinearLeakyReLU(128, 64, layout="plane")
        self.conv6 = VNLinearLeakyReLU(128, 128, layout="plane")
        self.use_kernels = True

    def forward(self, xyz):
        n = xyz.shape[1]
        uk = self.use_kernels
        # the bf16 policy's boundary: bf16 coordinates and features from here
        # on, FPS and kNN on bf16-rounded coordinates (JAX models/pointr.py:95-98)
        xyz = activation_dtype(xyz)
        coor = xyz.transpose(1, 2)  # (B, 3, N)
        f = _edge_vn_planes(coor[:, :, None, :], use_kernels=uk)  # (B, 3, 2, N*K)
        x1 = _pool_edge_planes(self.conv1[0](f), n)  # (B, 3, 32, N)
        coor_q, f_q = fps_downsample(coor, x1, 512, uk)
        f = vn_edge_layer(self.conv4, f_q)
        f = vn_edge_layer(self.conv5, f)
        coor_q, f_q = fps_downsample(coor_q, f, 128, uk)
        f = vn_edge_layer(self.conv6, f_q)  # (B, 3, 128, 128)
        return coor_q, f.transpose(1, 2)


class DGCNNGrouper(ScalarEdgeTrunk):
    """Scalar grouper (JAX models/pointr.py:57-65; reference
    dgcnn_group.py:9-109): the scalar EdgeConv trunk that ``DGCNNfps``
    shares, coor (B, 3, 128) and features (B, 128, 128)."""

    def forward(self, xyz):
        return self.trunk(xyz)


def pos_encoding_sin_wave(coor: torch.Tensor, num_freqs: int = 64) -> torch.Tensor:
    """NeRF-style sine and cosine encoding of coordinates (JAX
    models/pointr.py:171-183; the reference's unused helper,
    vn_pointr.py:555-575): coor (B, 3, N), normalised to [-1, 1] by the
    whole tensor's min and max, -> (B, 6 num_freqs, N).  The frequencies
    pi 2^i are float32, as JAX's."""
    normal = 2 * ((coor - coor.min()) / (coor.max() - coor.min() + 1e-12)) - 1
    freqs = math.pi * 2.0 ** torch.arange(num_freqs, dtype=torch.float32, device=coor.device)
    k = normal[..., None] * freqs  # (B, 3, N, D)
    x = torch.cat([torch.sin(k), torch.cos(k)], dim=-1)  # (B, 3, N, 2D)
    return x.transpose(-1, -2).reshape(coor.shape[0], -1, coor.shape[-1])


def _seq(layers, x):
    """Run the modules of a reference Sequential (a ModuleList here)."""
    for layer in layers:
        x = layer(x)
    return x


class VNPCTransformer(nn.Module):
    """Geometry-aware completion transformer (JAX models/pointr.py:253-413).

    The grouper (``dgcnn``: ``"vn_dgcnn"`` or ``"dgcnn"``), an input
    projection and the positional embedding (VN: of ``[centre, mean of the
    input]``; scalar: of the centre), ``enc_depth`` blocks (``trans``:
    ``"vn_trans"`` VN blocks or ``"trans"`` scalar ones; the first
    ``knn_layer`` with the proxy-graph branch; the embedding re-added before
    each), the global feature (a VN max pool or a max) and the coarse head,
    then the FPS tail.  With ``only_coarse=False``, queries from the global
    feature and each coarse point (``vn_mlp_query`` or ``mlp_query``) run
    through ``dec_depth`` decoder blocks against the encoder's tokens, the
    first ``knn_layer`` with the self (coarse vs coarse) and cross (coarse
    vs centres) k=8 graphs."""

    fps_tail = True

    def __init__(self, embed_dim: int = 384, enc_depth: int = 6, dec_depth: int = 8,
                 num_heads: int = 4, mlp_ratio: float = 2.0, num_query: int = 224,
                 knn_layer: int = 1, dgcnn: str = "vn_dgcnn", trans: str = "vn_trans",
                 only_coarse: bool = True):
        super().__init__()
        if dgcnn not in ("vn_dgcnn", "dgcnn") or trans not in ("vn_trans", "trans"):
            raise ValueError(f"VNPCTransformer: no arm dgcnn={dgcnn!r}, trans={trans!r}")
        c = embed_dim // 3
        self.num_query, self.knn_layer, self.only_coarse = num_query, knn_layer, only_coarse
        self.vn_grouper, self.vn_trans = dgcnn == "vn_dgcnn", trans == "vn_trans"
        self.global_shape = (1024, 3) if self.vn_trans else (1024,)
        if self.vn_grouper:
            self.grouper = VNDGCNNGrouper()
            self.vn_input_proj = nn.ModuleList([VNLinearLeakyReLU(128, 128),
                                                VNLinear(128, 128)])
            self.fourth_vn_pos_embed = nn.ModuleList([VNLinearAndLeakyReLU(2, 128),
                                                      VNLinear(128, 128)])
        else:
            self.grouper = DGCNNGrouper()
            self.input_proj = nn.ModuleList([ConvCh(128, embed_dim), BatchNormCh(embed_dim),
                                             nn.LeakyReLU(0.2), ConvCh(embed_dim, embed_dim)])
            self.pos_embed = nn.ModuleList([ConvCh(3, 128), BatchNormCh(128),
                                            nn.LeakyReLU(0.2), ConvCh(128, embed_dim)])
        if self.vn_trans:
            self.encoder = nn.ModuleList([
                VNBlock(c, embed_dim, num_heads, with_knn=i < knn_layer)
                for i in range(enc_depth)])
            self.vn_increase_dim = nn.ModuleList([VNLinearAndLeakyReLU(c, 1024),
                                                  VNLinear(1024, 1024)])
            self.vn_global_pool = VNMaxPool(1024, layout="vec")
            self.vn_coarse_pred = nn.ModuleList([VNLinear(1024, 512), VNLeakyReLU(512),
                                                 VNLinear(512, num_query)])
        else:
            self.encoder = nn.ModuleList([
                Block(embed_dim, num_heads, mlp_ratio, with_knn=i < knn_layer)
                for i in range(enc_depth)])
            self.increase_dim = nn.ModuleList([ConvCh(embed_dim, 1024), BatchNormCh(1024),
                                               nn.LeakyReLU(0.2), ConvCh(1024, 1024)])
            self.coarse_pred = nn.ModuleList([DenseTorch(1024, 1024), nn.ReLU(),
                                              DenseTorch(1024, 3 * num_query)])
        if not only_coarse:
            if self.vn_trans:
                self.vn_mlp_query = nn.ModuleList([
                    VNLinearLeakyReLU(1024 + 1, 1024), VNLinearLeakyReLU(1024, 1024),
                    VNLinear(1024, c)])
                self.decoder = nn.ModuleList([
                    VNDecoderBlock(c, embed_dim, num_heads, with_knn=i < knn_layer)
                    for i in range(dec_depth)])
            else:
                self.mlp_query = nn.ModuleList([
                    ConvCh(1024 + 3, 1024), nn.LeakyReLU(0.2), ConvCh(1024, 1024),
                    nn.LeakyReLU(0.2), ConvCh(1024, embed_dim)])
                self.decoder = nn.ModuleList([
                    DecoderBlock(embed_dim, num_heads, mlp_ratio, with_knn=i < knn_layer)
                    for i in range(dec_depth)])
        self.use_kernels = True

    def forward(self, xyz):
        b = xyz.shape[0]
        uk = self.use_kernels
        coor, f = self.grouper(xyz)  # (B, 3, Nc), (B, 128, 3, Nc) or (B, 128, Nc)
        nc = f.shape[-1]
        if self.vn_grouper:
            x = to_scalar(_seq(self.vn_input_proj, f))  # (B, Nc, 384)
        else:
            x = _seq(self.input_proj, f).transpose(1, 2)  # (B, Nc, E)

        pts = coor.transpose(1, 2)
        _, knn_idx = knn(pts, pts, PROXY_K, uk)

        if self.vn_grouper:
            rep = xyz.mean(1)[:, None, :, None].expand(b, 1, 3, nc)
            fourth = torch.cat([coor[:, None], rep], dim=1)  # (B, 2, 3, Nc)
            pos = to_scalar(_seq(self.fourth_vn_pos_embed, fourth))
        else:
            pos = _seq(self.pos_embed, coor).transpose(1, 2)

        for i, block in enumerate(self.encoder):
            idx = knn_idx if i < self.knn_layer else None
            if self.vn_trans:
                x = to_scalar(block(to_vn(x + pos), idx))
            else:
                x = block(x + pos, idx)

        if self.vn_trans:
            g = _seq(self.vn_increase_dim, to_vn(x))
            global_feature = self.vn_global_pool(g)[..., None]  # (B, 1024, 3, 1)
            h = self.vn_coarse_pred[1](self.vn_coarse_pred[0](global_feature))
            coarse = self.vn_coarse_pred[2](h)[..., 0]  # (B, 224, 3)
        else:
            global_feature = _seq(self.increase_dim, x.transpose(1, 2)).amax(-1)  # (B, 1024)
            h = F.relu(self.coarse_pred[0](global_feature))
            coarse = self.coarse_pred[2](h).reshape(b, self.num_query, 3)
        cat = concat_points(coarse, fps(xyz, self.num_query, uk))
        if self.only_coarse:
            return (coarse, cat), global_feature
        return (coarse, cat), (global_feature, self.refine(x, pts, global_feature, coarse))

    def refine(self, x, pts, global_feature, coarse):
        """The decoder stack: queries from the global feature and each
        coarse point (reference vn_pointr.py:685-712) through the decoder
        blocks against the encoder's tokens x (B, Nc, E), the first
        ``knn_layer`` with the self (coarse vs coarse) and cross (coarse vs
        the centres ``pts`` (B, Nc, 3)) k=8 graphs: the refined queries
        (B, M, E)."""
        uk = self.use_kernels
        _, self_knn = knn(coarse, coarse, PROXY_K, uk)
        _, cross_knn = knn(coarse, pts, PROXY_K, uk)
        if self.vn_trans:
            gf = global_feature.expand(-1, -1, -1, self.num_query)  # (B, 1024, 3, M)
            vq = torch.cat([gf, coarse.transpose(1, 2)[:, None]], dim=1)
            q = to_scalar(_seq(self.vn_mlp_query, vq))  # (B, M, E)
        else:
            gf = global_feature[:, None, :].expand(-1, self.num_query, -1)
            q = _seq(self.mlp_query, torch.cat([gf, coarse], dim=-1).transpose(1, 2))
            q = q.transpose(1, 2)
        for i, block in enumerate(self.decoder):
            if i < self.knn_layer:
                q = block(q, x, self_knn, cross_knn)
            else:
                q = block(q, x)
        return q
