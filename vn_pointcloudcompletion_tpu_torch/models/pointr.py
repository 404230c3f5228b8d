"""The ``vn_pointr`` encoder: ``VNDGCNNGrouper`` + ``VNPCTransformer``.

Port of the ``vn_dgcnn`` + ``vn_trans`` variant of
``vn_pointcloudcompletion_tpu/models/pointr.py`` (reference
``models/pointr/vn_pointr.py:414-722``, ``utils/dgcnn_group.py:112-248``)
with ``only_coarse=True``, the construction of the reference's
``model.py:23-24``.  It takes xyz (B, N, 3) and returns ``((coarse_224,
concat(coarse_224, FPS(xyz, 224))), feature_global (B, 1024, 3, 1))``.  The
coarse head emits 224 points, the JAX package's deliberate divergence from
the reference's 1024 (its ``models/pointr.py:13-17``).  Submodule names are
the reference's ``state_dict`` keys that the JAX package's
``torch_interop.vn_pointr_from_state_dict`` reads; the JAX scan over the
encoder's tail is the ``encoder.1`` .. ``encoder.5`` blocks here.

On the card the grouper takes kernels K2 (conv1's graph), B (conv1), F (two
downsamplings), K3 + A (conv4-6, dynamic feature-space graphs), the
transformer K2 for its k=8 proxy graph and F for the 224 FPS points, exactly
where the JAX package takes its Pallas kernels on a TPU; the VN layers in
vec layout are plain PyTorch there too.
"""

from __future__ import annotations

import torch
from torch import nn

from vn_pointcloudcompletion_tpu_torch.models.dgcnn import (
    _edge_vn_planes,
    _pool_edge_planes,
    fps_downsample,
    vn_edge_layer,
)
from vn_pointcloudcompletion_tpu_torch.nn.attention import VNBlock, to_scalar, to_vn
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


class VNPCTransformer(nn.Module):
    """Geometry-aware completion transformer, VN variant (JAX
    models/pointr.py:253-413 with ``dgcnn='vn_dgcnn'``, ``trans='vn_trans'``,
    ``only_coarse=True``): the grouper, a VN input projection, the
    positional embedding of ``[centre, mean of the input]``, ``enc_depth``
    VN blocks (the first ``knn_layer`` with the proxy-graph branch; the
    embedding re-added before each), ``vn_increase_dim``, a VN max pool to
    the global feature and the coarse head, then the FPS tail."""

    global_shape = (1024, 3)
    fps_tail = True

    def __init__(self, embed_dim: int = 384, enc_depth: int = 6, num_heads: int = 4,
                 num_query: int = 224, knn_layer: int = 1):
        super().__init__()
        c = embed_dim // 3
        self.num_query, self.knn_layer = num_query, knn_layer
        self.grouper = VNDGCNNGrouper()
        self.vn_input_proj = nn.ModuleList([VNLinearLeakyReLU(128, 128), VNLinear(128, 128)])
        self.fourth_vn_pos_embed = nn.ModuleList([VNLinearAndLeakyReLU(2, 128),
                                                  VNLinear(128, 128)])
        self.encoder = nn.ModuleList([
            VNBlock(c, embed_dim, num_heads, with_knn=i < knn_layer) for i in range(enc_depth)])
        self.vn_increase_dim = nn.ModuleList([VNLinearAndLeakyReLU(c, 1024),
                                              VNLinear(1024, 1024)])
        self.vn_global_pool = VNMaxPool(1024, layout="vec")
        self.vn_coarse_pred = nn.ModuleList([VNLinear(1024, 512), VNLeakyReLU(512),
                                             VNLinear(512, num_query)])
        self.use_kernels = True

    def forward(self, xyz):
        b = xyz.shape[0]
        coor, f = self.grouper(xyz)  # (B, 3, Nc), (B, 128, 3, Nc)
        nc = f.shape[-1]
        x = to_scalar(self.vn_input_proj[1](self.vn_input_proj[0](f)))  # (B, Nc, 384)

        pts = coor.transpose(1, 2)
        _, knn_idx = knn(pts, pts, PROXY_K, self.use_kernels)

        rep = xyz.mean(1)[:, None, :, None].expand(b, 1, 3, nc)
        fourth = torch.cat([coor[:, None], rep], dim=1)  # (B, 2, 3, Nc)
        pos = to_scalar(self.fourth_vn_pos_embed[1](self.fourth_vn_pos_embed[0](fourth)))

        for i, block in enumerate(self.encoder):
            x = to_scalar(block(to_vn(x + pos), knn_idx if i < self.knn_layer else None))

        g = self.vn_increase_dim[1](self.vn_increase_dim[0](to_vn(x)))
        global_feature = self.vn_global_pool(g)[..., None]  # (B, 1024, 3, 1)
        h = self.vn_coarse_pred[1](self.vn_coarse_pred[0](global_feature))
        coarse = self.vn_coarse_pred[2](h)[..., 0]  # (B, 224, 3)
        cat = concat_points(coarse, fps(xyz, self.num_query, self.use_kernels))
        return (coarse, cat), global_feature
