"""DGCNN-family encoders: ``VNDGCNNfps`` and ``DGCNNfps``.

Port of ``vn_pointcloudcompletion_tpu/models/dgcnn.py`` (reference
``models/dgcnn.py:19-324``).  Both take xyz (B, N, 3) and return
``(coarse (B, Nc, 3), feature_global)``, or at ``num_coarse == 448``
``((coarse_224, concat(coarse_224, FPS(xyz, 224))), feature_global)``.
Submodule names follow the reference's ``state_dict`` layout
(``training/torch_interop.py:168-202`` of the JAX package reads it).

On the card the kNN graphs take kernels K2 (``ops/knn.py::knn``) and K3
(the edge mode of ``VNLinearLeakyReLU``), the downsampling kernel F, exactly
where the JAX package takes its Pallas kernels on a TPU; ``use_kernels``
(set by ``PCNNet.use_kernels_``) takes the plain versions instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vn_pointcloudcompletion_tpu_torch.models.common import (
    BatchNormCh,
    ConvCh,
    DenseTorch,
    GroupNormCh,
)
from vn_pointcloudcompletion_tpu_torch.nn.vn import VNLinear, VNLinearLeakyReLU, VNMaxPool
from vn_pointcloudcompletion_tpu_torch.ops.fps import fps, furthest_point_sample, take_points
from vn_pointcloudcompletion_tpu_torch.ops.knn import graph_feature, knn, vn_graph_feature_planes

K = 16  # neighbours of every EdgeConv stage


def fps_downsample(coor, x, num_group: int, use_kernels: bool = True):
    """FPS on coor (B, 3, N), then gather coor and the features x (B, C, N)
    or planes (B, 3, C, N) along the point axis: (B, 3, S), x (..., S).  The
    JAX package's ``fps_downsample_scalar`` and ``fps_downsample_vn``."""
    idx = furthest_point_sample(coor.transpose(1, 2), num_group, use_kernels)
    return take_points(coor, idx), take_points(x, idx)


def _edge_scalar(coor_q, x_q, coor_k, x_k, use_kernels: bool):
    """EdgeConv features over the kNN in coordinate space: (B, 2C, Nq, K)."""
    _, idx = knn(coor_q.transpose(1, 2), coor_k.transpose(1, 2), K, use_kernels)
    return graph_feature(x_q, x_k, idx)


def _edge_vn_planes(x, coords=None, use_kernels: bool = True):
    """Plane-layout VN EdgeConv features over the kNN of the flattened (3C)
    features of x (B, 3, C, N), or of ``coords`` (B, 3, N) when given:
    (B, 3, 2C, N*K)."""
    b, _, c, n = x.shape
    pts = (coords if coords is not None else x.reshape(b, 3 * c, n)).transpose(1, 2)
    return vn_graph_feature_planes(x, x, knn(pts, pts, K, use_kernels)[1])


def _pool_edge_planes(f, n: int):
    """(B, 3, C, N*K) -> mean over K -> (B, 3, C, N)."""
    b, _, c, _ = f.shape
    return f.reshape(b, 3, c, n, K).mean(-1)


def vn_edge_layer(layer: VNLinearLeakyReLU, x, coords=None):
    """One VN EdgeConv stage, x (B, 3, C, N) -> (B, 3, C_out, N): the edge
    mode of the layer where C >= 16 (the JAX package's ``VN_EDGE_FUSED``
    default on a TPU), else the composition graph features -> layer ->
    mean over K (JAX models/dgcnn.py:114-135); kernels as the layer's
    ``use_kernels`` says."""
    if x.shape[2] >= 16:
        return layer(x, edge_k=K, edge_coords=coords)
    f = _edge_vn_planes(x, coords, layer.use_kernels)
    return _pool_edge_planes(layer(f), x.shape[3])


class VNDGCNNfps(nn.Module):
    """VN DGCNN encoder (reference :164-324; JAX models/dgcnn.py:198-254):
    feature_global (B, 512, 3, 1), coarse from the ``conv7`` head."""

    global_shape = (512, 3)

    def __init__(self, num_coarse: int = 1024):
        super().__init__()
        self.nc = 224 if num_coarse == 448 else num_coarse
        self.fps_tail = num_coarse == 448
        self.conv1 = nn.ModuleList([VNLinearLeakyReLU(2, 32, layout="plane")])
        self.conv4 = VNLinearLeakyReLU(64, 64, layout="plane")
        self.conv5 = VNLinearLeakyReLU(128, 128, layout="plane")
        self.conv6 = VNLinearLeakyReLU(256, 512, layout="plane")
        self.pool5 = VNMaxPool(512)
        self.conv7 = nn.ModuleList([VNLinearLeakyReLU(512, 1024, layout="plane"),
                                    VNLinear(1024, self.nc, layout="plane")])
        self.use_kernels = True

    def forward(self, xyz):
        b, n, _ = xyz.shape
        uk = self.use_kernels
        coor = xyz.transpose(1, 2)  # (B, 3, N)
        f = _edge_vn_planes(coor[:, :, None, :], use_kernels=uk)  # (B, 3, 2, N*K)
        x1 = _pool_edge_planes(self.conv1[0](f), n)  # (B, 3, 32, N)

        coor_q, f_q = fps_downsample(coor, x1, 512, uk)
        f = vn_edge_layer(self.conv4, f_q, coor_q)
        f = vn_edge_layer(self.conv5, f, coor_q)
        coor_q, f_q = fps_downsample(coor_q, f, 128, uk)
        f = vn_edge_layer(self.conv6, f_q, coor_q)  # (B, 3, 512, 128)

        gf_planes = self.pool5(f)[..., None]  # (B, 3, 512, 1)
        h = self.conv7[0](gf_planes)
        coarse = self.conv7[1](h)[..., 0].transpose(1, 2)  # (B, nc, 3)
        feature_global = gf_planes.transpose(1, 2)  # (B, 512, 3, 1)
        if self.fps_tail:
            cat = torch.cat([coarse, fps(xyz, 224, uk).to(coarse.dtype)], dim=1)
            return (coarse, cat), feature_global
        return coarse, feature_global


class DGCNNfps(nn.Module):
    """Scalar DGCNN encoder with FPS downsampling (reference :19-161; JAX
    models/dgcnn.py:145-195): EdgeConv + GroupNorm over FPS 2048 -> 512 ->
    128, feature_global (B, 1024)."""

    global_shape = (1024,)

    def __init__(self, num_coarse: int = 1024):
        super().__init__()
        self.nc = 224 if num_coarse == 448 else num_coarse
        self.fps_tail = num_coarse == 448
        self.input_trans = ConvCh(3, 8)

        def layer(c_in, c_out):  # Conv2d(bias=False), GroupNorm(4), LeakyReLU
            return nn.ModuleList([ConvCh(2 * c_in, c_out, bias=False, kernel_dims=2),
                                  GroupNormCh(4, c_out)])

        self.layer1, self.layer2 = layer(8, 32), layer(32, 64)
        self.layer3, self.layer4 = layer(64, 64), layer(64, 128)
        self.increase_dim = nn.ModuleList([
            ConvCh(128, 1024), BatchNormCh(1024), nn.LeakyReLU(0.2), ConvCh(1024, 1024)])
        self.coarse_pred = nn.ModuleList([
            DenseTorch(1024, 1024), nn.ReLU(), DenseTorch(1024, 3 * self.nc)])
        self.use_kernels = True

    @staticmethod
    def _layer(layer, h):
        h = F.leaky_relu(layer[1](layer[0](h)), 0.2)
        return h.amax(-1)  # over K

    def trunk(self, xyz):
        """The shared EdgeConv/FPS trunk (JAX ``scalar_edge_trunk``):
        coor (B, 3, 128), f (B, 128, 128)."""
        uk = self.use_kernels
        coor = xyz.transpose(1, 2)
        f = self.input_trans(coor)
        f = self._layer(self.layer1, _edge_scalar(coor, f, coor, f, uk))  # (B, 32, N)
        coor_q, f_q = fps_downsample(coor, f, 512, uk)
        f = self._layer(self.layer2, _edge_scalar(coor_q, f_q, coor, f, uk))
        coor = coor_q
        f = self._layer(self.layer3, _edge_scalar(coor, f, coor, f, uk))
        coor_q, f_q = fps_downsample(coor, f, 128, uk)
        f = self._layer(self.layer4, _edge_scalar(coor_q, f_q, coor, f, uk))
        return coor_q, f

    def forward(self, xyz):
        b = xyz.shape[0]
        _, f = self.trunk(xyz)
        g = self.increase_dim[0](f)
        g = F.leaky_relu(self.increase_dim[1](g), 0.2)
        feature_global = self.increase_dim[3](g).amax(-1)  # (B, 1024)
        h = F.relu(self.coarse_pred[0](feature_global))
        coarse = self.coarse_pred[2](h).reshape(b, self.nc, 3)
        if self.fps_tail:
            cat = torch.cat([coarse, fps(xyz, 224, self.use_kernels)], dim=1)
            return (coarse, cat), feature_global
        return coarse, feature_global
