"""DGCNN-family encoders ``VNDGCNNfps`` and ``DGCNNfps``, and the classic
coarse-only ``DGCNN`` with its ``TransformNet``.

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
from vn_pointcloudcompletion_tpu_torch.nn.precision import activation_dtype
from vn_pointcloudcompletion_tpu_torch.nn.vn import (
    VNLinear,
    VNLinearLeakyReLU,
    VNMaxPool,
    mean_pool,
)
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
    (B, 3, 2C, N*K).  The graph comes from x as given; under the bf16 policy
    the edge features are bf16 (JAX models/dgcnn.py:88-95)."""
    b, _, c, n = x.shape
    pts = (coords if coords is not None else x.reshape(b, 3 * c, n)).transpose(1, 2)
    idx = knn(pts, pts, K, use_kernels)[1]
    x = activation_dtype(x)
    return vn_graph_feature_planes(x, x, idx)


def _pool_edge_planes(f, n: int):
    """(B, 3, C, N*K) -> mean over K -> (B, 3, C, N), summed in at least
    float32 (JAX models/dgcnn.py:138-142)."""
    b, _, c, _ = f.shape
    return mean_pool(f.reshape(b, 3, c, n, K))


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
        # under the bf16 policy the trunk, its FPS and its graphs run on
        # bf16-rounded coordinates (JAX models/dgcnn.py:222-226)
        xyz = activation_dtype(xyz)
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


def _conv_bn(conv: ConvCh, bn: BatchNormCh, h):
    """Kernel-1 convolution, BatchNorm, LeakyReLU(0.2)."""
    return F.leaky_relu(bn(conv(h)), 0.2)


class TransformNet(nn.Module):
    """DGCNN's T-Net (reference models/utils/transform_net.py:12-57; JAX
    models/dgcnn.py:257-291): from the (B, 6, N, K) edge features of the raw
    coordinates, a 3x3 alignment, identity at initialisation (``transform``
    weight 0, bias the identity).  Keys as the reference module's:
    ``conv{1,2,3}`` Sequentials (convolution, BatchNorm), ``linear1``,
    ``bn3``, ``linear2``, ``bn4``, ``transform``."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.ModuleList([ConvCh(6, 64, bias=False, kernel_dims=2), BatchNormCh(64)])
        self.conv2 = nn.ModuleList([ConvCh(64, 128, bias=False, kernel_dims=2), BatchNormCh(128)])
        self.conv3 = nn.ModuleList([ConvCh(128, 1024, bias=False), BatchNormCh(1024)])
        self.linear1 = DenseTorch(1024, 512, bias=False)
        self.bn3 = BatchNormCh(512)
        self.linear2 = DenseTorch(512, 256, bias=False)
        self.bn4 = BatchNormCh(256)
        self.transform = DenseTorch(256, 9)
        self.reset_transform()

    def reset_transform(self) -> None:
        with torch.no_grad():
            self.transform.weight.zero_()
            self.transform.bias.copy_(torch.eye(3).reshape(9))

    def forward(self, x):
        b = x.shape[0]
        h = _conv_bn(*self.conv1, x)
        h = _conv_bn(*self.conv2, h).amax(-1)  # over K: (B, 128, N)
        h = _conv_bn(*self.conv3, h).amax(-1)  # (B, 1024)
        h = F.leaky_relu(self.bn3(self.linear1(h)), 0.2)
        h = F.leaky_relu(self.bn4(self.linear2(h)), 0.2)
        return self.transform(h).reshape(b, 3, 3)


class DGCNN(nn.Module):
    """Classic DGCNN with the input T-Net, k = 40 (reference
    models/dgcnn.py:327-417; JAX models/dgcnn.py:294-345), coarse only (the
    reference's dense branch reads attributes it never defines):
    ``forward(xyz)`` -> ``(coarse (B, num_coarse, 3), feature_global
    (B, 1024))``.  Four dynamic graphs (the raw and the aligned coordinates,
    then the 64-channel features twice), each the kNN of every point among
    all N, kernel K2 on the card (``ops/knn.py::knn``).  Keys:
    ``transform_net``, ``conv1`` .. ``conv6`` (convolution, BatchNorm),
    ``mlp`` (Linear, ReLU, Linear, ReLU, Linear)."""

    def __init__(self, num_coarse: int = 448, n_knn: int = 40):
        super().__init__()
        self.num_coarse, self.n_knn = num_coarse, n_knn
        self.transform_net = TransformNet()

        def conv_bn(c_in, c_out, kernel_dims=2):
            return nn.ModuleList([ConvCh(c_in, c_out, bias=False, kernel_dims=kernel_dims),
                                  BatchNormCh(c_out)])

        self.conv1, self.conv2 = conv_bn(6, 64), conv_bn(64, 64)
        self.conv3, self.conv4 = conv_bn(128, 64), conv_bn(64, 64)
        self.conv5 = conv_bn(128, 64)
        self.conv6 = conv_bn(192, 1024, kernel_dims=1)
        self.mlp = nn.ModuleList([DenseTorch(1024, 1024), nn.ReLU(), DenseTorch(1024, 1024),
                                  nn.ReLU(), DenseTorch(1024, 3 * num_coarse)])
        self.use_kernels = True

    def _graph(self, h):
        """(B, C, N) -> EdgeConv features over its own kNN, (B, 2C, N, K)."""
        pts = h.transpose(1, 2)
        _, idx = knn(pts, pts, self.n_knn, self.use_kernels)
        return graph_feature(h, h, idx)

    def forward(self, xyz):
        b = xyz.shape[0]
        x = xyz.transpose(1, 2)  # (B, 3, N)
        t = self.transform_net(self._graph(x))
        x = torch.einsum("bdn,bde->ben", x, t)  # x^T t, back to (B, 3, N)
        h = _conv_bn(*self.conv2, _conv_bn(*self.conv1, self._graph(x)))
        x1 = h.amax(-1)
        h = _conv_bn(*self.conv4, _conv_bn(*self.conv3, self._graph(x1)))
        x2 = h.amax(-1)
        x3 = _conv_bn(*self.conv5, self._graph(x2)).amax(-1)
        h = _conv_bn(*self.conv6, torch.cat([x1, x2, x3], dim=1))
        feature_global = h.amax(-1)  # (B, 1024)
        m = self.mlp
        h = torch.relu(m[2](torch.relu(m[0](feature_global))))
        return m[4](h).reshape(b, self.num_coarse, 3), feature_global
