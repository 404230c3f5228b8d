"""The flagship encoder and decoder: ``VNPointNet`` and ``VNFoldingNet``.

Port of the parts of ``vn_pointcloudcompletion_tpu/models/pcn.py`` that the
``vn_pointnet`` + ``vn_foldingnet`` pipeline runs; train mode comes from
``model.train()``.  The encoder
takes ``xyz`` (B, N, 3) and returns ``(coarse (B, Nc, 3), feature_global
(B, 2L, 3, 1))``; the decoder takes ``(coarse, feature_global, rot)`` and
returns the dense cloud (B, Nc * S, 3).  The wide layers run in plane layout
(B, 3, C, N); the module tree follows the reference's ``state_dict`` keys.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vn_pointcloudcompletion_tpu_torch.nn.vn import (
    VNLinear,
    VNLinearAndLeakyReLU,
    VNLinearLeakyReLU,
    bn_leaky,
    layer_moments,
    plane_norms,
)
from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused
from vn_pointcloudcompletion_tpu_torch.ops.grid import folding_grid_3d
from vn_pointcloudcompletion_tpu_torch.ops.rotations import rotate_points
from vn_pointcloudcompletion_tpu_torch.ops.vn_fused import plane_dot


class _DirMap(nn.Module):
    """Holds a VNMaxPool's learned direction map (``map_to_dir.weight``); the
    pool itself runs fused with the preceding VNLinear."""

    def __init__(self, channels: int):
        super().__init__()
        self.map_to_dir = nn.Linear(channels, channels, bias=False)


def linear_maxpool_planes(w, wd, x):
    """VNLinear followed by VNMaxPool on planes (B, 3, Cin, N).

    The pool's direction reads the linear's output, d = Wd (W x) = (Wd W) x,
    so the direction map is precomposed (fan-in Cin instead of Cout).
    Returns the linear's output (B, 3, Cout, N) and the pooled (B, 3, Cout):
    per channel, the vector of the point with the largest <f, d> (first on
    ties).  The gradient reaches the selected vectors only: the direction
    feeds the argmax and nothing else (JAX models/pcn.py:403).
    """
    wdc = (wd @ w).detach()  # (Cout, Cin)
    f = torch.matmul(w, x)
    d = torch.matmul(wdc, x)
    idx = plane_dot(f, d).argmax(dim=-1, keepdim=True)  # (B, Cout, 1)
    idx = idx[:, None].expand(-1, 3, -1, -1)
    return f, torch.gather(f, 3, idx)[..., 0]


class VNPointNet(nn.Module):
    """VN encoder (reference models/pcn.py:110-184; JAX models/pcn.py:413-482).

    ``num_coarse == 448`` (224 predicted + FPS(input, 224)) needs the FPS
    kernel, which this port does not have yet.
    """

    def __init__(self, num_coarse: int = 1024, latent_dim: int = 1024):
        super().__init__()
        if num_coarse == 448:
            raise NotImplementedError(
                "num_coarse=448 appends FPS(input, 224); FPS (TPU kernel F) "
                "is not ported yet (ROADMAP.md, queue 2)"
            )
        self.num_coarse = num_coarse
        self.first_conv = nn.ModuleList([
            VNLinearLeakyReLU(1, 128, layout="plane"),
            VNLinear(128, 512, layout="plane"),
        ])
        self.maxpool1 = _DirMap(512)
        self.second_conv = nn.ModuleList([
            VNLinearLeakyReLU(1024, 1024, layout="plane"),
            VNLinear(1024, latent_dim * 2, layout="plane"),
        ])
        self.maxpool2 = _DirMap(latent_dim * 2)
        self.mlp = nn.ModuleList([
            VNLinearAndLeakyReLU(latent_dim * 2, 2048, use_batchnorm="none"),
            VNLinearAndLeakyReLU(2048, 1024, use_batchnorm="none"),
            VNLinear(1024, num_coarse),
        ])

    def forward(self, xyz):
        b, n, _ = xyz.shape
        x = xyz.transpose(1, 2)[:, :, None, :]  # (B, 3, 1, N)
        f = self.first_conv[0](x)
        f, g = linear_maxpool_planes(
            self.first_conv[1].map_to_feat.weight,
            self.maxpool1.map_to_dir.weight, f,
        )  # (B, 3, 512, N), (B, 3, 512)
        f = torch.cat([g[..., None].expand(-1, -1, -1, n), f], dim=2)
        f = self.second_conv[0](f)  # (B, 3, 1024, N)
        _, fg = linear_maxpool_planes(
            self.second_conv[1].map_to_feat.weight,
            self.maxpool2.map_to_dir.weight, f,
        )
        feature_global = fg[..., None].transpose(1, 2)  # (B, 2L, 3, 1)
        h = self.mlp[0](feature_global)
        h = self.mlp[1](h)
        coarse = self.mlp[2](h).reshape(b, self.num_coarse, 3)
        return coarse, feature_global


class _SplitFoldLayer(VNLinearLeakyReLU):
    """The decoder's first fold layer, ``final_conv.0``.

    Mathematically VNLinearLeakyReLU over concat([global | seed | point])
    with the reference's single (out, latent + 2) weight, but the global
    latent (the same for all points of a sample) is contracted once per
    sample and enters as a bias (JAX models/pcn.py:39-153).  At
    ``num_dense >= 4096`` the rest of the layer is kernel B (with kernel S
    for the train-mode statistics, ``_VNSplitFoldLayerFused``), with the two
    per-point input channels multiplied in-kernel; below that it is the
    split products and kernel A (``_VNSplitFoldLayer``).
    """

    def forward(self, glob, seed, point):
        """glob (B, 3, L, 1); seed, point (B, 3, 1, Nd) -> (B, 3, C, Nd)."""
        cg = glob.shape[2]
        w, wd = self.map_to_feat.weight, self.map_to_dir.weight
        pbias = torch.matmul(w[:, :cg], glob)  # (B, 3, C, 1)
        dbias = torch.matmul(wd[:, :cg], glob)
        if self.use_kernels and seed.shape[3] >= 4096:
            x2 = torch.cat([seed, point], dim=2)
            a, b = self.batchnorm.bn(
                **layer_moments(x2, w[:, cg:], pbias, self.training))
            return vn_layer_fused.vn_layer_fused(
                x2, w[:, cg:], wd[:, cg:], pbias, dbias, a, b, self.negative_slope,
            )
        p = pbias + torch.matmul(w[:, cg : cg + 1], seed) + torch.matmul(w[:, cg + 1 :], point)
        d = dbias + torch.matmul(wd[:, cg : cg + 1], seed) + torch.matmul(wd[:, cg + 1 :], point)
        a, b = self.batchnorm.bn(plane_norms(p) if self.training else None)
        return bn_leaky(p, d, a, b, self.negative_slope, self.use_kernels)


def dense_layout(coarse: torch.Tensor, grid_size: int) -> torch.Tensor:
    """Tile each coarse point over its fold grid: (B, Nc, 3) -> (B, 3, Nc*S)."""
    b, nc, _ = coarse.shape
    s = grid_size * grid_size
    return coarse[:, :, None, :].expand(b, nc, s, 3).reshape(b, nc * s, 3).transpose(1, 2)


class VNFoldingNet(nn.Module):
    """VN folding decoder (reference models/pcn.py:319-389; JAX :550-612).

    The z=0 folding seed is rotated by the augmentation rotation when one is
    given, so the decoder stays consistent with the rotated encoder output.
    """

    def __init__(self, num_coarse: int = 1024, latent_dim: int = 2048):
        super().__init__()
        if num_coarse == 448:
            self.nc, self.grid_size = 224, 8
        else:
            self.nc, self.grid_size = num_coarse, 4
        self.final_conv = nn.ModuleList([
            _SplitFoldLayer(latent_dim + 2, 256, layout="plane"),
            VNLinearLeakyReLU(256, 256, layout="plane"),
            VNLinear(256, 1, layout="plane"),
        ])

    def forward(self, coarse, feature_global, rot: Optional[torch.Tensor] = None):
        b = coarse.shape[0]
        s = self.grid_size ** 2
        num_dense = self.nc * s
        seed = folding_grid_3d(self.grid_size).to(coarse)  # (3, S)
        if rot is not None:
            seed = rotate_points(seed.T, rot).transpose(1, 2)[:, :, None]  # (B, 3, 1, S)
        else:
            seed = seed[None, :, None].expand(b, 3, 1, s)
        seed = seed[:, :, :, None, :].expand(b, 3, 1, self.nc, s).reshape(b, 3, 1, num_dense)
        point_feat = dense_layout(coarse, self.grid_size)[:, :, None]  # (B, 3, 1, Nd)
        glob = feature_global.transpose(1, 2)  # (B, 3, L, 1)
        f = self.final_conv[0](glob, seed, point_feat)
        f = self.final_conv[1](f, project_out=self.final_conv[2].map_to_feat.weight)
        fine = f + point_feat  # (B, 3, 1, Nd)
        return fine[:, :, 0].transpose(1, 2)
