"""The PCN family: the encoder ``VNPointNet``, the decoders
``VNFoldingNet``, ``AttentionVNFoldingNet`` and ``FoldingNet``, and the
standalone models ``PCN`` (scalar, with its own folding head) and ``VNPCN``
(coarse only).

Port of those parts of ``vn_pointcloudcompletion_tpu/models/pcn.py``; train
mode comes from ``model.train()``.  The encoder takes ``xyz`` (B, N, 3) and
returns ``(coarse (B, Nc, 3), feature_global (B, 2L, 3, 1))`` (at
``num_coarse == 448`` a (predicted, with FPS points) pair of coarse clouds);
a decoder takes ``(coarse, feature_global, rot)`` and returns the dense
cloud (B, Nc * S, 3).  A decoder's first layer is as wide as the encoder's
global feature (``global_shape``), as flax infers it in the JAX package.
The wide VN layers run in plane layout (B, 3, C, N); the module tree follows
the reference's ``state_dict`` keys.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vn_pointcloudcompletion_tpu_torch.nn import precision
from vn_pointcloudcompletion_tpu_torch.nn.attention import VNBlock, to_vn
from vn_pointcloudcompletion_tpu_torch.nn.precision import activation_dtype, bf16_policy
from vn_pointcloudcompletion_tpu_torch.nn.vn import (
    VNLinear,
    VNLinearAndLeakyReLU,
    VNLinearLeakyReLU,
    bn_leaky,
    channel_linear,
    layer_moments,
    plane_norms,
    vector_dot,
)
from vn_pointcloudcompletion_tpu_torch.models.common import BatchNormCh, ConvCh, DenseTorch
from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused
from vn_pointcloudcompletion_tpu_torch.ops.fps import concat_points, fps
from vn_pointcloudcompletion_tpu_torch.ops.grid import folding_grid_2d, folding_grid_3d
from vn_pointcloudcompletion_tpu_torch.ops.rotations import rotate_points


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
    feeds the argmax and nothing else (JAX models/pcn.py:403).  Under the
    bf16 policy the composition is a bf16 product too (float32 sums), as
    the channel map consumes it in bf16 anyway (JAX models/pcn.py:388-400).
    """
    f, score = linear_pool_scores(w, wd, x)
    idx = score.argmax(dim=-1, keepdim=True)  # (B, Cout, 1)
    return f, torch.gather(f, 3, idx[:, None].expand(-1, 3, -1, -1))[..., 0]


def linear_pool_scores(w, wd, x):
    """The linear's output f = W x (B, 3, Cout, N) and the pool's scores
    <f, (Wd W) x> (B, Cout, N)."""
    if bf16_policy():
        wdc = precision.matmul(wd.to(torch.bfloat16), w.to(torch.bfloat16)).detach()
    else:
        wdc = (wd @ w).detach()  # (Cout, Cin)
    f = channel_linear(w, x, "plane")
    return f, vector_dot(f, channel_linear(wdc, x, "plane"), 1)


class VNPointNet(nn.Module):
    """VN encoder (reference models/pcn.py:110-184; JAX models/pcn.py:413-482).

    ``num_coarse == 448``: 224 predicted points, then FPS(input, 224)
    appended (kernel F on the card).
    """

    def __init__(self, num_coarse: int = 1024, latent_dim: int = 1024):
        super().__init__()
        self.num_coarse = 224 if num_coarse == 448 else num_coarse
        self.fps_tail = num_coarse == 448
        self.global_shape = (2 * latent_dim, 3)
        self.use_kernels = True
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
            VNLinear(1024, self.num_coarse),
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
        if self.fps_tail:
            cat = concat_points(coarse, fps(xyz, 224, self.use_kernels))
            return (coarse, cat), feature_global
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
        pbias = channel_linear(w[:, :cg], glob, "plane")  # (B, 3, C, 1)
        dbias = channel_linear(wd[:, :cg], glob, "plane")
        if self.use_kernels and seed.shape[3] >= 4096:
            x2 = torch.cat([seed, point], dim=2)
            a, b = self.batchnorm.bn(
                **layer_moments(x2, w[:, cg:], pbias, self.training))
            return vn_layer_fused.vn_layer_fused(
                x2, w[:, cg:], wd[:, cg:], pbias, dbias, a, b, self.negative_slope,
            )
        p = (pbias + channel_linear(w[:, cg : cg + 1], seed, "plane")
             + channel_linear(w[:, cg + 1 :], point, "plane"))
        d = (dbias + channel_linear(wd[:, cg : cg + 1], seed, "plane")
             + channel_linear(wd[:, cg + 1 :], point, "plane"))
        a, b = self.batchnorm.bn(plane_norms(p) if self.training else None)
        return bn_leaky(p, d, a, b, self.negative_slope, self.use_kernels)


class _PairFoldLayer(VNLinearLeakyReLU):
    """A fold layer of the attention decoder, ``vn_folding{1,2}.0``.

    Mathematically VNLinearLeakyReLU over concat([var | feat]) with the
    reference's single (out, 1 + Cf) weight: ``var`` (B, 3, 1, N*S) varies
    over the S grid points of each of N centres, the centre feature ``feat``
    (B, 3, Cf, N) does not, so its contraction is taken once per centre and
    enters as a per-centre bias (JAX models/pcn.py:182-294).  At N*S >= 4096
    with S dividing 512 the rest of the layer is kernel B with ``group=S``
    (with kernel S for the train-mode statistics,
    ``_VNSplitPairFoldLayerFused``); otherwise the bias is expanded, added to
    the var product, and kernel A (or the plain chain) follows
    (``_VNSplitPairFoldLayer``).
    """

    def forward(self, feat, var, s: int):
        """feat (B, 3, Cf, N); var (B, 3, 1, N*S) -> (B, 3, C, N*S)."""
        w, wd = self.map_to_feat.weight, self.map_to_dir.weight
        pbias = channel_linear(w[:, 1:], feat, "plane")  # (B, 3, C, N) per centre
        dbias = channel_linear(wd[:, 1:], feat, "plane")
        if (self.use_kernels and var.shape[3] >= 4096
                and vn_layer_fused.GROUP_TILE % s == 0):
            a, b = self.batchnorm.bn(
                **layer_moments(var, w[:, :1], pbias, self.training, group=s))
            return vn_layer_fused.vn_layer_fused(
                var, w[:, :1], wd[:, :1], pbias, dbias, a, b, self.negative_slope, group=s)
        p = vn_layer_fused.expand_bias(pbias, s) + channel_linear(w[:, :1], var, "plane")
        d = vn_layer_fused.expand_bias(dbias, s) + channel_linear(wd[:, :1], var, "plane")
        a, b = self.batchnorm.bn(plane_norms(p) if self.training else None)
        return bn_leaky(p, d, a, b, self.negative_slope, self.use_kernels)


def _grid_like(grid: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
    """A folding grid on coarse's device, in at least float32: under the
    bf16 policy the seed is built and rotated in float32 and cast to bf16
    only where the fold chain takes it (JAX models/pcn.py:585-590)."""
    return grid.to(coarse.device, torch.promote_types(coarse.dtype, torch.float32))


def fold_grid(num_coarse: int):
    """(coarse points folded, grid side): 224 and 8 at ``num_coarse == 448``
    (14336 dense points), else ``num_coarse`` and 4."""
    return (224, 8) if num_coarse == 448 else (num_coarse, 4)


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

    def __init__(self, num_coarse: int = 1024, global_channels: int = 2048):
        super().__init__()
        self.nc, self.grid_size = fold_grid(num_coarse)
        self.final_conv = nn.ModuleList([
            _SplitFoldLayer(global_channels + 2, 256, layout="plane"),
            VNLinearLeakyReLU(256, 256, layout="plane"),
            VNLinear(256, 1, layout="plane"),
        ])

    def forward(self, coarse, feature_global, rot: Optional[torch.Tensor] = None):
        b = coarse.shape[0]
        s = self.grid_size ** 2
        num_dense = self.nc * s
        seed = _grid_like(folding_grid_3d(self.grid_size), coarse)  # (3, S)
        if rot is not None:
            seed = rotate_points(seed.T, rot).transpose(1, 2)[:, :, None]  # (B, 3, 1, S)
        else:
            seed = seed[None, :, None].expand(b, 3, 1, s)
        seed = seed[:, :, :, None, :].expand(b, 3, 1, self.nc, s).reshape(b, 3, 1, num_dense)
        point_feat = dense_layout(coarse, self.grid_size)[:, :, None]  # (B, 3, 1, Nd)
        glob = feature_global.transpose(1, 2)  # (B, 3, L, 1)
        # under the bf16 policy the fold chain runs in bf16 (its kernels take
        # their mode from x), not promoted by the float32 seed and coarse
        # constants; the residual add stays in the coarse points' dtype
        # (JAX models/pcn.py:585-611)
        f = self.final_conv[0](activation_dtype(glob), activation_dtype(seed),
                               activation_dtype(point_feat))
        f = self.final_conv[1](f, project_out=self.final_conv[2].map_to_feat.weight)
        fine = f.to(point_feat.dtype) + point_feat  # (B, 3, 1, Nd)
        return fine[:, :, 0].transpose(1, 2)


class AttentionVNFoldingNet(nn.Module):
    """Transformer + two-stage VN fold (reference models/pcn.py:392-520; JAX
    models/pcn.py:615-689).

    Two VN blocks (384 channels, 8 heads, ``qk_scale`` 1) run over per-centre
    features, the downsized global feature plus the centre, the latter put
    through the reference's scrambling ``repeat_input_centers`` reshape
    (copied as it is).  Then a [-1, 1] grid of S points is folded around each
    centre twice (``vn_folding1``, ``vn_folding2``: a pair fold layer, then a
    VNLinearLeakyReLU whose 1-channel VNLinear runs inside kernel C), and
    ``rebuild = relative_xyz + coarse``.  The rotation is not used.
    """

    def __init__(self, num_coarse: int = 1024, global_channels: int = 2048):
        super().__init__()
        self.grid_size = 8 if num_coarse == 448 else 4
        self.downsize_global = VNLinear(global_channels, 384)
        self.transformer = nn.ModuleList([
            VNBlock(384, 384, num_heads=8, qk_scale=1.0) for _ in range(2)])

        def folding():
            return nn.ModuleList([_PairFoldLayer(1 + 384, 256, layout="plane"),
                                  VNLinearLeakyReLU(256, 128, layout="plane"),
                                  VNLinear(128, 1, layout="plane")])

        self.vn_folding1, self.vn_folding2 = folding(), folding()

    def forward(self, coarse, feature_global, rot: Optional[torch.Tensor] = None):
        b, n, _ = coarse.shape
        s = self.grid_size ** 2
        # (B, 384, N, 3) -> (B, 1152, N) -> (B, N, 1152): the reference's reshape
        repeat_centers = coarse[:, None].expand(b, 384, n, 3).reshape(b, 384 * 3, n)
        fg = self.downsize_global(feature_global)  # (B, 384, 3, 1)
        fg = fg.expand(b, 384, 3, n).reshape(b, 384 * 3, n)
        vn_x = to_vn((fg + repeat_centers).transpose(1, 2))  # (B, 384, 3, N)
        for block in self.transformer:
            vn_x = block(vn_x)

        # (B, 3, 384, N), constant over each grid; bf16 under the bf16 policy,
        # the seed too (JAX models/pcn.py:660-666)
        feat = activation_dtype(vn_x.transpose(1, 2))
        seed = _grid_like(folding_grid_3d(self.grid_size, extent=1.0), coarse)  # (3, S)
        seed = seed[None, :, None, None, :].expand(b, 3, 1, n, s).reshape(b, 3, 1, n * s)
        fold = activation_dtype(seed)
        for stage in (self.vn_folding1, self.vn_folding2):
            h = stage[0](feat, fold, s)
            fold = stage[1](h, project_out=stage[2].map_to_feat.weight)  # (B, 3, 1, N*S)
        relative_xyz = fold[:, :, 0].reshape(b, 3, n, s).transpose(1, 2)  # (B, N, 3, S)
        rebuild = relative_xyz.to(coarse.dtype) + coarse[..., None]
        return rebuild.transpose(2, 3).reshape(b, n * s, 3)


class _ScalarSplitFoldLayer(nn.Module):
    """FoldingNet's first layer, ``final_conv.0``: a kernel-1 Conv1d over
    ``concat([glob | seed | point])`` with the reference's single (out,
    Cg + 5, 1) weight and a bias, the global part contracted once per sample
    (JAX models/pcn.py:156-179).  All of it is drawn with fan-in Cg + 5."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, glob, seed, point):
        """glob (B, Cg), seed (B, 2, Nd), point (B, 3, Nd) -> (B, out, Nd)."""
        w = self.weight[..., 0]
        cg = glob.shape[1]
        # a bf16 global feature (the bf16 policy) meets the float32 weight in
        # float32, as jnp's promotion takes it
        glob = glob.to(torch.promote_types(glob.dtype, w.dtype))
        return ((glob @ w[:, :cg].T)[:, :, None]
                + torch.einsum("oc,bcn->bon", w[:, cg:cg + 2], seed)
                + torch.einsum("oc,bcn->bon", w[:, cg + 2:], point)
                + self.bias[None, :, None])


class FoldingNet(nn.Module):
    """Scalar folding decoder (reference models/pcn.py:275-317; JAX
    :512-547): the flattened global feature, a 2-D seed grid and each coarse
    point through Conv1d + BatchNorm + ReLU twice and a Conv1d to 3, added
    to the coarse point.  The rotation is not used."""

    def __init__(self, num_coarse: int = 1024, global_size: int = 1024):
        super().__init__()
        self.nc, self.grid_size = fold_grid(num_coarse)
        self.final_conv = nn.ModuleList([
            _ScalarSplitFoldLayer(global_size + 5, 512), BatchNormCh(512), nn.ReLU(),
            ConvCh(512, 512), BatchNormCh(512), nn.ReLU(), ConvCh(512, 3),
        ])

    def forward(self, coarse, feature_global, rot: Optional[torch.Tensor] = None):
        b = coarse.shape[0]
        s = self.grid_size ** 2
        point_feat = dense_layout(coarse, self.grid_size)  # (B, 3, Nd)
        seed = _grid_like(folding_grid_2d(self.grid_size), coarse)  # (2, S)
        seed = seed[None, :, None, :].expand(b, 2, self.nc, s).reshape(b, 2, self.nc * s)
        fc = self.final_conv
        f = torch.relu(fc[1](fc[0](feature_global.reshape(b, -1), seed, point_feat)))
        f = torch.relu(fc[4](fc[3](f)))
        return (fc[6](f) + point_feat).transpose(1, 2)


class PCN(nn.Module):
    """Classic scalar PCN (reference models/pcn.py:186-273; JAX
    models/pcn.py:309-358): a shared point MLP with a max-pooled global
    feature, twice, an MLP to ``num_dense // grid_size^2`` coarse points, and
    a folding head as :class:`FoldingNet`'s.  ``forward(xyz, rot)`` returns
    ``(coarse, fine)``, ``fine`` None when ``only_coarse``; the rotation is
    not used.  Keys as the reference's Sequentials: ``first_conv``,
    ``second_conv``, ``mlp`` and ``final_conv``."""

    def __init__(self, num_dense: int = 16384, latent_dim: int = 1024, grid_size: int = 4,
                 only_coarse: bool = False):
        super().__init__()
        self.num_dense, self.grid_size, self.only_coarse = num_dense, grid_size, only_coarse
        self.num_coarse = num_dense // grid_size ** 2
        self.first_conv = nn.ModuleList([ConvCh(3, 128), BatchNormCh(128), nn.ReLU(),
                                         ConvCh(128, 256)])
        self.second_conv = nn.ModuleList([ConvCh(512, 512), BatchNormCh(512), nn.ReLU(),
                                          ConvCh(512, latent_dim)])
        self.mlp = nn.ModuleList([DenseTorch(latent_dim, 1024), nn.ReLU(), DenseTorch(1024, 1024),
                                  nn.ReLU(), DenseTorch(1024, 3 * self.num_coarse)])
        if not only_coarse:
            self.final_conv = nn.ModuleList([
                _ScalarSplitFoldLayer(latent_dim + 5, 512), BatchNormCh(512), nn.ReLU(),
                ConvCh(512, 512), BatchNormCh(512), nn.ReLU(), ConvCh(512, 3)])

    def forward(self, xyz, rot: Optional[torch.Tensor] = None):
        b = xyz.shape[0]
        fc, sc, mlp = self.first_conv, self.second_conv, self.mlp
        f = fc[3](torch.relu(fc[1](fc[0](xyz.transpose(1, 2)))))  # (B, 256, N)
        g = f.amax(2, keepdim=True)
        f = torch.cat([g.expand_as(f), f], dim=1)  # (B, 512, N)
        f = sc[3](torch.relu(sc[1](sc[0](f))))
        feature_global = f.amax(2)  # (B, latent)
        h = torch.relu(mlp[2](torch.relu(mlp[0](feature_global))))
        coarse = mlp[4](h).reshape(b, self.num_coarse, 3)
        if self.only_coarse:
            return coarse, None
        s = self.grid_size ** 2
        point_feat = dense_layout(coarse, self.grid_size)  # (B, 3, Nd)
        seed = _grid_like(folding_grid_2d(self.grid_size), coarse)  # (2, S)
        seed = seed[None, :, None, :].expand(b, 2, self.num_coarse, s).reshape(
            b, 2, self.num_dense)
        f = self.final_conv
        h = torch.relu(f[1](f[0](feature_global, seed, point_feat)))
        h = torch.relu(f[4](f[3](h)))
        return coarse, (f[6](h) + point_feat).transpose(1, 2)


class VNPCN(VNPointNet):
    """Standalone VN-PCN (reference models/pcn.py:11-108; JAX
    models/pcn.py:485-509): the VN-PointNet trunk with 1024 coarse points,
    ``forward(xyz, rot)`` -> ``(coarse, feature_global (B, 2L, 3, 1))``.
    Coarse only, as in JAX: the reference's dense path cannot run (its 5-D
    global feature meets a 3-argument ``expand``), so ``only_coarse=False``
    raises."""

    def __init__(self, num_dense: int = 16384, latent_dim: int = 1024, grid_size: int = 4,
                 only_coarse: bool = True):
        if not only_coarse:
            raise NotImplementedError(
                "VNPCN dense path is broken in the reference (models/pcn.py:97-108); "
                "use VNPointNet + VNFoldingNet via PCNNet instead")
        super().__init__(1024, latent_dim)

    def forward(self, xyz, rot: Optional[torch.Tensor] = None):
        return super().forward(xyz)
