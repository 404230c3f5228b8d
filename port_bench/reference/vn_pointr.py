"""The ``vn_pointr_448`` pipeline of the reference: the ``vn_pointr`` encoder
(a VN DGCNN grouper, a VN transformer of six blocks, the first with a k=8
graph branch, a VN max pool and a coarse head of 224 points, with 224
furthest input points appended) and the ``attention_vn_foldingnet``
decoder (two VN transformer blocks over the 224 centres, then two VN folds
of an 8 x 8 grid about each): 448 coarse and 14336 dense points.

Written from the reference repository (``models/pointr/vn_pointr.py``,
``models/pcn.py``, ``utils/dgcnn_group.py``), with the PyTorch port's
deliberate choices where the repo leaves them open: 224 predicted coarse
points (not 1024), the reference's own scrambling reshape of the centres
in the decoder, attention scale (P / H)^-0.5 in the encoder and 1 in the
decoder.  The EdgeConv features are ``concat([x_j - x_i, x_i])`` over the
k = 16 nearest neighbours (of the coordinates for the first stage, of the
flattened features after) and are averaged over the neighbours.
"""

from __future__ import annotations

import torch

from port_bench.reference import vn
from port_bench.reference.flagship import folding_grid, spec_bn, spec_linear_leaky
from port_bench.reference.geometry import furthest_point_indices, knn_indices

K = 16
PROXY_K = 8
EMBED = 384
C = EMBED // 3
HEADS = 4


def spec_lin(name: str, c_in: int, c_out: int) -> list:
    return [(f"{name}.map_to_feat.weight", (c_out, c_in))]


def spec_lin_and_leaky(name: str, c_in: int, c_out: int) -> list:
    return (spec_lin(f"{name}.linear", c_in, c_out) + spec_bn(f"{name}.batchnorm.bn", c_out)
            + [(f"{name}.leaky_relu.map_to_dir.weight", (c_out, c_out))])


def spec_ln(name: str, c: int) -> list:
    return [(f"{name}.layer_norm.weight", (c,)), (f"{name}.layer_norm.bias", (c,))]


def spec_block(name: str, c: int, attn: int, knn: bool) -> list:
    out = spec_ln(f"{name}.norm1", c)
    for p in ("proj_vnq", "proj_vnk", "proj_vnv"):
        out += spec_lin(f"{name}.attn.{p}", c, attn)
    out += spec_lin(f"{name}.attn.proj_vn", attn, c)
    if knn:
        out += spec_linear_leaky(f"{name}.conv1", 2 * c, c) + spec_lin(f"{name}.conv2", 2 * c, c)
    return (out + spec_ln(f"{name}.norm2", c) + spec_linear_leaky(f"{name}.conv3", c, 2 * c)
            + spec_linear_leaky(f"{name}.conv4", 2 * c, c))


def param_spec(config: dict) -> list:
    """(name, shape) of every parameter and buffer, in ``state_dict`` order."""
    e, d = "encoder", "decoder"
    out = (spec_linear_leaky(f"{e}.grouper.conv1.0", 2, 32)
           + spec_linear_leaky(f"{e}.grouper.conv4", 64, 64)
           + spec_linear_leaky(f"{e}.grouper.conv5", 128, 64)
           + spec_linear_leaky(f"{e}.grouper.conv6", 128, 128)
           + spec_linear_leaky(f"{e}.vn_input_proj.0", 128, 128)
           + spec_lin(f"{e}.vn_input_proj.1", 128, 128)
           + spec_lin_and_leaky(f"{e}.fourth_vn_pos_embed.0", 2, 128)
           + spec_lin(f"{e}.fourth_vn_pos_embed.1", 128, 128))
    for i in range(6):
        out += spec_block(f"{e}.encoder.{i}", C, EMBED, knn=i == 0)
    out += (spec_lin_and_leaky(f"{e}.vn_increase_dim.0", C, 1024)
            + spec_lin(f"{e}.vn_increase_dim.1", 1024, 1024)
            + [(f"{e}.vn_global_pool.map_to_dir.weight", (1024, 1024))]
            + spec_lin(f"{e}.vn_coarse_pred.0", 1024, 512)
            + [(f"{e}.vn_coarse_pred.1.map_to_dir.weight", (512, 512))]
            + spec_lin(f"{e}.vn_coarse_pred.2", 512, 224)
            + spec_lin(f"{d}.downsize_global", 1024, 384))
    for i in range(2):
        out += spec_block(f"{d}.transformer.{i}", 384, 384, knn=False)
    for f in ("vn_folding1", "vn_folding2"):
        out += (spec_linear_leaky(f"{d}.{f}.0", 385, 256) + spec_linear_leaky(f"{d}.{f}.1", 256, 128)
                + spec_lin(f"{d}.{f}.2", 128, 1))
    return out


def to_vn(x):
    """(B, N, 3C) -> (B, C, 3, N)."""
    b, n, c3 = x.shape
    return x.transpose(1, 2).reshape(b, c3 // 3, 3, n)


def to_scalar(x):
    """(B, C, 3, N) -> (B, N, 3C)."""
    b, c, _, n = x.shape
    return x.reshape(b, c * 3, n).transpose(1, 2)


def take(x, idx):
    """Gather along the last axis: x (B, ..., N), idx (B, S) -> (B, ..., S)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x.movedim(-1, 1)[rows, idx].movedim(1, -1)


def edge_features(x, idx):
    """Plane-layout EdgeConv features: x (B, 3, C, N), idx (B, N, K) ->
    (B, 3, 2C, N, K), ``concat([x_j - x_i, x_i])``."""
    b, _, c, n = x.shape
    rows = torch.arange(b, device=x.device)[:, None, None]
    nbr = x.permute(0, 3, 1, 2)[rows, idx]  # (B, N, K, 3, C)
    nbr = nbr.permute(0, 3, 4, 1, 2)
    ctr = x[..., None].expand_as(nbr)
    return torch.cat([nbr - ctr, ctr], dim=2)


def edge_stage(w, name, x, train, coords=None):
    """One EdgeConv stage over the k = 16 graph of ``coords`` (B, 3, N) or of
    the flattened features: the layer on every edge, the mean over K."""
    b, _, c, n = x.shape
    pts = (coords if coords is not None else x.reshape(b, 3 * c, n)).transpose(1, 2)
    f = edge_features(x, knn_indices(pts, pts, K))
    out = vn.linear_leaky_planes(w, name, f.reshape(b, 3, 2 * c, n * K), train)
    return out.reshape(b, 3, -1, n, K).mean(-1)


def grouper(w, xyz, train):
    """coor (B, 3, 128), features (B, 128, 3, 128)."""
    g = "encoder.grouper"
    coor = xyz.transpose(1, 2)
    f = edge_stage(w, f"{g}.conv1.0", coor[:, :, None, :], train, coords=coor)
    idx = furthest_point_indices(xyz, 512)
    coor_q, f = take(coor, idx), take(f, idx)
    f = edge_stage(w, f"{g}.conv4", f, train)
    f = edge_stage(w, f"{g}.conv5", f, train)
    idx = furthest_point_indices(coor_q.transpose(1, 2), 128)
    coor_q, f = take(coor_q, idx), take(f, idx)
    return coor_q, edge_stage(w, f"{g}.conv6", f, train).transpose(1, 2)


def attention(w, name, x, heads, scale):
    """VN multi-head attention: per-head VN q, k, v maps, dot products over
    the flattened head vectors, softmax over the keys, a VN map back."""
    b, _, _, n = x.shape
    p = w[f"{name}.proj_vnq.map_to_feat.weight"].shape[0]

    def split(t):
        t = t.reshape(b, heads, p // heads, 3, n)
        return t.permute(0, 1, 4, 2, 3).reshape(b, heads, n, (p // heads) * 3)

    q, k, v = (split(vn.linear_vec(w[f"{name}.{m}.map_to_feat.weight"], x))
               for m in ("proj_vnq", "proj_vnk", "proj_vnv"))
    att = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    out = torch.matmul(att, v).permute(0, 2, 1, 3).reshape(b, n, p, 3).permute(0, 2, 3, 1)
    return vn.linear_vec(w[f"{name}.proj_vn.map_to_feat.weight"], out)


def block(w, name, x, train, heads, scale, knn_idx=None):
    """Pre-norm VN transformer block, with the graph branch when given."""
    norm_x = vn.layer_norm_vec(w, f"{name}.norm1", x)
    x_1 = attention(w, f"{name}.attn", norm_x, heads, scale)
    if knn_idx is not None:
        b, c, _, n = norm_x.shape
        flat = norm_x.permute(0, 3, 1, 2).reshape(b, n, c * 3)
        rows = torch.arange(b, device=x.device)[:, None, None]
        nbr = flat[rows, knn_idx].reshape(b, n, -1, c, 3).permute(0, 3, 4, 1, 2)
        ctr = norm_x[..., None].expand_as(nbr)
        f = vn.linear_leaky_vec(w, f"{name}.conv1", torch.cat([nbr - ctr, ctr], 1), train)
        x_1 = vn.linear_vec(w[f"{name}.conv2.map_to_feat.weight"], torch.cat([x_1, f.mean(-1)], 1))
    x = x + x_1
    h = vn.linear_leaky_vec(w, f"{name}.conv3", vn.layer_norm_vec(w, f"{name}.norm2", x), train)
    return x + vn.linear_leaky_vec(w, f"{name}.conv4", h, train)


def encode(w, xyz, train):
    """-> (coarse 224 (B, 224, 3), with the FPS points (B, 448, 3),
    global feature (B, 1024, 3, 1))."""
    e = "encoder"
    b = xyz.shape[0]
    coor, f = grouper(w, xyz, train)
    nc = f.shape[-1]
    f = vn.linear_leaky_vec(w, f"{e}.vn_input_proj.0", f, train)
    x = to_scalar(vn.linear_vec(w[f"{e}.vn_input_proj.1.map_to_feat.weight"], f))
    pts = coor.transpose(1, 2)
    knn_idx = knn_indices(pts, pts, PROXY_K)
    rep = xyz.mean(1)[:, None, :, None].expand(b, 1, 3, nc)
    fourth = torch.cat([coor[:, None], rep], dim=1)
    pos = vn.linear_and_leaky_vec(w, f"{e}.fourth_vn_pos_embed.0", fourth, train)
    pos = to_scalar(vn.linear_vec(w[f"{e}.fourth_vn_pos_embed.1.map_to_feat.weight"], pos))
    scale = (EMBED // HEADS) ** -0.5
    for i in range(6):
        x = to_scalar(block(w, f"{e}.encoder.{i}", to_vn(x + pos), train, HEADS, scale,
                            knn_idx if i == 0 else None))
    g = vn.linear_and_leaky_vec(w, f"{e}.vn_increase_dim.0", to_vn(x), train)
    g = vn.linear_vec(w[f"{e}.vn_increase_dim.1.map_to_feat.weight"], g)
    glob = vn.maxpool_vec(g, vn.linear_vec(w[f"{e}.vn_global_pool.map_to_dir.weight"], g))[..., None]
    h = vn.linear_vec(w[f"{e}.vn_coarse_pred.0.map_to_feat.weight"], glob)
    h = vn.leaky_vec(h, vn.linear_vec(w[f"{e}.vn_coarse_pred.1.map_to_dir.weight"], h))
    coarse = vn.linear_vec(w[f"{e}.vn_coarse_pred.2.map_to_feat.weight"], h)[..., 0]
    fps = torch.gather(xyz, 1, furthest_point_indices(xyz, 224)[..., None].expand(-1, -1, 3))
    return coarse, torch.cat([coarse, fps], dim=1), glob


def fold_layer(w, name, feat, var, s, train):
    """The first layer of a fold over concat([grid | centre feature]): the
    centre's part contracted once per centre and repeated over its s grid
    points."""
    wf, wd = w[f"{name}.map_to_feat.weight"], w[f"{name}.map_to_dir.weight"]
    p = torch.matmul(wf[:, 1:], feat).repeat_interleave(s, dim=3) + torch.matmul(wf[:, :1], var)
    d = torch.matmul(wd[:, 1:], feat).repeat_interleave(s, dim=3) + torch.matmul(wd[:, :1], var)
    a, b = vn.norm_affine(w, f"{name}.batchnorm.bn", vn.planes_norm(p) if train else None, train)
    return vn.bn_leaky_planes(p, d, a, b)


def decode(w, coarse, glob, train):
    """224 centres -> (B, 224 * 64, 3)."""
    dd = "decoder"
    b, n, _ = coarse.shape
    s = 64
    centres = coarse[:, None].expand(b, 384, n, 3).reshape(b, 384 * 3, n)
    fg = vn.linear_vec(w[f"{dd}.downsize_global.map_to_feat.weight"], glob)
    x = fg.expand(b, 384, 3, n).reshape(b, 384 * 3, n) + centres
    x = to_vn(x.transpose(1, 2))
    for i in range(2):
        x = block(w, f"{dd}.transformer.{i}", x, train, 8, 1.0)
    feat = x.transpose(1, 2)
    fold = folding_grid(8, 1.0, coarse.device)[None, :, None, None, :].expand(
        b, 3, 1, n, s).reshape(b, 3, 1, n * s)
    for f in ("vn_folding1", "vn_folding2"):
        h = fold_layer(w, f"{dd}.{f}.0", feat, fold, s, train)
        h = vn.linear_leaky_planes(w, f"{dd}.{f}.1", h, train)
        fold = torch.matmul(w[f"{dd}.{f}.2.map_to_feat.weight"], h)
    rel = fold[:, :, 0].reshape(b, 3, n, s).transpose(1, 2)
    return (rel + coarse[..., None]).transpose(2, 3).reshape(b, n * s, 3)


def forward(w: dict, xyz: torch.Tensor, rot, train: bool):
    """(coarse 448, dense 14336); the rotation is not used by this pipeline."""
    coarse, cat, glob = encode(w, xyz, train)
    return cat, decode(w, coarse, glob, train)
