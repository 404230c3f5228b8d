"""The flagship pipeline of the reference: the ``vn_pointnet`` encoder and the
``vn_foldingnet`` decoder (reference repository ``models/pcn.py``:
``VN_PointNet`` and ``VN_FoldingNet``), at ``num_coarse`` 1024, a 2048-wide
global feature and a 4 x 4 fold: 16384 dense points.

Two departures from a literal reading, both the same function: a pool's
direction ``Wd (W x)`` is taken as ``(Wd W) x``, and the decoder's first
layer contracts the (per-sample constant) global feature once per sample
and adds it as a bias, instead of concatenating it to every point.
"""

from __future__ import annotations

import torch

from port_bench.reference import vn
from port_bench.reference.geometry import rotate_points

GLOBAL = 2048
GRID = 4


def spec_linear_leaky(name: str, c_in: int, c_out: int) -> list:
    return [(f"{name}.map_to_feat.weight", (c_out, c_in)),
            (f"{name}.map_to_dir.weight", (c_out, c_in))] + spec_bn(f"{name}.batchnorm.bn", c_out)


def spec_bn(name: str, c: int) -> list:
    return [(f"{name}.{k}", (c,)) for k in ("weight", "bias", "running_mean", "running_var")]


def param_spec(config: dict) -> list:
    """(name, shape) of every parameter and buffer, in ``state_dict`` order;
    ``config['num_coarse']`` coarse points (1024 as published)."""
    e, d = "encoder", "decoder"
    return (spec_linear_leaky(f"{e}.first_conv.0", 1, 128)
            + [(f"{e}.first_conv.1.map_to_feat.weight", (512, 128)),
               (f"{e}.maxpool1.map_to_dir.weight", (512, 512))]
            + spec_linear_leaky(f"{e}.second_conv.0", 1024, 1024)
            + [(f"{e}.second_conv.1.map_to_feat.weight", (GLOBAL, 1024)),
               (f"{e}.maxpool2.map_to_dir.weight", (GLOBAL, GLOBAL)),
               (f"{e}.mlp.0.linear.map_to_feat.weight", (2048, GLOBAL)),
               (f"{e}.mlp.0.leaky_relu.map_to_dir.weight", (2048, 2048)),
               (f"{e}.mlp.1.linear.map_to_feat.weight", (1024, 2048)),
               (f"{e}.mlp.1.leaky_relu.map_to_dir.weight", (1024, 1024)),
               (f"{e}.mlp.2.map_to_feat.weight", (config["num_coarse"], 1024))]
            + spec_linear_leaky(f"{d}.final_conv.0", GLOBAL + 2, 256)
            + spec_linear_leaky(f"{d}.final_conv.1", 256, 256)
            + [(f"{d}.final_conv.2.map_to_feat.weight", (1, 256))])


def folding_grid(g: int, extent: float, device) -> torch.Tensor:
    """(3, g*g) seed on the z = 0 plane, the first coordinate fastest."""
    lin = torch.linspace(-extent, extent, g, dtype=torch.float32, device=device)
    a = lin[None, :].expand(g, g).reshape(-1)
    b = lin[:, None].expand(g, g).reshape(-1)
    return torch.stack([a, b, torch.zeros_like(a)])


def linear_maxpool(w_feat, w_dir, x):
    """VNLinear then VNMaxPool on planes: (W x, pooled (B, 3, C_out))."""
    f = torch.matmul(w_feat, x)
    direction = torch.matmul((w_dir @ w_feat).detach(), x)
    return f, vn.maxpool_planes(f, direction)


def encode(w: dict, xyz: torch.Tensor, train: bool):
    """xyz (B, N, 3) -> (coarse (B, Nc, 3), feature_global (B, 2048, 3, 1))."""
    b, n, _ = xyz.shape
    x = xyz.transpose(1, 2)[:, :, None, :]
    f = vn.linear_leaky_planes(w, "encoder.first_conv.0", x, train)
    f, g = linear_maxpool(w["encoder.first_conv.1.map_to_feat.weight"],
                          w["encoder.maxpool1.map_to_dir.weight"], f)
    f = torch.cat([g[..., None].expand(-1, -1, -1, n), f], dim=2)
    f = vn.linear_leaky_planes(w, "encoder.second_conv.0", f, train)
    _, fg = linear_maxpool(w["encoder.second_conv.1.map_to_feat.weight"],
                           w["encoder.maxpool2.map_to_dir.weight"], f)
    glob = fg[..., None].transpose(1, 2)
    h = vn.linear_and_leaky_vec(w, "encoder.mlp.0", glob, train, batchnorm=False)
    h = vn.linear_and_leaky_vec(w, "encoder.mlp.1", h, train, batchnorm=False)
    coarse = vn.linear_vec(w["encoder.mlp.2.map_to_feat.weight"], h).reshape(b, -1, 3)
    return coarse, glob


def decode(w: dict, coarse, glob, rot, train: bool):
    """The VN fold: 16 grid points about each coarse point -> (B, 16 Nc, 3)."""
    b, nc, _ = coarse.shape
    s = GRID * GRID
    nd = nc * s
    seed = folding_grid(GRID, 0.05, coarse.device)
    if rot is not None:
        seed = rotate_points(seed.T, rot).transpose(1, 2)[:, :, None]
    else:
        seed = seed[None, :, None].expand(b, 3, 1, s)
    seed = seed[:, :, :, None, :].expand(b, 3, 1, nc, s).reshape(b, 3, 1, nd)
    point = coarse[:, :, None, :].expand(b, nc, s, 3).reshape(b, nd, 3).transpose(1, 2)[:, :, None]
    g = glob.transpose(1, 2)  # (B, 3, 2048, 1)
    name = "decoder.final_conv.0"
    wf, wd = w[name + ".map_to_feat.weight"], w[name + ".map_to_dir.weight"]
    cg = g.shape[2]
    p = (torch.matmul(wf[:, :cg], g) + torch.matmul(wf[:, cg:cg + 1], seed)
         + torch.matmul(wf[:, cg + 1:], point))
    d = (torch.matmul(wd[:, :cg], g) + torch.matmul(wd[:, cg:cg + 1], seed)
         + torch.matmul(wd[:, cg + 1:], point))
    a, bb = vn.norm_affine(w, name + ".batchnorm.bn", vn.planes_norm(p) if train else None, train)
    f = vn.bn_leaky_planes(p, d, a, bb)
    f = vn.linear_leaky_planes(w, "decoder.final_conv.1", f, train)
    f = torch.matmul(w["decoder.final_conv.2.map_to_feat.weight"], f)
    return (f + point)[:, :, 0].transpose(1, 2)


def forward(w: dict, xyz: torch.Tensor, rot, train: bool):
    """(coarse, dense) of the whole pipeline."""
    coarse, glob = encode(w, xyz, train)
    return coarse, decode(w, coarse, glob, rot, train)
