"""Work of the ``vn_pointr_448`` forward (``vn_pointr`` +
``attention_vn_foldingnet``) from its shapes: B samples of ``n_partial``
points; the grouper's k = 16 EdgeConv stages at 2048, 512, 512 and 128
points with furthest-point sampling between; six VN transformer blocks over
128 centres (the first with a k = 8 graph branch); the global pool and the
224-point head; two VN blocks over the 224 centres and two folds of 64 grid
points about each.  kNN and FPS count their distance operations as
elementwise work; an EdgeConv stage reads its points and writes the
neighbour-averaged output (its edges are not counted as memory)."""

from __future__ import annotations

import math

from port_bench.counts import F32, PAIR_OPS, Work
from port_bench.counts.flagship import BN_LEAKY_OPS

K = 16
PROXY_K = 8
CENTRES = 128
QUERIES = 224
GRID = 64


def cloud_sizes(config: dict):
    return 2 * QUERIES, QUERIES * GRID


def rotated_points(config: dict) -> int:
    return 0


def vn_map(name, b, n, c_in, c_out, dirs=0, bn=False, read=None, write=None) -> Work:
    """A VN channel map over n positions (with a direction map of ``dirs``
    outputs and BatchNorm + reflection where given)."""
    flops = 2 * b * 3 * n * c_in * (c_out + dirs)
    ew = BN_LEAKY_OPS * b * 3 * n * c_out if (bn or dirs) else 0
    rd = b * 3 * n * c_in if read is None else read
    wr = b * 3 * n * c_out if write is None else write
    return Work(name, flops=flops, ew=ew, nbytes=F32 * (rd + wr + c_in * (c_out + dirs)))


def edge(name, b, n, c, c_out, d) -> list:
    """kNN over d-dimensional points, then the layer on n K edges of 2c
    channels, averaged over K."""
    return [Work(name + ".knn", ew=3 * b * n * n * d, nbytes=F32 * b * n * (d + K)),
            vn_map(name, b, n * K, 2 * c, c_out, dirs=c_out, read=b * 3 * n * c,
                   write=b * 3 * n * c_out)]


def fps(name, b, n, s) -> Work:
    return Work(name, ew=9 * b * n * s, nbytes=F32 * b * 3 * (n + s))


def block(name, b, n, c, p, knn) -> list:
    out = [vn_map(name + ".attn.qkv", b, n, c, 3 * p),
           Work(name + ".attn.scores", flops=2 * 2 * b * n * n * 3 * p, ew=5 * b * n * n,
                nbytes=F32 * b * 3 * n * 3 * p),
           vn_map(name + ".attn.proj_vn", b, n, p, c)]
    if knn:
        out += [vn_map(name + ".conv1", b, n * PROXY_K, 2 * c, c, dirs=c, read=b * 3 * n * c,
                       write=b * 3 * n * c),
                vn_map(name + ".conv2", b, n, 2 * c, c)]
    return out + [vn_map(name + ".conv3", b, n, c, 2 * c, dirs=2 * c),
                  vn_map(name + ".conv4", b, n, 2 * c, c, dirs=c)]


def forward(config: dict, b: int) -> list:
    n = config["n_partial"]
    g = "encoder.grouper"
    items = (edge(f"{g}.conv1", b, n, 1, 32, 3) + [fps(f"{g}.fps512", b, n, 512)]
             + edge(f"{g}.conv4", b, 512, 32, 64, 96) + edge(f"{g}.conv5", b, 512, 64, 64, 192)
             + [fps(f"{g}.fps128", b, 512, CENTRES)] + edge(f"{g}.conv6", b, CENTRES, 64, 128, 192))
    m = CENTRES
    items += [vn_map("encoder.vn_input_proj.0", b, m, 128, 128, dirs=128),
              vn_map("encoder.vn_input_proj.1", b, m, 128, 128),
              Work("encoder.proxy_knn", ew=PAIR_OPS * b * m * m, nbytes=F32 * b * m * (3 + PROXY_K)),
              vn_map("encoder.fourth_vn_pos_embed.0.linear", b, m, 2, 128, bn=True),
              vn_map("encoder.fourth_vn_pos_embed.0.leaky_relu", b, m, 128, 0, dirs=128),
              vn_map("encoder.fourth_vn_pos_embed.1", b, m, 128, 128)]
    for i in range(6):
        items += block(f"encoder.encoder.{i}", b, m, 128, 384, knn=i == 0)
    items += [vn_map("encoder.vn_increase_dim.0.linear", b, m, 128, 1024, bn=True),
              vn_map("encoder.vn_increase_dim.0.leaky_relu", b, m, 1024, 0, dirs=1024),
              vn_map("encoder.vn_increase_dim.1", b, m, 1024, 1024),
              vn_map("encoder.vn_global_pool", b, m, 1024, 0, dirs=1024, write=b * 3 * 1024),
              vn_map("encoder.vn_coarse_pred.0", b, 1, 1024, 512),
              vn_map("encoder.vn_coarse_pred.1", b, 1, 512, 0, dirs=512, write=b * 3 * 512),
              vn_map("encoder.vn_coarse_pred.2", b, 1, 512, QUERIES),
              fps("encoder.fps224", b, n, QUERIES),
              vn_map("decoder.downsize_global", b, 1, 1024, 384)]
    q = QUERIES
    for i in range(2):
        items += block(f"decoder.transformer.{i}", b, q, 384, 384, knn=False)
    for f in ("vn_folding1", "vn_folding2"):
        items += [Work(f"decoder.{f}.0", flops=2 * b * 3 * 2 * 256 * (q * 384 + q * GRID),
                       ew=BN_LEAKY_OPS * b * 3 * q * GRID * 256,
                       nbytes=F32 * (b * 3 * (q * 384 + q * GRID + q * GRID * 256) + 2 * 256 * 385)),
                  vn_map(f"decoder.{f}.1+2", b, q * GRID, 256, 128, dirs=128,
                         write=b * 3 * q * GRID)]
        items[-1].flops += 2 * b * 3 * q * GRID * 128
        items[-1].nbytes += F32 * 128
    return items


def params(config: dict) -> int:
    """Parameters that get a gradient: all but the global pool's direction."""
    from port_bench.reference.vn_pointr import param_spec

    return sum(math.prod(s) for n, s in param_spec(config)
               if not n.endswith((".running_mean", ".running_var"))
               and n != "encoder.vn_global_pool.map_to_dir.weight")


