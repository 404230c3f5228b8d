"""Work of the flagship's forward (``vn_pointnet`` + ``vn_foldingnet``) from
its shapes: B samples of ``n_partial`` points, ``num_coarse`` coarse points
and 16 fold points about each.  A layer whose output feeds only the next
one inside the model's own composition (a linear into its max pool, the
last fold layer into its 1-channel projection) is one operation: its
intermediate is neither written nor read."""

from __future__ import annotations

from port_bench.counts import F32, Work

GLOBAL = 2048
GRID = 16
BN_LEAKY_OPS = 30  # per output coordinate: the norm, BatchNorm, the reflection


def cloud_sizes(config: dict):
    return config["num_coarse"], GRID * config["num_coarse"]


def rotated_points(config: dict) -> int:
    """Points of the decoder's seed that the serving rotation turns."""
    return GRID


def params(config: dict) -> int:
    """Parameters that get a gradient (the pools' directions only choose)."""
    nc = config["num_coarse"]
    mats = [(128, 1), (128, 1), (512, 128), (1024, 1024), (1024, 1024), (GLOBAL, 1024),
            (2048, GLOBAL), (2048, 2048), (1024, 2048), (1024, 1024), (nc, 1024),
            (256, GLOBAL + 2), (256, GLOBAL + 2), (256, 256), (256, 256), (1, 256)]
    norms = 2 * (128 + 1024 + 256 + 256)
    return sum(a * b for a, b in mats) + norms


def vn_layer(name: str, b: int, n: int, c_in: int, c_out: int, project: int = 0) -> Work:
    """Linear + direction maps, BatchNorm on norms, reflection (and a fused
    ``project``-channel projection): x read, the output written once."""
    c_last = project or c_out
    return Work(name, flops=2 * b * 3 * n * c_in * 2 * c_out + 2 * b * 3 * n * c_out * project,
                ew=BN_LEAKY_OPS * b * 3 * n * c_out,
                nbytes=F32 * (b * 3 * n * (c_in + c_last) + 2 * c_in * c_out + c_out * project))


def linear_pool(name: str, b: int, n: int, c_in: int, c_out: int, keep: bool) -> Work:
    """VNLinear into VNMaxPool: the linear, the direction through the
    composed map (Wd W), the scores; ``keep``: the linear's output is used
    on (written), else only the pooled vectors are."""
    flops = 2 * b * 3 * n * c_in * c_out * 2 + 2 * c_out * c_out * c_in
    out = b * 3 * n * c_out if keep else b * 3 * c_out
    return Work(name, flops=flops, ew=5 * b * n * c_out,
                nbytes=F32 * (b * 3 * n * c_in + out + c_in * c_out + c_out * c_out))


def mlp(name: str, b: int, c_in: int, c_out: int, dirs: int) -> Work:
    """A VN map of the global feature, with its direction map (``dirs``)."""
    return Work(name, flops=2 * b * 3 * (c_in * c_out + c_out * dirs),
                ew=BN_LEAKY_OPS * b * 3 * c_out if dirs else 0,
                nbytes=F32 * (c_in * c_out + c_out * dirs + b * 3 * (c_in + c_out)))


def forward(config: dict, b: int) -> list:
    n, nc = config["n_partial"], config["num_coarse"]
    nd = GRID * nc
    return [
        vn_layer("encoder.first_conv.0", b, n, 1, 128),
        linear_pool("encoder.first_conv.1+maxpool1", b, n, 128, 512, keep=True),
        vn_layer("encoder.second_conv.0", b, n, 1024, 1024),
        linear_pool("encoder.second_conv.1+maxpool2", b, n, 1024, GLOBAL, keep=False),
        mlp("encoder.mlp.0", b, GLOBAL, 2048, 2048),
        mlp("encoder.mlp.1", b, 2048, 1024, 1024),
        mlp("encoder.mlp.2", b, 1024, nc, 0),
        Work("decoder.final_conv.0", flops=2 * b * 3 * 2 * 256 * (GLOBAL + 2 * nd),
             ew=BN_LEAKY_OPS * b * 3 * nd * 256,
             nbytes=F32 * (b * 3 * (GLOBAL + 2 * nd + 256 * nd) + 2 * 256 * (GLOBAL + 2))),
        vn_layer("decoder.final_conv.1+2", b, nd, 256, 256, project=1),
    ]
