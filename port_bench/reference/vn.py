"""Vector Neuron layers of the reference, functional, on a dict of weights.

Written from the Vector Neurons equations as the reference repository
(ChenBarryHu/VN_PointCloudCompletion, ``models/vn_layers.py``) states them:
a channel map ``W x`` of 3-vector features, BatchNorm on the vectors' norms
(``|p| + 1e-6``; batch moments in train mode, the running buffers in eval
mode; eps 1e-5), and the leaky reflection with slope 0.2 of ``p`` against a
learned direction ``d = Wd x``.  Features are in plane layout (B, 3, C, N)
for the point-wise layers and in the reference's vec layout (B, C, 3, ...)
for the rest.  Weight names are the reference's ``state_dict`` keys.
"""

from __future__ import annotations

import torch

EPS = 1e-6
SLOPE = 0.2
BN_EPS = 1e-5


def safe_sqrt(sq: torch.Tensor) -> torch.Tensor:
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)


def plane_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """<u, v> over axis 1 of (B, 3, ...)."""
    return u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1] + u[:, 2] * v[:, 2]


def norm_affine(w: dict, name: str, norm: torch.Tensor, train: bool):
    """BatchNorm of the norms ``norm`` (B, C, ...) folded to a per-channel
    ``(a, b)`` with ``bn(norm) = a norm + b``."""
    if train:
        dims = (0,) + tuple(range(2, norm.ndim))
        mean = norm.mean(dims)
        var = (norm * norm).mean(dims) - mean * mean
    else:
        mean, var = w[name + ".running_mean"], w[name + ".running_var"]
    a = w[name + ".weight"] * torch.rsqrt(var + BN_EPS)
    return a, w[name + ".bias"] - mean * a


def bn_leaky_planes(p, d, a, b):
    """BatchNorm of p's norms, then the leaky reflection against d, on
    (B, 3, C, N) planes."""
    norm = safe_sqrt(plane_dot(p, p)) + EPS
    q = p * (a[None, :, None] + b[None, :, None] / norm)[:, None]
    dot = plane_dot(q, d)[:, None]
    z = plane_dot(d, d)[:, None] + EPS
    return q - torch.where(dot >= 0, 0.0, (1 - SLOPE) * dot / z) * d


def planes_norm(p: torch.Tensor) -> torch.Tensor:
    return safe_sqrt(plane_dot(p, p)) + EPS


def linear_leaky_planes(w: dict, name: str, x: torch.Tensor, train: bool,
                        p_extra=None, d_extra=None):
    """VNLinearLeakyReLU on planes (B, 3, C_in, N): p = W x (+ p_extra), d =
    Wd x (+ d_extra), BatchNorm on |p|, reflection."""
    p = torch.matmul(w[name + ".map_to_feat.weight"], x)
    d = torch.matmul(w[name + ".map_to_dir.weight"], x)
    if p_extra is not None:
        p, d = p + p_extra, d + d_extra
    a, b = norm_affine(w, name + ".batchnorm.bn", planes_norm(p) if train else None, train)
    return bn_leaky_planes(p, d, a, b)


def linear_vec(weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Channel map over axis 1 of (B, C, 3, ...)."""
    return torch.einsum("oc,bc...->bo...", weight, x)


def leaky_vec(p: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The leaky reflection over the 3-vector axis 2 of (B, C, 3, ...)."""
    dot = (p * d).sum(2, keepdim=True)
    mask = (dot >= 0).to(p.dtype)
    reflected = p - (dot / ((d * d).sum(2, keepdim=True) + EPS)) * d
    return SLOPE * p + (1 - SLOPE) * (mask * p + (1 - mask) * reflected)


def batchnorm_vec(w: dict, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    """VNBatchNorm on (B, C, 3, ...): the vectors rescaled by bn(|x|) / |x|."""
    norm = safe_sqrt((x * x).sum(2)) + EPS
    a, b = norm_affine(w, name, norm, train)
    shape = (1, -1) + (1,) * (norm.ndim - 2)
    return x * ((a.reshape(shape) * norm + b.reshape(shape)) / norm).unsqueeze(2)


def linear_leaky_vec(w: dict, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    """VNLinearLeakyReLU on (B, C, 3, ...): the direction read from x."""
    p = linear_vec(w[name + ".map_to_feat.weight"], x)
    d = linear_vec(w[name + ".map_to_dir.weight"], x)
    return leaky_vec(batchnorm_vec(w, name + ".batchnorm.bn", p, train), d)


def linear_and_leaky_vec(w: dict, name: str, x: torch.Tensor, train: bool,
                         batchnorm: bool = True) -> torch.Tensor:
    """VNLinearAndLeakyReLU: linear, optional BatchNorm, then a VNLeakyReLU
    whose direction reads the (normalised) linear output."""
    x = linear_vec(w[name + ".linear.map_to_feat.weight"], x)
    if batchnorm:
        x = batchnorm_vec(w, name + ".batchnorm.bn", x, train)
    return leaky_vec(x, linear_vec(w[name + ".leaky_relu.map_to_dir.weight"], x))


def maxpool_planes(f: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Per channel, the vector of the point with the largest <f, d> (the
    first on ties): (B, 3, C, N) -> (B, 3, C).  Only the selected vectors
    carry a gradient."""
    idx = plane_dot(f, direction).argmax(dim=-1, keepdim=True)  # (B, C, 1)
    return torch.gather(f, 3, idx[:, None].expand(-1, 3, -1, -1))[..., 0]


def maxpool_vec(f: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """The same over the last axis of (B, C, 3, N)."""
    dot = (f * direction).sum(2)
    idx = dot.argmax(dim=-1, keepdim=True)[:, :, None]
    return torch.gather(f, -1, idx.expand(f.shape[:-1] + (1,)))[..., 0]


def layer_norm_vec(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """VNLayerNorm: LayerNorm (eps 1e-5) over the channels of the norms,
    the vectors rescaled."""
    norm = safe_sqrt((x * x).sum(2)) + EPS  # (B, C, N)
    normed = torch.nn.functional.layer_norm(
        norm.movedim(1, -1), (norm.shape[1],), w[name + ".layer_norm.weight"],
        w[name + ".layer_norm.bias"], 1e-5).movedim(-1, 1)
    return x * (normed / norm).unsqueeze(2)
