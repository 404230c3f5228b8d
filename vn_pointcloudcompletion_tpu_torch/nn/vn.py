"""Vector Neuron layers, as ``torch.nn`` modules.

Port of ``vn_pointcloudcompletion_tpu/nn/vn.py``, the whole layer zoo, in
train and eval mode: the EdgeConv mode of ``VNLinearLeakyReLU``,
``VNLayerNorm``, ``VNMaxPool`` in both layouts, ``mean_pool`` and
``VNStdFeature`` included.  Feature tensors carry 3-vector channels in one
of two layouts:

- ``vec`` (B, C, 3, N...), the reference's;
- ``plane`` (B, 3, C, N), coordinate planes, for the wide layers: a channel
  map is one batched matrix product, and the fused kernels read aligned
  planes.

Submodule and parameter names follow the reference's ``state_dict`` layout
(``map_to_feat.weight``, ``batchnorm.bn.running_var``, ...), so reference
checkpoints load as they are.  BatchNorm follows ``module.training``: in
train mode it normalises with the batch statistics and updates its running
buffers (torch's semantics), in eval mode it uses the running buffers.

Layers that have a kernel carry ``use_kernels`` (default True): where it is
set and the JAX package would take its Pallas kernel for the shape, the
layer calls the kernel's wrapper (the kernel on a CUDA tensor, its plain
version on a CPU tensor); otherwise it runs the plain PyTorch chain.

Under the bfloat16 compute policy (``nn/precision.py``) every channel map
takes bf16 operands, accumulates in float32 and stores bf16 (JAX
``_channel_linear``); norm statistics stay in at least float32 with the
scale cast back; the pools' scores are bf16 products summed in float32;
the kernels run their bf16 modes (A, B, C, K3), which they take from the
dtype of the activations they are given.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vn_pointcloudcompletion_tpu_torch.nn import precision
from vn_pointcloudcompletion_tpu_torch.nn.precision import activation_dtype, bf16_policy, weak
from vn_pointcloudcompletion_tpu_torch.ops import knn_pallas, vn_fused, vn_layer_fused
from vn_pointcloudcompletion_tpu_torch.ops.knn import gather_planes, knn
from vn_pointcloudcompletion_tpu_torch.ops.vn_fused import safe_sqrt
from vn_pointcloudcompletion_tpu_torch.parallel.mesh import data_parallel, global_sums

EPS = 1e-6  # models/vn_layers.py:10 of the reference
# flax's BatchNorm momentum, the weight of the old running value (torch's 0.1)
BN_MOMENTUM = 0.9


def safe_norm(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """L2 norm with a gradient of 0 (not NaN) at exactly-zero vectors."""
    return safe_sqrt((x * x).sum(dim, keepdim=keepdim))


def channel_linear(w: torch.Tensor, x: torch.Tensor, layout: str) -> torch.Tensor:
    """Apply an (out, in) channel map: over axis 2 of (B, 3, C, N) planes or
    over axis 1 of (B, C, ...) vec tensors.  Under the bfloat16 policy both
    operands are cast to bf16, the sums run in float32 and the result is
    stored bf16 (JAX nn/vn.py:83-112)."""
    if bf16_policy():
        w, x = w.to(torch.bfloat16), x.to(torch.bfloat16)
    if layout == "plane":
        return precision.matmul(w, x)
    return precision.einsum("oc,bc...->bo...", w, x)


def vector_dot(u: torch.Tensor, v: torch.Tensor, dim: int) -> torch.Tensor:
    """<u, v> over the 3-vector axis ``dim``, summed in plane order; for
    bf16 vectors the products are rounded to bf16 and summed in float32,
    then rounded once (JAX's ``jnp.sum(x * d, axis)`` on bf16: the pools'
    scores)."""
    if u.dtype == torch.bfloat16:
        return (u * v).float().sum(dim).to(torch.bfloat16)
    u0, u1, u2 = u.unbind(dim)
    v0, v1, v2 = v.unbind(dim)
    return u0 * v0 + u1 * v1 + u2 * v2


def _leaky_reflect(p, d, negative_slope: float, dim: int):
    """The VN leaky ReLU: keep p where <p, d> >= 0, else remove its
    component along d; blend with ``negative_slope`` (vn_layers.py:38-43).
    bf16 vectors are computed in bf16, each operation rounded, with the
    constants rounded to bf16 as JAX's weak types round them."""
    dotprod = (p * d).sum(dim, keepdim=True)
    mask = (dotprod >= 0).to(p.dtype)
    d_norm_sq = (d * d).sum(dim, keepdim=True)
    reflected = p - (dotprod / (d_norm_sq + weak(EPS, p))) * d
    return weak(negative_slope, p) * p + weak(1 - negative_slope, p) * (
        mask * p + (1 - mask) * reflected
    )


class VNLinear(nn.Module):
    """Channel-mixing linear on vector features (vn_layers.py:12-22)."""

    def __init__(self, in_channels: int, out_channels: int, layout: str = "vec"):
        super().__init__()
        self.map_to_feat = nn.Linear(in_channels, out_channels, bias=False)
        self.layout = layout

    def forward(self, x):
        return channel_linear(self.map_to_feat.weight, x, self.layout)


class VNLeakyReLU(nn.Module):
    """Learned direction, reflect the negative half (vn_layers.py:25-43);
    vec layout."""

    def __init__(self, in_channels: int, share_nonlinearity: bool = False,
                 negative_slope: float = 0.2):
        super().__init__()
        out = 1 if share_nonlinearity else in_channels
        self.map_to_dir = nn.Linear(in_channels, out, bias=False)
        self.negative_slope = negative_slope

    def forward(self, x):
        d = channel_linear(self.map_to_dir.weight, x, "vec")
        return _leaky_reflect(x, d, self.negative_slope, dim=2)


class _NormAffine(nn.Module):
    """BatchNorm on vector norms, folded to a per-channel affine (A, B) with
    ``norm_bn = A * norm + B`` (JAX nn/vn.py:218-276).

    torch ``BatchNorm`` semantics: in train mode the batch statistics
    normalise (biased variance) and the running buffers take the unbiased
    variance, ``running = 0.9 * running + 0.1 * batch``; in eval mode the
    running buffers normalise.  The statistics come either from ``norm``
    (B, C, ...) or, on the whole-layer kernel path, from ``moments=(mean,
    biased var)`` with the reduction's element ``count``.  Under a
    data-parallel mesh of more than one rank the statistics are those of
    the global batch (``parallel/mesh.py::global_sums``; the kernel path's
    sums are reduced in :func:`layer_moments`).
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps

    def forward(self, norm: Optional[torch.Tensor] = None, moments=None,
                count=None):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            if moments is not None:
                mean, var = moments
                cnt = count
            else:
                dims = (0,) + tuple(range(2, norm.ndim))
                cnt = norm.numel() // norm.shape[1]
                if data_parallel():
                    s1, s2, cnt = global_sums(norm.sum(dims), (norm * norm).sum(dims), cnt)
                    mean = s1 / cnt
                    var = s2 / cnt - mean * mean
                else:
                    mean = norm.mean(dims)
                    var = (norm * norm).mean(dims) - mean * mean
            with torch.no_grad():
                unbiased = var * (cnt / torch.clamp_min(cnt - 1, 1) if torch.is_tensor(cnt)
                                  else cnt / max(cnt - 1, 1))
                m = BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * unbiased)
        a = self.weight * torch.rsqrt(var + self.eps)
        return a, self.bias - mean * a


class VNBatchNorm(nn.Module):
    """BatchNorm on vector norms, rescaling the vectors (vn_layers.py:107-127);
    vec layout (B, C, 3, N...)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.bn = _NormAffine(num_features)

    def forward(self, x):
        ct = torch.promote_types(x.dtype, torch.float32)
        norm = safe_norm(x.to(ct), dim=2) + EPS  # (B, C, N...)
        a, b = self.bn(norm)
        shape = (1, -1) + (1,) * (norm.ndim - 2)
        norm_bn = a.reshape(shape) * norm + b.reshape(shape)
        return x * (norm_bn / norm).to(x.dtype).unsqueeze(2)


def bn_leaky(p, d, a, b, negative_slope: float, use_kernels: bool):
    """Folded BN + leaky reflection on (B, 3, C, N) planes: kernel A where the
    JAX package takes its Pallas kernel, else the plain chain."""
    if use_kernels and vn_fused.eligible(p):
        return vn_fused.fused_bn_leaky(p, d, a, b, negative_slope)
    return vn_fused.reference_bn_leaky_planes(p, d, a, b, negative_slope)


def plane_norms(p: torch.Tensor) -> torch.Tensor:
    """``|p| + EPS`` of (B, 3, C, N) planes, at least float32: (B, C, N)."""
    return safe_norm(p.to(torch.promote_types(p.dtype, torch.float32)), dim=1) + EPS


def layer_moments(x, w, pbias, training: bool, group: int = 0) -> dict:
    """Arguments of ``_NormAffine`` for the whole-layer path: in train mode
    the batch moments of ``|W x + pbias| + EPS`` from kernel S (JAX
    nn/vn.py:457-466; ``group``: per-group bias columns), over every rank's
    rows under a data-parallel mesh; in eval mode none."""
    if not training:
        return {}
    s1, s2 = vn_layer_fused.vn_layer_stats(x, w, pbias, group)
    s1, s2, cnt = global_sums(s1, s2, x.shape[0] * x.shape[3])
    mean = s1 / cnt
    return {"moments": (mean, s2 / cnt - mean * mean), "count": cnt}


class VNLinearLeakyReLU(nn.Module):
    """Linear + norm-BatchNorm + leaky reflection (vn_layers.py:46-74).

    The direction map reads the input ``x``; the nonlinearity acts on the
    normalised ``p``, the reference's wiring.  In plane layout the layer
    takes kernel B/C (whole layer, with kernel S for the train-mode
    statistics) where ``layer_eligible`` holds and kernel A (BN + reflection
    after the products) where ``vn_fused.eligible`` holds; each kernel's
    backward is its own kernel.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 share_nonlinearity: bool = False, negative_slope: float = 0.2,
                 layout: str = "vec"):
        super().__init__()
        self.map_to_feat = nn.Linear(in_channels, out_channels, bias=False)
        d_out = 1 if share_nonlinearity else out_channels
        self.map_to_dir = nn.Linear(in_channels, d_out, bias=False)
        self.batchnorm = VNBatchNorm(out_channels)
        self.share_nonlinearity = share_nonlinearity
        self.negative_slope = negative_slope
        self.layout = layout
        self.use_kernels = True

    def forward(self, x, project_out: Optional[torch.Tensor] = None,
                edge_k: Optional[int] = None,
                edge_coords: Optional[torch.Tensor] = None):
        """``project_out``: optional (1, C_out) weight of a trailing
        1-channel VNLinear; the whole-layer kernel contracts it in-kernel.

        ``edge_k``: EdgeConv mode (plane layout), see :meth:`_edge`."""
        if edge_k is not None:
            return self._edge(x, edge_k, edge_coords)
        w, wd = self.map_to_feat.weight, self.map_to_dir.weight
        if self.layout == "plane":
            if self.use_kernels and vn_layer_fused.layer_eligible(
                x, w.shape[0], self.share_nonlinearity
            ):
                # the kernels' mode follows x: bf16 under the bf16 policy
                x = activation_dtype(x)
                a, b = self.batchnorm.bn(**layer_moments(x, w, None, self.training))
                if project_out is not None:
                    return vn_layer_fused.vn_layer_fused_project(
                        x, w, wd, None, None, a, b, project_out.reshape(-1),
                        self.negative_slope,
                    )
                return vn_layer_fused.vn_layer_fused(
                    x, w, wd, None, None, a, b, self.negative_slope
                )
            p = channel_linear(w, x, "plane")
            d = channel_linear(wd, x, "plane")
            if self.share_nonlinearity:
                d = d.expand_as(p)
            a, b = self.batchnorm.bn(plane_norms(p) if self.training else None)
            out = bn_leaky(p, d, a, b, self.negative_slope, self.use_kernels)
        else:
            pd = channel_linear(torch.cat([w, wd], dim=0), x, "vec")
            p, d = pd[:, : w.shape[0]], pd[:, w.shape[0]:]
            p = self.batchnorm(p)
            out = _leaky_reflect(p, d, self.negative_slope, dim=2)
        if project_out is not None:
            out = channel_linear(project_out, out, self.layout)
        return out

    def _edge(self, x, k: int, coords: Optional[torch.Tensor]):
        """EdgeConv over the kNN graph, then a mean over the K neighbours
        (JAX nn/vn.py:344-424): x (B, 3, C, N) -> (B, 3, C_out, N).

        The layer maps ``concat([x[nbr] - x[q], x[q]])``; being linear, that
        is ``u[nbr] + v[q]`` with ``u = W_diff x`` and ``v = (W_ctr - W_diff)
        x`` per point, the feature and direction maps stacked.  The graph is
        euclidean over ``coords`` (B, 3, N) when given, else over the
        flattened features.  Kernel K3 builds the graph and gathers where
        ``edge_gather_eligible`` holds (edge axis order (K, N)); elsewhere
        ``knn`` + a gather (order (N, K)).  Then BatchNorm and kernel A.
        """
        b, _, c, n = x.shape
        w, wd = self.map_to_feat.weight, self.map_to_dir.weight
        co = w.shape[0]
        w_diff = torch.cat([w[:, :c], wd[:, :c]], dim=0)
        w_ctr = torch.cat([w[:, c:], wd[:, c:]], dim=0)
        u = channel_linear(w_diff, x, "plane")  # (B, 3, Co + Do, N)
        v = channel_linear(w_ctr - w_diff, x, "plane")
        cpd = u.shape[2]
        xflat = coords if coords is not None else x.reshape(b, 3 * c, n)
        if knn_pallas.edge_gather_eligible(n, xflat.shape[1], k, 3 * cpd):
            args = (xflat, u.reshape(b, 3 * cpd, n), v.reshape(b, 3 * cpd, n), k)
            if self.use_kernels:
                pd = knn_pallas.edge_knn_gather(*args)
            else:
                pd = knn_pallas.reference_edge_knn_gather(*args)[0]
            pd = pd.reshape(b, 3, cpd, k * n)
            pool_shape, pool_dim = (b, 3, co, k, n), 3
        else:
            pts = xflat.transpose(1, 2)
            _, idx = knn(pts, pts, k, self.use_kernels)
            pd = gather_planes(u, idx).reshape(b, 3, cpd, n, k) + v[..., None]
            pd = pd.reshape(b, 3, cpd, n * k)
            pool_shape, pool_dim = (b, 3, co, n, k), 4
        p, d = pd[:, :, :co], pd[:, :, co:]
        if self.share_nonlinearity:
            d = d.expand_as(p)
        a, bb = self.batchnorm.bn(plane_norms(p) if self.training else None)
        out = bn_leaky(p, d, a, bb, self.negative_slope, self.use_kernels)
        return mean_pool(out.reshape(pool_shape), pool_dim)


class VNMaxPool(nn.Module):
    """Pool over the last axis by argmax of a learned projection
    (vn_layers.py:153-167), the first point on ties; the gradient reaches
    the selected vectors only.  ``plane``: (B, 3, C, N) -> (B, 3, C);
    ``vec``, rank-generic as the reference's meshgrid gather: (B, C, 3, N)
    -> (B, C, 3), (B, C, 3, N, K) -> (B, C, 3, N)."""

    def __init__(self, channels: int, layout: str = "plane"):
        super().__init__()
        self.map_to_dir = nn.Linear(channels, channels, bias=False)
        self.layout = layout

    def forward(self, x):
        if self.layout == "plane":
            d = channel_linear(self.map_to_dir.weight, x, "plane")
            idx = vector_dot(x, d, 1).argmax(dim=-1, keepdim=True)  # (B, C, 1)
            return torch.gather(x, 3, idx[:, None].expand(-1, 3, -1, -1))[..., 0]
        d = channel_linear(self.map_to_dir.weight, x, "vec")
        dot = vector_dot(x, d, 2)
        idx = dot.argmax(dim=-1, keepdim=True)[:, :, None]  # (B, C, 1, ..., 1)
        return torch.gather(x, -1, idx.expand(x.shape[:-1] + (1,)))[..., 0]


def mean_pool(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """vn_layers.py:170-171; bf16 is summed in float32 and the mean
    rounded once (JAX's ``jnp.mean`` upcasts it so)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return x.mean(dim, keepdim=keepdim, dtype=acc).to(x.dtype)


class VNLayerNorm(nn.Module):
    """LayerNorm over the channels of the vector norms, the vectors rescaled
    (vn_layers.py:129-150; JAX nn/vn.py:203-215): vec layout (B, C, 3,
    N...), statistics in at least float32, eps 1e-5."""

    def __init__(self, channels: int):
        super().__init__()
        self.layer_norm = nn.LayerNorm(channels, eps=1e-5)

    def forward(self, x):
        ct = torch.promote_types(x.dtype, torch.float32)
        norm = safe_norm(x.to(ct), dim=2) + EPS  # (B, C, N...)
        norm_l = nn.functional.layer_norm(
            norm.movedim(1, -1), (norm.shape[1],), self.layer_norm.weight.to(ct),
            self.layer_norm.bias.to(ct), self.layer_norm.eps).movedim(-1, 1)
        return x * (norm_l / norm).to(x.dtype).unsqueeze(2)


class VNStdFeature(nn.Module):
    """A learned invariant frame and the features expressed in it
    (vn_layers.py:174-220; JAX nn/vn.py:577-609), vec layout (B, C, 3,
    N...): returns ``(x_std (B, C, 3, N...), frame (B, 3, 3, N...))``, the
    frame in the reference's transposed layout (with ``normalize_frame`` two
    learned axes and their cross product)."""

    def __init__(self, in_channels: int, normalize_frame: bool = False,
                 share_nonlinearity: bool = False, negative_slope: float = 0.2):
        super().__init__()
        self.normalize_frame = normalize_frame
        self.vn1 = VNLinearLeakyReLU(in_channels, in_channels // 2, share_nonlinearity,
                                     negative_slope)
        self.vn2 = VNLinearLeakyReLU(in_channels // 2, in_channels // 4, share_nonlinearity,
                                     negative_slope)
        self.vn_lin = nn.Linear(in_channels // 4, 2 if normalize_frame else 3, bias=False)

    def forward(self, x):
        z0 = channel_linear(self.vn_lin.weight, self.vn2(self.vn1(x)), "vec")
        if self.normalize_frame:
            v1 = z0[:, 0]  # (B, 3, ...)
            u1 = v1 / (safe_norm(v1, dim=1, keepdim=True) + EPS)
            v2 = z0[:, 1]
            v2 = v2 - (v2 * u1).sum(1, keepdim=True) * u1
            u2 = v2 / (safe_norm(v2, dim=1, keepdim=True) + EPS)
            z0 = torch.stack([u1, u2, torch.cross(u1, u2, dim=1)], dim=1)
        x_std = torch.einsum("bij...,bkj...->bik...", x, z0)
        return x_std, z0.transpose(1, 2)


class VNLinearAndLeakyReLU(nn.Module):
    """Linear -> optional norm-BatchNorm -> VNLeakyReLU (vn_layers.py:77-104);
    vec layout."""

    def __init__(self, in_channels: int, out_channels: int,
                 share_nonlinearity: bool = False, use_batchnorm: str = "norm",
                 negative_slope: float = 0.2):
        super().__init__()
        self.linear = VNLinear(in_channels, out_channels)
        self.batchnorm = (
            VNBatchNorm(out_channels) if use_batchnorm != "none" else None
        )
        self.leaky_relu = VNLeakyReLU(
            out_channels, share_nonlinearity, negative_slope
        )

    def forward(self, x):
        x = self.linear(x)
        if self.batchnorm is not None:
            x = self.batchnorm(x)
        return self.leaky_relu(x)
