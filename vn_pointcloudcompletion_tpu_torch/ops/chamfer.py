"""Chamfer distance: bidirectional nearest-neighbour squared distances.

Port of ``vn_pointcloudcompletion_tpu/ops/chamfer.py::chamfer_distance``, as
a ``torch.autograd.Function``.  The forward takes :func:`nn_bidirectional`
for 3-D clouds with enough pairs, which is kernel D on the card, exactly
where the JAX package takes its Pallas kernel on a TPU (chamfer.py:102);
everything else takes the plain diff-form version, any dimension.

The backward is that of the JAX op (chamfer.py:144-204), in plain PyTorch:
the JAX backward has no Pallas kernel.  With ``d1_n = |x_n - y_{i1_n}|^2``
and ``d2_m = |y_m - x_{i2_m}|^2``, the gradient for one cloud is a gather of
the matched points plus the other direction's matches scattered back in one
widened pass, ``2 (g1_n (x_n - y_{i1_n}) + x_n s_n - t_n)`` with
``s = scatter(g2)`` and ``t = scatter(g2 y)``.  The scatter is
``index_put_(..., accumulate=True)``, which on the card sorts the indices
and sums each row in a fixed order (``index_add_`` would use atomics), so a
train step gives the same bits on every run.
"""

from __future__ import annotations

import torch

from vn_pointcloudcompletion_tpu_torch.ops.chamfer_pallas_bidir import (
    nn_bidirectional,
    nn_bidirectional_reference,
)


def _use_kernel(x: torch.Tensor, y: torch.Tensor) -> bool:
    return (
        x.dtype == torch.float32 and x.shape[-1] == 3
        and x.shape[1] * y.shape[1] >= 256 * 256
    )


def _cross_term(idx, g, pts, n_rows):
    """Scatter ``[g * pts, g]`` of the other direction's matches onto their
    ``n_rows`` targets in one pass: returns (t (B, n_rows, D), s (B, n_rows, 1))."""
    u = torch.cat([g[..., None] * pts, g[..., None]], dim=-1)  # (B, M, D+1)
    bsz, width = u.shape[0], u.shape[2]
    rows = idx.long() + torch.arange(bsz, device=idx.device)[:, None] * n_rows
    out = torch.zeros(bsz * n_rows, width, dtype=u.dtype, device=u.device)
    out.index_put_((rows.reshape(-1),), u.reshape(-1, width), accumulate=True)
    out = out.reshape(bsz, n_rows, width)
    return out[..., :-1], out[..., -1:]


def _grad_side(g_self, other, g_other, i_self, i_other, self_pts):
    """Gradient for one cloud: its own direction's gather plus the cross
    term from the other direction (JAX chamfer.py::_grad_side)."""
    other_nn = torch.gather(other, 1, i_self.long()[..., None].expand(-1, -1, other.shape[2]))
    t, s = _cross_term(i_other, g_other, other, self_pts.shape[1])
    return 2.0 * (g_self[..., None] * (self_pts - other_nn) + self_pts * s - t)


class _Chamfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        if _use_kernel(x, y):
            d1, i1, d2, i2 = nn_bidirectional(x, y)
        else:
            d1, i1, d2, i2 = nn_bidirectional_reference(x, y)
        ctx.save_for_backward(x, y, i1, i2)
        ctx.mark_non_differentiable(i1, i2)
        return d1, d2, i1, i2

    @staticmethod
    def backward(ctx, g1, g2, _gi1, _gi2):
        x, y, i1, i2 = ctx.saved_tensors
        g1 = torch.zeros(i1.shape, dtype=x.dtype, device=x.device) if g1 is None else g1
        g2 = torch.zeros(i2.shape, dtype=x.dtype, device=x.device) if g2 is None else g2
        gx = gy = None
        if ctx.needs_input_grad[0]:
            gx = _grad_side(g1, y, g2, i1, i2, x)
        if ctx.needs_input_grad[1]:
            gy = _grad_side(g2, x, g1, i2, i1, y)
        return gx, gy


def chamfer_distance(x: torch.Tensor, y: torch.Tensor):
    """x (B, N, D), y (B, M, D) -> (dist1 (B, N), dist2 (B, M), idx1, idx2):
    squared distances and int32 indices of the nearest neighbours, at least
    float32, differentiable in x and y."""
    ct = torch.promote_types(torch.promote_types(x.dtype, y.dtype), torch.float32)
    return _Chamfer.apply(x.to(ct), y.to(ct))
