"""The reference's training steps and serving step.

``train_steps`` follows the program's first steps from the same initial
weights and batches: the forward in train mode, Chamfer-L1 of the coarse and
of the dense cloud, the gradient by autograd, the non-finite guard and
Adam(0.9, 0.999, eps 1e-8) written out, bias-corrected as ``torch.optim.Adam``
defines it.  ``serve`` completes and scores a batch in eval mode.
"""

from __future__ import annotations

import importlib

import torch

from port_bench.reference import geometry

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def model(config: dict):
    """The reference module of a configuration (``config['reference']``)."""
    return importlib.import_module(f"port_bench.reference.{config['reference']}")


def is_buffer(name: str) -> bool:
    return name.endswith((".running_mean", ".running_var"))


def train_steps(config: dict, weights: dict, batches, lr: float, steps: int = 3) -> dict:
    """``steps`` guarded Adam steps on ``batches`` [(partial, complete)] on
    the device: {"loss": [float], "grad1": {name: first gradient}, "params":
    {name: parameters after the last step}}.  Leaves without a gradient
    (the pools' directions, which only choose) are left out of grad1."""
    mod = model(config)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()
              if not is_buffer(k)}
    buffers = {k: v for k, v in weights.items() if is_buffer(k)}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {"loss": [], "grad1": {}}
    t = 0
    for i, (partial, complete) in enumerate(batches[:steps]):
        coarse, dense = mod.forward({**buffers, **params}, partial, None, train=True)
        loss = geometry.cd_loss_l1(coarse, complete) + geometry.cd_loss_l1(dense, complete)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        grads = {k: g for k, g in zip(names, grads) if g is not None}
        out["loss"].append(float(loss.detach()))
        if i == 0:
            out["grad1"] = {k: g.detach().clone() for k, g in grads.items()}
        finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                                    for g in grads.values())
        if not finite:
            continue
        t += 1
        bc1, bc2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
        with torch.no_grad():
            for k, g in grads.items():
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = v2[k].sqrt() / bc2 ** 0.5 + ADAM_EPS
                params[k].sub_(lr / bc1 * m[k] / denom)
    out["params"] = {k: p.detach() for k, p in params.items()}
    return out


@torch.no_grad()
def serve(config: dict, weights: dict, partial, complete, rot) -> dict:
    """Rotate, complete in eval mode and score one batch: coarse, dense and
    the per-sample metrics."""
    if rot is not None:
        partial = geometry.rotate_points(partial, rot)
        complete = geometry.rotate_points(complete, rot)
    coarse, dense = model(config).forward(weights, partial, rot, train=False)
    return {"coarse": coarse, "dense": dense, **geometry.completion_metrics(dense, complete)}


@torch.no_grad()
def score(dense, complete, rot) -> dict:
    """The per-sample metrics of a given completion against the rotated
    ground truth: how the reference scores the program's own completion."""
    if rot is not None:
        complete = geometry.rotate_points(complete, rot)
    return geometry.completion_metrics(dense, complete)
