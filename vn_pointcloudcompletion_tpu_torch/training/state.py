"""Optimiser state: Adam(0.9, 0.999) under StepLR(50 epochs, 0.8), optional
global-norm clipping, and the freeze masks (port of ``training/state.py``;
reference ``train.py:60-93``).

``torch.optim.Adam`` computes optax's ``adam`` update (``mu_hat / (sqrt(nu_hat)
+ eps)`` with bias correction by the step count) and keeps its state in the
reference's ``optimizer.state_dict()`` layout.  The learning rate is set
before every update from the count of accepted steps, so a resumed run
continues the schedule and a skipped step does not advance it, as the
optax schedule driven by ``opt_state``'s count does.  Frozen parameters
(``freeze_encoder``, or a pretrained encoder: ``enc_pretrained``;
``freeze_decoder``) stay out of the optimiser, the counterpart of optax's
``set_to_zero`` branch (JAX ``training/state.py:51``) and of the
reference's ``requires_grad=False`` on a model in train mode: their
gradients are still computed (and checked by the non-finite guard) but
never applied, and a frozen encoder's BatchNorm running statistics still
move.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch
from torch import nn

from vn_pointcloudcompletion_tpu_torch.utils.config import Config


def step_lr(base_lr: float, count: int, steps_per_epoch: int,
            step_size_epochs: int = 50, gamma: float = 0.8) -> float:
    """StepLR over epochs, driven by the count of accepted steps."""
    epoch = count // max(steps_per_epoch, 1)
    return base_lr * gamma ** (epoch // step_size_epochs)


def trainable_parameters(model: nn.Module, config: Config) -> List[nn.Parameter]:
    """Every parameter outside the frozen top-level submodules."""
    frozen = set()
    if config.freeze_encoder or config.enc_pretrained != "none":
        frozen.add("encoder")
    if config.freeze_decoder:
        frozen.add("decoder")
    return [p for name, p in model.named_parameters()
            if name.split(".")[0] not in frozen]


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """Replace ``grads`` in place by ``g / norm * max_norm`` when their
    global norm reaches ``max_norm`` (``optax.clip_by_global_norm``), with
    no host read."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


@dataclass
class TrainState:
    """The model, its optimiser and the count of accepted steps."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    config: Config
    steps_per_epoch: int
    step: int = 0

    def apply_gradients(self) -> None:
        """One Adam update from the ``.grad`` of the trainable parameters
        (clipped first when ``clip_gradient > 0``) at the scheduled rate."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]
                  if p.grad is not None]
        clip = self.config.clip_gradient or 0.0
        if clip > 0:
            clip_by_global_norm([p.grad for p in params], clip)
        lr = step_lr(self.config.lr, self.step, self.steps_per_epoch)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, config: Config,
                       steps_per_epoch: int) -> TrainState:
    opt = torch.optim.Adam(trainable_parameters(model, config), lr=config.lr,
                           betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model, opt, config, steps_per_epoch)
