"""Train mode: a closed loop of guarded steps of the program
(``training/steps.py::train_step`` on a ``TrainState`` with Adam), each on
a batch staged from pinned host memory (``data/pipeline.py::stage_batch``).

Set-up builds the one ``TrainState`` that the window drives and runs its
first steps through the window's own call and feed on distinct pool
batches; the first three are the ones the reference follows.  It keeps
their losses, the first gradient as Adam received it (its first moment
after one step, over 1 - beta1) and the parameters after the third step.
"""

from __future__ import annotations

import time

import torch

from port_bench import check, traffic, weights
from port_bench.reference import steps as reference
from port_bench.tracing import span, stamp
from vn_pointcloudcompletion_tpu_torch.data.pipeline import stage_batch
from vn_pointcloudcompletion_tpu_torch.models.composer import PCNNet
from vn_pointcloudcompletion_tpu_torch.nn.precision import compute_dtype_scope, from_config_dtype
from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state
from vn_pointcloudcompletion_tpu_torch.training.steps import train_step
from vn_pointcloudcompletion_tpu_torch.utils.config import Config

CHECK_STEPS = 3


def build_model(config: dict, w: dict, device: torch.device) -> PCNNet:
    """The program's model with the benchmark's weights (no host init)."""
    with torch.device("meta"):
        model = PCNNet(config["enc_type"], config["dec_type"], config["num_coarse"])
    model.load_state_dict(w, strict=True, assign=True)
    return model.to(device)


class Train:
    def __init__(self, config: dict, work: dict, seed: int, device: torch.device):
        self.config, self.work, self.device = config, work, device
        self.batch = work["batch"]
        offsets = work["seed_offsets"]
        self.pool = traffic.pool(seed + offsets["data"], work["pool"], self.batch,
                                 config["n_partial"], config["n_dense"])
        if len(self.pool) < CHECK_STEPS:
            raise ValueError("the pool holds fewer batches than the checked steps")
        stamp("data pool")
        self.spec = reference.model(config).param_spec(config)
        self.w_seed = seed + offsets["weights"]
        model = build_model(config, weights.make(self.spec, self.w_seed, device), device)
        cfg = Config(enc_type=config["enc_type"], dec_type=config["dec_type"],
                     num_coarse=config["num_coarse"], dtype=config["dtype"],
                     rotation=work["rotation"], lr=work["lr"], batch_size=self.batch)
        self.state = create_train_state(model, cfg, work["steps_per_epoch"])
        self.gen = torch.Generator().manual_seed(seed + offsets["rotation"])
        self.scope = compute_dtype_scope(from_config_dtype(config["dtype"]))
        self.scope.__enter__()
        self.names = {p: n for n, p in model.named_parameters()}
        stamp("weights, model and optimizer")
        self.i = 0
        self.losses = []
        for _ in range(CHECK_STEPS):
            out = self.step()
            self.losses.append(out["total"])
            if self.i == 1:
                beta1 = self.state.optimizer.param_groups[0]["betas"][0]
                self.grad1 = {self.names[p]: s["exp_avg"] / (1 - beta1)
                              for p, s in self.state.optimizer.state.items()}
                stamp("first step")
        self.params3 = {n: p.detach().clone() for n, p in model.named_parameters()}
        stamp("checked steps 2-3")
        for _ in range(work["warmup"]):
            self.step()
        if device.type == "cuda":
            torch.cuda.synchronize()
        stamp("warm-up")

    def step(self, _=None):
        """One step of the window: stage the next pool batch, one guarded step."""
        with span("stage_batch"):
            partial, complete = stage_batch(self.pool[self.i % len(self.pool)], self.device)
        with span("train_step"):
            out = train_step(self.state, partial, complete, self.gen)
        self.i += 1
        return out

    def window(self, seconds: float) -> dict:
        outs = []
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            outs.append(self.step())
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        skipped = int(sum(float(o["skipped"]) for o in outs))
        done = (len(outs) - skipped) * self.batch
        return {"e2e": {"train_samples_per_s": done / elapsed},
                "attempted": len(outs) * self.batch, "failed": skipped * self.batch,
                "window_s": elapsed, "steps": len(outs), "samples": done}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.scope.__exit__(None, None, None)
        self.losses = [float(x) for x in self.losses]
        del self.state, self.names
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self) -> dict:
        """The program's first steps against the reference's (``check.py``)."""
        w0 = weights.make(self.spec, self.w_seed, self.device)
        batches = [stage_batch(self.pool[i], self.device) for i in range(CHECK_STEPS)]
        ref = reference.train_steps(self.config, w0, batches, self.work["lr"], CHECK_STEPS)
        prog = {"loss": self.losses, "grad1": self.grad1, "params": self.params3}
        return check.compare_train(prog, ref, w0)


def setup(config: dict, work: dict, seed: int, device: torch.device) -> Train:
    return Train(config, work, seed, device)
