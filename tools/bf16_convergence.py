#!/usr/bin/env python3
"""The flagship's ``overfit`` under the bfloat16 policy against float32, in
JAX and in the port, on the CPU:

    JAX_PLATFORMS=cpu python tools/bf16_convergence.py [steps] [lr]

One batch made from a seed with numpy (``batch`` partial clouds of
``n_partial`` points, their ``num_coarse * 16``-point completions), the
flagship (``vn_pointnet`` + ``vn_foldingnet``: its widths are fixed, the
batch, the clouds and ``num_coarse`` are cut), JAX's seed-0 weights carried
into the port
(``training/interop.py``), and ``steps`` guarded train steps on that batch
again and again, as ``overfit`` runs them (Adam at ``lr``, StepLR by epochs
of one step; no rotation, so both sides see the same points): JAX's
``make_train_step`` and the port's ``train_step`` on its plain path, each
in float32 and under the bf16 policy (``compute_dtype_scope``).  Prints
each curve every tenth of the run and the ratio of the final losses, bf16
over float32 (a final loss: the mean of the last ``tail`` steps), for JAX
and for the port; ``run`` returns them.  The two sides part step by step
(the argmax pools turn rounding into other picks, on both sides alike), so
the ratios, not the curves, are compared.
"""

from __future__ import annotations

import statistics
import sys
import time


def run(steps: int = 200, lr: float = 3e-4, batch: int = 4, n_partial: int = 256,
        num_coarse: int = 64, seed: int = 0, tail: int = 10,
        verbose: bool = True) -> dict:
    """{"curves": {(side, dtype): [total loss a step]}, "final": {...},
    "ratio": {side: final bf16 / final float32}, "skipped": {...}} for side
    "jax" and "port", dtype "float32" and "bfloat16"."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from vn_pointcloudcompletion_tpu.models.composer import PCNNet as JaxPCNNet
    from vn_pointcloudcompletion_tpu.nn import precision as jax_precision
    from vn_pointcloudcompletion_tpu.training import state as jax_state
    from vn_pointcloudcompletion_tpu.training import steps as jax_steps
    from vn_pointcloudcompletion_tpu.utils.config import Config as JaxConfig
    from vn_pointcloudcompletion_tpu_torch.models.composer import PCNNet
    from vn_pointcloudcompletion_tpu_torch.nn import precision
    from vn_pointcloudcompletion_tpu_torch.training.interop import state_dict_from_jax_variables
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state
    from vn_pointcloudcompletion_tpu_torch.training.steps import train_step
    from vn_pointcloudcompletion_tpu_torch.utils.config import Config

    rng = np.random.default_rng(seed)
    partial = (rng.standard_normal((batch, n_partial, 3)) * 0.3).astype(np.float32)
    complete = (rng.standard_normal((batch, num_coarse * 16, 3)) * 0.3).astype(np.float32)
    widths = {"num_coarse": num_coarse, "lr": lr, "rotation": "none"}
    jm = JaxPCNNet(num_coarse=num_coarse)
    v0 = jax.tree.map(np.array, jax.jit(lambda k, x: jm.init(k, x, None, train=False))(
        jax.random.key(seed), jnp.asarray(partial)))
    dtypes = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
    curves, skipped = {}, {}
    for name, (jdt, tdt) in dtypes.items():
        t = time.perf_counter()
        jcfg = JaxConfig(**widths)
        state = jax_state.create_train_state(jm, jcfg, 1, jax.random.key(seed),
                                             jnp.asarray(partial))
        state = state.replace(params=v0["params"], batch_stats=v0["batch_stats"])
        losses, skips = [], 0
        with jax_precision.compute_dtype_scope(jdt):
            step = jax_steps.make_train_step(jcfg)
            for k in range(steps):
                state, m = step(state, jnp.asarray(partial), jnp.asarray(complete),
                                jax.random.key(k))
                losses.append(float(m["total"]))
                skips += int(m["skipped"])
        curves["jax", name], skipped["jax", name] = losses, skips
        t_jax = time.perf_counter() - t

        t = time.perf_counter()
        model = PCNNet(num_coarse=num_coarse)
        model.load_state_dict(state_dict_from_jax_variables(v0), strict=True)
        pstate = create_train_state(model, Config.from_dict(widths), 1)
        gen = torch.Generator().manual_seed(seed)
        p, c = torch.from_numpy(partial), torch.from_numpy(complete)
        losses, skips = [], 0
        with precision.compute_dtype_scope(tdt):
            for _ in range(steps):
                m = train_step(pstate, p, c, gen)
                losses.append(float(m["total"]))
                skips += int(m["skipped"])
        curves["port", name], skipped["port", name] = losses, skips
        if verbose:
            print(f"[{name}] {steps} steps: JAX {t_jax:.1f} s, the port "
                  f"{time.perf_counter() - t:.1f} s", flush=True)
    final = {key: statistics.mean(curve[-tail:]) for key, curve in curves.items()}
    ratio = {side: final[side, "bfloat16"] / final[side, "float32"] for side in ("jax", "port")}
    if verbose:
        every = max(1, steps // 10)
        for key, curve in curves.items():
            shown = ", ".join(f"{i}: {curve[i] * 1e3:.3f}" for i in range(0, steps, every))
            print(f"{key[0]} {key[1]}: total loss x1e3 by step {shown}, {steps - 1}: "
                  f"{curve[-1] * 1e3:.3f}; final (mean of the last {tail}) "
                  f"{final[key] * 1e3:.4f}; {skipped[key]} steps skipped", flush=True)
        print(f"final loss bf16 / float32: JAX {ratio['jax']:.4f}, the port "
              f"{ratio['port']:.4f}; port / JAX {ratio['port'] / ratio['jax']:.4f}", flush=True)
    return {"curves": curves, "final": final, "ratio": ratio, "skipped": skipped}


def main() -> int:
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    lr = float(sys.argv[2]) if len(sys.argv) > 2 else 3e-4
    run(steps, lr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
