"""Weights made by the benchmark from the run's seed, on the device.

Every matrix of the reference's parameter list (``(name, shape)``) is drawn
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch's default for a linear map, from
one ``torch.rand`` call on a generator on the card; every 1-D entry is a
normalisation's (weight and running variance 1, bias and running mean 0).
The same dict goes to the program (``load_state_dict``) and the reference.
"""

from __future__ import annotations

import math

import torch

from port_bench.traffic import SEED_MOD


def make(spec: list, seed: int, device: torch.device) -> dict:
    mats = [(n, s) for n, s in spec if len(s) >= 2]
    sizes = [math.prod(s) for _, s in mats]
    gen = torch.Generator(device=device).manual_seed(seed % SEED_MOD)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), part in zip(mats, torch.split(flat, sizes)):
        bound = 1.0 / math.sqrt(math.prod(shape[1:]))
        out[name] = (part * (2 * bound) - bound).reshape(shape)
    for name, shape in spec:
        if len(shape) < 2:
            one = name.endswith((".weight", ".running_var"))
            out[name] = (torch.ones if one else torch.zeros)(shape, device=device)
    return {name: out[name] for name, _ in spec}
