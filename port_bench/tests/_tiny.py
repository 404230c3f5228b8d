"""Tiny sizes for the CPU tests: a few points, the published widths."""

import torch

CPU = torch.device("cpu")
SEED = 2 ** 31 + 977  # above 32 signed bits, as the driver's seeds are
FLAGSHIP = {"config": {"num_coarse": 64, "n_partial": 256, "n_dense": 1024},
            "work": {"batch": 2, "pool": 3, "warmup": 1}}
POINTR = {"config": {"n_partial": 600, "n_dense": 1024}, "work": {"batch": 4, "pool": 3, "warmup": 1}}
