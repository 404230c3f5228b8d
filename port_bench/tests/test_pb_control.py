"""The control of each serve and train cell comes out as not correct on the
card, at the cell's own sizes: the reference in TF32 put in the program's
place, and the reference with half of each batch left out (the fault of
``control.py --fault half_batch``)."""

import pytest
import torch

from port_bench import control, harness

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)
CASES = [(w["name"], fault) for w in harness.benchmark()["workloads"]
         for fault in ("tf32", "half_batch")]


@pytest.mark.gpu
@pytest.mark.parametrize("cell,fault", CASES)
def test_control_is_not_correct(cell, fault):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    limits = harness.cell(harness.benchmark(), cell)[1]["limits"]
    for seed in SEEDS:
        out = control.readings(cell, seed, torch.device("cuda", 0), fault)
        assert any(out[k] > v for k, v in limits.items()), (seed, out)
