"""port_bench/counts agrees with torch's FlopCounterMode over the plain
reference's products, at small sizes on the CPU."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import counts, weights
from port_bench.reference import steps as reference
from port_bench.tests._tiny import CPU, FLAGSHIP, POINTR


@pytest.mark.parametrize("name,tiny", [("flagship", FLAGSHIP), ("vn_pointr_448", POINTR)])
@pytest.mark.parametrize("train", [False, True])
def test_forward_products_match_flop_counter(name, tiny, train):
    from port_bench import harness

    config = {**harness.load_json(harness.HERE / "configs" / f"{name}.json"), **tiny["config"]}
    w = weights.make(reference.model(config).param_spec(config), 3, CPU)
    xyz = torch.rand(2, config["n_partial"], 3) - 0.5
    with FlopCounterMode(display=False) as fc:
        reference.model(config).forward(w, xyz, None, train)
    items = counts.model(config).forward(config, 2)
    assert fc.get_total_flops() == sum(i.flops for i in items)


@pytest.mark.parametrize("name", ["flagship", "vn_pointr_448"])
def test_params_count_the_leaves_that_get_a_gradient(name):
    from port_bench import harness

    config = {**harness.load_json(harness.HERE / "configs" / f"{name}.json"),
              **(FLAGSHIP if name == "flagship" else POINTR)["config"]}
    w = weights.make(reference.model(config).param_spec(config), 3, CPU)
    xyz, gt = torch.rand(2, config["n_partial"], 3), torch.rand(2, config["n_dense"], 3)
    out = reference.train_steps(config, w, [(xyz, gt)], 1e-4, steps=1)
    assert sum(g.numel() for g in out["grad1"].values()) == counts.model(config).params(config)


def test_full_size_steps_have_positive_least_time():
    from port_bench import harness

    for name in ("flagship", "vn_pointr_448"):
        config = harness.load_json(harness.HERE / "configs" / f"{name}.json")
        for mode, batch in (("train", 8), ("serve", 32)):
            s = counts.step(config, mode, batch)
            assert s["flops"] > 0 and 0 < s["least_s"] < 1
