"""Each mode end to end at a tiny size on the CPU, through the port's plain
paths: the result line's keys, "not measured" under every metric, and the
comparison coming out false when the timed path is broken underneath."""

import json
import time

import pytest
import torch

from port_bench import harness
from port_bench.modes import serve as serve_mode
from port_bench.modes import train as train_mode
from port_bench.tests._tiny import CPU, FLAGSHIP, POINTR, SEED

TINY = {"flagship-train-b8": FLAGSHIP, "flagship-serve-b32": FLAGSHIP,
        "vn_pointr_448-serve-b32": POINTR}


def run(cell, trace=False, seed=SEED):
    return harness.run(cell, seed, 0.5, trace, CPU, time.perf_counter(), overrides=TINY[cell])


@pytest.mark.parametrize("cell", ["flagship-train-b8", "flagship-serve-b32",
                                  "vn_pointr_448-serve-b32"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_reports_nothing_measured_off_the_card(cell, trace):
    result = run(cell, trace)
    assert list(result) == (["correct", "attempted", "failed", "metrics", "device"]
                            + (["breakdown"] if trace else []) + ["compared"])
    assert result["correct"] is True, result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["metrics"] and all(m["value"] == harness.NOT_MEASURED
                                     for m in result["metrics"].values())
    assert result["device"]["platform"] == "cpu"
    json.dumps(result)


def frozen_step(state, partial, complete, generator, mesh=None):
    """A step that returns its state unchanged: no update is applied."""
    apply = state.apply_gradients
    state.apply_gradients = lambda: None
    try:
        return train_mode_step(state, partial, complete, generator)
    finally:
        state.apply_gradients = apply


def half_batch_step(state, partial, complete, generator, mesh=None):
    """Half of the batch left out, the mean taken over the rest."""
    half = partial.shape[0] // 2
    return train_mode_step(state, partial[:half], complete[:half], generator)


train_mode_step = train_mode.train_step
serve_mode_step = serve_mode.metric_step


def altered_answer(model, partial, complete, rot, with_emd=False):
    """A completion altered where it is produced."""
    out, pred = serve_mode_step(model, partial, complete, rot, with_emd)
    return out, pred + torch.where(torch.arange(pred.shape[1]) < 64, 0.01, 0.0)[None, :, None]


def altered_score(model, partial, complete, rot, with_emd=False):
    """One sample's F-score altered where it is produced."""
    out, pred = serve_mode_step(model, partial, complete, rot, with_emd)
    return {**out, "f": out["f"] + torch.where(torch.arange(len(pred)) == 0, 0.05, 0.0)}, pred


def half_batch_serve(model, partial, complete, rot, with_emd=False):
    half = partial.shape[0] // 2
    return serve_mode_step(model, partial[:half], complete[:half],
                           None if rot is None else rot[:half], with_emd)


def half_batch_repeated(model, partial, complete, rot, with_emd=False):
    """The batch's second half answered with its first half's outputs."""
    half = partial.shape[0] // 2
    out, pred = serve_mode_step(model, partial[:half], complete[:half],
                                None if rot is None else rot[:half], with_emd)
    def twice(v):
        return torch.cat([v, v[: partial.shape[0] - half]])
    return {k: twice(v) for k, v in out.items()}, twice(pred)


@pytest.mark.parametrize("fault", [frozen_step, half_batch_step])
def test_broken_train_step_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(train_mode, "train_step", fault)
    result = run("flagship-train-b8")
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("cell", ["flagship-serve-b32", "vn_pointr_448-serve-b32"])
@pytest.mark.parametrize("fault", [altered_answer, altered_score, half_batch_serve,
                                   half_batch_repeated])
def test_broken_serve_step_is_not_correct(monkeypatch, cell, fault):
    monkeypatch.setattr(serve_mode, "metric_step", fault)
    result = run(cell)
    assert result["correct"] is False, result["compared"]
