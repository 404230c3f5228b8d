"""The comparison that decides ``correct``: what the timed path produced
against the plain reference over the same inputs.  Each function returns
the cell's numbers (the larger, the further apart); the workload file
holds each number's limit.

Training (the first steps of the one ``TrainState`` the window drives):
``loss_gap`` the worst step's loss relative, ``loss1_gap`` the first
step's; ``grad_gap`` the first gradient as the optimizer received it, by
the worst leaf: |program's norm - reference's| over the larger of the
reference's norm of that leaf and of the median leaf; ``change_gap`` the
same of the parameters' change over the steps, and ``change_median_gap``
its median leaf.  The change counts only leaves whose reference gradient
reaches 1e-3 of the median leaf's: below that, Adam moves a leaf by its
rounding alone.

Serving (the kept batches): ``coarse_gap`` and ``dense_gap`` the worst
sample's distance of the completion from the reference's over the
reference's norm; ``l1_gap``, ``l2_gap`` the Chamfer distances relative;
``f_gap``, ``iou_gap`` the F-score and IoU (fractions) apart; and each of
them by the median sample, ``<key>_median_gap``: a discrete choice of the
model (a VN max pool's argmax, a neighbour) that rounding flips moves one
sample's completion far, and the median sample does not see it.  The median
does not see a fault in up to half of the samples either: ``far_share`` is
the share of samples of which any number lies beyond its ``FAR`` level, and
``<key>_far_share`` the share by one number.  ``<key>_self_gap`` judges the
program's scores of every kept sample against the reference's scores of the
program's own completion (worst sample): no discrete choice of the model
stands between the two, so they hold where the completions part.
"""

from __future__ import annotations

import math
import statistics

import torch

SERVE_KEYS = ("l1", "l2", "f", "iou")
# A sample's number beyond this level counts the sample as far off: relative
# for the clouds and the Chamfer distances, absolute for F-score and IoU.
FAR = {"coarse": 0.1, "dense": 0.1, "l1": 0.1, "l2": 0.1, "f": 0.05, "iou": 0.05}


def finite(out: dict) -> dict:
    return {k: (v if math.isfinite(v) else float("inf")) for k, v in out.items()}


def compare_train(prog: dict, ref: dict, w0: dict) -> dict:
    """prog, ref: {"loss": [float], "grad1": {name: tensor}, "params":
    {name: tensor after the steps}}; w0: the initial weights."""
    loss_gaps = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    g_ref = {k: float(g.norm()) for k, g in ref["grad1"].items()}
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(float(prog["grad1"][k].norm()) - g) / max(g, g_med)
                   if k in prog["grad1"] else 1.0 for k, g in g_ref.items())
    moved = [k for k, g in g_ref.items() if g >= 1e-3 * g_med]
    d_ref = {k: float((ref["params"][k] - w0[k]).norm()) for k in moved}
    d_med = statistics.median(d_ref.values())
    leaf = [abs(float((prog["params"][k] - w0[k]).norm()) - d_ref[k]) / max(d_ref[k], d_med)
            for k in moved]
    return finite({"loss_gap": max(loss_gaps), "loss1_gap": loss_gaps[0], "grad_gap": grad_gap,
                   "change_gap": max(leaf), "change_median_gap": statistics.median(leaf)})


def compare_serve(kept: list, refs: list, scored: list) -> dict:
    """kept: [{"coarse", "dense", "l1", "l2", "f", "iou"}] of the program,
    refs: the reference's over the same batches, scored: the reference's
    scores {"l1", "l2", "f", "iou"} of the program's dense completions.  Each number by the worst
    sample (``<key>_gap``), by the median sample (``<key>_median_gap``) and
    by the share of samples beyond ``FAR`` (``<key>_far_share``), and the
    share of samples beyond it in any number (``far_share``); each score by
    the worst sample against ``scored`` (``<key>_self_gap``)."""
    names = ("coarse", "dense", *SERVE_KEYS)
    if len(kept) != len(refs) or len(kept) != len(scored) or not kept or any(
            got[k].shape != ref[k].shape for got, ref in zip(kept, refs) for k in names):
        out = {f"{k}{m}": float("inf") for k in names for m in ("_gap", "_median_gap",
                                                                  "_far_share")}
        return {**out, "far_share": float("inf"),
                **{f"{k}_self_gap": float("inf") for k in SERVE_KEYS}}
    per = {k: [] for k in names}
    for got, ref in zip(kept, refs):
        for key in ("coarse", "dense"):
            d = (got[key].float() - ref[key]).flatten(1).norm(dim=1)
            per[key].append(d / ref[key].flatten(1).norm(dim=1))
        for key in ("l1", "l2"):
            per[key].append((got[key] - ref[key]).abs() / ref[key].abs())
        for key in ("f", "iou"):
            per[key].append((got[key] - ref[key]).abs())
    out = {}
    far = None
    for key, parts in per.items():
        v = torch.cat(parts).double()
        out[f"{key}_gap"] = float(v.max())
        out[f"{key}_median_gap"] = float(v.median())
        beyond = ~(v <= FAR[key])  # a NaN counts as far off
        out[f"{key}_far_share"] = float(beyond.double().mean())
        far = beyond if far is None else far | beyond
    out["far_share"] = float(far.double().mean())
    for key in SERVE_KEYS:
        gaps = [(got[key] - own[key]).abs() for got, own in zip(kept, scored)]
        if key in ("l1", "l2"):
            gaps = [g / own[key].abs() for g, own in zip(gaps, scored)]
        out[f"{key}_self_gap"] = float(torch.cat(gaps).double().max())
    return finite(out)


def as_tensors(vals, device) -> dict:
    """The host-read metrics (4, B) of a batch as device tensors by key."""
    return dict(zip(SERVE_KEYS, torch.as_tensor(vals, device=device)))
