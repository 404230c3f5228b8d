"""Where kernel C' takes its backward at the p, d that the forward kernel
C formed, and the plain backwards' ``planes=``, on the CPU.

JAX forms p and d for every kernel of the VN layer in one function
(``_compute_pd``), so its backward recomputes the bits its forward used.
The port's designs sum p = W x in one of two orders
(``ops/vn_layer_fused.py::summation_order``: input-channel order, or the
tensor cores' k16 steps), and each chooser picks a design from the shape:

- over a grid of widths, point counts, base alignments, bias groups and
  both modes, the design C' takes sums in the order of the design C takes
  at the same shape (and S' in S's), but at the wide bf16 shapes, where C
  sums in k16 steps and C' in input-channel order (the fault
  ``ROADMAP.md`` §3 keeps open);
- the plain backwards of B' and C' take ``planes=(p, d)``, the planes at
  which to take the backward (on the card, kernel C's ``pd_out``):
  ``planes=None`` leaves them as they were to the bit (the in-order planes
  recomputed), JAX's Pallas backward (``bf16=True``, interpret mode) still
  matches them at ``tests/test_torch_port_bf16_train.py``'s bound, and one
  plane element moved by one bf16 ulp through ``planes`` moves the output.

The kernels themselves are held to this on the card by the ``gpu`` tests
of ``tests/test_torch_port_kernels.py``
(``test_wide_bf16_c_bwd_planes_part_from_the_forward``,
``test_narrow_c_bwd_recomputes_the_forward_planes``,
``test_float32_wide_c_bwd_recomputes_the_forward_planes``).
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_port_bf16_train import NS, _bf16, _check, _layer_case
from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused as port_layer
from vn_pointcloudcompletion_tpu_torch.ops.vn_fused import EPS, plane_dot, safe_sqrt

torch.set_num_threads(2)

_WIDTHS = [3, 8, 16, 48, 64, 128, 256, 320]
_OUTS = [8, 15, 64, 80, 128, 192, 256]
_POINTS = [1000, 1004, 1024, 4096, 14336, 16384]


def _stats_designs(c_in, c_out, n, bf16, aligned, group):
    """(S's design, S''s design) as their wrappers choose them."""
    s, sb = port_layer.stats_design(c_in, c_out), port_layer.stats_bwd_design(c_in, c_out)
    if bf16 and s == "wide":
        s = port_layer.pass1_bf16_design("S", c_in, c_out, n, aligned, group)
    if bf16 and sb == "wide":
        sb = port_layer.pass1_bf16_design("S'", c_in, c_out, n, aligned, group)
    return s, sb


@pytest.mark.parametrize("group", [0, 16, 64, 128])
@pytest.mark.parametrize("bf16", [False, True])
def test_c_bwd_sums_in_the_order_of_c(group, bf16):
    order = port_layer.summation_order
    seen = set()
    for c_in, c_out, n, aligned in itertools.product(_WIDTHS, _OUTS, _POINTS, (True, False)):
        fwd = port_layer.project_fwd_design(c_in, c_out, n, bf16, aligned, group)
        bwd = port_layer.project_bwd_design(c_in, c_out, n, bf16, aligned, group)
        shape = (c_in, c_out, n, aligned, group, bf16, fwd, bwd)
        if fwd == "wgmma":
            assert bwd == "certified", shape
        if bf16 and fwd != "narrow":  # the open fault: the in-order p, d after C's k16 ones
            assert order("C", fwd, bf16) == "k16", shape
            assert order("C'", bwd, bf16) == "in_order", shape
        else:
            assert order("C", fwd, bf16) == order("C'", bwd, bf16), shape
        s, sb = _stats_designs(c_in, c_out, n, bf16, aligned, group)
        assert order("S", s, bf16) == order("S'", sb, bf16), shape + (s, sb)
        seen.add((fwd, bwd))
    if bf16 and group in (0, 64):  # every pair the choosers give in bf16
        assert seen == {("narrow", "narrow"), ("wide", "wide"), ("wide", "wgmma"),
                        ("wgmma", "certified")}
    if not bf16:
        assert seen == {("narrow", "narrow"), ("wide", "wide")}


@pytest.mark.parametrize("kernel,design,bf16,order", [
    ("C", "narrow", True, "in_order"), ("C", "wide", False, "in_order"),
    ("C", "wide", True, "k16"), ("C", "wgmma", True, "k16"),
    ("C'", "wide", True, "in_order"), ("C'", "wgmma", True, "in_order"),
    ("C'", "certified", True, "in_order"), ("S", "stream", True, "in_order"),
    ("S'", "wgmma_p", True, "k16"),
])
def test_summation_order_table(kernel, design, bf16, order):
    """The table's entries for the kernels' designs: FMAs in input-channel
    order (vn_tile.cuh's loop, pd_wide_fma, proj_wide_fma; pd_cert's
    certified result) and the tensor cores' k16 steps (pd_wide_mma,
    proj_wide_mma, pd_wgmma, proj_wgmma)."""
    assert port_layer.summation_order(kernel, design, bf16) == order


def _b_case(group, n, dtype):
    """Plain B' inputs (x, w, wd, pbias, dbias, a, b, g) in ``dtype``'s mode
    and their in-order planes."""
    (x, w, wd, pb, db, a, b, _), _, rng = _layer_case(group, n, 8)
    g = torch.from_numpy(rng.standard_normal((2, 3, 16, n)).astype(np.float32))
    if dtype == torch.float32:
        x, pb, db = x.float(), pb.float(), db.float()
    else:
        g = g.to(dtype)
    return (x, w, wd, pb, db, a, b, g.to(x.dtype))


def _c_case(group, n, dtype):
    """Plain C' inputs (x, w, wd, pbias, dbias, a, b, w_out, g)."""
    (x, w, wd, pb, db, a, b, w_out), _, rng = _layer_case(group, n, 16)
    g = torch.from_numpy(rng.standard_normal((2, 3, 1, n)).astype(np.float32))
    if dtype == torch.float32:
        x, pb, db = x.float(), pb.float(), db.float()
    return (x, w, wd, pb, db, a, b, w_out, g.to(x.dtype))


def _in_order(x, w, wd, pb, db, group):
    return port_layer._products(w, x, pb, group), port_layer._products(wd, x, db, group)


def _same_bits(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("kernel", ["B'", "C'"])
@pytest.mark.parametrize("group,n", [(0, 1024), (16, 1040)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_planes_none_leaves_the_plain_backwards_unchanged(kernel, group, n, dtype):
    """``planes=None`` gives the bits of the backward at the planes it
    recomputes in input-channel order (``_planes``), passed explicitly."""
    if kernel == "B'":
        args = _b_case(group, n, dtype)
        x, w, wd, pb, db = args[:5]
        fn = port_layer.reference_layer_bwd
    else:
        args = _c_case(group, n, dtype)
        x, w, wd, pb, db = args[:5]
        fn = port_layer.reference_layer_project_bwd
    planes = (port_layer._planes(w, x, pb, group), port_layer._planes(wd, x, db, group))
    _same_bits(fn(*args, NS, group), fn(*args, NS, group, planes=planes))
    if dtype == torch.bfloat16:  # the bf16 planes themselves, as kernel C hands them out
        _same_bits(fn(*args, NS, group), fn(*args, NS, group,
                                            planes=_in_order(x, w, wd, pb, db, group)))


def test_plain_c_bwd_with_planes_matches_pallas():
    """JAX's C' backward (``bf16=True``, interpret mode, through
    ``jax.vjp``) against the plain C' at the in-order planes passed through
    ``planes``: ``tests/test_torch_port_bf16_train.py``'s bound."""
    from vn_pointcloudcompletion_tpu.ops import vn_layer_fused as jax_layer

    (tx, tw, twd, tpb, tdb, ta, tb, two), jargs, rng = _layer_case(0, 1024, 16)
    tg, jg = _bf16(rng.standard_normal((2, 3, 1, 1024)))
    _, vjp = jax.vjp(lambda *t: jax_layer.vn_layer_fused_project(*t, NS, True, True), *jargs)
    got = port_layer.reference_layer_project_bwd(
        tx, tw, twd, tpb, tdb, ta, tb, two, tg, NS,
        planes=_in_order(tx, tw, twd, tpb, tdb, 0))
    _check("C' at the given planes", got, vjp(jg))


def test_plain_b_bwd_with_planes_matches_pallas():
    """The same for B' at group 16 (the pair folds' bias columns)."""
    from vn_pointcloudcompletion_tpu.ops import vn_layer_fused as jax_layer

    (tx, tw, twd, tpb, tdb, ta, tb, _), jargs, rng = _layer_case(16, 1040, 8)
    tg, jg = _bf16(rng.standard_normal((2, 3, 16, 1040)))
    _, vjp = jax.vjp(lambda *t: jax_layer.vn_layer_fused(*t, NS, True, True, 16), *jargs[:7])
    got = port_layer.reference_layer_bwd(tx, tw, twd, tpb, tdb, ta, tb, tg, NS, 16,
                                         planes=_in_order(tx, tw, twd, tpb, tdb, 16))
    _check("B' at the given planes", got, vjp(jg))


def _one_ulp_up(t, index):
    """A copy of the bf16 tensor ``t`` with element ``index`` moved one bf16
    ulp away from zero."""
    out = t.clone()
    bits = out.view(torch.int16)
    bits[index] = bits[index] + 1
    return out


@pytest.mark.parametrize("kernel", ["B'", "C'"])
@pytest.mark.parametrize("which", [0, 1])
def test_planes_moves_the_plain_backward(kernel, which):
    """One element of p (``which`` 0) or d (1) moved by one bf16 ulp
    through ``planes`` moves the outputs: the backward reads the planes it
    is given, not its own."""
    if kernel == "B'":
        args = _b_case(0, 1024, torch.bfloat16)
        fn = port_layer.reference_layer_bwd
    else:
        args = _c_case(0, 1024, torch.bfloat16)
        fn = port_layer.reference_layer_project_bwd
    x, w, wd, pb, db, a, b = args[:7]
    planes = list(_in_order(x, w, wd, pb, db, 0))
    base = fn(*args, NS, planes=tuple(planes))
    # a vector on the leaky side where the output reads d too (<q, d> < 0)
    p, d = (t.float() for t in planes)
    q = p * (a[None, :, None] + b[None, :, None]
             / (safe_sqrt(plane_dot(p, p)) + EPS))[:, None]
    bi, c, n = (int(i) for i in torch.nonzero(plane_dot(q, d) < 0)[0])
    planes[which] = _one_ulp_up(planes[which], (bi, 1, c, n))
    moved = fn(*args, NS, planes=tuple(planes))
    changed = [k for k, (a, b) in enumerate(zip(base, moved))
               if a is not None and not torch.equal(a, b)]
    assert changed, "no output moved"  # at least dA, dB: float32 sums of the float32 dp, dd
