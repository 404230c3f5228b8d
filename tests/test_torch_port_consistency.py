"""Kernel C' takes its backward at the p, d that the forward kernel C
formed, the plain versions sum p, d in their kernels' order, and the plain
backwards' ``planes=``, on the CPU.

JAX forms p and d for every kernel of the VN layer in one function
(``_compute_pd``), so its backward recomputes the bits its forward used.
The port's designs sum p = W x in one of two orders
(``ops/vn_layer_fused.py::summation_order``: input-channel order, or the
tensor cores' k16 steps), and each chooser picks a design from the shape:

- over a grid of widths, point counts, base alignments, bias groups and
  both modes, the design C' takes sums in the order of the design C takes
  at the same shape, and S' in S's;
- the plain versions of S, S', C and C' take ``order``: "k16" (the tensor
  cores' steps, ``k16_sum``) stays within the bounds that the in-order
  versions meet against JAX's ``bf16=True`` Pallas kernels in interpret
  mode, and "in_order" (the default, the CPU model path's) is the plain
  versions' arithmetic unchanged to the bit;
- ``chip_smoke.kernels_as_plain``, which runs the plain versions in the
  kernels' place on the card, hands each the order of its kernel's launch
  (``launch_order``) at every S, S', C and C' call of a flagship and a
  vn_pointr_448 bf16 train step;
- the plain backwards of B' and C' take ``planes=(p, d)``, the planes at
  which to take the backward (on the card, kernel C's ``pd_out``):
  ``planes=None`` leaves them as they were to the bit (the in-order planes
  recomputed), JAX's Pallas backward (``bf16=True``, interpret mode) still
  matches them at ``tests/test_torch_port_bf16_train.py``'s bound, and one
  plane element moved by one bf16 ulp through ``planes`` moves the output.

The kernels themselves are held to this on the card by the ``gpu`` tests
of ``tests/test_torch_port_kernels.py``
(``test_wide_bf16_c_bwd_recomputes_the_forward_planes``,
``test_narrow_c_bwd_recomputes_the_forward_planes``,
``test_float32_wide_c_bwd_recomputes_the_forward_planes``,
``test_k16_model_gives_the_cards_planes``).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_bf16 import _check_bf16
from tests.test_torch_port_bf16_train import NS, _bf16, _check, _layer_case
from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused as port_layer
from vn_pointcloudcompletion_tpu_torch.ops.vn_fused import EPS, plane_dot, safe_sqrt

torch.set_num_threads(2)

_WIDTHS = [3, 8, 16, 48, 64, 128, 256, 320]
_OUTS = [8, 15, 64, 80, 128, 192, 256]
_POINTS = [1000, 1004, 1024, 4096, 14336, 16384]


def _stats_designs(c_in, c_out, n, bf16, aligned, group):
    """(S's design, S''s design) as their wrappers choose them."""
    return tuple(port_layer.launch_design(k, c_in, c_out, n, bf16, aligned, group)
                 for k in ("S", "S'"))


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
            assert bwd == "wgmma_p", shape
        assert order("C", fwd, bf16) == order("C'", bwd, bf16), shape
        assert order("C", fwd, bf16) == ("k16" if bf16 and fwd != "narrow" else "in_order")
        s, sb = _stats_designs(c_in, c_out, n, bf16, aligned, group)
        assert order("S", s, bf16) == order("S'", sb, bf16), shape + (s, sb)
        seen.add((fwd, bwd))
    if bf16 and group in (0, 64):  # every pair the choosers give in bf16
        assert seen == {("narrow", "narrow"), ("wide", "wide"), ("wide", "wgmma"),
                        ("wgmma", "wgmma_p")}
    if not bf16:
        assert seen == {("narrow", "narrow"), ("wide", "wide")}


@pytest.mark.parametrize("kernel,design,bf16,order", [
    ("C", "narrow", True, "in_order"), ("C", "wide", False, "in_order"),
    ("C", "wide", True, "k16"), ("C", "wgmma", True, "k16"),
    ("C'", "wide", True, "k16"), ("C'", "wgmma", True, "k16"),
    ("C'", "wgmma_p", True, "k16"), ("C'", "narrow", True, "in_order"),
    ("S", "stream", True, "in_order"), ("S'", "wgmma_p", True, "k16"),
])
def test_summation_order_table(kernel, design, bf16, order):
    """The table's entries for the kernels' designs: FMAs in input-channel
    order (vn_tile.cuh's loop, pd_wide_fma, proj_wide_fma) and the tensor
    cores' k16 steps (pd_wide_mma, proj_wide_mma, pd_wgmma, proj_wgmma)."""
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


# ---------------------------------------- the plain versions in k16 order
#
# At C_in 64 (four k16 steps), groups 0 and 64: the plain S, S', C and C'
# summing p, d in the tensor cores' order against JAX's bf16=True Pallas
# kernels in interpret mode, at the bounds the in-order versions meet there
# (tests/test_torch_port_bf16_train.py's _check; C's
# test_torch_port_bf16.py::test_kernel_c_bf16_plain_matches_pallas's).


@pytest.mark.parametrize("group", [0, 64])
@pytest.mark.parametrize("kernel", ["S", "S'", "C", "C'"])
def test_plain_k16_matches_pallas(kernel, group):
    from vn_pointcloudcompletion_tpu.ops import vn_layer_fused as jax_layer

    n = 1024
    (tx, tw, twd, tpb, tdb, ta, tb, two), jargs, rng = _layer_case(group, n, 64)
    jx, jw, _, jpb = jargs[:4]
    tag = f"{kernel} k16 group {group}"
    if kernel in ("S", "S'"):
        c1, c2 = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
        want, vjp = jax.vjp(lambda *t: jax_layer.vn_layer_stats(*t, True, True, group),
                            jx, jw, jpb)
        if kernel == "S":
            _check(tag, port_layer.reference_stats(tx, tw, tpb, group, order="k16"), want)
        else:
            got = port_layer.reference_stats_bwd(tx, tw, tpb, *map(torch.from_numpy, (c1, c2)),
                                                 group, order="k16")
            _check(tag, got, vjp((jnp.asarray(c1), jnp.asarray(c2))))
    elif kernel == "C":
        got = port_layer.reference_layer_fused_project(tx, tw, twd, tpb, tdb, ta, tb, two, NS,
                                                       group, order="k16")
        want = jax_layer.vn_layer_fused_project(*jargs, NS, True, True, group)
        _check_bf16(tag, got, want, share=0.05)
    else:
        tg, jg = _bf16(rng.standard_normal((2, 3, 1, n)))
        _, vjp = jax.vjp(lambda *t: jax_layer.vn_layer_fused_project(*t, NS, True, True, group),
                         *jargs)
        got = port_layer.reference_layer_project_bwd(tx, tw, twd, tpb, tdb, ta, tb, two, tg, NS,
                                                     group, order="k16")
        _check(tag, got, vjp(jg))


def _in_order_loop(w, x, bias, group):
    """The plain bf16 p as it has always been summed: one exact product at a
    time in input-channel order in float32, the bias, one rounding."""
    wf, xf = w.to(torch.bfloat16).float(), x.float()
    p = torch.zeros(x.shape[:2] + (w.shape[0], x.shape[3]))
    for k in range(w.shape[1]):
        p = p + wf[:, k:k + 1] * xf[:, :, k:k + 1]
    return (p + port_layer.expand_bias(bias, group).float()).to(torch.bfloat16)


@pytest.mark.parametrize("kernel", ["S", "S'", "C", "C'"])
def test_in_order_leaves_the_plain_versions_unchanged(kernel):
    """``order="in_order"``, the default that the CPU model path takes, is
    the in-order loop to the bit, and every plain version given it
    explicitly returns the bits it returns by default; "k16" is another
    order there (some p of these inputs part)."""
    (x, w, wd, pb, db, a, b, w_out), _, rng = _layer_case(64, 1024, 64)
    assert torch.equal(port_layer._products(w, x, pb, 64, order="in_order"),
                       _in_order_loop(w, x, pb, 64))
    assert not torch.equal(port_layer._products(w, x, pb, 64, order="k16"),
                           _in_order_loop(w, x, pb, 64))
    c1, c2 = (torch.from_numpy(rng.standard_normal(16).astype(np.float32)) for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((2, 3, 1, 1024)).astype(np.float32)).to(x.dtype)
    call = {
        "S": lambda **o: port_layer.reference_stats(x, w, pb, 64, **o),
        "S'": lambda **o: port_layer.reference_stats_bwd(x, w, pb, c1, c2, 64, **o),
        "C": lambda **o: (port_layer.reference_layer_fused_project(
            x, w, wd, pb, db, a, b, w_out, NS, 64, **o),),
        "C'": lambda **o: port_layer.reference_layer_project_bwd(
            x, w, wd, pb, db, a, b, w_out, g, NS, 64, **o),
    }[kernel]
    _same_bits(call(), call(order="in_order"))
    with pytest.raises(ValueError):  # the float32 mode sums in a matrix product only
        port_layer._products(w, x.float(), None, order="k16")


_ORDER_PIPELINES = {"flagship": ("vn_pointnet", "vn_foldingnet", 256),
                    "vn_pointr": ("vn_pointr", "attention_vn_foldingnet", 448)}


@pytest.mark.parametrize("name", list(_ORDER_PIPELINES))
def test_kernels_as_plain_sums_in_the_kernels_order(name, monkeypatch):
    """One bf16 train-mode forward and backward of a pipeline inside
    ``chip_smoke.kernels_as_plain``: every S, S', C and C' call hands its
    plain version the order its kernel's launch takes at that call's
    shapes (``launch_order``): k16 at the wide layers (C_in, C_out >= 16),
    input-channel order at the walks and the narrow ones; C' the order of
    the C at the same layer.  The plain versions run in input-channel order
    here (the order is recorded, not used: the CPU is slow at k16)."""
    import chip_smoke
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.nn import precision
    from vn_pointcloudcompletion_tpu_torch.utils.config import Config

    seen = []
    for fn_name, kernel in (("reference_stats", "S"), ("reference_stats_bwd", "S'"),
                            ("reference_layer_fused_project", "C"),
                            ("reference_layer_project_bwd", "C'")):
        def spy(x, w, *args, order="in_order", _real=getattr(port_layer, fn_name),
                _kernel=kernel, **kw):
            seen.append((_kernel, x.shape[2], w.shape[0], x.shape[3], order))
            return _real(x, w, *args, **kw)
        monkeypatch.setattr(port_layer, fn_name, spy)
    enc, dec, nc = _ORDER_PIPELINES[name]
    model = build_model(Config.from_dict({"enc_type": enc, "dec_type": dec,
                                          "num_coarse": nc, "seed": 3})).train()
    xyz = torch.from_numpy((np.random.default_rng(5).standard_normal((1, 600, 3)) * 0.3)
                           .astype(np.float32))
    with precision.compute_dtype_scope(torch.bfloat16), chip_smoke.kernels_as_plain():
        coarse, fine = model(xyz)[:2]
        (coarse.float().square().sum() + fine.float().square().sum()).backward()
    assert {k for k, *_ in seen} == {"S", "S'", "C", "C'"}
    for kernel, c_in, c_out, n, order in seen:
        wide = min(c_in, c_out) >= port_layer.WIDE_MIN_CHANNELS
        assert order == ("k16" if wide else "in_order"), (kernel, c_in, c_out, n, order)
    forward = {(c_in, c_out, n): order for k, c_in, c_out, n, order in seen if k == "C"}
    for kernel, c_in, c_out, n, order in seen:
        if kernel == "C'":
            assert forward[(c_in, c_out, n)] == order
    assert any(order == "k16" for *_, order in seen)
