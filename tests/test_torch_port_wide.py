"""Which passes kernels S, S' and C' run, and the chunking of their wide
weight-gradient pass, on the CPU.

``ops/vn_layer_fused.py::backward_design`` picks the wide passes (cp.async
rings; in the bf16 mode dx, dW and S''s p on the tensor cores) for C_in
and C_out >= 16 and the narrow ones (pd_pass, dx_gemm, dw_gemm) below
that, for C' and for S' above C_in 2; ``stats_bwd_design`` gives S' one
fused pass that walks the channels at C_in <= 2, and ``stats_design`` gives
S that walk without its gradients ("stream") there and the wide pass 1
without its dp store, or pd_pass, above; the CUDA kernels take what the
wrapper picks, so the choice for every layer a pipeline trains is checked
here, where no card is needed.
``wide_split`` cuts pass 3's reduction into whole stages of one plane
each: every point is summed by exactly one split.  The kernels themselves
are held against their plain versions by the ``gpu`` tests of
``tests/test_torch_port_kernels.py``.
"""

import numpy as np
import pytest
import torch

from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused as port_layer
from vn_pointcloudcompletion_tpu_torch.utils.config import Config

torch.set_num_threads(2)

# (encoder, decoder, num_coarse): the decoders' fold layers take the
# whole-layer kernels at >= 4096 points
_PIPELINES = {
    "flagship": ("vn_pointnet", "vn_foldingnet", 256),
    "vn_dgcnn": ("vn_dgcnn_fps", "vn_foldingnet", 256),
    "vn_pointr": ("vn_pointr", "attention_vn_foldingnet", 448),
}
# (kernel, C_in, C_out, group) of every S' and C' launch of one train step,
# and its design: final_conv.0 (2 -> 256), the pair folds (1 -> 256, group
# 64) and VN DGCNN's and vn_pointr's conv1 (2 -> 32) fused; final_conv.1
# (256 -> 256) and vn_folding{1,2}.1 (256 -> 128) wide
_EXPECTED = {
    "flagship": {("S'", 2, 256, 0): "fused", ("S'", 256, 256, 0): "wide",
                 ("C'", 256, 256, 0): "wide"},
    "vn_dgcnn": {("S'", 2, 32, 0): "fused", ("S'", 2, 256, 0): "fused",
                 ("S'", 256, 256, 0): "wide", ("C'", 256, 256, 0): "wide"},
    "vn_pointr": {("S'", 2, 32, 0): "fused", ("S'", 1, 256, 64): "fused",
                  ("S'", 256, 128, 0): "wide", ("C'", 256, 128, 0): "wide"},
}


# ... and the design each takes in the bf16 mode (pass1_bf16_design): every
# wide layer's widths are multiples of 64 and its point rows (4096 points
# at num_coarse 256, 14336 at 448) 16-byte aligned, so the wgmma passes, and
# pass 1 on wgmma too ("wgmma_p": S''s, and C''s where kernel C takes its
# wgmma design, as at every C call of a flagship and a vn_pointr_448 train
# step); the walk and the narrow passes keep theirs
_EXPECTED_BF16 = {name: {key: "wgmma_p" if design == "wide" else design
                         for key, design in layers.items()}
                  for name, layers in _EXPECTED.items()}


@pytest.mark.parametrize("name", list(_PIPELINES))
def test_backward_design_of_every_trained_layer(name, monkeypatch):
    """One train-mode forward and backward of a pipeline at num_coarse 256
    or 448: each S' and C' call's (C_in, C_out, group) and the design the
    wrapper takes for it, in float32 and in the bf16 mode (where a wide
    layer's passes go to wgmma, its pass 1 too)."""
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model

    seen, seen_bf16 = {}, {}

    def record(kernel, fn, design):
        def wrapped(x, w, *args):
            group = args[-1] if isinstance(args[-1], int) else 0
            key = (kernel, x.shape[2], w.shape[0], group)
            seen[key] = design(x.shape[2], w.shape[0])
            seen_bf16[key] = (port_layer.pass1_bf16_design(kernel, x.shape[2], w.shape[0],
                                                           x.shape[3], True, group)
                              if seen[key] == "wide" else seen[key])
            return fn(x, w, *args)
        return wrapped

    monkeypatch.setattr(port_layer, "stats_bwd",
                        record("S'", port_layer.stats_bwd, port_layer.stats_bwd_design))
    monkeypatch.setattr(port_layer, "layer_project_bwd",
                        record("C'", port_layer.layer_project_bwd, port_layer.backward_design))
    enc, dec, nc = _PIPELINES[name]
    model = build_model(Config.from_dict({"enc_type": enc, "dec_type": dec,
                                          "num_coarse": nc, "seed": 3})).train()
    xyz = torch.from_numpy((np.random.default_rng(5).standard_normal((1, 600, 3)) * 0.3)
                           .astype(np.float32))
    coarse, fine = model(xyz)
    (coarse.square().sum() + fine.square().sum()).backward()
    assert seen == _EXPECTED[name]
    assert seen_bf16 == _EXPECTED_BF16[name]


# (C_in, C_out, group) of every S launch of one train step, and its
# design: the train-mode BatchNorm statistics of each whole-layer VN layer,
# so the same widths as S', and the channel walk ("stream") where S' fuses
_STATS_EXPECTED = {name: {(c_in, c_out, group): "stream" if design == "fused" else design
                          for (kernel, c_in, c_out, group), design in layers.items()
                          if kernel == "S'"}
                   for name, layers in _EXPECTED.items()}


@pytest.mark.parametrize("name", list(_PIPELINES))
def test_stats_design_of_every_trained_layer(name, monkeypatch):
    """One train-mode forward of a pipeline at num_coarse 256 or 448: each
    kernel S call's (C_in, C_out, group) and the design the wrapper takes
    for it (final_conv.1's 256 -> 256 and vn_folding{1,2}.1's 256 -> 128
    wide; 2 -> 256, 2 -> 32 and the pair folds' 1 -> 256 at group 64 the
    stream)."""
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model

    seen = {}
    stats_fwd = port_layer.stats_fwd

    def record(x, w, pbias, group=0):
        seen[(x.shape[2], w.shape[0], group)] = port_layer.stats_design(x.shape[2], w.shape[0])
        return stats_fwd(x, w, pbias, group)

    monkeypatch.setattr(port_layer, "stats_fwd", record)
    enc, dec, nc = _PIPELINES[name]
    model = build_model(Config.from_dict({"enc_type": enc, "dec_type": dec,
                                          "num_coarse": nc, "seed": 3})).train()
    xyz = torch.from_numpy((np.random.default_rng(5).standard_normal((1, 600, 3)) * 0.3)
                           .astype(np.float32))
    model(xyz)
    assert seen == _STATS_EXPECTED[name]


@pytest.mark.parametrize("c_in,c_out,design", [
    (1, 256, "stream"), (2, 256, "stream"), (2, 32, "stream"), (1, 4, "stream"),
    (3, 256, "narrow"), (15, 256, "narrow"), (16, 15, "narrow"), (15, 16, "narrow"),
    (16, 16, "wide"), (256, 128, "wide"), (256, 256, "wide"),
])
def test_stats_design_boundary(c_in, c_out, design):
    """Kernel S walks its channels at C_in <= 2 exactly where S' and B' fuse
    their passes, and above that is wide from C_in = C_out = 16 up, as S'
    and C'."""
    assert port_layer.stats_design(c_in, c_out) == design
    walks = port_layer.stats_design(c_in, c_out) == "stream"
    assert walks == (port_layer.stats_bwd_design(c_in, c_out) == "fused")
    assert walks == (port_layer.layer_bwd_design(c_in) == "fused")
    if not walks:
        assert port_layer.stats_design(c_in, c_out) == port_layer.backward_design(c_in, c_out)


@pytest.mark.parametrize("c_in,c_out,design", [
    (1, 256, "fused"), (2, 256, "fused"), (2, 32, "fused"), (1, 4, "fused"),
    (3, 256, "narrow"), (3, 16, "narrow"), (15, 256, "narrow"), (15, 16, "narrow"),
    (16, 15, "narrow"), (16, 16, "wide"), (16, 256, "wide"), (256, 256, "wide"),
])
def test_stats_bwd_design_boundary(c_in, c_out, design):
    """Kernel S' fuses its passes at C_in 1 and 2 (csrc channel_walk
    instantiates those), whatever the output width; above that it takes C''s
    passes (backward_design): narrow below C_in = C_out = 16, wide from
    there."""
    assert port_layer.stats_bwd_design(c_in, c_out) == design
    if c_in > port_layer.FUSED_MAX_CIN:
        assert design == port_layer.backward_design(c_in, c_out)


@pytest.mark.parametrize("c_in,c_out", [(1, 256), (2, 32), (3, 16), (16, 15), (16, 16),
                                        (256, 128)])
def test_design_codes_cover_every_choice(c_in, c_out):
    """Every design the choosers of S, S', C' and B' return has its code in
    DESIGN_CODES (csrc/vn_layer_bwd.cu's enum Design), and the channel walk
    has one code under both of its names."""
    codes = port_layer.DESIGN_CODES
    for design in (port_layer.stats_design(c_in, c_out), port_layer.stats_bwd_design(c_in, c_out),
                   port_layer.backward_design(c_in, c_out), port_layer.layer_bwd_design(c_in),
                   port_layer.wide_bf16_design(c_in, c_out, 1024)):
        assert design in codes
    assert codes["stream"] == codes["fused"] not in (codes["narrow"], codes["wide"])
    assert codes["wgmma"] not in (codes["narrow"], codes["wide"], codes["fused"])


@pytest.mark.parametrize("c_in,c_out,design", [
    (1, 256, "narrow"), (2, 256, "narrow"), (2, 32, "narrow"), (15, 256, "narrow"),
    (16, 15, "narrow"), (16, 16, "wide"), (48, 80, "wide"), (256, 128, "wide"),
    (256, 256, "wide"), (512, 512, "wide"),
])
def test_backward_design_boundary(c_in, c_out, design):
    """Wide from C_in = C_out = 16 (one m16n8k16 product's depth) up; C'
    at group 64 (256 -> 128, phase 3 of chip_smoke.py) is wide too: the
    choice reads the shape only."""
    assert port_layer.backward_design(c_in, c_out) == design


def _split_points(s, chunk, bsz, n, bf16, design="wide"):
    """The (plane, point) pairs that split ``s`` of the wide pass 3 sums
    over, walked as ``dw_wide_f32`` / ``dw_wide_bf16`` / ``dw_wgmma`` walk
    them: stage t is plane t // ceil(n / step), points (t % ceil(n / step))
    * step ..."""
    step = port_layer.wide_stage_points(bf16, design)
    per_plane = -(-n // step)
    for t in range(s * chunk, min((s + 1) * chunk, bsz * 3 * per_plane)):
        n0 = (t % per_plane) * step
        for p in range(n0, min(n0 + step, n)):
            yield t // per_plane, p


@pytest.mark.parametrize("bsz,n,c_in,c_out,two,bf16", [
    (2, 1000, 48, 80, True, False),
    (2, 1000, 48, 80, False, True),
    (1, 4100, 256, 256, True, True),
    (3, 17, 16, 16, False, True),
    (2, 1088, 256, 128, True, False),
    (8, 16384, 256, 256, False, False),
])
def test_wide_split_covers_every_point_once(bsz, n, c_in, c_out, two, bf16):
    """Every (plane, point) of B*3 planes of n points lies in exactly one
    split's stages, no split is empty, and the splits fill the card (132
    SMs) at least once over."""
    sms = 132
    splits, chunk = port_layer.wide_split(c_in, c_out, bsz, n, two, bf16, sms)
    step = port_layer.wide_stage_points(bf16)
    stages = bsz * 3 * -(-n // step)
    assert splits >= 1 and chunk >= 1
    assert (splits - 1) * chunk < stages <= splits * chunk  # none empty, none missing
    seen = np.zeros((bsz * 3, n), dtype=np.int64)
    for s in range(splits):
        pts = list(_split_points(s, chunk, bsz, n, bf16))
        assert pts, f"split {s} is empty"
        planes, points = np.array(pts).T
        np.add.at(seen, (planes, points), 1)
    assert (seen == 1).all()
    tiles = -(-c_out // (64 if two else 128)) * -(-c_in // 128)
    assert splits * tiles >= min(sms, stages * tiles)


@pytest.mark.parametrize("bsz,n,c_in,c_out,two", [
    (2, 1000, 64, 64, True),
    (2, 1000, 128, 64, False),
    (1, 4104, 256, 256, True),
    (8, 16384, 256, 256, False),
    (8, 14336, 256, 128, True),
    (3, 24, 64, 192, True),
])
def test_wgmma_split_covers_every_point_once(bsz, n, c_in, c_out, two):
    """The wgmma pass 3 (csrc ``dw_wgmma``) walks 64-point stages of one
    plane: every (plane, point) lies in exactly one split, none is empty,
    and its one-block-an-SM grid of 128 x 128 tiles fills the card once
    over, or takes the 64 splits that the in-order reduction sums one
    thread a column (less at most a half, where whole chunks of stages
    round the count down)."""
    sms = 132
    splits, chunk = port_layer.wide_split(c_in, c_out, bsz, n, two, True, sms, "wgmma")
    step = port_layer.wide_stage_points(True, "wgmma")
    assert step == port_layer.WGMMA_CHANNELS == 64
    stages = bsz * 3 * -(-n // step)
    assert (splits - 1) * chunk < stages <= splits * chunk
    seen = np.zeros((bsz * 3, n), dtype=np.int64)
    for s in range(splits):
        pts = list(_split_points(s, chunk, bsz, n, True, "wgmma"))
        assert pts, f"split {s} is empty"
        planes, points = np.array(pts).T
        np.add.at(seen, (planes, points), 1)
    assert (seen == 1).all()
    tiles = -(-c_out // 128) * -(-c_in // 128)
    assert splits <= port_layer.REDUCE_FEW_ROWS
    assert 2 * splits >= min(-(-sms // tiles), stages, port_layer.REDUCE_FEW_ROWS)


@pytest.mark.parametrize("c_in,c_out,n,aligned,design", [
    (64, 64, 1000, True, "wgmma"), (256, 256, 16384, True, "wgmma"),
    (256, 128, 14336, True, "wgmma"), (128, 192, 1088, True, "wgmma"),
    (48, 80, 1000, True, "wide"), (16, 64, 1000, True, "wide"), (64, 48, 1000, True, "wide"),
    (256, 256, 999, True, "wide"), (256, 256, 1004, True, "wide"),
    (256, 256, 16384, False, "wide"),
])
def test_wide_bf16_design_boundary(c_in, c_out, n, aligned, design):
    """A wide bf16 S' or C' takes the wgmma passes where both widths are
    multiples of 64 and the point rows are whole 16-byte vectors (N % 8 ==
    0, aligned bases: the tensor maps' strides); elsewhere the mma.sync
    passes of the wide design."""
    assert port_layer.wide_bf16_design(c_in, c_out, n, aligned) == design
    assert port_layer.backward_design(c_in, c_out) == "wide"




# ------------------------------------------ the tensor cores' k16 step
#
# ops/vn_layer_fused.py::k16_sum sums p = W x as the tensor cores do, to the
# bit (established on an H100 by tools/probe_k16.py, and held to kernel C's,
# S's, S''s and C''s p, d by the gpu tests): each step adds 16 exact
# products to a float32 accumulator, all 17 addends aligned to the largest
# exponent E (a product's taken as its operands' sum, an exponent at least
# -126) and truncated toward zero to multiples of 2^(E - 25), summed
# exactly, the sum truncated to float32.  Held here on steps whose answers
# are known and against a float64 loop written apart from it.

_U = 2.0 ** -24


def _k16_one(acc, pairs):
    """k16_sum of one output: the float32 accumulator ``acc`` plus the
    products of the (w, x) pairs (bf16-exact), as a Python float."""
    w = torch.tensor([[p[0] for p in pairs]], dtype=torch.float64).to(torch.bfloat16)
    x = torch.tensor([[p[1]] for p in pairs], dtype=torch.float64).to(torch.bfloat16)
    assert torch.equal(w.double(), torch.tensor([[p[0] for p in pairs]], dtype=torch.float64))
    assert torch.equal(x.double(), torch.tensor([[p[1]] for p in pairs], dtype=torch.float64))
    out = port_layer.k16_sum(w, x, torch.tensor([[acc]], dtype=torch.float32))
    return float(out[0, 0])


# (acc, the step's (w, x) pairs, the card's answer, the answer of the
# reading of the step that the case rules out, or None)
_KNOWN_STEPS = {
    # exact 1 + 1.5 2^-24: rounding to nearest would give 1 + 2^-23
    "sum_truncated": (1.0, [(2.0 ** -24, 1.5)], 1.0, 1 + 2.0 ** -23),
    # exact 2^-8 + 2^-26: 2^-26 lies below 2^(E - 25), E = 0
    "dropped_by_alignment": (1.0, [(-1.0, 1 - 2.0 ** -8), (2.0 ** -13, 2.0 ** -13)], 2.0 ** -8,
                             2.0 ** -8 + 2.0 ** -26),
    "exact_cancellation": (3.0, [(-1.5, 1.0), (-1.5, 1.0)], 0.0, None),
    # exact 2^-25: the accumulator's exponent (1) sets E, so 2^-25 drops;
    # aligned without it (E = 0) it would stay
    "accumulator_aligned": (-2.25, [(1.5, 1.5), (2.0 ** -12, 2.0 ** -13)], 0.0, 2.0 ** -25),
    # 1.5 x 1.5 = 2.25 counts at its operands' exponent 0, not at its own 1:
    # 2^-25 stays
    "product_exponent_of_operands": (0.0, [(1.5, 1.5), (2.0 ** -12, 2.0 ** -13), (-1.5, 1.5)],
                                     2.0 ** -25, 0.0),
    # exact -1.5 2^-25: truncated toward zero, not toward -inf
    "negative_toward_zero": (1.0, [(-1.0, 1.0), (-1.5 * 2.0 ** -12, 2.0 ** -13)],
                             -(2.0 ** -25), -(2.0 ** -24)),
    "zeros": (-0.0, [(0.0, 1.0), (0.0, -1.0)], 0.0, None),
    # a subnormal accumulator counts at exponent -126: sixteen products of
    # 1.5 2^-152 drop (at -127 each would keep 2^-152)
    "subnormal_accumulator": (2.0 ** -127, [(1.5 * 2.0 ** -76, 2.0 ** -76)] * 16, 2.0 ** -127,
                              2.0 ** -127 + 2.0 ** -148),
}


@pytest.mark.parametrize("case", list(_KNOWN_STEPS))
def test_k16_step_known_answers(case):
    acc, pairs, want, other = _KNOWN_STEPS[case]
    got = _k16_one(acc, pairs)
    assert got == want and np.copysign(1.0, got) == np.copysign(1.0, want), (case, got, want)
    assert other is None or got != other, case


def _trunc_f32(y):
    """float64 -> the float32 next to it toward zero."""
    f = y.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(y)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _exp_floor(v):
    """floor(log2 |v|), at least -126 (v != 0)."""
    _, e = np.frexp(v)
    return np.maximum(e - 1, -126)


def _k16_loop(w, x):
    """The k16 steps of sum_k w[m, k] x[k, n] in float64, one product at a
    time: w (M, K), x (K, N) bf16-exact float64 arrays."""
    m, k = w.shape
    acc = np.zeros((m, x.shape[1]), np.float32)
    for k0 in range(0, k, 16):
        terms = [w[:, i, None] * x[None, i, :] for i in range(k0, min(k0 + 16, k))]
        tops = [np.where(t == 0, -1000, _exp_floor(w[:, i, None]) + _exp_floor(x[None, i, :]))
                for i, t in zip(range(k0, k), terms)]
        a = acc.astype(np.float64)
        top = np.where(a == 0, -1000, _exp_floor(np.where(a == 0, 1.0, a)))
        for t in tops:
            top = np.maximum(top, t)
        unit = np.ldexp(1.0, np.maximum(top, -300) - 25)
        total = np.trunc(a / unit)
        for t in terms:
            total = total + np.trunc(t / unit)
        acc = _trunc_f32(total * unit)
    return acc


def _k16_inputs(kind, c_in, c_out, n, seed):
    """bf16 x (1, 3, c_in, n) and bf16-exact w (c_out, c_in).
    ``adversarial``: channel 0's product t0 a power of two, channel 1's t0
    2^-8 (so the two land on the midpoint t0 (1 + 2^-8) between two bf16
    values), the other c_in - 2 products ~2^-25 t0 with random signs, so
    every sum lies within a few float32 ulps of the midpoint."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        x = rng.standard_normal((1, 3, c_in, n))
        w = rng.uniform(-1, 1, (c_out, c_in)) / np.sqrt(c_in)
    else:
        lead_x = np.ldexp(rng.choice([-1.0, 1.0], (1, 3, 1, n)), rng.integers(-2, 3, (1, 3, 1, n)))
        lead_w = np.ldexp(rng.choice([-1.0, 1.0], (c_out, 1)), rng.integers(-2, 3, (c_out, 1)))
        small = lambda *shape: (rng.choice([-1.0, 1.0], shape)  # noqa: E731
                                * np.ldexp(rng.uniform(1, 2, shape), -13))
        x = np.concatenate([lead_x, lead_x, lead_x * small(1, 3, c_in - 2, n)], 2)
        w = np.concatenate([lead_w, lead_w * 2.0 ** -8, lead_w * small(c_out, c_in - 2)], 1)
    as16 = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    return as16(x), as16(w).float()


@pytest.mark.parametrize("c_in", [16, 64, 256])
@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_k16_sum_against_a_float64_loop(c_in, kind):
    """k16_sum's float32 sums equal, in bits, a float64 loop over the same
    steps; in bf16 (the bias-free p) they part from the in-order sum of the
    plain version where the sums lie at a rounding midpoint, and stay within
    one bf16 ulp of it."""
    x, w = _k16_inputs(kind, c_in, 48, 40, c_in + len(kind))
    got = port_layer.k16_sum(w, x.float())
    x64 = x.double().numpy()[0]
    want = np.stack([_k16_loop(w.double().numpy(), x64[j]) for j in range(3)])[None]
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    k16 = port_layer._products(w, x, None, order="k16")
    assert torch.equal(k16, got.to(torch.bfloat16))
    in_order = port_layer._products(w, x, None)
    parted = (k16 != in_order).float().mean()
    step = torch.exp2(torch.floor(torch.log2(in_order.float().abs().clamp_min(2.0 ** -126))) - 7)
    mag = torch.matmul(w.abs(), x.float().abs())  # two float32 orders of one sum
    assert bool(((k16.float() - in_order.float()).abs() <= step + 2.0 ** -13 * mag).all())
    if kind == "adversarial":
        assert parted > 0.01, parted  # the orders really part there


def test_tensor_core_model_errs_inside_its_bound():
    """The model's step errs within 11 u (|acc| + the step's sum of
    |products|) of the exact step (float64): 17 addends each truncated below
    2^(E - 25) <= 2^-25 4 max (a product's exponent counts from its
    operands', so its magnitude may reach 2^(E + 2)), then the float32
    truncation of the sum, 2 u |sum|; and truncates: an all-positive step
    never comes out above the exact sum."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((4096, 16)) * rng.uniform(0.01, 10, (1, 16))
                         ).to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((16, 1))).to(torch.bfloat16)
    acc = torch.from_numpy((rng.standard_normal((4096, 1)) * 8).astype(np.float32))
    got = port_layer.k16_sum(w, x, acc).double().numpy()[:, 0]
    prods = (w.double() * x.double()[:, 0]).numpy()
    a = acc.double().numpy()[:, 0]
    exact = a + prods.sum(1)
    bound = 11 * _U * (np.abs(a) + np.abs(prods).sum(1))
    assert bool((np.abs(got - exact) <= bound).all())
    pos = port_layer.k16_sum(w.abs(), x.abs(), acc.abs()).double().numpy()[:, 0]
    assert bool((pos <= np.abs(a) + np.abs(prods).sum(1)).all())
