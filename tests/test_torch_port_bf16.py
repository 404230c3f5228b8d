"""The bfloat16 compute policy of the port against the JAX package on the CPU.

- The policy itself (``nn/precision.py``) against JAX's.
- Each kernel's plain bf16 version (A, B at group 0 and 64, C, K3) against
  the JAX Pallas kernel in interpret mode on identical bf16 inputs: both
  outputs bf16, every element within one bf16 ulp of the larger magnitude,
  and a bounded share of elements differing at all (K3: equal).  A plain B
  that skips the rounding of p and d through bf16 fails that check.
- Modules under both scopes: the channel map, ``VNLinearLeakyReLU``, the
  flagship's ``linear_maxpool_planes``, the VN attention, and the dtype
  contracts (encoders hand back the policy dtype, models float32).
- The eval forward of the four pipelines and the flagship metric step
  under ``compute_dtype_scope(bfloat16)`` on both sides, with JAX's weights.

bf16 rounds at other places in the two frameworks (JAX's CPU takes the
unfused VN layers, the port the kernels' plain versions, which round where
the kernels round), so whole models are held to JAX's own bf16-vs-float32
distance; the algorithm itself is held in float32 and float64 by the other
``test_torch_port_*`` files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_dgcnn import _assert_knn_gap
from tests.test_torch_port_model import _randomize_bn, carried_flagship, flagship_pool_gaps
from vn_pointcloudcompletion_tpu.nn import precision as jax_precision
from vn_pointcloudcompletion_tpu_torch.nn import precision
from vn_pointcloudcompletion_tpu_torch.nn import vn as port_vn
from vn_pointcloudcompletion_tpu_torch.ops import knn_pallas as port_knn
from vn_pointcloudcompletion_tpu_torch.ops import vn_fused as port_fused
from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused as port_layer
from vn_pointcloudcompletion_tpu_torch.training.interop import state_dict_from_jax_variables

torch.set_num_threads(2)

NS = 0.2
BF16_STEP = 2.0 ** -8  # bf16's relative step (8 bits of mantissa)


def _bf16(a):
    """The same bf16 values on both sides: (numpy float32 copy, jnp bf16,
    torch bf16), rounded to nearest even from float32 on each side."""
    a = np.asarray(a, np.float32)
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t.float().numpy(), jnp.asarray(a, jnp.bfloat16), t


def _ulp(v):
    """One bf16 ulp at |v| (float32 array): 2^(floor(log2|v|) - 7); the
    smallest normal's ulp at 0."""
    v = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(v)) - 7).astype(np.float32)


def bf16_agreement(got, want, vector_axis=None):
    """(largest |got - want| in bf16 ulps of the larger magnitude, share of
    elements that differ at all); both arrays bf16 values as float32.

    With ``vector_axis`` the magnitude is that of the element's 3-vector
    (its largest component on either side): a component that cancels to
    ~1e-6 of its vector carries the float32 rounding of the vector's terms,
    and XLA's interpret mode orders (and may contract) those terms otherwise
    than the port's plain version, which equals JAX's own jnp version."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    mag = np.maximum(np.abs(got), np.abs(want))
    if vector_axis is not None:
        mag = np.broadcast_to(mag.max(vector_axis, keepdims=True), mag.shape)
    ulps = diff / _ulp(mag)
    return float(ulps.max()), float((diff > 0).mean())


def _check_bf16(name, got, want, share, vector_axis=1):
    """Both bf16; within one ulp everywhere (of the element's vector, the
    plane axis 1 by default); at most ``share`` differ."""
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, name
    worst, differ = bf16_agreement(got.float().numpy(), np.asarray(want, np.float32),
                                   vector_axis)
    print(f"{name}: worst {worst:.2f} ulp, {differ:.4%} of elements differ")
    assert worst <= 1.0 and differ <= share, (name, worst, differ)
    return worst, differ


# ------------------------------------------------------------------ policy


def test_policy_defaults_and_scope_match_jax():
    assert precision.compute_dtype() == torch.float32
    assert jax_precision.compute_dtype() == jnp.float32
    with precision.compute_dtype_scope(torch.bfloat16), \
            jax_precision.compute_dtype_scope(jnp.bfloat16):
        assert precision.compute_dtype() == torch.bfloat16
        assert jax_precision.compute_dtype() == jnp.bfloat16
        with precision.compute_dtype_scope(torch.float32):
            assert precision.compute_dtype() == torch.float32
        assert precision.compute_dtype() == torch.bfloat16
    assert precision.compute_dtype() == torch.float32
    with pytest.raises(RuntimeError), precision.compute_dtype_scope(torch.bfloat16):
        raise RuntimeError("the scope restores the old dtype on the way out")
    assert precision.compute_dtype() == torch.float32
    for name, want in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        assert precision.from_config_dtype(name) == want
        assert str(jax_precision.from_config_dtype(name).dtype) == name
    with pytest.raises(KeyError):
        precision.from_config_dtype("float16")


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_activation_dtype_matches_jax(dtype):
    """A no-op under float32 (float64 passes through), a cast to bf16 of
    float32 and float64 under bfloat16; the values are the same bits."""
    x = np.random.default_rng(0).standard_normal(7)
    jx = jnp.asarray(x, getattr(jnp, dtype)) if dtype != "float64" else x
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert precision.activation_dtype(tx) is tx
    for scope, jscope in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        with precision.compute_dtype_scope(scope), jax_precision.compute_dtype_scope(jscope):
            got = precision.activation_dtype(tx)
            want = jax_precision.activation_dtype(jnp.asarray(jx))
        assert str(got.dtype).split(".")[1] == str(np.asarray(want).dtype) or (
            dtype == "float64" and scope == torch.float32 and got.dtype == torch.float64)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))


# ------------------------------------------- plain bf16 kernels vs Pallas


def _bn_planes(rng, b, c, n):
    p = rng.standard_normal((b, 3, c, n)).astype(np.float32)
    d = rng.standard_normal((b, 3, c, n)).astype(np.float32)
    p[:, :, : c // 4, :7] = 0.0  # exact zero vectors: the |p| + EPS guard
    a = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bb = rng.normal(0.0, 0.3, c).astype(np.float32)
    return p, d, a, bb


def test_kernel_a_bf16_plain_matches_pallas():
    from vn_pointcloudcompletion_tpu.ops import vn_fused as jax_fused

    p, d, a, b = _bn_planes(np.random.default_rng(3), 2, 128, 512)
    (_, jp, tp), (_, jd, td) = _bf16(p), _bf16(d)
    got = port_fused.fused_bn_leaky(tp, td, torch.from_numpy(a), torch.from_numpy(b), NS)
    want = jax_fused.fused_bn_leaky(jp, jd, jnp.asarray(a), jnp.asarray(b), NS, True)
    _check_bf16("A", got, want, share=1e-3)


def _layer_bf16_inputs(rng, b, c_in, c_out, n, cols):
    """x, w, wd, pbias, dbias (cols bias columns, or none), a, b, w_out."""
    x = rng.standard_normal((b, 3, c_in, n)).astype(np.float32)
    bound = 1 / np.sqrt(c_in)
    w = rng.uniform(-bound, bound, (c_out, c_in)).astype(np.float32)
    wd = rng.uniform(-bound, bound, (c_out, c_in)).astype(np.float32)
    pb = rng.standard_normal((b, 3, c_out, cols)).astype(np.float32) if cols else None
    db = rng.standard_normal((b, 3, c_out, cols)).astype(np.float32) if cols else None
    a = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
    bb = rng.normal(0.0, 0.3, c_out).astype(np.float32)
    w_out = rng.uniform(-0.3, 0.3, c_out).astype(np.float32)
    return x, w, wd, pb, db, a, bb, w_out


# (C_in, C_out, N, group): the decoder's first fold layer (2 -> C over a
# per-sample bias) and the attention decoder's pair fold (1 -> C, S = 64)
B_CASES = [(2, 32, 1024, 0), (1, 32, 1024, 64)]


def _b_case(c_in, c_out, n, group):
    rng = np.random.default_rng(7 + group)
    x, w, wd, pb, db, a, b, _ = _layer_bf16_inputs(
        rng, 2, c_in, c_out, n, n // group if group else 1)
    (_, jx, tx), (_, jpb, tpb), (_, jdb, tdb) = _bf16(x), _bf16(pb), _bf16(db)
    tw = [torch.from_numpy(t) for t in (w, wd, a, b)]
    jw = [jnp.asarray(t) for t in (w, wd, a, b)]
    return (tx, tw[0], tw[1], tpb, tdb, tw[2], tw[3]), (jx, jw[0], jw[1], jpb, jdb, jw[2], jw[3])


def _pallas_b(jargs, group):
    from vn_pointcloudcompletion_tpu.ops import vn_layer_fused as jax_layer

    return jax_layer.vn_layer_fused(*jargs, NS, True, True, group)


@pytest.mark.parametrize("case", B_CASES, ids=["group0", "group64"])
def test_kernel_b_bf16_plain_matches_pallas(case):
    targs, jargs = _b_case(*case)
    got = port_layer.vn_layer_fused(*targs, NS, group=case[3])
    assert got.shape == (2, 3, case[1], case[2])
    _check_bf16(f"B group {case[3]}", got, _pallas_b(jargs, case[3]), share=1e-3)


def test_kernel_b_bf16_check_catches_unrounded_planes():
    """A plain B that feeds the epilogue the float32 planes, skipping their
    rounding through bf16 (JAX ``_compute_pd``), fails the check."""
    targs, jargs = _b_case(*B_CASES[0])
    x, w, wd, pb, db, a, b = targs

    def planes(m, bias):
        return torch.matmul(m.to(torch.bfloat16).float(), x.float()) + bias.float()

    mutant = port_fused.reference_bn_leaky_planes(
        planes(w, pb), planes(wd, db), a, b, NS).to(torch.bfloat16)
    with pytest.raises(AssertionError):
        _check_bf16("B mutant", mutant, _pallas_b(jargs, 0), share=1e-3)


def test_kernel_c_bf16_plain_matches_pallas():
    from vn_pointcloudcompletion_tpu.ops import vn_layer_fused as jax_layer

    rng = np.random.default_rng(11)
    x, w, wd, _, _, a, b, w_out = _layer_bf16_inputs(rng, 2, 32, 32, 1024, 0)
    _, jx, tx = _bf16(x)
    t = [torch.from_numpy(v) for v in (w, wd, a, b, w_out)]
    got = port_layer.vn_layer_fused_project(tx, t[0], t[1], None, None, *t[2:], NS)
    want = jax_layer.vn_layer_fused_project(
        jx, jnp.asarray(w), jnp.asarray(wd), None, None,
        *map(jnp.asarray, (a, b, w_out)), NS, True, True)
    assert got.shape == (2, 3, 1, 1024)
    _check_bf16("C", got, want, share=0.05)


def test_kernel_k3_bf16_plain_matches_pallas():
    """bf16 features and coordinates: the selection on the coordinates
    upcast to float32 (gap-checked in bf16-rounded coordinates), the exact
    gather and the one-rounding centre add give JAX's bits."""
    from vn_pointcloudcompletion_tpu.ops import knn_pallas as jax_knn

    rng = np.random.default_rng(5)
    x32, jx, tx = _bf16(rng.standard_normal((2, 3, 256)) * 0.3)
    _assert_knn_gap(x32.transpose(0, 2, 1), 16, 1e-5)
    _, ju, tu = _bf16(rng.standard_normal((2, 48, 256)))
    _, jv, tv = _bf16(rng.standard_normal((2, 48, 256)))
    got = port_knn.edge_knn_gather(tx, tu, tv, 16)
    want = jax_knn.edge_knn_gather(jx, ju, jv, 16, True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_knn_selection_ties_go_to_the_lowest_index_in_bf16():
    """bf16 rounding makes exact ties: distinct float32 points that round to
    one bf16 point are equally near every query; K2's and K3's plain
    versions then list them in index order, as JAX's kernels do."""
    from vn_pointcloudcompletion_tpu.ops import knn_pallas as jax_knn

    rng = np.random.default_rng(9)
    pts = (rng.standard_normal((1, 64, 3)) * 0.3).astype(np.float32)
    pts[0, 40:48] = pts[0, 3] * (1 + rng.uniform(-1e-3, 1e-3, (8, 1)).astype(np.float32))
    x32, jx, tx = _bf16(pts.transpose(0, 2, 1))
    assert (np.abs(x32[0, :, 40:48] - x32[0, :, 3:4]).max(0) == 0).sum() >= 2  # real ties
    _, idx = port_knn.knn_min(tx.transpose(1, 2), tx.transpose(1, 2), 16)
    _, jidx = jax_knn.knn_min_pallas(jx.transpose(0, 2, 1), jx.transpose(0, 2, 1), 16, True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    u = torch.arange(64, dtype=torch.bfloat16)[None, None].expand(1, 2, 64).contiguous()
    got = port_knn.edge_knn_gather(tx, u, torch.zeros_like(u), 16)
    want = jax_knn.edge_knn_gather(jx, jnp.asarray(u.float().numpy(), jnp.bfloat16),
                                   jnp.zeros((1, 2, 64), jnp.bfloat16), 16, True)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


# ---------------------------------------------------- modules, both scopes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_linear_plane_matches_jax(dtype):
    from vn_pointcloudcompletion_tpu.nn import vn as jax_vn

    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 3, 64, 40)).astype(np.float32)
    w = rng.uniform(-0.2, 0.2, (48, 64)).astype(np.float32)
    with precision.compute_dtype_scope(getattr(torch, dtype)), \
            jax_precision.compute_dtype_scope(getattr(jnp, dtype)):
        got = port_vn.channel_linear(torch.from_numpy(w), torch.from_numpy(x), "plane")
        want = jax_vn._channel_linear_plane(jnp.asarray(w), jnp.asarray(x))
    if dtype == "float32":
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    else:
        _check_bf16("channel map", got, want, share=1e-3)


def _jax_layer_tree(jl, x, rng):
    v = jax.tree.map(np.array, jl.init(jax.random.key(1), jnp.asarray(x)))
    return _randomize_bn(v, rng)


def _port_layer_from(v, layer):
    bn = v["params"]["batchnorm"]["BatchNorm_0"]
    st = v["batch_stats"]["batchnorm"]["BatchNorm_0"]
    layer.load_state_dict({
        "map_to_feat.weight": torch.from_numpy(v["params"]["kernel"]),
        "map_to_dir.weight": torch.from_numpy(v["params"]["dir_kernel"]),
        "batchnorm.bn.weight": torch.from_numpy(bn["scale"]),
        "batchnorm.bn.bias": torch.from_numpy(bn["bias"]),
        "batchnorm.bn.running_mean": torch.from_numpy(st["mean"]),
        "batchnorm.bn.running_var": torch.from_numpy(st["var"]),
    })
    return layer.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["plane", "vec"])
def test_vn_linear_leaky_relu_matches_jax(layout, dtype):
    """Eval mode, the plain chain on both sides (below the kernels'
    shapes): the bf16 products and the float32 epilogue stored bf16."""
    from vn_pointcloudcompletion_tpu.nn import vn as jax_vn

    rng = np.random.default_rng(17)
    shape = (2, 3, 24, 40) if layout == "plane" else (2, 24, 3, 40)
    x = rng.standard_normal(shape).astype(np.float32)
    jl = jax_vn.VNLinearLeakyReLU(32, layout=layout)
    v = _jax_layer_tree(jl, x, rng)
    layer = _port_layer_from(v, port_vn.VNLinearLeakyReLU(24, 32, layout=layout))
    with precision.compute_dtype_scope(getattr(torch, dtype)), \
            jax_precision.compute_dtype_scope(getattr(jnp, dtype)):
        want = jl.apply(v, jnp.asarray(x), train=False)
        with torch.no_grad():
            got = layer(torch.from_numpy(x))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    else:
        # plane: the float32 epilogue of bf16 planes; vec: the reflection in
        # bf16 arithmetic on both sides, every operation and constant rounded
        # to bf16 (JAX eager), the norm statistics in float32
        _check_bf16(f"VNLinearLeakyReLU {layout}", got, want, share=1e-3,
                    vector_axis=1 if layout == "plane" else 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_maxpool_planes_matches_jax(dtype):
    """The flagship's fused VNLinear + VNMaxPool: the linear's output, and
    the pooled vectors wherever the pool's top-2 gap exceeds the rounding
    of the policy's scores (every channel of this cloud in float32)."""
    from vn_pointcloudcompletion_tpu.models import pcn as jax_pcn
    from vn_pointcloudcompletion_tpu_torch.models import pcn as port_pcn

    rng = np.random.default_rng(19)
    x = rng.standard_normal((2, 3, 32, 48)).astype(np.float32)
    w = rng.uniform(-0.2, 0.2, (40, 32)).astype(np.float32)
    wd = rng.uniform(-0.2, 0.2, (40, 40)).astype(np.float32)
    with precision.compute_dtype_scope(getattr(torch, dtype)), \
            jax_precision.compute_dtype_scope(getattr(jnp, dtype)):
        f, g = port_pcn.linear_maxpool_planes(*map(torch.from_numpy, (w, wd, x)))
        jf, jg = jax_pcn._linear_maxpool_planes(*map(jnp.asarray, (w, wd, x)))
    assert f.dtype == getattr(torch, dtype) and g.shape == (2, 3, 40)
    if dtype == "float32":
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5)
        return
    _check_bf16("pool linear", f, jf, share=1e-3)
    # the bf16 scores are bf16 products summed in float32 on both sides:
    # the same picks, ties (frequent at 8 bits) to the first point
    np.testing.assert_array_equal(g.float().numpy(), np.asarray(jg, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vn_attention_matches_jax(dtype):
    from vn_pointcloudcompletion_tpu.nn import attention as jax_attn
    from vn_pointcloudcompletion_tpu_torch.nn import attention as port_attn

    rng = np.random.default_rng(23)
    x = (rng.standard_normal((2, 16, 3, 24)) * 0.5).astype(np.float32)
    ja = jax_attn.VNAttention(24, 16, num_heads=4)
    v = jax.tree.map(np.array, ja.init(jax.random.key(2), jnp.asarray(x)))
    pa = port_attn.VNAttention(16, 24, 16, num_heads=4)
    pa.load_state_dict({f"{k}.map_to_feat.weight": torch.from_numpy(v["params"][k]["kernel"])
                        for k in ("proj_vnq", "proj_vnk", "proj_vnv", "proj_vn")})
    with precision.compute_dtype_scope(getattr(torch, dtype)), \
            jax_precision.compute_dtype_scope(getattr(jnp, dtype)):
        want = np.asarray(ja.apply(v, jnp.asarray(x)), np.float32)
        with torch.no_grad():
            got = pa(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    # bf16: four rounded products and a softmax stored bf16 in a row; a few
    # ulps of the largest output
    tol = 1e-5 if dtype == "float32" else 8 * BF16_STEP
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


# ------------------------------------------------------ dtype contracts


def test_encoders_hand_back_the_policy_dtype_and_models_float32():
    """As JAX's ``tests/test_precision.py``: the VN grouper and the VN
    DGCNN encoder return bf16 under the bf16 policy and float32 outside it;
    a whole model returns float32 under both."""
    from vn_pointcloudcompletion_tpu_torch.models.composer import PCNNet, init_weights_
    from vn_pointcloudcompletion_tpu_torch.models.dgcnn import VNDGCNNfps
    from vn_pointcloudcompletion_tpu_torch.models.pointr import VNDGCNNGrouper

    xyz = torch.from_numpy((np.random.default_rng(29).standard_normal((1, 600, 3))
                            * 0.3).astype(np.float32))
    grouper, enc = VNDGCNNGrouper().eval(), VNDGCNNfps(64).eval()
    model = init_weights_(PCNNet(num_coarse=64), 0).eval()
    for dtype in (torch.float32, torch.bfloat16):
        with torch.no_grad(), precision.compute_dtype_scope(dtype):
            coor, f = grouper(xyz)
            coarse, gf = enc(xyz)
            c, fine = model(xyz[:, :256])
        assert coor.dtype == f.dtype == coarse.dtype == gf.dtype == dtype
        assert c.dtype == fine.dtype == torch.float32
        assert torch.isfinite(f.float()).all() and torch.isfinite(fine).all()


# ------------------------------------------ whole eval forwards under bf16

# name: (encoder, decoder, num_coarse, batch, points, cloud seed); the
# flagship is ``tests/test_torch_port_model.py``'s (32 points)
PIPELINES = {
    "flagship": ("vn_pointnet", "vn_foldingnet", 64, 2, 32, None),
    "vn_dgcnn": ("vn_dgcnn_fps", "vn_foldingnet", 64, 2, 600, 60),
    "dgcnn": ("dgcnn_fps", "foldingnet", 64, 2, 600, 60),
    "vn_pointr": ("vn_pointr", "attention_vn_foldingnet", 448, 1, 600, 61),
}
_CARRIED = {}


def _carried(name):
    """(JAX model, variables, port model, cloud); random VN norms except
    vn_pointr's (its scanned encoder stacks them)."""
    from vn_pointcloudcompletion_tpu.models.composer import PCNNet as JaxPCNNet
    from vn_pointcloudcompletion_tpu_torch.models.composer import PCNNet

    if name == "flagship":
        _CARRIED.setdefault(name, carried_flagship())
    if name not in _CARRIED:
        enc, dec, nc, b, n, seed = PIPELINES[name]
        xyz = (np.random.default_rng(seed).standard_normal((b, n, 3)) * 0.3).astype(np.float32)
        jm = JaxPCNNet(enc, dec, nc)
        v = jax.jit(lambda k, x: jm.init(k, x, None, train=False))(jax.random.key(0),
                                                                   jnp.asarray(xyz))
        v = jax.tree.map(np.asarray, v)
        if enc != "vn_pointr":
            v = _randomize_bn(v, np.random.default_rng(seed))
        model = PCNNet(enc, dec, nc).eval()
        model.load_state_dict(state_dict_from_jax_variables(v), strict=True)
        _CARRIED[name] = (jm, v, model, xyz)
    return _CARRIED[name]


def _jax_apply(mod, v, *args, dtype, **kw):
    """``mod.apply`` traced and run under the JAX policy ``dtype``."""
    with jax_precision.compute_dtype_scope(dtype):
        return jax.jit(lambda v, *a: mod.apply(v, *a, **kw))(v, *args)


_JAX_OUT = {}


def _jax_forward(name, dtype):
    """JAX's eval forward (coarse, fine) of ``_carried(name)`` under the
    policy ``dtype``, as numpy float32; computed once."""
    if (name, dtype) not in _JAX_OUT:
        jm, v, _, xyz = _carried(name)
        out = _jax_apply(jm, v, jnp.asarray(xyz), None, dtype=dtype, train=False)
        assert all(t.dtype == jnp.float32 for t in out)
        _JAX_OUT[name, dtype] = [np.asarray(t) for t in out]
    return _JAX_OUT[name, dtype]


def _cd_l1(a, b):
    """Chamfer-L1 of two (B, N, 3) clouds through ``torch.cdist`` in row
    chunks (a yardstick: the port's exact chamfer is tested elsewhere)."""
    def one_way(x, y):
        return torch.cat([torch.cdist(x[:, i:i + 2048], y).amin(-1)
                          for i in range(0, x.shape[1], 2048)], 1).mean()

    x, y = torch.from_numpy(a).double(), torch.from_numpy(b).double()
    return float((one_way(x, y) + one_way(y, x)) / 2)


@pytest.mark.parametrize("name", list(PIPELINES))
def test_eval_forward_bf16_within_jax_bf16_spread(name):
    """Under ``compute_dtype_scope(bfloat16)`` on both sides: float32
    outputs of the right shapes, and the port's coarse and dense clouds no
    further from JAX's bf16 clouds than twice JAX's own bf16 clouds lie from
    its float32 ones, as max-abs and as CD-L1.  (The argmax pools and the
    kNN graphs pick on bf16 scores and coordinates, and the two frameworks
    round at other places, so a pick may differ: the spread of the policy
    itself is the yardstick.)"""
    _, _, model, xyz = _carried(name)
    want32, want16 = _jax_forward(name, jnp.float32), _jax_forward(name, jnp.bfloat16)
    with torch.no_grad(), precision.compute_dtype_scope(torch.bfloat16):
        got = model(torch.from_numpy(xyz))
    for g, w16, w32 in zip(got, want16, want32):
        assert g.dtype == torch.float32 and g.shape == w16.shape
        g = g.numpy()
        assert np.isfinite(g).all()
        spread, dist = np.abs(w16 - w32).max(), np.abs(g - w16).max()
        cd_spread, cd = _cd_l1(w16, w32), _cd_l1(g, w16)
        print(f"{name} {g.shape}: max-abs {dist:.3g} (JAX spread {spread:.3g}), "
              f"CD-L1 {cd:.3g} (JAX spread {cd_spread:.3g})")
        assert spread > 0 and dist <= 2 * spread and cd <= 2 * cd_spread


def test_decoders_bf16_match_jax():
    """The VN decoders alone, on the same (coarse, feature_global): they
    take no discrete decision (no pool, no kNN; the leaky reflection is
    continuous), so the pool- and kNN-gap checks pass trivially and the two
    sides differ only by where they round.  Bound: 4 bf16 steps (2^-6) of
    the output's largest coordinate; the dense points are the coarse ones
    plus a fold that passes through five bf16-rounded layers (the attention
    decoder: two VN transformer blocks and two folds), whose sums the two
    frameworks take in other orders and at other rounding sites (the port's
    fold layers round as kernels B and C round)."""
    from vn_pointcloudcompletion_tpu.models import pcn as jax_pcn

    rng = np.random.default_rng(31)
    for name, cls, nc, width in (("flagship", "VNFoldingNet", 64, 2048),
                                 ("vn_pointr", "AttentionVNFoldingNet", 448, 1024)):
        _, v, model, _ = _carried(name)
        n = 224 if nc == 448 else nc
        coarse = (rng.standard_normal((1, n, 3)) * 0.3).astype(np.float32)
        fg = (rng.standard_normal((1, width, 3, 1)) * 0.3).astype(np.float32)
        jdec = getattr(jax_pcn, cls)(nc, width)
        jv = {k: v[k]["decoder"] for k in v if "decoder" in v[k]}
        want = np.asarray(_jax_apply(jdec, jv, *map(jnp.asarray, (coarse, fg)),
                                     dtype=jnp.bfloat16), np.float32)
        with torch.no_grad(), precision.compute_dtype_scope(torch.bfloat16):
            got = model.decoder(*map(torch.from_numpy, (coarse, fg))).float().numpy()
        dist = np.abs(got - want).max() / np.abs(want).max()
        print(f"{cls}: {dist:.3g} of the max")
        assert got.shape == want.shape and dist <= 2.0 ** -6, (cls, dist)


def test_dgcnn_pipeline_bf16_matches_jax():
    """``dgcnn_fps`` + ``foldingnet``: its graphs and FPS pick on float32
    coordinates under either policy (bf16 reaches only the kernel-1
    convolutions' operands), so on a cloud whose k-th neighbour gaps pass
    1e-5 the two sides take the same decisions and differ by rounding only:
    within 4 bf16 steps (2^-6) of each output's max (about ten bf16-rounded
    convolutions, summed in other orders)."""
    _, _, model, xyz = _carried("dgcnn")
    _assert_knn_gap(xyz, 16, 1e-5)
    want = _jax_forward("dgcnn", jnp.bfloat16)
    with torch.no_grad(), precision.compute_dtype_scope(torch.bfloat16):
        got = model(torch.from_numpy(xyz))
    for g, w in zip(got, want):
        w = np.asarray(w)
        dist = np.abs(g.numpy() - w).max() / np.abs(w).max()
        print(f"dgcnn {w.shape}: {dist:.3g} of the max")
        assert dist <= 2.0 ** -6


def test_flagship_pools_cannot_be_gap_checked_at_bf16_step():
    """Why the VN encoders are held to JAX's own spread and not to a gap
    check at bf16's step (2^-8): a random-init flagship has channels whose
    top-2 pool scores lie far closer than that on every cloud, float32
    rounding apart (the check at 1e-5 that the float32 tests use passes)."""
    _, _, model, xyz = _carried("flagship")
    gaps = flagship_pool_gaps(model, xyz)
    assert min(g.min() for g in gaps) > 1e-5
    assert min(g.min() for g in gaps) < BF16_STEP


def test_metric_step_bf16_matches_jax():
    """The flagship ``test`` metric step (no rotation, so both sides see the
    same batch) under bf16 on both sides against JAX's ``_make_metric_step``:
    outputs float32; CD-L1, CD-L2, F-score and voxel IoU per sample within
    twice JAX's own bf16-vs-float32 difference of each, plus 1e-3 of it
    (the forward's yardstick, ``test_eval_forward_bf16_within_jax_bf16_spread``,
    carried to the metrics; their float32 noise on equal clouds is far
    below 1e-3)."""
    from vn_pointcloudcompletion_tpu.training.evaluate import _make_metric_step
    from vn_pointcloudcompletion_tpu.training.state import create_train_state
    from vn_pointcloudcompletion_tpu.utils.config import Config as JaxConfig
    from vn_pointcloudcompletion_tpu_torch.training.evaluate import metric_step

    from vn_pointcloudcompletion_tpu.metrics import metrics as jax_metrics

    jm, v, model, xyz = _carried("flagship")
    # a ground truth near JAX's bf16 completion, so that F-score@0.01 and
    # the voxel IoU are neither 0 nor 1
    fine16 = _jax_forward("flagship", jnp.bfloat16)[1]
    complete = fine16 + 0.004 * np.random.default_rng(37).standard_normal(
        fine16.shape).astype(np.float32)
    cfg = JaxConfig.from_dict({"num_coarse": 64, "test_rotation": "none"})
    state = create_train_state(jm, cfg, 1, jax.random.key(0), jnp.asarray(xyz))
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    with jax_precision.compute_dtype_scope(jnp.bfloat16):
        out, _ = _make_metric_step(cfg)(state, jnp.asarray(xyz), jnp.asarray(complete),
                                        jax.random.key(0))

    def per_sample(pred):  # JAX's metrics of a prediction, per sample
        pj, cj = jnp.asarray(pred), jnp.asarray(complete)
        d = {"l1": [jax_metrics.l1_cd(pj[i:i + 1], cj[i:i + 1]) for i in range(2)],
             "l2": [jax_metrics.l2_cd(pj[i:i + 1], cj[i:i + 1]) for i in range(2)],
             "f": jax_metrics.f_score(pj, cj), "iou": jax.vmap(jax_metrics.voxel_iou)(pj, cj)}
        return {k: np.asarray(val, np.float64).reshape(-1) for k, val in d.items()}

    want = {"bf16": {k: np.asarray(t, np.float64) for k, t in out.items()},
            "f32": per_sample(_jax_forward("flagship", jnp.float32)[1])}
    with precision.compute_dtype_scope(torch.bfloat16):
        got, pred = metric_step(model, *map(torch.from_numpy, (xyz, complete)), None)
    assert pred.dtype == torch.float32
    for key in ("l1", "l2", "f", "iou"):
        g, w16, w32 = got[key].double().numpy(), want["bf16"][key], want["f32"][key]
        tol = 2 * np.abs(w16 - w32) + 1e-3 * np.abs(w16)
        print(f"{key}: port {g}, JAX bf16 {w16}, JAX f32 {w32}")
        assert np.all(np.abs(g - w16) <= tol), key
        if key in ("f", "iou"):
            assert 0 < w16.min() and w16.max() < 1  # the metric discriminates
    # and the metrics of the port's own completion are JAX's metrics of it
    for key, w in per_sample(pred.numpy()).items():
        np.testing.assert_allclose(got[key].double().numpy(), w, rtol=1e-5, atol=1e-7,
                                   err_msg=key)


# --------------------------------------------------- the CLI on bf16 configs


def _run_test(tmp_path, monkeypatch, name, cfg):
    """``test`` through the CLI on an experiment written with ``cfg`` and a
    checkpoint of its seed's weights; returns the metric table."""
    import json

    from vn_pointcloudcompletion_tpu_torch import __main__ as cli
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.training.checkpoint import save_model
    from vn_pointcloudcompletion_tpu_torch.utils.config import load_config

    out = tmp_path / "experiments"
    exp_dir = out / name
    (exp_dir / "models").mkdir(parents=True)
    (exp_dir / "config.json").write_text(json.dumps(dict(cfg, exp_dir=str(exp_dir))))
    monkeypatch.setenv("OUTPUT_DIR", str(out))
    save_model(str(exp_dir), build_model(load_config(name)), "best")
    return cli.main(["-n", name, "--resume", "--device", "cpu", "test"])


@pytest.mark.parametrize("root", [False, True], ids=["flagship", "root_config"])
def test_cli_test_on_a_bf16_config_runs_float32(tmp_path, monkeypatch, root):
    """``test`` never sets the policy (JAX ``main.py`` neither): on a config
    whose ``dtype`` is bfloat16 it gives the float32 config's metrics
    exactly.  ``root_config``: the repo's own ``config.json`` (vn_pointr +
    attention_vn_foldingnet at 448, bfloat16) on synthetic 600-point scans."""
    import json
    from pathlib import Path

    small = {"dataset": "synthetic", "batch_size": 2, "num_workers": 1,
             "synthetic_test_samples": 2, "synthetic_n_complete": 2048}
    if root:
        cfg = json.loads((Path(__file__).resolve().parents[1] / "config.json").read_text())
        assert cfg["dtype"] == "bfloat16" and cfg["enc_type"] == "vn_pointr"
        cfg.update(small, synthetic_n_partial=600)
    else:
        cfg = dict(small, enc_type="vn_pointnet", dec_type="vn_foldingnet", num_coarse=64,
                   latent_dim=2048, test_rotation="so3", synthetic_n_partial=256, seed=1)
    got = _run_test(tmp_path, monkeypatch, "bf16", dict(cfg, dtype="bfloat16"))
    want = _run_test(tmp_path, monkeypatch, "f32", dict(cfg, dtype="float32"))
    assert precision.compute_dtype() == torch.float32
    assert got == want and np.isfinite(got["average"]["l1"])


def test_cli_train_on_a_bf16_config_names_the_next_slice(tmp_path, monkeypatch):
    """bf16 training runs (below); what a bf16 config still cannot ask of
    ``train`` and ``overfit`` is the next slice, ``remat``, and the error
    names it and its ROADMAP.md item."""
    import json

    from vn_pointcloudcompletion_tpu_torch import __main__ as cli

    cfg = {"enc_type": "vn_pointnet", "dec_type": "vn_foldingnet", "num_coarse": 64,
           "batch_size": 2, "dataset": "synthetic", "num_workers": 1, "dtype": "bfloat16",
           "remat": True}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "out"))
    for command in ("train", "overfit"):
        with pytest.raises(NotImplementedError, match="remat.*item 7"):
            cli.main(["-epochs", "0", "--device", "cpu", command])
    assert precision.compute_dtype() == torch.float32


@pytest.mark.parametrize("root", [False, True], ids=["flagship", "root_config"])
def test_cli_train_and_resume_on_a_bf16_config(tmp_path, monkeypatch, root):
    """``overfit`` then ``-n <run> --resume train`` on a bf16 config under
    the bf16 policy: finite losses, the checkpoints float32 and restored
    into a fresh state as they were saved (parameters, BatchNorm statistics,
    Adam's moments and count), the resumed run continuing from them.  ``root_config``:
    the repo's own ``config.json`` (vn_pointr + attention_vn_foldingnet at
    448, bfloat16, batch 8) cut to batch 2 of 600-point synthetic scans."""
    import json
    import os
    from pathlib import Path

    from vn_pointcloudcompletion_tpu_torch import __main__ as cli
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model
    from vn_pointcloudcompletion_tpu_torch.training.checkpoint import restore_checkpoint
    from vn_pointcloudcompletion_tpu_torch.training.state import create_train_state
    from vn_pointcloudcompletion_tpu_torch.utils.config import load_config

    small = {"name": "b16", "dataset": "synthetic", "batch_size": 2, "num_workers": 1,
             "synthetic_n_complete": 1024, "log_frequency": 1}
    if root:
        cfg = json.loads((Path(__file__).resolve().parents[1] / "config.json").read_text())
        assert cfg["dtype"] == "bfloat16" and cfg["enc_type"] == "vn_pointr"
        cfg.update(small, synthetic_n_partial=600)
    else:
        cfg = dict(small, enc_type="vn_pointnet", dec_type="vn_foldingnet", num_coarse=64,
                   latent_dim=2048, synthetic_n_partial=512, dtype="bfloat16", seed=1)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "out"))
    assert cli.main(["-epochs", "0", "--device", "cpu", "overfit"])["epochs_run"] == 1
    (run,) = os.listdir(tmp_path / "out")
    exp = tmp_path / "out" / run
    # the stored pair restores into a fresh state under the policy as it was saved
    saved_model = torch.load(exp / "models" / "model_last.pth", weights_only=True)
    saved = torch.load(exp / "optimizer" / "optim_last.pth", weights_only=True)
    config = load_config(run)
    state = create_train_state(build_model(config), config, 1)
    with precision.compute_dtype_scope(torch.bfloat16):
        state, epoch, _, _ = restore_checkpoint(str(exp), state, "last")
    assert epoch == 0 and state.step == saved["step"] == 1
    for k, t in state.model.state_dict().items():
        assert t.dtype == saved_model[k].dtype and torch.equal(t, saved_model[k]), k
    for i, moments in state.optimizer.state_dict()["state"].items():
        for k, t in moments.items():
            assert torch.equal(torch.as_tensor(t), torch.as_tensor(
                saved["optim_state_dict"]["state"][i][k])), (i, k)
            assert not torch.is_floating_point(t) or t.dtype == torch.float32, (i, k)
    assert cli.main(["-n", run, "--resume", "-epochs", "1", "--device", "cpu",
                     "train"])["epochs_run"] == 1
    assert precision.compute_dtype() == torch.float32
    assert "[RESUME INFO] resume ckpts @ 0 epoch" in (exp / "train.log").read_text()
    rows = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    assert len([r for r in rows if r["tag"] == "Loss/Epoch/Total"]) == 4  # train, val x 2
    assert all(np.isfinite(r["value"]) for r in rows)
    model = torch.load(exp / "models" / "model_last.pth", weights_only=True)
    meta = torch.load(exp / "optimizer" / "optim_last.pth", weights_only=True)
    assert all(t.dtype == torch.float32 for t in model.values() if t.is_floating_point())
    assert meta["epoch"] == 1 and meta["step"] == 2
