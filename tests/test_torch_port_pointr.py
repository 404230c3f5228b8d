"""vn_pointr + attention_vn_foldingnet of the port against the JAX package
on the CPU.

- the plain versions of kernels B, C, S and their backwards in group=S mode
  against the Pallas kernels in interpret mode, the group checks, and
  ``gradcheck`` of the three ``autograd.Function``s with a group;
- the pair fold layer against JAX's ``_VNSplitPairFoldLayerFused`` (its
  group=S kernels in interpret mode) and ``_VNSplitPairFoldLayer``, eval
  and train;
- ``VNLayerNorm``, the vec ``VNMaxPool``, ``mean_pool``,
  ``vn_graph_feature``, ``VNStdFeature``, ``VNAttention`` and ``VNBlock``;
- ``VNPCTransformer``, ``AttentionVNFoldingNet`` and the whole ``PCNNet``,
  a float64 train step of the encoder and of the decoder, the float32
  step's sensitivity to one ulp of input on both sides, the weights'
  mapping both ways, the re-initialisation of the encoder, and the CLI.

Inputs come from numpy seeds, weights from JAX ``init`` carried across with
the port's interop.  Whole models are compared in float64 (JAX with x64):
in float32 the two sides' matrix products round differently by a few ulp,
and ``VNLayerNorm`` rescales every vector to O(1), so a vector whose norm is
1e-3 of the typical one carries that rounding up a thousandfold (ROADMAP.md
section 3).  Under x64 JAX still rounds the attention softmax through
float32 (``nn/attention.py:78``); the float64 cases read that cast as
float64 and take JAX's folding grid (``_X64``; the two linspace round 1 ulp
apart, ``tests/test_torch_port_model.py::test_folding_grids_match_jax``),
so both sides compute in float64 throughout.
The kNN and FPS picks are float32 in JAX; the inputs keep wide gaps.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vn_pointcloudcompletion_tpu_torch import __main__ as cli
from vn_pointcloudcompletion_tpu_torch.models import pcn as port_pcn
from vn_pointcloudcompletion_tpu_torch.models.composer import PCNNet, build_model
from vn_pointcloudcompletion_tpu_torch.models.pointr import VNPCTransformer
from vn_pointcloudcompletion_tpu_torch.nn import attention as port_attn
from vn_pointcloudcompletion_tpu_torch.nn import vn as port_vn
from vn_pointcloudcompletion_tpu_torch.ops import vn_layer_fused as port_layer
from vn_pointcloudcompletion_tpu_torch.ops.knn import vn_graph_feature
from vn_pointcloudcompletion_tpu_torch.training import interop
from vn_pointcloudcompletion_tpu_torch.training.interop import state_dict_from_jax_variables
from vn_pointcloudcompletion_tpu_torch.utils.config import Config

torch.set_num_threads(2)

NS = 0.2
TOL = 1e-8  # measured 1.8e-10 (the encoder), 1e-14 and below elsewhere
N_POINTS = 600  # input points: FPS 600 -> 512 -> 128 as at full width


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _randomize_norms(tree, rng):
    """Non-identity scale/bias of every norm layer and non-trivial running
    statistics, so the folded affines are exercised."""
    def walk(node):
        if not isinstance(node, dict):
            return np.array(node)
        out = {k: walk(v) for k, v in node.items()}
        if {"scale", "bias"} <= set(out) and "kernel" not in out:
            shape = out["scale"].shape
            out["scale"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
            out["bias"] = rng.normal(0, 0.2, shape).astype(np.float32)
        if {"mean", "var"} <= set(out):
            shape = out["mean"].shape
            out["mean"] = rng.uniform(0.0, 0.5, shape).astype(np.float32)
            out["var"] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return out

    return walk(tree)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _cloud(seed, b=2, n=N_POINTS, scale=0.3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, 3)) * scale).astype(np.float32)


def _sub_sd(fill, p, s):
    """A port submodule's state_dict from a JAX subtree through the interop
    helper ``fill(sd, key, p, s)``."""
    sd = {}
    fill(sd, "m", p, s)
    return {k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _assert_rel(got, want, rel):
    """Each tensor within ``rel`` of its largest |want| (and atol 1e-12)."""
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        w = np.asarray(w)
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape, (g.shape, w.shape)
        err = np.abs(g - w).max()
        assert err <= rel * np.abs(w).max() + 1e-12, (err, np.abs(w).max())


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


class _X64:
    """JAX with float64 inside the block, its attention softmax included,
    and JAX's folding grid in the port."""

    def __init__(self, monkeypatch):
        from vn_pointcloudcompletion_tpu.nn import attention as jax_attention
        from vn_pointcloudcompletion_tpu.ops import grid as jax_grid

        monkeypatch.setattr(jax_attention, "jnp", _Float64Numpy())
        monkeypatch.setattr(port_pcn, "folding_grid_3d", lambda g, extent=0.05: torch.from_numpy(
            np.array(jax_grid.folding_grid_3d(g, extent))))

    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


def _apply(mod, v, *args, **kw):
    """``mod.apply`` compiled once (eager flax dispatches thousands of ops)."""
    return jax.jit(lambda v, *a: mod.apply(v, *a, **kw))(v, *args)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


# ------------------------------------------- kernels B, C, S with group=S


def _group_inputs(s, n, c_in=8, c_out=16, seed=0):
    rng = np.random.default_rng(seed + s)
    x = rng.standard_normal((2, 3, c_in, n)).astype(np.float32)
    x[:, :, :, :7] = 0.0  # with the bias, p is the bias there
    bound = 1 / np.sqrt(c_in)
    w, wd = (rng.uniform(-bound, bound, (c_out, c_in)).astype(np.float32) for _ in range(2))
    pb, db = (rng.standard_normal((2, 3, c_out, n // s)).astype(np.float32) * 0.3
              for _ in range(2))
    a = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
    b = rng.normal(0.0, 0.3, c_out).astype(np.float32)
    w_out = rng.uniform(-0.3, 0.3, c_out).astype(np.float32)
    return rng, x, w, wd, pb, db, a, b, w_out


# N a multiple of S but not of the Pallas kernels' 512-point tile (padded there)
_GROUPS = [(16, 1040), (64, 1088), (128, 1024)]


@pytest.mark.parametrize("s,n", _GROUPS)
def test_group_forward_plain_matches_pallas(s, n):
    """B, C and S (the sums s1, s2) with per-group bias columns: within 1e-5
    of each output's max (the sums over points run in another order)."""
    from vn_pointcloudcompletion_tpu.ops import vn_layer_fused as jax_layer

    _, x, w, wd, pb, db, a, b, w_out = _group_inputs(s, n)
    got = port_layer.vn_layer_fused(*_t(x, w, wd, pb, db, a, b), NS, group=s)
    want, _ = jax_layer._layer_fwd(*_j(x, w, wd, pb, db, a, b), NS, False, True, s)
    _assert_rel([got], [want], 1e-5)
    got = port_layer.vn_layer_fused_project(*_t(x, w, wd, pb, db, a, b, w_out), NS, group=s)
    want, _ = jax_layer._proj_fwd(*_j(x, w, wd, pb, db, a, b, w_out), NS, False, True, s)
    assert got.shape == (2, 3, 1, n)
    _assert_rel([got], [want], 1e-5)
    got = port_layer.vn_layer_stats(*_t(x, w, pb), s)
    want, _ = jax_layer._stats_fwd(*_j(x, w, pb), False, True, s)
    _assert_rel(got, want, 1e-5)


@pytest.mark.parametrize("s,n", _GROUPS)
def test_group_backward_plain_matches_pallas(s, n):
    """S', B' and C' with per-group bias columns: the bias gradients are dp
    summed over each group's S points; every output within 1e-5 of its
    max."""
    from vn_pointcloudcompletion_tpu.ops import vn_layer_fused as jax_layer

    rng, x, w, wd, pb, db, a, b, w_out = _group_inputs(s, n, seed=1)
    c1, c2 = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    got = port_layer.reference_stats_bwd(*_t(x, w, pb, c1, c2), s)
    _, res = jax_layer._stats_fwd(*_j(x, w, pb), False, True, s)
    want = jax_layer._stats_bwd(False, True, s, res, tuple(_j(c1, c2)))
    assert got[2].shape == (2, 3, 16, n // s)
    _assert_rel(got, want, 1e-5)

    g = rng.standard_normal((2, 3, 16, n)).astype(np.float32)
    got = port_layer.reference_layer_bwd(*_t(x, w, wd, pb, db, a, b, g), NS, s)
    want = jax_layer._layer_bwd(NS, False, True, s, tuple(_j(x, w, wd, pb, db, a, b)),
                                jnp.asarray(g))
    _assert_rel(got, want, 1e-5)

    g = rng.standard_normal((2, 3, 1, n)).astype(np.float32)
    got = port_layer.reference_layer_project_bwd(*_t(x, w, wd, pb, db, a, b, w_out, g), NS, s)
    want = jax_layer._proj_bwd(NS, False, True, s, tuple(_j(x, w, wd, pb, db, a, b, w_out)),
                               jnp.asarray(g))
    _assert_rel(got, want, 1e-5)


@pytest.mark.parametrize("group,n,cols,match", [
    (48, 960, 20, "divide"),  # not a divisor of 512
    (64, 1000, 15, "divide"),  # not a divisor of N
    (64, 1024, 15, r"\(2, 3, 16, 16\)"),  # the wrong number of columns
    (-1, 1024, 1, "divide"),
])
def test_group_checks_raise(group, n, cols, match):
    """The launch checks, which hold on the card (the plain versions on the
    CPU take any broadcastable bias)."""
    x = torch.zeros(2, 3, 8, n)
    w = torch.zeros(16, 8)
    pb = torch.zeros(2, 3, 16, cols)
    with pytest.raises(ValueError, match=match):
        port_layer._prepare("layer", x, w, w, pb, pb, group=group)


@pytest.mark.parametrize("which", ["stats", "layer", "project"])
def test_group_functions_gradcheck(which):
    g = torch.Generator().manual_seed(7)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, dtype=torch.float64) * scale).requires_grad_()

    x, w, wd = r(2, 3, 1, 8), r(4, 1, scale=0.5), r(4, 1, scale=0.5)
    pb, db = r(2, 3, 4, 2), r(2, 3, 4, 2)
    a = (torch.rand(4, generator=g, dtype=torch.float64) + 0.5).requires_grad_()
    b = r(4, scale=0.3)
    if which == "stats":
        fn, args = (lambda *t: port_layer.vn_layer_stats(*t, 4)), (x, w, pb)
    elif which == "layer":
        fn = lambda *t: port_layer.vn_layer_fused(*t, NS, group=4)  # noqa: E731
        args = (x, w, wd, pb, db, a, b)
    else:
        fn = lambda *t: port_layer.vn_layer_fused_project(*t, NS, group=4)  # noqa: E731
        args = (x, w, wd, pb, db, a, b, r(4))
    assert torch.autograd.gradcheck(fn, args)


# ------------------------------------------------------- the pair fold


def _pair_fold_case(train, jax_cls, port_path):
    from vn_pointcloudcompletion_tpu.models import pcn as jax_pcn

    rng = np.random.default_rng(23)
    n, s, cf, out = 64, 64, 48, 128  # 4096 grid points: the port's group path
    feat = rng.standard_normal((2, 3, cf, n)).astype(np.float32)
    var = rng.standard_normal((2, 3, 1, n * s)).astype(np.float32)
    cls = (jax_pcn._VNSplitPairFoldLayerFused if jax_cls == "fused"
           else jax_pcn._VNSplitPairFoldLayer)
    mod = cls(out)
    v = _randomize_norms(_np_tree(mod.init(jax.random.key(0), *_j(feat, var), s)), rng)
    p = v["params"]
    joined = {"kernel": np.concatenate([p["kernel_var"], p["kernel_feat"]], 1),
              "dir_kernel": np.concatenate([p["dir_kernel_var"], p["dir_kernel_feat"]], 1),
              "batchnorm": p["batchnorm"]}
    layer = port_pcn._PairFoldLayer(1 + cf, out, layout="plane").train(train)
    layer.load_state_dict(_sub_sd(interop._vnllr, joined, v["batch_stats"]))
    layer.use_kernels = port_path == "kernels"
    return mod, v, layer, feat, var, s


@pytest.mark.parametrize("port_path", ["kernels", "plain"])
@pytest.mark.parametrize("jax_cls", ["fused", "split"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pair_fold_layer_matches_jax(train, jax_cls, port_path):
    """The port's pair fold (kernel B with group=S and kernel S for the
    train-mode moments, or the expanded bias and kernel A) against JAX's
    fused layer (Pallas, interpret mode) and its split layer: output within
    1e-5 of its max, the running statistics rtol 1e-5; in train mode the
    gradients of the layer's weights and of the centre feature within 1e-4
    of each tensor's max against JAX's autodiff."""
    mod, v, layer, feat, var, s = _pair_fold_case(train, jax_cls, port_path)
    if train:
        want, mut = mod.apply(v, *_j(feat, var), s, train=True, mutable=["batch_stats"])
    else:
        want = mod.apply(v, *_j(feat, var), s, train=False)
    ft = torch.from_numpy(feat).requires_grad_()
    got = layer(ft, torch.from_numpy(var), s)
    _assert_rel([got], [want], 1e-5)
    if not train:
        return
    new = mut["batch_stats"]["batchnorm"]["BatchNorm_0"]
    np.testing.assert_allclose(layer.batchnorm.bn.running_mean.numpy(), new["mean"], rtol=1e-5)
    np.testing.assert_allclose(layer.batchnorm.bn.running_var.numpy(), new["var"], rtol=1e-5)

    def jax_loss(params, f):
        o, _ = mod.apply({"params": params, "batch_stats": v["batch_stats"]}, f,
                         jnp.asarray(var), s, train=True, mutable=["batch_stats"])
        return jnp.sum(o * o)

    gp, gf = jax.grad(jax_loss, argnums=(0, 1))(v["params"], jnp.asarray(feat))
    (got * got).sum().backward()
    w_grad = np.concatenate([gp["kernel_var"], gp["kernel_feat"]], 1)
    d_grad = np.concatenate([gp["dir_kernel_var"], gp["dir_kernel_feat"]], 1)
    _assert_rel([layer.map_to_feat.weight.grad, layer.map_to_dir.weight.grad, ft.grad],
                [w_grad, d_grad, gf], 1e-4)


# ------------------------------------------------------- the VN layer zoo


def test_vn_layer_norm_matches_jax():
    from vn_pointcloudcompletion_tpu.nn.vn import VNLayerNorm

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 3, 50)).astype(np.float32)
    x[:, :3, :, :4] = 0.0  # exact zero vectors
    mod = VNLayerNorm()
    v = _randomize_norms(_np_tree(mod.init(jax.random.key(0), jnp.asarray(x))), rng)
    port = port_vn.VNLayerNorm(24)
    ln = v["params"]["LayerNorm_0"]
    port.load_state_dict({"layer_norm.weight": torch.from_numpy(ln["scale"]),
                          "layer_norm.bias": torch.from_numpy(ln["bias"])})
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _assert_rel([got], [mod.apply(v, jnp.asarray(x))], 1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 3, 40), (2, 16, 3, 12, 8)], ids=["4d", "5d"])
def test_vn_maxpool_vec_matches_jax(shape):
    """The vec layout, rank-generic: the same picks (equal outputs), and the
    first point on ties (a repeated maximum)."""
    from vn_pointcloudcompletion_tpu.nn.vn import VNMaxPool

    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 5] = x[..., 2]  # ties: both sides keep index 2 if it wins
    mod = VNMaxPool()
    v = _np_tree(mod.init(jax.random.key(1), jnp.asarray(x)))
    port = port_vn.VNMaxPool(16, layout="vec")
    port.map_to_dir.weight.data = torch.from_numpy(v["params"]["dir_kernel"])
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(mod.apply(v, jnp.asarray(x))))
    got.sum().backward()  # the gradient reaches the selected vectors only
    picked = (xt.grad != 0).any(2)  # (B, C, ..., L)
    assert torch.all(picked.sum(-1) == 1)


def test_mean_pool_and_vn_graph_feature_match_jax():
    from vn_pointcloudcompletion_tpu.nn.vn import mean_pool
    from vn_pointcloudcompletion_tpu.ops.knn import knn, vn_graph_feature as jax_graph

    rng = np.random.default_rng(3)
    xq = rng.standard_normal((2, 8, 3, 30)).astype(np.float32)
    xk = rng.standard_normal((2, 8, 3, 40)).astype(np.float32)
    _, idx = knn(jnp.asarray(xq.reshape(2, 24, 30).transpose(0, 2, 1)),
                 jnp.asarray(xk.reshape(2, 24, 40).transpose(0, 2, 1)), 5)
    idx = np.asarray(idx)
    want = np.asarray(jax_graph(*_j(xq, xk, idx)))
    got = vn_graph_feature(*_t(xq, xk, idx)).numpy()
    assert got.shape == (2, 16, 3, 30, 5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(port_vn.mean_pool(torch.from_numpy(got)).numpy(),
                               np.asarray(mean_pool(jnp.asarray(want))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("normalize_frame", [False, True])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_vn_std_feature_matches_jax(normalize_frame, train):
    from vn_pointcloudcompletion_tpu.nn.vn import VNStdFeature

    rng = np.random.default_rng(4 + normalize_frame)
    x = rng.standard_normal((2, 16, 3, 30)).astype(np.float32)
    mod = VNStdFeature(normalize_frame=normalize_frame)
    v = _randomize_norms(_np_tree(mod.init(jax.random.key(2), jnp.asarray(x))), rng)
    if train:
        want, _ = mod.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = mod.apply(v, jnp.asarray(x))
    port = port_vn.VNStdFeature(16, normalize_frame=normalize_frame).train(train)
    p, s = v["params"], v["batch_stats"]
    sd = {f"vn1.{k}": t for k, t in _sub_sd(interop._vnllr, p["vn1"], s["vn1"]).items()}
    sd.update({f"vn2.{k}": t for k, t in _sub_sd(interop._vnllr, p["vn2"], s["vn2"]).items()})
    sd["vn_lin.weight"] = torch.from_numpy(p["frame_kernel"])
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got[0].shape == (2, 16, 3, 30) and got[1].shape == (2, 3, 3, 30)
    # normalising the frame divides by its vectors' norms: 1e-4 there
    _assert_rel(got, want, 1e-4 if normalize_frame else 1e-5)


@pytest.mark.parametrize("qk_scale", [None, 1.0])
def test_vn_attention_matches_jax(qk_scale):
    """The head split, the scale, the float32 softmax and the return layout,
    on 96 vector channels into 4 heads of 24."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 3, 20)).astype(np.float32) * 0.5
    from vn_pointcloudcompletion_tpu.nn.attention import VNAttention

    mod = VNAttention(96, 32, num_heads=4, qk_scale=qk_scale)
    v = _np_tree(mod.init(jax.random.key(3), jnp.asarray(x)))
    port = port_attn.VNAttention(32, 96, 32, num_heads=4, qk_scale=qk_scale)
    port.load_state_dict({f"{k}.map_to_feat.weight": torch.from_numpy(p["kernel"])
                          for k, p in v["params"].items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _assert_rel([got], [mod.apply(v, jnp.asarray(x))], 1e-5)


def test_layout_conversions_match_jax():
    from vn_pointcloudcompletion_tpu.nn.attention import to_scalar, to_vn

    x = np.arange(2 * 7 * 12, dtype=np.float32).reshape(2, 7, 12)
    np.testing.assert_array_equal(port_attn.to_vn(torch.from_numpy(x)).numpy(),
                                  np.asarray(to_vn(jnp.asarray(x))))
    y = np.asarray(to_vn(jnp.asarray(x)))
    np.testing.assert_array_equal(port_attn.to_scalar(torch.from_numpy(y)).numpy(), x)
    np.testing.assert_array_equal(np.asarray(to_scalar(jnp.asarray(y))), x)


def _block_sd(p, s):
    return _sub_sd(interop._vn_block, p, s)


@pytest.mark.parametrize("with_knn", [False, True], ids=["plain", "knn"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_vn_block_matches_jax(with_knn, train):
    """A VNBlock (32 channels, attention over 96, 4 heads), with the kNN
    branch on a k=8 graph when ``knn_idx`` is given: output within 1e-5 of
    its max in eval mode, 1e-4 in train mode (the batch variance of the
    norms is a float32 difference of two sums), the running statistics
    rtol 1e-5."""
    from vn_pointcloudcompletion_tpu.nn.attention import VNBlock
    from vn_pointcloudcompletion_tpu.ops.knn import knn

    rng = np.random.default_rng(6 + with_knn)
    x = rng.standard_normal((2, 32, 3, 40)).astype(np.float32) * 0.5
    pts = _cloud(6, n=40)
    idx = np.asarray(knn(jnp.asarray(pts), jnp.asarray(pts), 8)[1]) if with_knn else None
    mod = VNBlock(32, 96, num_heads=4)
    v = _randomize_norms(_np_tree(mod.init(jax.random.key(4), jnp.asarray(x),
                                           None if idx is None else jnp.asarray(idx))), rng)
    args = (jnp.asarray(x), None if idx is None else jnp.asarray(idx))
    if train:
        want, mut = mod.apply(v, *args, train=True, mutable=["batch_stats"])
    else:
        want = mod.apply(v, *args)
    port = port_attn.VNBlock(32, 96, num_heads=4, with_knn=with_knn).train(train)
    port.load_state_dict(_block_sd(v["params"], v["batch_stats"]), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), None if idx is None else torch.from_numpy(idx))
    _assert_rel([got], [want], 1e-4 if train else 1e-5)
    if train:
        new = _block_sd(v["params"], mut["batch_stats"])
        for k, b in port.named_buffers():
            np.testing.assert_allclose(b.numpy(), new[k].numpy(), rtol=1e-5, err_msg=k)


# ------------------------------------------------------- the models


_MODELS = {}


def _jax_init(key, make, *args):
    """JAX variables of ``make()`` (jitted init, norms randomised), cached."""
    if key not in _MODELS:
        mod = make()
        v = jax.jit(lambda k, *a: mod.init(k, *a, train=False))(jax.random.key(0), *args)
        v = {k: _randomize_norms(_np_tree(dict(v[k])), np.random.default_rng(len(key)))
             for k in v}
        _MODELS[key] = (mod, v)
    return _MODELS[key]


def _encoder_case():
    from vn_pointcloudcompletion_tpu.models.pointr import VNPCTransformer as JaxEnc

    xyz = _cloud(60)
    mod, v = _jax_init(("enc",), lambda: JaxEnc(enc_depth=2), jnp.asarray(xyz))
    sd = {}
    interop._vn_pointr(sd, v["params"], v["batch_stats"])
    enc = VNPCTransformer(enc_depth=2)
    enc.load_state_dict({k[len("encoder."):]: torch.from_numpy(np.array(t))
                         for k, t in sd.items()}, strict=True)
    return mod, v, enc, xyz


def test_vn_pctransformer_matches_jax(monkeypatch):
    """Eval forward in float64 (enc_depth 2): the 224 predicted points, the
    448 with the FPS tail and the (B, 1024, 3, 1) global feature within
    2e-6 of each one's max."""
    mod, v, enc, xyz = _encoder_case()
    with _X64(monkeypatch):
        (jc, jcat), jg = _apply(mod, _f64(v), jnp.asarray(xyz, jnp.float64))
        want = [np.asarray(t) for t in (jc, jcat, jg)]
    with torch.no_grad():
        (c, cat), g = enc.double().eval()(torch.from_numpy(xyz.astype(np.float64)))
    assert c.shape == (2, 224, 3) and cat.shape == (2, 448, 3) and g.shape == (2, 1024, 3, 1)
    _assert_rel([c, cat, g], want, TOL)


def _decoder_case(nc):
    from vn_pointcloudcompletion_tpu.models.pcn import AttentionVNFoldingNet as JaxDec

    rng = np.random.default_rng(nc)
    n = 224 if nc == 448 else nc
    coarse = (rng.standard_normal((2, n, 3)) * 0.3).astype(np.float32)
    fg = (rng.standard_normal((2, 64, 3, 1)) * 0.3).astype(np.float32)
    mod, v = _jax_init(("dec", nc), lambda: JaxDec(nc), *_j(coarse, fg))
    sd = {}
    interop._attention_vn_foldingnet(sd, v["params"], v["batch_stats"])
    dec = port_pcn.AttentionVNFoldingNet(nc, 64)
    dec.load_state_dict({k[len("decoder."):]: torch.from_numpy(np.array(t))
                         for k, t in sd.items()}, strict=True)
    return mod, v, dec, coarse, fg


@pytest.mark.parametrize("nc", [32, 448], ids=["32x16", "224x64"])
def test_attention_decoder_matches_jax(nc, monkeypatch):
    """Eval forward in float64: 32 centres (num_coarse 32, grid 4) and 224
    centres (num_coarse 448, grid 8: 14336 points, the pair folds through
    kernel B's group mode); dense cloud within 2e-6 of its max."""
    mod, v, dec, coarse, fg = _decoder_case(nc)
    with _X64(monkeypatch):
        want = _apply(mod, _f64(v), *_j(coarse.astype(np.float64), fg.astype(np.float64)))
    with torch.no_grad():
        got = dec.double().eval()(*_t(coarse.astype(np.float64), fg.astype(np.float64)))
    n_dense = 14336 if nc == 448 else nc * 16
    assert got.shape == (2, n_dense, 3)
    _assert_rel([got], [want], TOL)


_PIPELINE = {}


def _pipeline():
    """The whole pipeline at num_coarse 448 (enc_depth 6), batch 1."""
    from vn_pointcloudcompletion_tpu.models.composer import PCNNet as JaxPCNNet

    if not _PIPELINE:
        xyz = _cloud(61, b=1)
        jm = JaxPCNNet("vn_pointr", "attention_vn_foldingnet", 448)
        v = jax.jit(lambda k, x: jm.init(k, x, None, train=False))(jax.random.key(0),
                                                                   jnp.asarray(xyz))
        v = _np_tree(v)
        model = PCNNet("vn_pointr", "attention_vn_foldingnet", 448).eval()
        model.load_state_dict(state_dict_from_jax_variables(v), strict=True)
        _PIPELINE.update(jm=jm, v=v, model=model, xyz=xyz)
    return _PIPELINE


def test_pipeline_matches_jax(monkeypatch):
    """The whole eval forward at num_coarse 448, batch 1, in float64: (448,
    3) coarse and (14336, 3) dense points within TOL of each one's max.  (In
    float32 the two sides part further than rounding: the noise that
    VNLayerNorm carries up (module docstring) can make the global VNMaxPool
    pick another point in a channel whose top two scores lie close, and
    every output moves.)"""
    p = _pipeline()
    xyz = p["xyz"].astype(np.float64)
    with _X64(monkeypatch):
        jc, jf = _apply(p["jm"], _f64(p["v"]), jnp.asarray(xyz), None)
        want = [np.asarray(jc), np.asarray(jf)]
    model = PCNNet("vn_pointr", "attention_vn_foldingnet", 448).double().eval()
    model.load_state_dict(p["model"].state_dict())
    with torch.no_grad():
        got = model(torch.from_numpy(xyz))
    assert got[0].shape == (1, 448, 3) and got[1].shape == (1, 14336, 3)
    _assert_rel(got, want, TOL)


def _grads_within(got: dict, want: dict, rel=1e-7):
    assert set(got) == set(want), set(got) ^ set(want)
    for name, g in got.items():
        w = want[name].numpy()
        assert np.abs(g.numpy() - w).max() <= rel * np.abs(w).max() + 1e-14, name


def test_encoder_train_step_matches_jax_float64(monkeypatch):
    """A train-mode step of the encoder (enc_depth 2) in float64 against JAX
    with x64: the loss is the chamfer L1 of the 448 coarse points to a
    complete cloud plus a fixed cotangent of the global feature; every
    gradient within 1e-7 of its tensor's max, the running statistics rtol
    1e-9."""
    from vn_pointcloudcompletion_tpu.metrics import losses as jax_losses

    from vn_pointcloudcompletion_tpu_torch.metrics import losses as port_losses

    mod, v, enc, xyz = _encoder_case()
    complete = _cloud(22, n=512).astype(np.float64)
    cot = np.random.default_rng(9).standard_normal((2, 1024, 3, 1))
    with _X64(monkeypatch):
        v64 = _f64(v)

        def jax_loss(params):
            ((_, cat), g), mut = mod.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                           jnp.asarray(xyz, jnp.float64), train=True,
                                           mutable=["batch_stats"])
            return jax_losses.cd_loss_l1(cat, jnp.asarray(complete)) + jnp.sum(g * cot), mut

        (jl, mut), jg = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(v64["params"])
        jg, mut = _np_tree(jg), _np_tree(mut)
    enc = enc.double().train()
    (_, cat), g = enc(torch.from_numpy(xyz.astype(np.float64)))
    loss = (port_losses.cd_loss_l1(cat, torch.from_numpy(complete))
            + (g * torch.from_numpy(cot)).sum())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-9)
    want, stats = {}, {}
    zero = jax.tree.map(np.zeros_like, v["batch_stats"])
    interop._vn_pointr(want, jg, zero)
    interop._vn_pointr(stats, v["params"], mut["batch_stats"])
    got = {f"encoder.{k}": p.grad for k, p in enc.named_parameters() if p.grad is not None}
    no_grad = {k for k, p in enc.named_parameters() if p.grad is None}
    assert no_grad == {"vn_global_pool.map_to_dir.weight"}  # it feeds only an argmax
    _grads_within(got, {k: torch.from_numpy(np.array(t)) for k, t in want.items()
                        if "running" not in k and k != "encoder.vn_global_pool.map_to_dir.weight"})
    for k, b in enc.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[f"encoder.{k}"], rtol=1e-9, atol=1e-12,
                                   err_msg=k)


def test_decoder_train_step_matches_jax_float64(monkeypatch):
    """A train-mode step of the attention decoder at num_coarse 448 (224
    centres, the pair folds through the group=S path, kernel C's plain
    version after them) in float64 against JAX with x64: the chamfer L1 of
    the dense cloud to a complete cloud; every gradient (and those of the
    decoder's two inputs) within 1e-7 of its tensor's max, the running
    statistics rtol 1e-9."""
    from vn_pointcloudcompletion_tpu.metrics import losses as jax_losses

    from vn_pointcloudcompletion_tpu_torch.metrics import losses as port_losses

    mod, v, dec, coarse, fg = _decoder_case(448)
    coarse, fg = coarse[:1].astype(np.float64), fg[:1].astype(np.float64)
    complete = _cloud(23, b=1, n=2048).astype(np.float64)
    with _X64(monkeypatch):
        v64 = _f64(v)

        def jax_loss(params, c, f):
            fine, mut = mod.apply({"params": params, "batch_stats": v64["batch_stats"]}, c, f,
                                  train=True, mutable=["batch_stats"])
            return jax_losses.cd_loss_l1(fine, jnp.asarray(complete)), mut

        (jl, mut), jg = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True))(
            v64["params"], *_j(coarse, fg))
        jg, mut = _np_tree(jg), _np_tree(mut)
    dec = dec.double().train()
    c, f = (t.requires_grad_() for t in _t(coarse, fg))
    loss = port_losses.cd_loss_l1(dec(c, f), torch.from_numpy(complete))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-9)
    want, stats = {}, {}
    interop._attention_vn_foldingnet(want, jg[0], jax.tree.map(np.zeros_like, v["batch_stats"]))
    interop._attention_vn_foldingnet(stats, v["params"], mut["batch_stats"])
    got = {f"decoder.{k}": p.grad for k, p in dec.named_parameters()}
    want = {k: torch.from_numpy(np.array(t)) for k, t in want.items() if "running" not in k}
    got.update(coarse=c.grad, feature_global=f.grad)
    want.update(coarse=torch.from_numpy(jg[1]), feature_global=torch.from_numpy(jg[2]))
    _grads_within(got, want)
    for k, b in dec.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[f"decoder.{k}"], rtol=1e-9, atol=1e-12,
                                   err_msg=k)


def _rel_errs(got: dict, want: dict) -> dict:
    """Per tensor of ``got``, max |got - want| / max |want|."""
    return {k: float((g - want[k]).abs().max() / want[k].abs().max()) for k, g in got.items()}


def test_float32_step_as_sensitive_as_jax():
    """The whole pipeline's float32 train-mode step (the coarse and dense
    chamfer L1, batch 2, the encoder re-initialised as the JAX trainer does)
    moves by O(1) for one ulp of input in the JAX package as in the port:
    each JAX gradient by at least 0.1 of its tensor's max (measured 0.63 at
    least, 1.34 the median), the loss by 9.4e-3, the running statistics by
    0.54 of their max.  The port's float32 step lies within 4x that spread
    of JAX's: the loss (measured 0.85x), the running statistics (0.91x) and
    each gradient (2.01x); and each of its gradients within 4x JAX's
    distance from float64 (1.77x; the float64 reference is the port's plain
    path, equal to JAX's within 1e-7 by the float64 tests above).  Bounds
    this wide catch a gross fault only; the float64 tests hold the function.
    What this shows is that the spread of a float32 step is the reference's
    own, so no float32 comparison of whole steps can be tighter."""
    from vn_pointcloudcompletion_tpu.metrics import losses as jax_losses
    from vn_pointcloudcompletion_tpu.models.pointr import reinit_pointr_params

    from vn_pointcloudcompletion_tpu_torch.metrics import losses as port_losses

    p = _pipeline()
    jm = p["jm"]
    params = dict(p["v"]["params"])
    params["encoder"] = _np_tree(reinit_pointr_params(params["encoder"], jax.random.key(5)))
    v = {"params": params, "batch_stats": p["v"]["batch_stats"]}
    xyz, complete = _cloud(62), _cloud(63, n=2048)
    nudged = np.nextafter(xyz, np.float32(np.inf))

    def jax_loss(params, x):
        (c, f), mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x, None,
                               train=True, mutable=["batch_stats"])
        cj = jnp.asarray(complete)
        return jax_losses.cd_loss_l1(c, cj) + jax_losses.cd_loss_l1(f, cj), mut

    step = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))
    zero = jax.tree.map(np.zeros_like, v["batch_stats"])
    jax_runs = []
    for x in (xyz, nudged):
        (loss, mut), grads = step(params, jnp.asarray(x))
        mut = _np_tree(mut)
        jax_runs.append((float(loss), {
            k: t.double() for k, t in state_dict_from_jax_variables(
                {"params": _np_tree(grads), "batch_stats": zero}).items()}, {
            k: t.double() for k, t in state_dict_from_jax_variables(
                {"params": params, "batch_stats": mut["batch_stats"]}).items()}))

    def port_step(dtype):
        model = PCNNet("vn_pointr", "attention_vn_foldingnet", 448)
        model.load_state_dict(state_dict_from_jax_variables(v), strict=True)
        model = model.to(dtype).train()
        c, f = model(torch.from_numpy(xyz).to(dtype))
        ct = torch.from_numpy(complete).to(dtype)
        loss = port_losses.cd_loss_l1(c, ct) + port_losses.cd_loss_l1(f, ct)
        loss.backward()
        return (loss.item(), {k: t.grad.double() for k, t in model.named_parameters()
                              if t.grad is not None},
                {k: b.double() for k, b in model.named_buffers()})

    (lj, gj, bj), (lc, gc, bc) = jax_runs
    lp, gp, bp = port_step(torch.float32)
    l64, g64, _ = port_step(torch.float64)
    keys = sorted(gp)  # every gradient but the global pool's direction map
    assert len(keys) == 186 and all(gj[k].abs().max() > 0 for k in keys)
    spread = _rel_errs({k: gc[k] for k in keys}, gj)
    assert min(spread.values()) >= 0.1, min(spread.values())
    assert abs(lc - lj) >= 1e-3 * lj
    gap = _rel_errs(gp, gj)
    assert all(gap[k] <= 4 * spread[k] for k in keys), max(gap[k] / spread[k] for k in keys)
    assert abs(lp - lj) <= 4 * abs(lc - lj)
    assert max(_rel_errs(bp, bj).values()) <= 4 * max(
        _rel_errs({k: bc[k] for k in bp}, bj).values())
    port64, jax64 = _rel_errs(gp, g64), _rel_errs({k: gj[k] for k in keys}, g64)
    assert all(port64[k] <= 4 * jax64[k] for k in keys), max(port64[k] / jax64[k] for k in keys)
    assert np.isfinite(l64)


# ------------------------------------------------- weights and the CLI


def test_vn_pointr_weights_map_back_to_jax():
    """The JAX package's ``vn_pointr_from_state_dict`` reads the port's
    ``state_dict`` back into the JAX parameters and statistics it came from,
    for every key that function maps (the scanned tail stacked again)."""
    from vn_pointcloudcompletion_tpu.training.torch_interop import vn_pointr_from_state_dict

    p = _pipeline()
    sd = {k: t.numpy() for k, t in p["model"].state_dict().items()}
    params, stats = vn_pointr_from_state_dict(sd)
    enc_p, enc_s = p["v"]["params"]["encoder"], p["v"]["batch_stats"]["encoder"]

    def same(got, want, path=""):
        if isinstance(got, dict):
            for k in got:
                same(got[k], want[k], f"{path}/{k}")
            return
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)

    same(params, enc_p)
    same(stats, enc_s)
    assert np.asarray(params["encoder_scan"]["block"]["conv3"]["kernel"]).shape[0] == 5


def test_vn_pointr_reinit_distribution():
    """``build_model`` redraws the vn_pointr encoder as the reference's
    ``_init_weights`` does: every channel map trunc_normal(0.02) on +-2 std
    (std 0.02 x 0.8796 after the cut), the norms at scale 1 and bias 0; the
    decoder keeps torch's U(-1/sqrt(fan_in), 1/sqrt(fan_in)); seeded."""
    cfg = Config.from_dict({"enc_type": "vn_pointr", "dec_type": "attention_vn_foldingnet",
                            "num_coarse": 448, "seed": 5})
    model = build_model(cfg)
    ws = [m.weight.detach() for m in model.encoder.modules() if isinstance(m, torch.nn.Linear)]
    flat = torch.cat([w.reshape(-1) for w in ws])
    assert flat.abs().max() <= 0.04 and flat.numel() > 5e6
    assert abs(flat.std().item() - 0.02 * 0.8796) < 2e-4 and abs(flat.mean().item()) < 2e-4
    for m in model.encoder.modules():
        if isinstance(m, (torch.nn.LayerNorm, port_vn._NormAffine)):
            assert torch.all(m.weight == 1) and torch.all(m.bias == 0)
    w = model.decoder.vn_folding1[1].map_to_feat.weight
    assert w.abs().max() <= 1 / 16 and w.std() > 0.03
    again = build_model(cfg).state_dict()
    assert all(torch.equal(t, again[k]) for k, t in model.state_dict().items())


def test_cli_vn_pointr_train_then_resume_test(tmp_path, monkeypatch):
    """``train`` one epoch (one step, one validation batch) of the root
    config.json's pipeline at full width with ``dtype`` float32, on a tiny
    synthetic set, then ``--resume test``."""
    with open(os.path.join(os.path.dirname(__file__), "..", "config.json")) as f:
        cfg = json.load(f)
    cfg.update(name="ptr", dtype="float32", batch_size=2, dataset="synthetic",
               num_workers=1, synthetic_n_partial=N_POINTS, synthetic_n_complete=512,
               synthetic_train_samples=2, synthetic_val_samples=2,
               synthetic_test_samples=2, log_frequency=1)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "out"))
    summary = cli.main(["-n", "ptr", "-epochs", "0", "--device", "cpu", "train"])
    assert summary["epochs_run"] == 1
    (run,) = os.listdir(tmp_path / "out")
    rows = [json.loads(line) for line in
            (tmp_path / "out" / run / "metrics.jsonl").read_text().splitlines()]
    assert rows and all(np.isfinite(r["value"]) for r in rows)
    res = cli.main(["-n", run, "--resume", "--device", "cpu", "test"])
    row = res["synthetic"]
    assert all(np.isfinite(x) for x in row.values()) and 0 < row["iou"] <= 1
