"""vn_pointr's decoder stack (``pointr_decoder``) and the scalar PoinTr
branches of the port against the JAX package on the CPU.

- ``CrossAttention``, ``VNDecoderBlock`` (with and without the kNN
  branches, eval and train), ``Mlp``, ``ScalarAttention``, ``Block`` (with
  and without ``knn_idx``), ``DecoderBlock``, ``scalar_graph_feature``,
  ``pos_encoding_sin_wave`` and ``DGCNNGrouper``;
- ``VNPCTransformer(only_coarse=False)`` at ``enc_depth`` 2 and
  ``dec_depth`` 2 in all four ``dgcnn`` x ``trans`` arms, the refined
  queries included;
- the whole ``pointr_decoder`` model (vn_pointr_448 with the eight-block
  stack) through ``build_model``'s construction: the float64 eval forward,
  a float64 train step's gradients and running statistics, the bf16 eval
  forward against JAX's own bf16-vs-float32 spread;
- the weights both ways, the pretrained-encoder load into a
  ``pointr_decoder`` model, the init's distribution, and the CLI
  (``train``, ``--resume train``, ``test``); ``build_model``'s refusals
  are ``tests/test_torch_port_model.py::test_unported_configs_raise``.

Everything is compared in float64 (JAX with x64, its attention softmax
read as float64: ``tests/test_torch_port_pointr.py::_X64``) but the bf16
forward, with weights from JAX ``init`` carried across by
``training/interop.py``.
Inputs come from numpy seeds; clouds have 600 points, so FPS goes 600 ->
512 -> 128 as at full width.  The kNN and FPS picks are float32 in JAX;
the inputs keep wide gaps.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_bf16 import _cd_l1, _jax_apply
from tests.test_torch_port_dgcnn import _assert_knn_gap
from tests.test_torch_port_pointr import (
    N_POINTS,
    TOL,
    _X64,
    _apply,
    _assert_rel,
    _cloud,
    _f64,
    _grads_within,
    _np_tree,
    _randomize_norms,
    _t,
)
from vn_pointcloudcompletion_tpu_torch import __main__ as cli
from vn_pointcloudcompletion_tpu_torch.models import pcn as port_pcn
from vn_pointcloudcompletion_tpu_torch.models import pointr as port_pointr
from vn_pointcloudcompletion_tpu_torch.models.composer import PCNNet, build_model
from vn_pointcloudcompletion_tpu_torch.models.dgcnn import DGCNNfps
from vn_pointcloudcompletion_tpu_torch.nn import attention as port_attn
from vn_pointcloudcompletion_tpu_torch.nn import precision
from vn_pointcloudcompletion_tpu_torch.training import interop
from vn_pointcloudcompletion_tpu_torch.training.checkpoint import load_pretrained_encoder
from vn_pointcloudcompletion_tpu_torch.utils.config import Config

torch.set_num_threads(2)


def _sd(fill, p, s=None):
    """A port submodule's state_dict from a JAX subtree through the interop
    helper ``fill(sd, key, p[, s])``."""
    sd = {}
    if s is None:
        fill(sd, "m", p)
    else:
        fill(sd, "m", p, s)
    return {k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _x64_case(monkeypatch, mod, v, port, args, jax_kw=None, port_train=False):
    """JAX's apply in float64 (x64, ``_X64``) against the port module's
    forward in float64 on the same numpy ``args`` (None passes through;
    integer arrays stay integer): (port outputs, JAX outputs[, JAX's new
    batch statistics])."""
    def f64(a):
        return a if a is None or a.dtype.kind == "i" else a.astype(np.float64)

    args = [f64(a) for a in args]
    jax_kw = jax_kw or {}
    with _X64(monkeypatch):
        out = _apply(mod, _f64(v), *[None if a is None else jnp.asarray(a) for a in args],
                     **jax_kw)
        out = jax.tree.map(np.asarray, out)
    with torch.no_grad():
        got = port.double().train(port_train)(*_t(*args))
    return got, out


def _randomize_biases(tree, rng):
    """Every dense map's bias (a ``bias`` beside a ``kernel``) drawn
    N(0, 0.2), so that the biases' placement is exercised."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _randomize_biases(v, rng) for k, v in tree.items()}
    if {"kernel", "bias"} <= set(out):
        out["bias"] = rng.normal(0, 0.2, out["bias"].shape).astype(np.float32)
    return out


def _knn_idx(q, r, k=8):
    from vn_pointcloudcompletion_tpu.ops.knn import knn

    return np.asarray(knn(jnp.asarray(q), jnp.asarray(r), k)[1])


# ------------------------------------------------------------ the blocks


def test_cross_attention_matches_jax(monkeypatch):
    """48 channels into 4 heads, 20 queries over 12 keys; JAX's Dense
    kernels (in, out) transposed into the torch maps."""
    from vn_pointcloudcompletion_tpu.nn.attention import CrossAttention

    rng = np.random.default_rng(1)
    q, v = rng.standard_normal((2, 20, 48)), rng.standard_normal((2, 12, 48))
    mod = CrossAttention(48, 48, num_heads=4)
    var = _randomize_biases(_np_tree(mod.init(jax.random.key(1), *map(jnp.asarray, (q, v)))),
                            rng)
    port = port_attn.CrossAttention(48, 48, num_heads=4)
    port.load_state_dict(_sd(interop._cross_attention, var["params"]), strict=True)
    got, want = _x64_case(monkeypatch, mod, var, port, (q, v))
    assert got.shape == (2, 20, 48)
    _assert_rel([got], [want], TOL)


def _decoder_block_inputs(seed, c=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 24, 3 * c)).astype(np.float32) * 0.5
    v = rng.standard_normal((2, 20, 3 * c)).astype(np.float32) * 0.5
    pq, pv = _cloud(seed, n=24), _cloud(seed + 1, n=20)
    return rng, q, v, _knn_idx(pq, pq), _knn_idx(pq, pv)


@pytest.mark.parametrize("with_knn", [False, True], ids=["plain", "knn"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_vn_decoder_block_matches_jax(with_knn, train, monkeypatch):
    """A VNDecoderBlock (16 vector channels, attention over 48, 4 heads) on
    24 queries against 20 tokens, with the self and cross k=8 graphs when
    ``with_knn``: output within TOL of its max in float64, the running
    statistics of conv1 and conv3 rtol 1e-9 in train mode."""
    from vn_pointcloudcompletion_tpu.nn.attention import VNDecoderBlock

    rng, q, v, self_idx, cross_idx = _decoder_block_inputs(3 + with_knn)
    idx = (self_idx, cross_idx) if with_knn else (None, None)
    mod = VNDecoderBlock(16, 48, num_heads=4)
    var = _randomize_norms(_np_tree(mod.init(
        jax.random.key(2), jnp.asarray(q), jnp.asarray(v),
        *[None if i is None else jnp.asarray(i) for i in idx])), rng)
    port = port_attn.VNDecoderBlock(16, 48, num_heads=4, with_knn=with_knn)
    stats = var.get("batch_stats", {})
    port.load_state_dict(_sd(interop._vn_decoder_block, var["params"], stats), strict=True)
    kw = {"train": True, "mutable": ["batch_stats"]} if train else {}
    got, want = _x64_case(monkeypatch, mod, var, port, (q, v) + idx, kw, port_train=train)
    if train:
        want, mut = want
    assert got.shape == (2, 24, 48)
    _assert_rel([got], [want], TOL)
    if train and with_knn:
        new = _sd(interop._vn_decoder_block, var["params"], mut["batch_stats"])
        for k, b in port.named_buffers():
            np.testing.assert_allclose(b.numpy(), new[k].numpy(), rtol=1e-9, err_msg=k)


def _scalar_module(name):
    """(JAX module, port module) of a scalar block case, at 48 channels
    and 4 heads."""
    from vn_pointcloudcompletion_tpu.nn import attention as jax_attn

    if name == "mlp":
        return jax_attn.Mlp(96, 48), port_attn.Mlp(48, 96, 48)
    if name == "scalar_attention":
        return jax_attn.ScalarAttention(48, 4), port_attn.ScalarAttention(48, 4)
    if name.startswith("block"):
        return (jax_attn.Block(48, 4),
                port_attn.Block(48, 4, with_knn=name.endswith("knn")))
    return (jax_attn.DecoderBlock(48, 4),
            port_attn.DecoderBlock(48, 4, with_knn=name.endswith("knn")))


def _fill_scalar(name):
    def fill(sd, key, p):
        if name == "mlp":
            interop._dense(sd, f"{key}.fc1", p["Dense_0"])
            interop._dense(sd, f"{key}.fc2", p["Dense_1"])
        elif name == "scalar_attention":
            interop._dense(sd, f"{key}.qkv", p["qkv"])
            interop._dense(sd, f"{key}.proj", p["proj"])
        else:
            interop._scalar_block(sd, key, p)
    return fill


@pytest.mark.parametrize("name", ["mlp", "scalar_attention", "block", "block_knn",
                                  "decoder_block", "decoder_block_knn"])
def test_scalar_blocks_match_jax(name, monkeypatch):
    """The scalar PoinTr blocks on 24 tokens of 48 channels (the decoder
    blocks against 20 tokens; with ``_knn`` the k=8 graphs): output within
    TOL of its max in float64, norms and biases randomised."""
    rng, q, v, self_idx, cross_idx = _decoder_block_inputs(7)
    args = {"mlp": (q,), "scalar_attention": (q,), "block": (q,), "block_knn": (q, self_idx),
            "decoder_block": (q, v),
            "decoder_block_knn": (q, v, self_idx, cross_idx)}[name]
    mod, port = _scalar_module(name)
    var = _randomize_biases(_randomize_norms(
        _np_tree(mod.init(jax.random.key(3), *map(jnp.asarray, args))), rng), rng)
    port.load_state_dict(_sd(_fill_scalar(name), var["params"]), strict=True)
    got, want = _x64_case(monkeypatch, mod, var, port, args)
    assert got.shape == (2, 24, 48)
    _assert_rel([got], [want], TOL)


@pytest.mark.parametrize("centres", [False, True], ids=["self", "cross"])
def test_scalar_graph_feature_matches_jax(centres, monkeypatch):
    from vn_pointcloudcompletion_tpu.nn.attention import scalar_graph_feature

    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 20, 12))
    x_q = rng.standard_normal((2, 24, 12)) if centres else None
    idx = rng.integers(0, 20, (2, 24 if centres else 20, 8)).astype(np.int32)
    with _X64(monkeypatch):
        want = np.asarray(scalar_graph_feature(
            jnp.asarray(x), jnp.asarray(idx), None if x_q is None else jnp.asarray(x_q)))
    got = port_attn.scalar_graph_feature(*_t(x, idx, x_q))
    assert got.shape == want.shape == (2, idx.shape[1], 8, 24)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pos_encoding_sin_wave_matches_jax(monkeypatch):
    """The default 64 frequencies (pi 2^i in float32, as JAX's) of a
    (2, 3, 50) cloud normalised by its min and max, in float64."""
    from vn_pointcloudcompletion_tpu.models.pointr import pos_encoding_sin_wave

    coor = _cloud(9, n=50).transpose(0, 2, 1).astype(np.float64)
    with _X64(monkeypatch):
        want = np.asarray(pos_encoding_sin_wave(jnp.asarray(coor)))
    got = port_pointr.pos_encoding_sin_wave(torch.from_numpy(coor))
    assert got.shape == (2, 384, 50) and got.dtype == torch.float64
    _assert_rel([got], [want], TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dgcnn_grouper_matches_jax(train, monkeypatch):
    """``DGCNNGrouper`` (the trunk ``DGCNNfps`` shares, its keys) against
    JAX's scalar trunk at 600 points: the 128 centres and their features
    within TOL in float64."""
    from vn_pointcloudcompletion_tpu.models.pointr import DGCNNGrouper

    xyz = _cloud(60)
    _assert_knn_gap(xyz)
    mod = DGCNNGrouper()
    var = _randomize_norms(_np_tree(mod.init(jax.random.key(4), jnp.asarray(xyz))),
                           np.random.default_rng(4))
    port = port_pointr.DGCNNGrouper()
    port.load_state_dict(_sd(interop._scalar_trunk, var["params"]), strict=True)
    assert set(port.state_dict()) < set(DGCNNfps(448).state_dict())
    got, want = _x64_case(monkeypatch, mod, var, port, (xyz,), {"train": train},
                          port_train=train)
    assert got[0].shape == (2, 3, 128) and got[1].shape == (2, 128, 128)
    _assert_rel(got, want, TOL)


# ------------------------------------------------------- the transformer


_ARMS = [("vn_dgcnn", "vn_trans"), ("vn_dgcnn", "trans"), ("dgcnn", "vn_trans"),
         ("dgcnn", "trans")]
_MODELS = {}


def _transformer_case(dgcnn, trans):
    """JAX's and the port's ``VNPCTransformer(only_coarse=False)`` at
    enc_depth 2, dec_depth 2 (one kNN block and one scanned block of each
    stack), norms randomised, weights carried by the interop."""
    from vn_pointcloudcompletion_tpu.models.pointr import VNPCTransformer as JaxEnc

    key = (dgcnn, trans)
    if key not in _MODELS:
        xyz = _cloud(60)
        mod = JaxEnc(enc_depth=2, dec_depth=2, dgcnn=dgcnn, trans=trans, only_coarse=False)
        v = jax.jit(lambda k, x: mod.init(k, x, train=False))(jax.random.key(0),
                                                              jnp.asarray(xyz))
        v = {k: _randomize_norms(_np_tree(dict(v[k])), np.random.default_rng(5)) for k in v}
        sd = {}
        interop._vn_pointr(sd, v["params"], v.get("batch_stats", {}))
        enc = port_pointr.VNPCTransformer(enc_depth=2, dec_depth=2, dgcnn=dgcnn, trans=trans,
                                          only_coarse=False)
        enc.load_state_dict({k[len("encoder."):]: torch.from_numpy(np.array(t))
                             for k, t in sd.items()}, strict=True)
        _MODELS[key] = (mod, v, enc, xyz)
    return _MODELS[key]


@pytest.mark.parametrize("dgcnn,trans", _ARMS)
def test_vn_pctransformer_decoder_matches_jax(dgcnn, trans, monkeypatch):
    """Eval forward in float64: the 224 predicted points, the 448 with the
    FPS tail, the global feature ((B, 1024, 3, 1) VN, (B, 1024) scalar) and
    the refined (B, 224, 384) queries within TOL of each one's max."""
    mod, v, enc, xyz = _transformer_case(dgcnn, trans)
    with _X64(monkeypatch):
        (jc, jcat), (jg, jq) = _apply(mod, _f64(v), jnp.asarray(xyz, jnp.float64))
        want = [np.asarray(t) for t in (jc, jcat, jg, jq)]
    with torch.no_grad():
        (c, cat), (g, q) = enc.double().eval()(torch.from_numpy(xyz.astype(np.float64)))
    glob = (2, 1024, 3, 1) if trans == "vn_trans" else (2, 1024)
    assert c.shape == (2, 224, 3) and cat.shape == (2, 448, 3) and g.shape == glob
    assert q.shape == (2, 224, 384)
    _assert_rel([c, cat, g, q], want, TOL)


# ------------------------------------------------- the whole model


_PIPELINE = {}


def _pipeline():
    """vn_pointr_448 + attention_vn_foldingnet with ``pointr_decoder`` (enc
    6, dec 8 blocks) from ``build_model``, batch 1, JAX init carried
    across."""
    from vn_pointcloudcompletion_tpu.models.composer import PCNNet as JaxPCNNet

    if not _PIPELINE:
        xyz = _cloud(61, b=1)
        jm = JaxPCNNet("vn_pointr", "attention_vn_foldingnet", 448, pointr_decoder=True)
        v = jax.jit(lambda k, x: jm.init(k, x, None, train=False))(jax.random.key(0),
                                                                   jnp.asarray(xyz))
        v = _np_tree(v)
        model = build_model(_decoder_config())
        model.load_state_dict(interop.state_dict_from_jax_variables(v), strict=True)
        _PIPELINE.update(jm=jm, v=v, model=model.eval(), xyz=xyz)
    return _PIPELINE


def test_pointr_decoder_pipeline_matches_jax(monkeypatch):
    """The whole eval forward in float64: (448, 3) coarse and (14336, 3)
    dense points within TOL of each one's max; the model holds the eight
    blocks and ``query_proj``."""
    p = _pipeline()
    assert len(p["model"].encoder.decoder) == 8 and hasattr(p["model"].decoder, "query_proj")
    xyz = p["xyz"].astype(np.float64)
    with _X64(monkeypatch):
        want = [np.asarray(t) for t in _apply(p["jm"], _f64(p["v"]), jnp.asarray(xyz), None)]
    model = PCNNet("vn_pointr", "attention_vn_foldingnet", 448,
                   pointr_decoder=True).double().eval()
    model.load_state_dict(p["model"].state_dict())
    with torch.no_grad():
        got = model(torch.from_numpy(xyz))
    assert got[0].shape == (1, 448, 3) and got[1].shape == (1, 14336, 3)
    _assert_rel(got, want, TOL)


def _losses():
    from vn_pointcloudcompletion_tpu.metrics import losses as jax_losses

    from vn_pointcloudcompletion_tpu_torch.metrics import losses as port_losses

    return jax_losses, port_losses


@pytest.mark.parametrize("dgcnn,trans", [("vn_dgcnn", "vn_trans"), ("dgcnn", "trans")])
def test_transformer_decoder_train_step_matches_jax_float64(dgcnn, trans, monkeypatch):
    """A train-mode step of ``VNPCTransformer(only_coarse=False)`` (enc 2,
    dec 2, batch 2) in float64 against JAX with x64: the loss is the chamfer
    L1 of the 448 coarse points to a complete cloud plus fixed cotangents of
    the global feature and of the refined queries; every gradient within
    1e-7 of its tensor's max (the stack's among them), the running
    statistics rtol 1e-9.  The direction maps of the argmax pools get no
    gradient, on both sides."""
    jax_losses, port_losses = _losses()
    mod, v, enc, xyz = _transformer_case(dgcnn, trans)
    complete = _cloud(22, n=512).astype(np.float64)
    rng = np.random.default_rng(9)
    cot_g = rng.standard_normal((2, 1024, 3, 1) if trans == "vn_trans" else (2, 1024))
    cot_q = rng.standard_normal((2, 224, 384))
    with _X64(monkeypatch):
        v64 = _f64(v)

        def jax_loss(params):
            ((_, cat), (g, q)), mut = mod.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                jnp.asarray(xyz, jnp.float64), train=True, mutable=["batch_stats"])
            return (jax_losses.cd_loss_l1(cat, jnp.asarray(complete)) + jnp.sum(g * cot_g)
                    + jnp.sum(q * cot_q)), mut

        (jl, mut), jg = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(v64["params"])
        jg, mut = _np_tree(jg), _np_tree(mut)
    enc = enc.double().train()
    enc.zero_grad()
    (_, cat), (g, q) = enc(torch.from_numpy(xyz.astype(np.float64)))
    loss = (port_losses.cd_loss_l1(cat, torch.from_numpy(complete))
            + (g * torch.from_numpy(cot_g)).sum() + (q * torch.from_numpy(cot_q)).sum())
    loss.backward()
    enc.eval()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-9)
    want, stats = {}, {}
    interop._vn_pointr(want, jg, jax.tree.map(np.zeros_like, v["batch_stats"]))
    interop._vn_pointr(stats, v["params"], mut["batch_stats"])
    got = {f"encoder.{k}": t.grad for k, t in enc.named_parameters() if t.grad is not None}
    no_grad = {k for k, t in enc.named_parameters() if t.grad is None}
    assert no_grad == {k for k in dict(enc.named_parameters())
                       if "pool" in k and k.endswith("map_to_dir.weight")}
    assert any(k.startswith("encoder.decoder.1.") for k in got)
    # a convolution's bias before a train-mode BatchNorm has no effect: its
    # gradient is 0 but for rounding, on both sides
    for k in [k for k in got if k.endswith(("input_proj.0.bias", "pos_embed.0.bias",
                                            "increase_dim.0.bias"))]:
        scale = got[k.replace("bias", "weight")].abs().max()
        assert got.pop(k).abs().max() <= 1e-9 * scale and abs(want[k]).max() <= 1e-9 * scale
    _grads_within(got, {k: torch.from_numpy(np.array(t)) for k, t in want.items()
                        if k in got})
    for k, b in enc.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[f"encoder.{k}"], rtol=1e-9, atol=1e-12,
                                   err_msg=k)


def test_fold_decoder_query_proj_train_step_matches_jax_float64(monkeypatch):
    """A train-mode step of the attention decoder with ``query_proj`` at
    num_coarse 448 (224 centres, each with a (384,) query from the stack) in
    float64 against JAX with x64: the chamfer L1 of the dense cloud; every
    gradient, ``query_proj``'s and those of the three inputs among them,
    within 1e-7 of its tensor's max, the running statistics rtol 1e-9."""
    from vn_pointcloudcompletion_tpu.models.pcn import AttentionVNFoldingNet as JaxDec

    jax_losses, port_losses = _losses()
    rng = np.random.default_rng(12)
    coarse = rng.standard_normal((1, 224, 3)) * 0.3
    fg = rng.standard_normal((1, 64, 3, 1)) * 0.3
    feats = rng.standard_normal((1, 224, 384)) * 0.3
    complete = _cloud(23, b=1, n=2048).astype(np.float64)
    mod = JaxDec(448)
    v = jax.jit(lambda k, c, f, q: mod.init(k, c, f, None, train=False, center_feats=q))(
        jax.random.key(0), *(jnp.asarray(a, jnp.float32) for a in (coarse, fg, feats)))
    v = {k: _randomize_norms(_np_tree(dict(v[k])), rng) for k in v}
    sd = {}
    interop._attention_vn_foldingnet(sd, v["params"], v["batch_stats"])
    dec = port_pcn.AttentionVNFoldingNet(448, 64, query_channels=128)
    dec.load_state_dict({k[len("decoder."):]: torch.from_numpy(np.array(t))
                         for k, t in sd.items()}, strict=True)
    with _X64(monkeypatch):
        v64 = _f64(v)

        def jax_loss(params, c, f, q):
            fine, mut = mod.apply({"params": params, "batch_stats": v64["batch_stats"]}, c, f,
                                  None, train=True, center_feats=q, mutable=["batch_stats"])
            return jax_losses.cd_loss_l1(fine, jnp.asarray(complete)), mut

        (jl, mut), jg = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3),
                                                   has_aux=True))(
            v64["params"], *map(jnp.asarray, (coarse, fg, feats)))
        jg, mut = _np_tree(jg), _np_tree(mut)
    dec = dec.double().train()
    c, f, q = (torch.from_numpy(a).requires_grad_() for a in (coarse, fg, feats))
    loss = port_losses.cd_loss_l1(dec(c, f, center_feats=q), torch.from_numpy(complete))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-9)
    want, stats = {}, {}
    interop._attention_vn_foldingnet(want, jg[0], jax.tree.map(np.zeros_like, v["batch_stats"]))
    interop._attention_vn_foldingnet(stats, v["params"], mut["batch_stats"])
    got = {f"decoder.{k}": t.grad for k, t in dec.named_parameters()}
    want = {k: torch.from_numpy(np.array(t)) for k, t in want.items() if "running" not in k}
    got.update(coarse=c.grad, feature_global=f.grad, center_feats=q.grad)
    want.update({k: torch.from_numpy(jg[i]) for i, k in
                 enumerate(("coarse", "feature_global", "center_feats"), 1)})
    assert got["decoder.query_proj.map_to_feat.weight"].abs().max() > 0
    _grads_within(got, want)
    for k, b in dec.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[f"decoder.{k}"], rtol=1e-9, atol=1e-12,
                                   err_msg=k)


def test_pointr_decoder_train_step_as_sensitive_as_jax(monkeypatch):
    """The whole model's float64 train-mode step (batch 1, the coarse and
    dense chamfer L1): gradients reach every tensor of the stack and
    ``query_proj`` but the pools' direction maps, and lie within 1e-7 of
    JAX's, or for a tensor that the step carries up, within twice JAX's own
    distance from its step on an input 1e-13 of itself away (relative); the
    running statistics likewise within 1e-9 of their max or twice JAX's
    spread.
    The step does carry up: at batch 1 the 1024 global channels are the
    same for every query, so ``vn_mlp_query.0``'s BatchNorm divides by the
    spread of the one coarse channel (down to 4e-5 of the norms' mean), and
    JAX's own dense output moves by 2.3e-3 of its max for an input 1e-12
    away (the port's by 4.3e-5 from JAX's); the two tests above hold the
    stack and ``query_proj`` to 1e-7 where they are well conditioned."""
    jax_losses, port_losses = _losses()
    p = _pipeline()
    xyz = p["xyz"].astype(np.float64)
    complete = _cloud(22, b=1, n=2048).astype(np.float64)
    with _X64(monkeypatch):
        v64 = _f64(p["v"])

        def jax_loss(params, x):
            (c, f), mut = p["jm"].apply({"params": params, "batch_stats": v64["batch_stats"]},
                                        x, None, train=True, mutable=["batch_stats"])
            target = jnp.asarray(complete)
            return jax_losses.cd_loss_l1(c, target) + jax_losses.cd_loss_l1(f, target), mut

        step = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))
        zero = jax.tree.map(np.zeros_like, p["v"]["batch_stats"])
        runs = []
        for x in (xyz, xyz * (1 + 1e-13)):
            (jl, mut), jg = step(v64["params"], jnp.asarray(x))
            runs.append((float(jl), interop.state_dict_from_jax_variables(
                {"params": _np_tree(jg), "batch_stats": zero}),
                interop.state_dict_from_jax_variables(
                {"params": p["v"]["params"], "batch_stats": _np_tree(mut["batch_stats"])})))
    model = PCNNet("vn_pointr", "attention_vn_foldingnet", 448,
                   pointr_decoder=True).double().train()
    model.load_state_dict(p["model"].state_dict())
    c, f = model(torch.from_numpy(xyz))
    target = torch.from_numpy(complete)
    loss = port_losses.cd_loss_l1(c, target) + port_losses.cd_loss_l1(f, target)
    loss.backward()
    (jl, jg, js), (jl2, jg2, js2) = runs
    assert abs(loss.item() - jl) <= max(1e-9 * jl, 2 * abs(jl2 - jl))
    got = {k: t.grad for k, t in model.named_parameters() if t.grad is not None}
    no_grad = {k for k, t in model.named_parameters() if t.grad is None}
    assert no_grad == {k for k in dict(model.named_parameters())
                       if "pool" in k and k.endswith("map_to_dir.weight")}
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in got.values())
    assert any(k.startswith("encoder.decoder.7.") for k in got)
    assert "decoder.query_proj.map_to_feat.weight" in got
    for k, g in got.items():
        w, w2 = jg[k].numpy(), jg2[k].numpy()
        gap, spread = np.abs(g.numpy() - w).max(), np.abs(w2 - w).max()
        assert gap <= max(1e-7 * np.abs(w).max(), 2 * spread), (k, gap, spread)
    for k, b in model.named_buffers():
        w, w2 = js[k].numpy(), js2[k].numpy()
        gap, spread = np.abs(b.numpy() - w).max(), np.abs(w2 - w).max()
        assert gap <= max(1e-9 * np.abs(w).max(), 2 * spread), (k, gap, spread)


def test_pointr_decoder_bf16_forward_within_jax_bf16_spread(monkeypatch):
    """Under ``compute_dtype_scope(bfloat16)`` on both sides: float32
    outputs, and the port's coarse and dense clouds no further from JAX's
    bf16 clouds than twice JAX's own bf16 clouds lie from its float32 ones,
    as max-abs and as CD-L1 (``tests/test_torch_port_bf16.py``'s yardstick
    for vn_pointr_448).  JAX cannot run this model under bf16 as it is: the
    decoder's scanned blocks return float32 queries (their cross-attention
    maps are float32 ``Dense`` layers, which promote) for a bf16 carry, and
    ``nn.scan`` refuses the change.  So JAX's first decoder block here
    returns its bf16 queries widened to float32, the dtype the scanned ones
    return, the dtype the port's blocks reach after the first residual of
    block 1."""
    from vn_pointcloudcompletion_tpu.models import pointr as jax_pointr

    class WidenedVNDecoderBlock(jax_pointr.VNDecoderBlock):
        def __call__(self, *args, **kw):
            q = super().__call__(*args, **kw)
            return q.astype(jnp.promote_types(q.dtype, jnp.float32))

    monkeypatch.setattr(jax_pointr, "VNDecoderBlock", WidenedVNDecoderBlock)
    p = _pipeline()
    args = (jnp.asarray(p["xyz"]), None)
    want32 = _jax_apply(p["jm"], p["v"], *args, dtype=jnp.float32, train=False)
    want16 = _jax_apply(p["jm"], p["v"], *args, dtype=jnp.bfloat16, train=False)
    with torch.no_grad(), precision.compute_dtype_scope(torch.bfloat16):
        got = p["model"](torch.from_numpy(p["xyz"]))
    for g, w16, w32 in zip(got, want16, want32):
        w16, w32 = np.asarray(w16), np.asarray(w32)
        assert g.dtype == torch.float32 and g.shape == w16.shape
        g = g.numpy()
        assert np.isfinite(g).all()
        spread, dist = np.abs(w16 - w32).max(), np.abs(g - w16).max()
        cd_spread, cd = _cd_l1(w16, w32), _cd_l1(g, w16)
        print(f"{g.shape}: max-abs {dist:.3g} (JAX spread {spread:.3g}), "
              f"CD-L1 {cd:.3g} (JAX spread {cd_spread:.3g})")
        assert spread > 0 and dist <= 2 * spread and cd <= 2 * cd_spread


# ------------------------------------------------- weights and the CLI


def test_pointr_decoder_weights_map_back_to_jax():
    """The interop's keys are the port model's, strictly, and JAX's
    ``vn_pointr_from_state_dict`` reads the encoder (the stack left out, as
    JAX's converter leaves it) back into the JAX parameters it came from."""
    from vn_pointcloudcompletion_tpu.training.torch_interop import vn_pointr_from_state_dict

    p = _pipeline()
    sd = {k: t.numpy() for k, t in p["model"].state_dict().items()}
    assert any(k.startswith("encoder.decoder.7.") for k in sd)
    params, stats = vn_pointr_from_state_dict(sd)
    enc_p = p["v"]["params"]["encoder"]
    assert "decoder_0" not in params and "vn_mlp_query_0" not in params
    for name in ("encoder_0", "grouper", "vn_coarse_pred_0"):
        jax.tree.map(np.testing.assert_array_equal, params[name], enc_p[name])
    np.testing.assert_array_equal(
        sd["encoder.decoder.3.attn.q_map.weight"],
        np.asarray(enc_p["decoder_scan"]["block"]["attn"]["q_map"]["kernel"])[2].T)
    np.testing.assert_array_equal(sd["decoder.query_proj.map_to_feat.weight"],
                                  p["v"]["params"]["decoder"]["query_proj"]["kernel"])


def _decoder_config(**extra):
    return Config.from_dict({"enc_type": "vn_pointr", "dec_type": "attention_vn_foldingnet",
                             "num_coarse": 448, "pointr_decoder": True, "seed": 5, **extra})


def test_pretrained_encoder_loads_into_pointr_decoder_model(tmp_path):
    """A vn_pointr encoder trained without the stack (a whole ``PCNNet``'s
    ``.pth``) loads into a ``pointr_decoder`` model: every encoder key but
    the coarse head and the stack comes from the file, which JAX's
    converter leaves at their init too."""
    src = build_model(_decoder_config(pointr_decoder=False, seed=1))
    path = str(tmp_path / "enc.pth")
    torch.save(src.state_dict(), path)
    model = build_model(_decoder_config())
    before = {k: t.clone() for k, t in model.encoder.state_dict().items()}
    keys = load_pretrained_encoder(model, path, "vn_pointr")
    own = model.encoder.state_dict()
    skipped = interop.PRETRAINED_SKIPPED["vn_pointr"]
    assert set(keys) == {k for k in own if not k.startswith(skipped)}
    for k, t in own.items():
        want = before[k] if k.startswith(skipped) else src.encoder.state_dict()[k]
        assert torch.equal(t, want), k
    assert any(k.startswith("decoder.") for k in own)


def test_pointr_decoder_init_distribution():
    """``build_model`` draws the stack as JAX's ``reinit_pointr_params``
    draws the encoder: every linear map trunc_normal(0.02) on +-2 std, every
    bias 0, every LayerNorm at scale 1 and bias 0; ``query_proj`` keeps
    torch's U(-1/sqrt(fan_in), 1/sqrt(fan_in)); seeded."""
    model = build_model(_decoder_config())
    stack = [model.encoder.decoder, model.encoder.vn_mlp_query]
    ws = [m.weight.detach() for s in stack for m in s.modules()
          if isinstance(m, torch.nn.Linear)]
    flat = torch.cat([w.reshape(-1) for w in ws])
    assert flat.abs().max() <= 0.04 and flat.numel() > 2e6
    assert abs(flat.std().item() - 0.02 * 0.8796) < 2e-4 and abs(flat.mean().item()) < 2e-4
    biases = [m.bias for s in stack for m in s.modules() if getattr(m, "bias", None) is not None]
    assert biases and all(torch.all(b == 0) for b in biases)
    for m in model.encoder.decoder.modules():
        if isinstance(m, torch.nn.LayerNorm):
            assert torch.all(m.weight == 1) and torch.all(m.bias == 0)
    w = model.decoder.query_proj.map_to_feat.weight
    assert w.abs().max() <= 128 ** -0.5 and w.std() > 0.03
    again = build_model(_decoder_config()).state_dict()
    assert all(torch.equal(t, again[k]) for k, t in model.state_dict().items())


def test_cli_pointr_decoder_train_resume_test(tmp_path, monkeypatch):
    """``train`` one epoch (one step, one validation batch) of the root
    config.json's pipeline with ``pointr_decoder`` at full width, float32,
    on a tiny synthetic set; then ``--resume train`` one more epoch, then
    ``--resume test``."""
    import os

    with open(os.path.join(os.path.dirname(__file__), "..", "config.json")) as f:
        cfg = json.load(f)
    cfg.update(name="dec", dtype="float32", batch_size=2, dataset="synthetic",
               num_workers=1, synthetic_n_partial=N_POINTS, synthetic_n_complete=512,
               synthetic_train_samples=2, synthetic_val_samples=2,
               synthetic_test_samples=2, log_frequency=1, pointr_decoder=True)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "out"))
    summary = cli.main(["-n", "dec", "-epochs", "0", "--device", "cpu", "train"])
    assert summary["epochs_run"] == 1
    (run,) = os.listdir(tmp_path / "out")
    summary = cli.main(["-n", run, "--resume", "-epochs", "1", "--device", "cpu", "train"])
    assert summary["epochs_run"] >= 1
    res = cli.main(["-n", run, "--resume", "--device", "cpu", "test"])
    row = res["synthetic"]
    assert all(np.isfinite(x) for x in row.values()) and 0 < row["iou"] <= 1
