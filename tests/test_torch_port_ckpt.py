"""The JAX package's flax msgpack ``.ckpt`` files in the port, on the CPU.

- ``training/flax_msgpack.py`` against ``flax.serialization.msgpack_restore``
  on the same bytes: hypothesis-drawn trees, every msgpack form the
  decoder covers (written by msgpack itself), chunked leaves, refusals.
- ``load_pretrained_encoder`` on the JAX package's own ``.ckpt`` files of
  the four encoders against JAX's ``load_pretrained_encoder``: every tensor
  equal to the bit; the flagship's float64 eval forward within 1e-8; the
  CLI's ``--ckpt_path``; a missing leaf or another shape raises.

Every input comes from a numpy seed.
"""

import json
import math
import os
import shutil

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tests.test_torch_port_train import (  # noqa: F401  (flagship: a fixture)
    NUM_COARSE,
    _float64,
    _np_tree,
    _randomize_bn,
    flagship,
)
from tests.test_torch_port_train_options import _PIPELINES, _random_variables
from vn_pointcloudcompletion_tpu.training import checkpoint as jax_ckpt
from vn_pointcloudcompletion_tpu.training import state as jax_state
from vn_pointcloudcompletion_tpu.training import steps as jax_steps
from vn_pointcloudcompletion_tpu_torch import __main__ as cli
from vn_pointcloudcompletion_tpu_torch.models.composer import PCNNet
from vn_pointcloudcompletion_tpu_torch.training import flax_msgpack
from vn_pointcloudcompletion_tpu_torch.training.checkpoint import load_pretrained_encoder
from vn_pointcloudcompletion_tpu_torch.training.interop import state_dict_from_jax_variables

@pytest.fixture(autouse=True)
def _drop_tmp(tmp_path):
    """Remove each test's files (checkpoint pairs of ~100-500 MB) when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


# ------------------------------------------------------------ msgpack

_DTYPES = ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
           "float16", "float32", "float64", "complex64", "complex128", "bfloat16")


def _np_dtype(name):
    return np.dtype(jnp.bfloat16) if name == "bfloat16" else np.dtype(name)


@st.composite
def _arrays(draw):
    """A numpy array of any of flax's dtypes, its bits drawn (NaNs and
    infinities included); bool as 0/1."""
    dt = _np_dtype(draw(st.sampled_from(_DTYPES)))
    shape = tuple(draw(st.lists(st.integers(0, 4), max_size=3)))
    n = math.prod(shape) * dt.itemsize
    raw = draw(st.binary(min_size=n, max_size=n))
    if dt == np.bool_:
        raw = bytes(b & 1 for b in raw)
    return np.frombuffer(raw, dt).reshape(shape).copy()


@st.composite
def _np_scalars(draw):
    a = draw(_arrays().filter(lambda a: a.size > 0))
    return a.reshape(-1)[0]


_LEAVES = (st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
           | st.floats(allow_nan=True) | st.text(max_size=12) | st.binary(max_size=12)
           | st.complex_numbers(allow_nan=False) | _arrays() | _np_scalars())
_TREES = st.recursive(_LEAVES, lambda c: st.lists(c, max_size=4)
                      | st.dictionaries(st.text(max_size=8), c, max_size=4), max_leaves=16)


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.contiguous().numpy().tobytes()
    return np.asarray(x).tobytes()


def _same_tree(got, want, path="/"):
    """``got`` (the port's) is ``want`` (flax's) with tensors for arrays:
    the same structure, types, dtypes, shapes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}{k}/")
    elif isinstance(want, msgpack.ExtType):
        assert isinstance(got, flax_msgpack.ExtType) and tuple(got) == tuple(want), path
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}{i}/")
    elif isinstance(want, (np.ndarray, np.generic)):
        want = np.asarray(want)
        assert isinstance(got, torch.Tensor), path
        name = str(got.dtype).replace("torch.", "")
        assert name == want.dtype.name and tuple(got.shape) == want.shape, path
        assert _bits(got) == want.tobytes(), path
    elif isinstance(want, float):
        assert type(got) is float and (got == want or (math.isnan(got) and math.isnan(want))), path
    else:
        assert type(got) is type(want) and got == want, path


@settings(max_examples=80, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_TREES)
def test_msgpack_decoder_equals_flax(tree):
    """The port's decoder against ``msgpack_restore`` on the bytes flax's
    ``msgpack_serialize`` writes for a drawn tree: nested dicts and lists
    of arrays of every dtype (bf16 included), numpy scalars, ints from
    -2^63 to 2^64 - 1, floats, strings, bytes and complex numbers."""
    encoded = flax_ser.msgpack_serialize(tree)
    _same_tree(flax_msgpack.msgpack_restore(encoded), flax_ser.msgpack_restore(encoded))


def _ext_array(n_bytes: int):
    """An ndarray ext of code 1 whose payload is ``n_bytes`` long."""
    for n in range(max(0, n_bytes - 24), n_bytes):  # the header is under 24 bytes
        data = (bytes(range(256)) * (n // 256 + 1))[:n]
        payload = msgpack.packb(([n], "int8", data), use_bin_type=True)
        if len(payload) == n_bytes:
            return msgpack.ExtType(1, payload)
    raise AssertionError(n_bytes)


_FORMS = {
    "str 8, 16, 32": ["a" * 40, "é" * 200, "c" * 70000],
    "bin 8, 16, 32": [b"x" * 40, b"y" * 300, b"z" * 70000],
    "array 16, 32": [list(range(20)), [1] * 70000],
    "map 16": {str(i): i for i in range(20)},
    "map 32": {str(i): -i for i in range(70000)},
    "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33,
             -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
    "fixext 16, ext 8, 16, 32": [_ext_array(16), _ext_array(40), _ext_array(300),
                                 _ext_array(70000)],
    "fixext 1-8, unknown codes": [msgpack.ExtType(9, b"a"), msgpack.ExtType(5, b"ab"),
                                  msgpack.ExtType(7, b"abcd"), msgpack.ExtType(8, b"a" * 8)],
    "nil, bool, complex": [None, True, False, msgpack.ExtType(2, msgpack.packb((1.5, -2.0)))],
}


@pytest.mark.parametrize("form", sorted(_FORMS))
def test_msgpack_decoder_reads_every_form(form):
    """Each msgpack form the decoder covers, written by msgpack itself,
    against ``msgpack_restore``; also float32 (``use_single_float``)."""
    encoded = msgpack.packb(_FORMS[form], use_bin_type=True)
    _same_tree(flax_msgpack.msgpack_restore(encoded), flax_ser.msgpack_restore(encoded))
    single = msgpack.packb([1.5, -0.1, float("inf")], use_single_float=True)
    assert flax_msgpack.msgpack_restore(single) == flax_ser.msgpack_restore(single)


def test_msgpack_decoder_joins_chunked_leaves(monkeypatch):
    """A leaf over flax's ``MAX_CHUNK_SIZE`` (set to 64 bytes inside the
    test) is written as chunks; both decoders join them: at the top level,
    among a map's values and nested maps, and not inside a list (flax
    leaves those chunked)."""
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    big = rng.standard_normal((5, 7)).astype(np.float32)
    tree = {"a": big, "b": {"c": rng.integers(0, 9, (3, 11, 2)), "d": np.float64(2.0)},
            "e": [big[:1]], "small": big[0, :3]}
    encoded = flax_ser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in encoded
    got = flax_msgpack.msgpack_restore(encoded)
    _same_tree(got, flax_ser.msgpack_restore(encoded))
    assert torch.equal(got["a"], torch.from_numpy(big))
    top = flax_ser.msgpack_serialize(big)
    _same_tree(flax_msgpack.msgpack_restore(top), flax_ser.msgpack_restore(top))


@pytest.mark.parametrize("fault", ["trailing bytes", "int map key", "truncated"])
def test_msgpack_decoder_refuses_as_msgpack(fault):
    encoded = {"trailing bytes": msgpack.packb({"a": 1}) + b"\x00",
               "int map key": msgpack.packb({1: 2}),
               "truncated": msgpack.packb({"a": "abcdef"})[:-2]}[fault]
    with pytest.raises(ValueError):
        flax_ser.msgpack_restore(encoded)
    with pytest.raises(ValueError):
        flax_msgpack.msgpack_restore(encoded)


# ------------------------------------------------ pretrained encoders from .ckpt


def _jax_state(jm, variables):
    return jax_state.TrainState.create(apply_fn=jm.apply, params=variables["params"],
                                       tx=optax.identity(), batch_stats=variables["batch_stats"])


def _jax_checkpoint(jm, variables, exp_dir) -> str:
    """JAX's ``save_checkpoint`` of ``variables``: its ``model_best.ckpt``."""
    for sub in ("models", "optimizer"):
        os.makedirs(os.path.join(exp_dir, sub), exist_ok=True)
    jax_ckpt.save_checkpoint(str(exp_dir), _jax_state(jm, variables), 3, 0.5, 2, "best")
    return os.path.join(exp_dir, "models", "model_best.ckpt")


@pytest.mark.parametrize("enc", sorted(_PIPELINES))
def test_ckpt_encoder_matches_jax_load(enc, tmp_path):
    """A JAX ``save_checkpoint`` file of a whole model: the port's decoder
    gives flax's tree, and ``load_pretrained_encoder`` gives every tensor of
    the model JAX's ``load_pretrained_encoder`` gives, to the bit: the
    encoder's parameters and running statistics the file's (vn_pointr's
    coarse head too: JAX's ``.ckpt`` branch loads the whole encoder), the
    decoder untouched."""
    jm, init = _random_variables(enc, 0)
    _, file_v = _random_variables(enc, 1)
    path = _jax_checkpoint(jm, file_v, tmp_path)
    with open(path, "rb") as f:
        encoded = f.read()
    _same_tree(flax_msgpack.msgpack_restore(encoded), flax_ser.msgpack_restore(encoded))

    jloaded = jax_ckpt.load_pretrained_encoder(_jax_state(jm, init), path, enc_type=enc)
    want = state_dict_from_jax_variables({"params": _np_tree(jloaded.params),
                                          "batch_stats": _np_tree(jloaded.batch_stats)})
    dec, nc, _ = _PIPELINES[enc]
    model = PCNNet(enc, dec, nc)
    start = state_dict_from_jax_variables(init)
    model.load_state_dict(start, strict=True)
    keys = load_pretrained_encoder(model, path, enc)
    got = model.state_dict()
    file_sd = state_dict_from_jax_variables(file_v)
    assert set(got) == set(want)
    assert keys == sorted(k[len("encoder."):] for k in got if k.startswith("encoder."))
    for k, t in got.items():
        assert torch.equal(t, want[k]), k
        assert torch.equal(t, file_sd[k] if k.startswith("encoder.") else start[k]), k


def test_bare_ckpt_encoder_without_statistics(tmp_path):
    """A bare encoder tree ``{"params": <encoder>}`` without statistics:
    JAX takes the whole ``params`` as the encoder and leaves the running
    statistics; so does the port."""
    jm, init = _random_variables("vn_pointnet", 0)
    _, file_v = _random_variables("vn_pointnet", 1)
    path = str(tmp_path / "enc.ckpt")
    with open(path, "wb") as f:
        f.write(flax_ser.msgpack_serialize({"params": file_v["params"]["encoder"]}))
    jloaded = jax_ckpt.load_pretrained_encoder(_jax_state(jm, init), path)
    want = state_dict_from_jax_variables({"params": _np_tree(jloaded.params),
                                          "batch_stats": _np_tree(jloaded.batch_stats)})
    model = PCNNet("vn_pointnet", "vn_foldingnet", 64)
    start = state_dict_from_jax_variables(init)
    model.load_state_dict(start, strict=True)
    keys = load_pretrained_encoder(model, path)
    assert keys and not any("running" in k for k in keys)
    for k, t in model.state_dict().items():
        assert torch.equal(t, want[k]), k
    assert torch.equal(model.state_dict()["encoder.first_conv.0.batchnorm.bn.running_var"],
                       start["encoder.first_conv.0.batchnorm.bn.running_var"])


@pytest.mark.parametrize("fault", ["missing", "shape", "suffix"])
def test_ckpt_encoder_refusals(fault, tmp_path):
    """A tree without a leaf of the encoder: ValueError from JAX, KeyError
    naming it from the port; a leaf of another shape (JAX's
    ``from_state_dict`` does not check shapes): ValueError naming the port's
    key; a file of another suffix: ValueError naming the formats read."""
    jm, init = _random_variables("vn_pointnet", 0)
    model = PCNNet("vn_pointnet", "vn_foldingnet", 64)
    if fault == "suffix":
        with pytest.raises(ValueError, match=r"\.pth or \.pt.*\.ckpt"):
            load_pretrained_encoder(model, str(tmp_path / "enc.npz"))
        return
    _, v = _random_variables("vn_pointnet", 1)
    trunk = v["params"]["encoder"]["trunk"]
    if fault == "missing":
        del trunk["second_conv_1"]
    else:
        trunk["second_conv_1"]["kernel"] = trunk["second_conv_1"]["kernel"][:, :-1]
    path = str(tmp_path / "bad.ckpt")
    with open(path, "wb") as f:
        f.write(flax_ser.msgpack_serialize(v))
    if fault == "missing":
        with pytest.raises(ValueError):
            jax_ckpt.load_pretrained_encoder(_jax_state(jm, init), path)
        with pytest.raises(KeyError, match="second_conv_1"):
            load_pretrained_encoder(model, path)
    else:
        with pytest.raises(ValueError, match=r"second_conv\.1\.map_to_feat\.weight"):
            load_pretrained_encoder(model, path)


def test_ckpt_encoder_forward_matches_jax_float64(flagship, tmp_path, monkeypatch):  # noqa: F811
    """The flagship with the encoder of a JAX ``.ckpt`` (another init, its
    BatchNorm statistics randomised): the eval forward, so3-rotated, of the
    port against JAX's after JAX's ``load_pretrained_encoder``, in float64:
    coarse and dense within 1e-8."""
    jm, _, partial32, _, _ = flagship
    file_v = jm.init(jax.random.key(1), jnp.asarray(partial32), None, train=False)
    file_v = {k: _randomize_bn(_np_tree(dict(file_v[k])), np.random.default_rng(1))
              for k in file_v}
    path = _jax_checkpoint(jm, file_v, tmp_path)
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    with _float64(flagship, monkeypatch) as (jm, v, model, partial, _, rot):
        jv = jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})
        jstate = jax_ckpt.load_pretrained_encoder(_jax_state(jm, jv), path)
        jv = {"params": jax.tree.map(f64, jstate.params),
              "batch_stats": jax.tree.map(f64, jstate.batch_stats)}
        xyz = np.array(jax_steps.rotate_points(jnp.asarray(partial), jnp.asarray(rot)))
        jc, jf = jm.apply(jv, jnp.asarray(xyz), jnp.asarray(rot), train=False)
        load_pretrained_encoder(model, path)
        with torch.no_grad():
            pc, pf = model.eval()(torch.from_numpy(xyz), torch.from_numpy(rot))
    for got, want in ((pc, jc), (pf, jf)):
        assert got.dtype == torch.float64
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-8


@pytest.fixture
def project(tmp_path, monkeypatch):
    cfg = {"name": "t", "enc_type": "vn_pointnet", "dec_type": "vn_foldingnet",
           "num_coarse": NUM_COARSE, "latent_dim": 2048, "only_coarse": False,
           "batch_size": 2, "lr": 1e-3, "rotation": "so3", "val_rotation": "so3",
           "dataset": "synthetic", "num_workers": 1, "synthetic_n_partial": 256,
           "synthetic_n_complete": 1024, "synthetic_val_samples": 2, "seed": 0,
           "log_frequency": 1}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "out"))
    return tmp_path


def test_cli_ckpt_path_reads_a_jax_checkpoint(project, flagship):  # noqa: F811
    """``--ckpt_path <JAX model_best.ckpt> overfit``: the run's encoder
    parameters are the file's to the bit (loaded, then frozen), its running
    statistics moved off the file's, the decoder trained."""
    jm, _, partial32, _, _ = flagship
    file_v = jm.init(jax.random.key(2), jnp.asarray(partial32), None, train=False)
    file_v = {k: _randomize_bn(_np_tree(dict(file_v[k])), np.random.default_rng(2))
              for k in file_v}
    path = _jax_checkpoint(jm, file_v, project / "jax_run")
    summary = cli.main(["-n", "t", "--ckpt_path", path, "-epochs", "1", "--device", "cpu",
                        "overfit"])
    assert summary["epochs_run"] == 2
    (run,) = os.listdir(project / "out")
    got = torch.load(project / "out" / run / "models" / "model_last.pth", weights_only=True)
    want = state_dict_from_jax_variables(file_v)
    for k, t in got.items():
        if k.startswith("encoder.") and "running" not in k:
            assert torch.equal(t, want[k]), k
        elif "running" in k and k.startswith("encoder."):
            assert not torch.equal(t, want[k]), k
    assert "Loaded pretrained encoder from" in (project / "out" / run / "overfit.log").read_text()
