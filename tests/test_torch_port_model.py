"""The port's model, ops and metrics against the JAX package on the CPU.

The same numpy inputs and the same weights (a JAX ``PCNNet.init`` carried
across with ``state_dict_from_jax_variables``) go to both sides.  Rotations
are numpy matrices handed to both, since the two frameworks draw different
numbers from one seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vn_pointcloudcompletion_tpu.metrics import metrics as jax_metrics
from vn_pointcloudcompletion_tpu.models.composer import PCNNet as JaxPCNNet
from vn_pointcloudcompletion_tpu.ops import grid as jax_grid
from vn_pointcloudcompletion_tpu.ops import rotations as jax_rot
from vn_pointcloudcompletion_tpu.training.torch_interop import pcnnet_variables_from_torch
from vn_pointcloudcompletion_tpu_torch.metrics import metrics as port_metrics
from vn_pointcloudcompletion_tpu_torch.models.composer import PCNNet, build_model
from vn_pointcloudcompletion_tpu_torch.nn import vn as port_vn
from vn_pointcloudcompletion_tpu_torch.ops import grid as port_grid
from vn_pointcloudcompletion_tpu_torch.ops import rotations as port_rot
from vn_pointcloudcompletion_tpu_torch.ops.chamfer import chamfer_distance
from vn_pointcloudcompletion_tpu_torch.training.interop import state_dict_from_jax_variables
from vn_pointcloudcompletion_tpu_torch.utils.config import Config

torch.set_num_threads(2)

NUM_COARSE = 64  # dense 1024 points


def _randomize_bn(tree, rng):
    """Non-identity BatchNorm parameters and running statistics, so the
    folded affine is exercised."""
    def walk(node):
        if not isinstance(node, dict):
            return np.array(node)
        out = {k: walk(v) for k, v in node.items()}
        if "BatchNorm_0" in out:
            bn = out["BatchNorm_0"]
            c = next(iter(bn.values())).shape[0]
            if "scale" in bn:
                bn["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                bn["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
            else:
                bn["mean"] = rng.uniform(0.0, 0.5, c).astype(np.float32)
                bn["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        return out

    return walk(tree)


def flagship_pool_gaps(model, xyz):
    """The two VN max-pools of the flagship encoder (``maxpool1``,
    ``maxpool2``) scored in float64 through the port's layers, eval mode:
    per (sample, channel), the winner's score minus the best score of a
    point whose vector differs from the winner's, over the largest |score|
    of the channel.  A small gap lets two implementations that sum a score
    in different orders pick different vectors; a tie between equal
    vectors (duplicate points) picks the same vector either way and is
    not a gap.  Returns [(B, 512), (B, 2048)]."""
    enc = model.encoder
    params = {k: t.detach().double() for k, t in enc.state_dict().items()}
    x = torch.from_numpy(np.asarray(xyz, np.float64)).transpose(1, 2)[:, :, None, :]
    gaps = []
    with torch.no_grad():
        h = torch.func.functional_call(enc.first_conv[0], {
            k.split(".", 2)[2]: v for k, v in params.items() if k.startswith("first_conv.0.")}, (x,))
        for i, (conv, pool) in enumerate((("first_conv", "maxpool1"),
                                          ("second_conv", "maxpool2"))):
            w = params[f"{conv}.1.map_to_feat.weight"]
            f = torch.matmul(w, h)
            s = port_vn.vector_dot(f, torch.matmul(params[f"{pool}.map_to_dir.weight"] @ w, h), 1)
            top = s.argmax(-1, keepdim=True)  # (B, C, 1)
            win = torch.gather(f, 3, top[:, None].expand(-1, 3, -1, -1))  # (B, 3, C, 1)
            same = (f == win).all(1)  # points whose vector is the winner's
            second = torch.where(same, -torch.inf, s).amax(-1)
            gaps.append(((s.amax(-1) - second) / s.abs().amax(-1)).numpy())
            if i == 0:
                g = win.expand(-1, -1, -1, f.shape[3])
                h = torch.func.functional_call(enc.second_conv[0], {
                    k.split(".", 2)[2]: v for k, v in params.items()
                    if k.startswith("second_conv.0.")}, (torch.cat([g, f], 2),))
    return gaps


def _assert_pool_gap(model, xyz, rel=1e-5):
    """Every channel of both flagship pools picks its vector by more than
    ``rel`` of the channel's largest score (see :func:`flagship_pool_gaps`),
    as ``tests/test_torch_port_dgcnn.py::_assert_knn_gap`` holds kNN."""
    for name, gap in zip(("maxpool1", "maxpool2"), flagship_pool_gaps(model, xyz)):
        assert gap.min() > rel, (name, gap.min(), np.unravel_index(gap.argmin(), gap.shape))


def carried_flagship():
    """JAX model + variables and the port model loaded with the same weights,
    and a cloud (32 points) on which both flagship pools pick their vectors
    by more than 1e-5 of their scores (``_assert_pool_gap``).  A float32 tie
    in a pool lets JAX and the port, which sum the score in different
    orders, pick different vectors: the 256-point cloud this fixture took
    before had one at 8e-9 in ``maxpool1``."""
    rng = np.random.default_rng(0)
    jm = JaxPCNNet(num_coarse=NUM_COARSE, latent_dim=2048)
    init_xyz = (rng.standard_normal((2, 256, 3)) * 0.3).astype(np.float32)
    # jitted: the same values as the eager init, in a seventh of the time
    v = jax.jit(lambda k, x: jm.init(k, x, None, train=False))(jax.random.key(0),
                                                               jnp.asarray(init_xyz))
    v = {k: _randomize_bn(jax.tree.map(np.array, dict(v[k])), rng) for k in v}
    model = PCNNet(num_coarse=NUM_COARSE).eval()
    model.load_state_dict(state_dict_from_jax_variables(v), strict=True)
    xyz = (np.random.default_rng(1019).standard_normal((2, 32, 3)) * 0.3).astype(np.float32)
    _assert_pool_gap(model, xyz)
    return jm, v, model, xyz


@pytest.fixture(scope="module")
def carried():
    return carried_flagship()


def test_state_dict_round_trip_is_exact(carried):
    _, v, model, _ = carried
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    assert "decoder.final_conv.0.map_to_feat.weight" in sd
    assert sd["decoder.final_conv.0.map_to_feat.weight"].shape == (256, 2050)
    assert "encoder.mlp.0.leaky_relu.map_to_dir.weight" in sd
    back = pcnnet_variables_from_torch(sd, latent_dim=2048)
    want = jax.tree_util.tree_leaves_with_path(v)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


@pytest.mark.parametrize("rotated", [False, True])
def test_whole_model_matches_jax(carried, rotated):
    jm, v, model, xyz = carried
    rot = None
    if rotated:
        q = np.random.default_rng(5).standard_normal(4)
        q /= np.linalg.norm(q)
        r = np.asarray(jax_rot.quaternion_to_matrix(jnp.asarray(q, jnp.float32)))
        rot = np.repeat(r[None], 2, axis=0)
    jc, jf = jm.apply(v, jnp.asarray(xyz), None if rot is None else jnp.asarray(rot),
                      train=False)
    with torch.no_grad():
        c, f = model(torch.from_numpy(xyz), None if rot is None else torch.from_numpy(rot))
    assert c.shape == (2, NUM_COARSE, 3) and f.shape == (2, NUM_COARSE * 16, 3)
    for got, want in ((c.numpy(), np.asarray(jc)), (f.numpy(), np.asarray(jf))):
        assert np.abs(want).max() > 1e-2  # not a vanishing output
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_plain_path_equals_kernel_wrappers_on_cpu(carried):
    _, _, model, xyz = carried
    x = torch.from_numpy(xyz)
    with torch.no_grad():
        c1, f1 = model(x)
        model.use_kernels_(False)
        try:
            c2, f2 = model(x)
        finally:
            model.use_kernels_(True)
    assert torch.equal(c1, c2) and torch.equal(f1, f2)


def test_vec_layers_match_jax():
    from vn_pointcloudcompletion_tpu.nn import vn as jax_vn

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 3, 5)).astype(np.float32)
    jl = jax_vn.VNLinearLeakyReLU(6)
    v = jax.tree.map(np.array, jl.init(jax.random.key(1), jnp.asarray(x)))
    v = _randomize_bn(v, rng)
    want = np.asarray(jl.apply(v, jnp.asarray(x), train=False))
    layer = port_vn.VNLinearLeakyReLU(8, 6).eval()
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
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("extra_dims", [(), (2,)])
def test_batchnorm_train_mode_matches_jax(extra_dims):
    """Train-mode VNBatchNorm against JAX ``_NormAffine``: batch statistics
    (biased variance) normalise, the running buffers take the unbiased one
    with momentum 0.1; output and buffers rtol 1e-5 + atol 1e-6, the input
    gradient 1e-5 of its max."""
    from vn_pointcloudcompletion_tpu.nn import vn as jax_vn

    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 4, 3, 5) + extra_dims).astype(np.float32)
    x[0, 0, :, 0] = 0.0  # an exact zero vector
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jb = jax_vn.VNBatchNorm()
    v = _randomize_bn(jax.tree.map(np.array, jb.init(jax.random.key(0), jnp.asarray(x))), rng)

    def jax_loss(xx):
        out, mut = jb.apply(v, xx, train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut)

    (_, (want, mut)), gx = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(x))
    layer = port_vn.VNBatchNorm(4).train()
    bn, st = v["params"]["BatchNorm_0"], v["batch_stats"]["BatchNorm_0"]
    layer.load_state_dict({"bn.weight": torch.from_numpy(bn["scale"]),
                           "bn.bias": torch.from_numpy(bn["bias"]),
                           "bn.running_mean": torch.from_numpy(st["mean"]),
                           "bn.running_var": torch.from_numpy(st["var"])})
    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    new = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(layer.bn.running_mean.numpy(), new["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(layer.bn.running_var.numpy(), new["var"], rtol=1e-5, atol=1e-6)
    gx = np.asarray(gx)
    np.testing.assert_allclose(xt.grad.numpy(), gx, atol=1e-5 * np.abs(gx).max())
    layer.eval()  # eval mode reads the updated buffers and changes nothing
    before = layer.bn.running_var.clone()
    with torch.no_grad():
        layer(xt)
    assert torch.equal(before, layer.bn.running_var)


def test_safe_norm_zero_vector():
    x = torch.zeros(1, 2, 3, requires_grad=True)
    n = port_vn.safe_norm(x, dim=2)
    n.sum().backward()
    assert torch.equal(n, torch.zeros(1, 2)) and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("extent", [0.05, 1.0])  # 1.0: the attention decoder's
@pytest.mark.parametrize("grid_size", [4, 8])
def test_folding_grids_match_jax(grid_size, extent):
    # the two linspace implementations round differently: 1 ulp of the
    # extent apart at most
    np.testing.assert_allclose(
        port_grid.folding_grid_3d(grid_size, extent).numpy(),
        np.asarray(jax_grid.folding_grid_3d(grid_size, extent)),
        atol=np.spacing(np.float32(extent)), rtol=0)


def test_rotations_match_jax():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    r_port = port_rot.quaternion_to_matrix(torch.from_numpy(q))
    np.testing.assert_allclose(
        r_port.numpy(), np.asarray(jax_rot.quaternion_to_matrix(jnp.asarray(q))), atol=1e-6)
    pts = rng.standard_normal((5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        port_rot.rotate_points(torch.from_numpy(pts), r_port).numpy(),
        np.asarray(jax_rot.rotate_points(jnp.asarray(pts), jnp.asarray(r_port.numpy()))),
        atol=1e-6)


@pytest.mark.parametrize("mode", ["so3", "z", "none", "canonical"])
def test_sampled_rotations_are_proper(mode):
    g = torch.Generator().manual_seed(0)
    r = port_rot.sample_rotation(g, mode, 6)
    if mode in ("none", "canonical"):
        assert r is None
        return
    eye = torch.eye(3).expand(6, 3, 3)
    torch.testing.assert_close(r @ r.transpose(1, 2), eye, atol=1e-5, rtol=0)
    torch.testing.assert_close(torch.linalg.det(r), torch.ones(6), atol=1e-5, rtol=0)
    if mode == "z":
        assert torch.all(r[:, 2, 2] == 1)
    again = port_rot.sample_rotation(torch.Generator().manual_seed(0), mode, 6)
    assert torch.equal(r, again)


def _clouds(seed, n, m):
    rng = np.random.default_rng(seed)
    pred = (rng.standard_normal((2, n, 3)) * 0.05).astype(np.float32)
    gt = (rng.standard_normal((2, m, 3)) * 0.05).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("name", ["l1_cd", "l2_cd", "f_score"])
def test_chamfer_metrics_match_jax(name):
    pred, gt = _clouds(7, 300, 500)
    got = getattr(port_metrics, name)(torch.from_numpy(pred), torch.from_numpy(gt)).numpy()
    want = np.asarray(getattr(jax_metrics, name)(jnp.asarray(pred), jnp.asarray(gt)))
    if name == "f_score":
        assert 0 < got.min() and got.max() < 1  # threshold actually splits
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_voxel_iou_matches_jax():
    pred, gt = _clouds(8, 1024, 2048)
    gt[:, :5] = gt[:, 5:10]  # duplicates
    got = port_metrics.voxel_iou(torch.from_numpy(pred), torch.from_numpy(gt)).numpy()
    want = np.asarray(jax.vmap(jax_metrics.voxel_iou)(jnp.asarray(pred), jnp.asarray(gt)))
    assert got.shape == (2,) and 0 < got.min()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    single = port_metrics.voxel_iou(torch.from_numpy(pred[0]), torch.from_numpy(gt[0]))
    assert single.shape == () and float(single) == pytest.approx(float(want[0]))
    vox = port_metrics.points_to_voxels(torch.from_numpy(pred[0]), 16).numpy()
    np.testing.assert_array_equal(
        vox, np.asarray(jax_metrics.points_to_voxels(jnp.asarray(pred[0]), 16)))


def test_chamfer_distance_small_and_any_dim():
    from vn_pointcloudcompletion_tpu.ops.chamfer import chamfer_distance_reference

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 20, 5)).astype(np.float32)
    y = rng.standard_normal((2, 30, 5)).astype(np.float32)
    d1, d2, i1, i2 = chamfer_distance(torch.from_numpy(x), torch.from_numpy(y))
    w1, w2, j1, j2 = chamfer_distance_reference(x, y)
    np.testing.assert_allclose(d1.numpy(), w1, rtol=1e-5)
    np.testing.assert_allclose(d2.numpy(), w2, rtol=1e-5)
    np.testing.assert_array_equal(i1.numpy(), j1)
    np.testing.assert_array_equal(i2.numpy(), j2)


_PTR = {"enc_type": "vn_pointr", "num_coarse": 448}


@pytest.mark.parametrize("cfg,error,match", [
    ({"dtype": "bfloat16"}, None, None),
    ({**_PTR, "dec_type": "attention_vn_foldingnet"}, None, None),
    ({"enc_type": "vn_pointr"}, ValueError, "num_coarse=448"),
    ({"dec_type": "attention_vn_foldingnet"}, None, None),
    ({"pointr_decoder": True}, ValueError, "enc_type='vn_pointr'"),
    ({**_PTR, "pointr_decoder": True}, ValueError, "dec_type='attention_vn_foldingnet'"),
    ({**_PTR, "pointr_decoder": True, "only_coarse": True}, None, None),
])
def test_unported_configs_raise(cfg, error, match):
    """Every JAX config now builds or raises as JAX does (the name is the
    test's first purpose, the refusal of configs not yet ported; none is
    left).  The configs JAX's ``build_model`` refuses raise its ValueErrors:
    vn_pointr off num_coarse 448, ``pointr_decoder`` without the vn_pointr
    encoder or without the attention decoder; the pipelines build, and so
    does a bfloat16 config (the policy is set by the caller, not the model:
    parameters stay float32); ``pointr_decoder`` under ``only_coarse``
    holds no decoder stack (JAX composer.py:61-63)."""
    if error is None:
        model = build_model(Config.from_dict(cfg))
        assert all(p.dtype == torch.float32 for p in model.parameters())
        if cfg.get("only_coarse"):
            assert not hasattr(model, "decoder")
            assert not any(k.startswith(("encoder.decoder.", "encoder.vn_mlp_query."))
                           for k in model.state_dict())
            return
        want = "VNFoldingNet" if "dtype" in cfg else "AttentionVNFoldingNet"
        assert type(model.decoder).__name__ == want
        return
    with pytest.raises(error, match=match):
        build_model(Config.from_dict(cfg))


def test_build_model_is_seeded():
    cfg = Config.from_dict({"num_coarse": 64, "only_coarse": True, "seed": 3})
    a, b = build_model(cfg), build_model(cfg)
    c = build_model(cfg.replace(seed=4))
    wa = a.state_dict()["encoder.maxpool2.map_to_dir.weight"]
    assert torch.equal(wa, b.state_dict()["encoder.maxpool2.map_to_dir.weight"])
    assert not torch.equal(wa, c.state_dict()["encoder.maxpool2.map_to_dir.weight"])
    assert wa.abs().max() <= 1 / np.sqrt(2048)
    assert not hasattr(a, "decoder")
