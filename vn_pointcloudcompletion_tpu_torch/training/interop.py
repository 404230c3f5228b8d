"""JAX variables -> the port's ``state_dict`` (reference key layout).

:func:`state_dict_from_jax_variables` reads the ``{params, batch_stats}``
tree of a JAX ``PCNNet`` (any array-likes: numpy, or JAX arrays converted by
numpy) and needs no JAX itself.  It tells the pipeline from the tree:

- encoders ``vn_pointnet`` (the exact inverse of the JAX package's
  ``torch_interop.pcnnet_variables_from_torch``), ``vn_dgcnn_fps``,
  ``dgcnn_fps`` and ``vn_pointr`` (the inverses of
  ``vn_dgcnn_fps_from_state_dict``, ``dgcnn_fps_from_state_dict`` and
  ``vn_pointr_from_state_dict``, the reference's ``VN_DGCNN_fps``,
  ``DGCNN_fps`` and ``VN_PCTransformer`` keys).  vn_pointr's scanned tail
  ``encoder_scan`` (parameters and statistics stacked on a leading axis) is
  unstacked into the blocks ``encoder.1`` .. ``encoder.5``, and its coarse
  head ``vn_coarse_pred.2``, which the JAX mapping leaves out (the
  reference's head is 1024 wide), is carried too;
- decoders ``vn_foldingnet``, ``attention_vn_foldingnet`` and
  ``foldingnet``.  A fold layer's split kernels are joined back into the
  reference's single weight, columns [global | seed | point] for
  ``vn_foldingnet``, [var | feat] for the attention decoder's pair folds.
  The JAX package maps no reference ``FoldingNet`` or attention decoder
  checkpoint; their keys here are those of the reference modules
  (``final_conv`` Sequential: Conv1d, BatchNorm1d, ReLU, Conv1d,
  BatchNorm1d, ReLU, Conv1d; ``downsize_global``, ``transformer.{0,1}``,
  ``vn_folding{1,2}.{0,1,2}``).

It also reads the tree of a standalone model, told by its top-level keys:
``PCN`` (``first_conv_0``), ``VNPCN`` (a top-level ``trunk``) and ``DGCNN``
(``transform_net``).  The JAX package maps no reference checkpoint for
them; their keys here are those of the reference's Sequentials
(``first_conv``, ``second_conv``, ``mlp``, ``final_conv`` of PCN; the
VN-PointNet trunk's own for VNPCN; ``transform_net.{conv1,conv2,conv3,
linear1,bn3,linear2,bn4,transform}``, ``conv1`` .. ``conv6``, ``mlp`` of
DGCNN).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _vnllr(sd: dict, key: str, p: Mapping, s: Mapping) -> None:
    bn_p = p["batchnorm"]["BatchNorm_0"]
    bn_s = s["batchnorm"]["BatchNorm_0"]
    sd[f"{key}.map_to_feat.weight"] = p["kernel"]
    sd[f"{key}.map_to_dir.weight"] = p["dir_kernel"]
    sd[f"{key}.batchnorm.bn.weight"] = bn_p["scale"]
    sd[f"{key}.batchnorm.bn.bias"] = bn_p["bias"]
    sd[f"{key}.batchnorm.bn.running_mean"] = bn_s["mean"]
    sd[f"{key}.batchnorm.bn.running_var"] = bn_s["var"]


def _conv(sd: dict, key: str, p: Mapping, kernel_dims: int = 1) -> None:
    k = np.asarray(p["kernel"])
    sd[f"{key}.weight"] = k.reshape(k.shape + (1,) * kernel_dims)
    if "bias" in p:
        sd[f"{key}.bias"] = p["bias"]


def _bn(sd: dict, key: str, p: Mapping, s: Mapping) -> None:
    p, s = p["BatchNorm_0"], s["BatchNorm_0"]
    sd[f"{key}.weight"], sd[f"{key}.bias"] = p["scale"], p["bias"]
    sd[f"{key}.running_mean"], sd[f"{key}.running_var"] = s["mean"], s["var"]


def _vnlalr(sd: dict, key: str, p: Mapping, s: Mapping) -> None:
    """VNLinearAndLeakyReLU with its norm-BatchNorm."""
    sd[f"{key}.linear.map_to_feat.weight"] = p["linear"]["kernel"]
    sd[f"{key}.leaky_relu.map_to_dir.weight"] = p["leaky_relu"]["dir_kernel"]
    _bn(sd, f"{key}.batchnorm.bn", p["batchnorm"], s["batchnorm"])


def _vn_block(sd: dict, key: str, p: Mapping, s: Mapping) -> None:
    """VNBlock: norms, attention maps, conv1/conv2 where it has the kNN
    branch, conv3/conv4."""
    for norm in ("norm1", "norm2"):
        ln = p[norm]["LayerNorm_0"]
        sd[f"{key}.{norm}.layer_norm.weight"] = ln["scale"]
        sd[f"{key}.{norm}.layer_norm.bias"] = ln["bias"]
    for name in ("proj_vnq", "proj_vnk", "proj_vnv", "proj_vn"):
        sd[f"{key}.attn.{name}.map_to_feat.weight"] = p["attn"][name]["kernel"]
    for conv in ("conv1", "conv3", "conv4"):
        if conv in p:
            _vnllr(sd, f"{key}.{conv}", p[conv], s[conv])
    if "conv2" in p:
        sd[f"{key}.conv2.map_to_feat.weight"] = p["conv2"]["kernel"]


def _unstack(tree, i: int):
    """Layer i of a tree stacked on a leading axis (flax ``nn.scan``)."""
    if isinstance(tree, Mapping):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _vn_pointr(sd: dict, p: Mapping, s: Mapping) -> None:
    e = "encoder"
    for conv, key in (("conv1", "conv1.0"), ("conv4", "conv4"), ("conv5", "conv5"),
                      ("conv6", "conv6")):
        _vnllr(sd, f"{e}.grouper.{key}", p["grouper"][conv], s["grouper"][conv])
    _vnllr(sd, f"{e}.vn_input_proj.0", p["vn_input_proj_0"], s["vn_input_proj_0"])
    sd[f"{e}.vn_input_proj.1.map_to_feat.weight"] = p["vn_input_proj_1"]["kernel"]
    _vnlalr(sd, f"{e}.fourth_vn_pos_embed.0", p["fourth_vn_pos_embed_0"],
            s["fourth_vn_pos_embed_0"])
    sd[f"{e}.fourth_vn_pos_embed.1.map_to_feat.weight"] = p["fourth_vn_pos_embed_1"]["kernel"]
    heads = sorted(int(k.split("_")[1]) for k in p if k.startswith("encoder_")
                   and k != "encoder_scan")
    for i in heads:
        _vn_block(sd, f"{e}.encoder.{i}", p[f"encoder_{i}"], s[f"encoder_{i}"])
    if "encoder_scan" in p:
        tail_p, tail_s = p["encoder_scan"]["block"], s["encoder_scan"]["block"]
        depth = np.asarray(tail_p["norm1"]["LayerNorm_0"]["scale"]).shape[0]
        for j in range(depth):
            _vn_block(sd, f"{e}.encoder.{len(heads) + j}", _unstack(tail_p, j),
                      _unstack(tail_s, j))
    _vnlalr(sd, f"{e}.vn_increase_dim.0", p["vn_increase_dim_0"], s["vn_increase_dim_0"])
    sd[f"{e}.vn_increase_dim.1.map_to_feat.weight"] = p["vn_increase_dim_1"]["kernel"]
    sd[f"{e}.vn_global_pool.map_to_dir.weight"] = p["vn_global_pool"]["dir_kernel"]
    sd[f"{e}.vn_coarse_pred.0.map_to_feat.weight"] = p["vn_coarse_pred_0"]["kernel"]
    sd[f"{e}.vn_coarse_pred.1.map_to_dir.weight"] = p["vn_coarse_pred_1"]["dir_kernel"]
    sd[f"{e}.vn_coarse_pred.2.map_to_feat.weight"] = p["vn_coarse_pred_2"]["kernel"]


def _vn_pointnet(sd: dict, t: Mapping, ts: Mapping, e: str = "encoder.") -> None:
    _vnllr(sd, f"{e}first_conv.0", t["first_conv_0"], ts["first_conv_0"])
    sd[f"{e}first_conv.1.map_to_feat.weight"] = t["first_conv_1"]["kernel"]
    sd[f"{e}maxpool1.map_to_dir.weight"] = t["maxpool1"]["dir_kernel"]
    _vnllr(sd, f"{e}second_conv.0", t["second_conv_0"], ts["second_conv_0"])
    sd[f"{e}second_conv.1.map_to_feat.weight"] = t["second_conv_1"]["kernel"]
    sd[f"{e}maxpool2.map_to_dir.weight"] = t["maxpool2"]["dir_kernel"]
    for i in (0, 1):
        m = t[f"mlp_{i}"]
        sd[f"{e}mlp.{i}.linear.map_to_feat.weight"] = m["linear"]["kernel"]
        sd[f"{e}mlp.{i}.leaky_relu.map_to_dir.weight"] = m["leaky_relu"]["dir_kernel"]
    sd[f"{e}mlp.2.map_to_feat.weight"] = t["mlp_2"]["kernel"]


def _vn_dgcnn_fps(sd: dict, p: Mapping, s: Mapping) -> None:
    for jax_key, key in (("conv1", "conv1.0"), ("conv4", "conv4"), ("conv5", "conv5"),
                         ("conv6", "conv6"), ("conv7_0", "conv7.0")):
        _vnllr(sd, f"encoder.{key}", p[jax_key], s[jax_key])
    sd["encoder.conv7.1.map_to_feat.weight"] = p["conv7_1"]["kernel"]
    sd["encoder.pool5.map_to_dir.weight"] = p["pool5"]["dir_kernel"]


def _dgcnn_fps(sd: dict, p: Mapping, s: Mapping) -> None:
    e = "encoder"
    _conv(sd, f"{e}.input_trans", p["input_trans"])
    for i in (1, 2, 3, 4):
        _conv(sd, f"{e}.layer{i}.0", p[f"layer{i}_conv"], kernel_dims=2)
        gn = p[f"layer{i}_gn"]
        sd[f"{e}.layer{i}.1.weight"], sd[f"{e}.layer{i}.1.bias"] = gn["scale"], gn["bias"]
    _conv(sd, f"{e}.increase_dim.0", p["increase_dim_0"])
    _bn(sd, f"{e}.increase_dim.1", p["increase_bn"], s["increase_bn"])
    _conv(sd, f"{e}.increase_dim.3", p["increase_dim_1"])
    for jax_key, key in (("coarse_pred_0", "coarse_pred.0"), ("coarse_pred_1", "coarse_pred.2")):
        sd[f"{e}.{key}.weight"] = p[jax_key]["kernel"]
        sd[f"{e}.{key}.bias"] = p[jax_key]["bias"]


def _vn_foldingnet(sd: dict, d: Mapping, ds: Mapping) -> None:
    f0 = d["final_conv_0"]
    joined = {
        "kernel": np.concatenate(
            [f0["kernel_global"], f0["kernel_seed"], f0["kernel_point"]], axis=1),
        "dir_kernel": np.concatenate(
            [f0["dir_kernel_global"], f0["dir_kernel_seed"], f0["dir_kernel_point"]], axis=1),
        "batchnorm": f0["batchnorm"],
    }
    _vnllr(sd, "decoder.final_conv.0", joined, ds["final_conv_0"])
    _vnllr(sd, "decoder.final_conv.1", d["final_conv_1"], ds["final_conv_1"])
    sd["decoder.final_conv.2.map_to_feat.weight"] = d["final_conv_2"]["kernel"]


def _attention_vn_foldingnet(sd: dict, d: Mapping, ds: Mapping) -> None:
    sd["decoder.downsize_global.map_to_feat.weight"] = d["downsize_global"]["kernel"]
    for i in (0, 1):
        _vn_block(sd, f"decoder.transformer.{i}", d[f"transformer_{i}"], ds[f"transformer_{i}"])
    for stage in ("vn_folding1", "vn_folding2"):
        f0 = d[f"{stage}_0"]
        joined = {
            "kernel": np.concatenate([f0["kernel_var"], f0["kernel_feat"]], axis=1),
            "dir_kernel": np.concatenate([f0["dir_kernel_var"], f0["dir_kernel_feat"]], axis=1),
            "batchnorm": f0["batchnorm"],
        }
        _vnllr(sd, f"decoder.{stage}.0", joined, ds[f"{stage}_0"])
        _vnllr(sd, f"decoder.{stage}.1", d[f"{stage}_1"], ds[f"{stage}_1"])
        sd[f"decoder.{stage}.2.map_to_feat.weight"] = d[f"{stage}_2"]["kernel"]


def _foldingnet(sd: dict, d: Mapping, ds: Mapping, e: str = "decoder.") -> None:
    f0 = d["final_conv_0"]
    w = np.concatenate([f0["kernel_global"], f0["kernel_seed"], f0["kernel_point"]], axis=1)
    _conv(sd, f"{e}final_conv.0", {"kernel": w, "bias": f0["bias"]})
    _bn(sd, f"{e}final_conv.1", d["final_bn_0"], ds["final_bn_0"])
    _conv(sd, f"{e}final_conv.3", d["final_conv_1"])
    _bn(sd, f"{e}final_conv.4", d["final_bn_1"], ds["final_bn_1"])
    _conv(sd, f"{e}final_conv.6", d["final_conv_2"])


def _pcn(sd: dict, p: Mapping, s: Mapping) -> None:
    for seq in ("first", "second"):
        _conv(sd, f"{seq}_conv.0", p[f"{seq}_conv_0"])
        _bn(sd, f"{seq}_conv.1", p[f"{seq}_bn"], s[f"{seq}_bn"])
        _conv(sd, f"{seq}_conv.3", p[f"{seq}_conv_1"])
    for i in range(3):
        _conv(sd, f"mlp.{2 * i}", p[f"mlp_{i}"], kernel_dims=0)
    if "final_conv_0" in p:
        _foldingnet(sd, p, s, e="")


def _dgcnn(sd: dict, p: Mapping, s: Mapping) -> None:
    t, ts = p["transform_net"], s["transform_net"]
    for i, dims in ((1, 2), (2, 2), (3, 1)):
        _conv(sd, f"transform_net.conv{i}.0", t[f"conv{i}"], kernel_dims=dims)
        _bn(sd, f"transform_net.conv{i}.1", t[f"bn{i}"], ts[f"bn{i}"])
    for i, bn in ((1, 4), (2, 5)):
        _conv(sd, f"transform_net.linear{i}", t[f"linear{i}"], kernel_dims=0)
        _bn(sd, f"transform_net.bn{bn - 1}", t[f"bn{bn}"], ts[f"bn{bn}"])
    sd["transform_net.transform.weight"] = np.asarray(t["transform_kernel"]).T
    sd["transform_net.transform.bias"] = t["transform_bias"]
    for i in range(1, 7):
        _conv(sd, f"conv{i}.0", p[f"conv{i}_conv"], kernel_dims=1 if i == 6 else 2)
        _bn(sd, f"conv{i}.1", p[f"conv{i}_bn"], s[f"conv{i}_bn"])
    for i in range(3):
        _conv(sd, f"mlp.{2 * i}", p[f"mlp_{i}"], kernel_dims=0)


def state_dict_from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{params, batch_stats}`` of a JAX PCNNet, or of a standalone PCN,
    VNPCN or DGCNN -> port state_dict."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict = {}
    if "encoder" not in params:  # a standalone model
        if "first_conv_0" in params:
            _pcn(sd, params, stats)
        elif "trunk" in params:
            _vn_pointnet(sd, params["trunk"], stats["trunk"], e="")
        else:
            _dgcnn(sd, params, stats)
        return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    enc, enc_s = params["encoder"], stats.get("encoder", {})
    if "trunk" in enc:
        _vn_pointnet(sd, enc["trunk"], enc_s["trunk"])
    elif "grouper" in enc:
        _vn_pointr(sd, enc, enc_s)
    elif "conv1" in enc:
        _vn_dgcnn_fps(sd, enc, enc_s)
    else:
        _dgcnn_fps(sd, enc, enc_s)
    if "decoder" in params:
        d, ds = params["decoder"], stats["decoder"]
        if "final_bn_0" in d:
            _foldingnet(sd, d, ds)
        elif "downsize_global" in d:
            _attention_vn_foldingnet(sd, d, ds)
        else:
            _vn_foldingnet(sd, d, ds)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
