"""JAX variables -> the port's ``state_dict`` (reference key layout).

:func:`state_dict_from_jax_variables` reads the ``{params, batch_stats}``
tree of a JAX ``PCNNet`` (any array-likes: numpy, or JAX arrays converted by
numpy) and needs no JAX itself.  It tells the pipeline from the tree:

- encoders ``vn_pointnet`` (the exact inverse of the JAX package's
  ``torch_interop.pcnnet_variables_from_torch``), ``vn_dgcnn_fps``,
  ``dgcnn_fps`` and ``vn_pointr`` (the inverses of
  ``vn_dgcnn_fps_from_state_dict``, ``dgcnn_fps_from_state_dict`` and
  ``vn_pointr_from_state_dict``, the reference's ``VN_DGCNN_fps``,
  ``DGCNN_fps`` and ``VN_PCTransformer`` keys).  vn_pointr's scanned tails
  ``encoder_scan`` and ``decoder_scan`` (parameters and statistics stacked
  on a leading axis) are unstacked into the blocks ``encoder.1`` ..
  ``encoder.5`` and ``decoder.1`` .. ``decoder.7``; its coarse head
  ``vn_coarse_pred.2``, which the JAX mapping leaves out (the reference's
  head is 1024 wide), and its decoder stack (``vn_mlp_query``,
  ``decoder``), which the JAX mapping leaves at its init, are carried too,
  as are the scalar arms (``dgcnn="dgcnn"``: the ``DGCNNGrouper`` trunk,
  ``input_proj``, ``pos_embed``; ``trans="trans"``: the scalar ``Block``
  and ``DecoderBlock`` stacks, ``increase_dim``, ``coarse_pred``,
  ``mlp_query``).  A flax ``Dense`` kernel is (in, out), a torch
  ``Linear`` weight its transpose;
- decoders ``vn_foldingnet``, ``attention_vn_foldingnet`` and
  ``foldingnet``.  A fold layer's split kernels are joined back into the
  reference's single weight, columns [global | seed | point] for
  ``vn_foldingnet``, [var | feat] for the attention decoder's pair folds.
  The JAX package maps no reference ``FoldingNet`` or attention decoder
  checkpoint; their keys here are those of the reference modules
  (``final_conv`` Sequential: Conv1d, BatchNorm1d, ReLU, Conv1d,
  BatchNorm1d, ReLU, Conv1d; ``downsize_global``, ``transformer.{0,1}``,
  ``vn_folding{1,2}.{0,1,2}``, and ``query_proj`` with the decoder stack).

It also reads the tree of a standalone model, told by its top-level keys:
``PCN`` (``first_conv_0``), ``VNPCN`` (a top-level ``trunk``) and ``DGCNN``
(``transform_net``).  The JAX package maps no reference checkpoint for
them; their keys here are those of the reference's Sequentials
(``first_conv``, ``second_conv``, ``mlp``, ``final_conv`` of PCN; the
VN-PointNet trunk's own for VNPCN; ``transform_net.{conv1,conv2,conv3,
linear1,bn3,linear2,bn4,transform}``, ``conv1`` .. ``conv6``, ``mlp`` of
DGCNN).

:func:`encoder_state_dict_from_torch` carries the other outside weights
in: a reference (or port) ``.pth`` state dict -> the tensors of the port's
encoder that a pretrained-encoder load replaces, the keys of the JAX
package's ``torch_interop.encoder_variables_from_torch`` converters.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


# Encoder keys that the JAX converters leave at their init by design
# (``torch_interop.vn_pointr_from_state_dict``): vn_pointr's coarse head,
# 1024 vector channels wide in the reference where the 448-coarse contract
# needs 224, and its decoder stack (``decoder.*``, ``vn_mlp_query``), which
# the reference's only_coarse composition never runs.  The converters' other
# skipped keys (the dead ``input_proj``, ``pos_embed``,
# ``attn.qkv``/``attn.proj``, ``conv1``/``conv2`` past ``knn_layer``) are
# not in the port's encoder at all.
PRETRAINED_SKIPPED = {"vn_pointr": ("vn_coarse_pred.2.", "decoder.", "vn_mlp_query.")}


def encoder_state_dict_from_torch(sd: Mapping[str, torch.Tensor], encoder_keys,
                                  enc_type: str) -> Dict[str, torch.Tensor]:
    """The entries of a torch state dict ``sd`` (a whole ``PCNNet``'s, keys
    under ``encoder.``, or a bare encoder's) that a pretrained-encoder load
    takes, under the port encoder's own keys (``encoder_keys``, with their
    shapes: ``{key: shape}``), as JAX's converters read them: every key but
    ``PRETRAINED_SKIPPED`` is required (KeyError), with the encoder's shape
    (ValueError, as ``torch_interop.merge_partial_tree``); keys of ``sd``
    outside the encoder are ignored.  vn_pointr's wrapper is told by an
    ``encoder.grouper.`` key, since that encoder's own block stack is also
    named ``encoder.{i}``."""
    if enc_type == "vn_pointr":
        wrapped = any(k.startswith("encoder.grouper.") for k in sd)
    else:
        wrapped = any(k.startswith("encoder.") for k in sd)
    if wrapped:
        sd = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    skipped = PRETRAINED_SKIPPED.get(enc_type, ())
    wanted = {k: tuple(shape) for k, shape in encoder_keys.items()
              if not k.startswith(skipped)}
    missing = sorted(k for k in wanted if k not in sd)
    if missing:
        raise KeyError(f"pretrained {enc_type} encoder: {len(missing)} keys missing, "
                       f"first {missing[:5]}")
    out = {}
    for k, shape in wanted.items():
        t = torch.as_tensor(sd[k])
        if tuple(t.shape) != shape:
            raise ValueError(f"shape mismatch in pretrained load: {k} {shape} vs "
                             f"{tuple(t.shape)}")
        out[k] = t
    return out


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


def _ln(sd: dict, key: str, p: Mapping) -> None:
    """flax ``LayerNorm`` -> torch ``LayerNorm``."""
    sd[f"{key}.weight"], sd[f"{key}.bias"] = p["scale"], p["bias"]


def _dense(sd: dict, key: str, p: Mapping) -> None:
    """flax ``Dense`` (kernel (in, out)) -> torch ``Linear`` (weight (out, in))."""
    sd[f"{key}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        sd[f"{key}.bias"] = p["bias"]


def _cross_attention(sd: dict, key: str, p: Mapping) -> None:
    for name in ("q_map", "k_map", "v_map", "proj"):
        _dense(sd, f"{key}.{name}", p[name])


def _scalar_block(sd: dict, key: str, p: Mapping, s: Mapping = None) -> None:
    """Scalar ``Block`` or ``DecoderBlock``: norms, attention maps, the kNN
    branches where it has them, the MLP."""
    for norm in ("norm1", "norm2", "norm_q", "norm_v"):
        if norm in p:
            _ln(sd, f"{key}.{norm}", p[norm])
    attn = "self_attn" if "self_attn" in p else "attn"
    for name in ("qkv", "proj"):
        _dense(sd, f"{key}.{attn}.{name}", p[attn][name])
    if attn == "self_attn":
        _cross_attention(sd, f"{key}.attn", p["attn"])
    for name in ("knn_map", "knn_map_cross"):
        if name in p:
            _dense(sd, f"{key}.{name}.0", p[name])
    for name in ("merge_map", "merge_map_cross"):
        if name in p:
            _dense(sd, f"{key}.{name}", p[name])
    _dense(sd, f"{key}.mlp.fc1", p["mlp"]["Dense_0"])
    _dense(sd, f"{key}.mlp.fc2", p["mlp"]["Dense_1"])


def _vn_decoder_block(sd: dict, key: str, p: Mapping, s: Mapping) -> None:
    """VNDecoderBlock: scalar norms, VN self-attention, cross-attention, and
    conv1-conv4, pool1, pool2 where it has the kNN branches."""
    for norm in ("norm1", "norm_q", "norm_v"):
        _ln(sd, f"{key}.{norm}", p[norm])
    for name in ("proj_vnq", "proj_vnk", "proj_vnv", "proj_vn"):
        sd[f"{key}.self_attn.{name}.map_to_feat.weight"] = p["self_attn"][name]["kernel"]
    _cross_attention(sd, f"{key}.attn", p["attn"])
    for conv in ("conv1", "conv3"):
        if conv in p:
            _vnllr(sd, f"{key}.{conv}", p[conv], s[conv])
    for conv in ("conv2", "conv4"):
        if conv in p:
            sd[f"{key}.{conv}.map_to_feat.weight"] = p[conv]["kernel"]
    for pool in ("pool1", "pool2"):
        if pool in p:
            sd[f"{key}.{pool}.map_to_dir.weight"] = p[pool]["dir_kernel"]


def _stack(sd: dict, key: str, name: str, p: Mapping, s: Mapping, fill) -> None:
    """A block stack: the unrolled heads ``{name}_{i}``, then the scanned
    tail ``{name}_scan``, unstacked, as ``{key}.{i}``."""
    heads = sorted(int(k.rsplit("_", 1)[1]) for k in p
                   if k.startswith(f"{name}_") and k != f"{name}_scan")
    for i in heads:
        fill(sd, f"{key}.{i}", p[f"{name}_{i}"], s.get(f"{name}_{i}", {}))
    if f"{name}_scan" in p:
        tail_p = p[f"{name}_scan"]["block"]
        tail_s = s.get(f"{name}_scan", {}).get("block", {})
        norm1 = tail_p["norm1"]  # every block has one (a VNLayerNorm in VNBlock)
        depth = np.asarray(norm1.get("LayerNorm_0", norm1)["scale"]).shape[0]
        for j in range(depth):
            fill(sd, f"{key}.{len(heads) + j}", _unstack(tail_p, j), _unstack(tail_s, j))


def _seq_conv_bn(sd: dict, key: str, p: Mapping, s: Mapping, name: str, bn: str) -> None:
    """The reference's Conv1d, BatchNorm1d, LeakyReLU, Conv1d Sequential
    from ``{name}_0``, ``{bn}``, ``{name}_1``."""
    _conv(sd, f"{key}.0", p[f"{name}_0"])
    _bn(sd, f"{key}.1", p[bn], s[bn])
    _conv(sd, f"{key}.3", p[f"{name}_1"])


def _vn_pointr(sd: dict, p: Mapping, s: Mapping) -> None:
    e = "encoder"
    if "input_trans" in p["grouper"]:  # dgcnn="dgcnn"
        _scalar_trunk(sd, f"{e}.grouper", p["grouper"])
        _seq_conv_bn(sd, f"{e}.input_proj", p, s, "input_proj", "input_proj_bn")
        _seq_conv_bn(sd, f"{e}.pos_embed", p, s, "pos_embed", "pos_embed_bn")
    else:
        for conv, key in (("conv1", "conv1.0"), ("conv4", "conv4"), ("conv5", "conv5"),
                          ("conv6", "conv6")):
            _vnllr(sd, f"{e}.grouper.{key}", p["grouper"][conv], s["grouper"][conv])
        _vnllr(sd, f"{e}.vn_input_proj.0", p["vn_input_proj_0"], s["vn_input_proj_0"])
        sd[f"{e}.vn_input_proj.1.map_to_feat.weight"] = p["vn_input_proj_1"]["kernel"]
        _vnlalr(sd, f"{e}.fourth_vn_pos_embed.0", p["fourth_vn_pos_embed_0"],
                s["fourth_vn_pos_embed_0"])
        sd[f"{e}.fourth_vn_pos_embed.1.map_to_feat.weight"] = (
            p["fourth_vn_pos_embed_1"]["kernel"])
    if "vn_increase_dim_0" in p:  # trans="vn_trans"
        _stack(sd, f"{e}.encoder", "encoder", p, s, _vn_block)
        _vnlalr(sd, f"{e}.vn_increase_dim.0", p["vn_increase_dim_0"], s["vn_increase_dim_0"])
        sd[f"{e}.vn_increase_dim.1.map_to_feat.weight"] = p["vn_increase_dim_1"]["kernel"]
        sd[f"{e}.vn_global_pool.map_to_dir.weight"] = p["vn_global_pool"]["dir_kernel"]
        sd[f"{e}.vn_coarse_pred.0.map_to_feat.weight"] = p["vn_coarse_pred_0"]["kernel"]
        sd[f"{e}.vn_coarse_pred.1.map_to_dir.weight"] = p["vn_coarse_pred_1"]["dir_kernel"]
        sd[f"{e}.vn_coarse_pred.2.map_to_feat.weight"] = p["vn_coarse_pred_2"]["kernel"]
        if "vn_mlp_query_0" in p:
            for i in (0, 1):
                _vnllr(sd, f"{e}.vn_mlp_query.{i}", p[f"vn_mlp_query_{i}"],
                       s[f"vn_mlp_query_{i}"])
            sd[f"{e}.vn_mlp_query.2.map_to_feat.weight"] = p["vn_mlp_query_2"]["kernel"]
            _stack(sd, f"{e}.decoder", "decoder", p, s, _vn_decoder_block)
    else:
        _stack(sd, f"{e}.encoder", "encoder", p, s, _scalar_block)
        _seq_conv_bn(sd, f"{e}.increase_dim", p, s, "increase_dim", "increase_bn")
        _coarse_pred(sd, e, p)
        if "mlp_query_0" in p:
            for i in range(3):
                _conv(sd, f"{e}.mlp_query.{2 * i}", p[f"mlp_query_{i}"])
            _stack(sd, f"{e}.decoder", "decoder", p, s, _scalar_block)


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


def _scalar_trunk(sd: dict, key: str, p: Mapping) -> None:
    """The scalar EdgeConv trunk (JAX ``scalar_edge_trunk``) of ``DGCNNfps``
    and ``DGCNNGrouper``."""
    _conv(sd, f"{key}.input_trans", p["input_trans"])
    for i in (1, 2, 3, 4):
        _conv(sd, f"{key}.layer{i}.0", p[f"layer{i}_conv"], kernel_dims=2)
        gn = p[f"layer{i}_gn"]
        sd[f"{key}.layer{i}.1.weight"], sd[f"{key}.layer{i}.1.bias"] = gn["scale"], gn["bias"]


def _coarse_pred(sd: dict, e: str, p: Mapping) -> None:
    """The scalar coarse head: Linear, ReLU, Linear (JAX ``DenseTorch``
    kernels are (out, in) already)."""
    for jax_key, key in (("coarse_pred_0", "coarse_pred.0"), ("coarse_pred_1", "coarse_pred.2")):
        _conv(sd, f"{e}.{key}", p[jax_key], kernel_dims=0)


def _dgcnn_fps(sd: dict, p: Mapping, s: Mapping) -> None:
    e = "encoder"
    _scalar_trunk(sd, e, p)
    _seq_conv_bn(sd, f"{e}.increase_dim", p, s, "increase_dim", "increase_bn")
    _coarse_pred(sd, e, p)


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
    if "query_proj" in d:
        sd["decoder.query_proj.map_to_feat.weight"] = d["query_proj"]["kernel"]
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
