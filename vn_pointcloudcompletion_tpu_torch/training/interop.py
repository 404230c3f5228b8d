"""JAX variables -> the port's ``state_dict`` (reference key layout).

:func:`state_dict_from_jax_variables` is the exact inverse of
``vn_pointcloudcompletion_tpu/training/torch_interop.py
::pcnnet_variables_from_torch`` for the flagship ``vn_pointnet`` +
``vn_foldingnet`` pipeline.  It reads the ``{params, batch_stats}`` tree of a
JAX ``PCNNet`` (any array-likes: numpy, or JAX arrays converted by numpy) and
needs no JAX itself.  The first fold layer's split kernels are joined back
into the reference's single (256, latent + 2) weight, columns
[global | seed | point].
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


def state_dict_from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{params, batch_stats}`` of a JAX flagship PCNNet -> port state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    t, ts = params["encoder"]["trunk"], stats["encoder"]["trunk"]
    sd: dict = {}
    e = "encoder"
    _vnllr(sd, f"{e}.first_conv.0", t["first_conv_0"], ts["first_conv_0"])
    sd[f"{e}.first_conv.1.map_to_feat.weight"] = t["first_conv_1"]["kernel"]
    sd[f"{e}.maxpool1.map_to_dir.weight"] = t["maxpool1"]["dir_kernel"]
    _vnllr(sd, f"{e}.second_conv.0", t["second_conv_0"], ts["second_conv_0"])
    sd[f"{e}.second_conv.1.map_to_feat.weight"] = t["second_conv_1"]["kernel"]
    sd[f"{e}.maxpool2.map_to_dir.weight"] = t["maxpool2"]["dir_kernel"]
    for i in (0, 1):
        m = t[f"mlp_{i}"]
        sd[f"{e}.mlp.{i}.linear.map_to_feat.weight"] = m["linear"]["kernel"]
        sd[f"{e}.mlp.{i}.leaky_relu.map_to_dir.weight"] = m["leaky_relu"]["dir_kernel"]
    sd[f"{e}.mlp.2.map_to_feat.weight"] = t["mlp_2"]["kernel"]

    if "decoder" in params:
        d, ds = params["decoder"], stats["decoder"]
        f0 = d["final_conv_0"]
        joined = {
            "kernel": np.concatenate(
                [f0["kernel_global"], f0["kernel_seed"], f0["kernel_point"]], axis=1),
            "dir_kernel": np.concatenate(
                [f0["dir_kernel_global"], f0["dir_kernel_seed"],
                 f0["dir_kernel_point"]], axis=1),
            "batchnorm": f0["batchnorm"],
        }
        _vnllr(sd, "decoder.final_conv.0", joined, ds["final_conv_0"])
        _vnllr(sd, "decoder.final_conv.1", d["final_conv_1"], ds["final_conv_1"])
        sd["decoder.final_conv.2.map_to_feat.weight"] = d["final_conv_2"]["kernel"]
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
