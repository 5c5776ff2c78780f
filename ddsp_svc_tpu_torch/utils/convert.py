"""The weight bridge: the JAX package's flax variables -> the port's
state_dict (the synthesizers, NSF-HiFiGAN, HuBERT and CREPE).

Each function takes the flax variable tree as nested dicts of numpy arrays
and inverts the layouts that `ddsp_svc_tpu/utils/convert.py` documents:
    Conv             (k, in, out) -> (out, in, k)
    Dense            (in, out)    -> (out, in)
    ConvTranspose    (k, in, out) -> (in, out, k)
    WeightNormDense  g (out,), v (in, out) -> weight_g (out, 1), weight_v
    PCmer projections from the `constants` collection.
The keys are the port's, which are the reference model's own.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _conv(p: Mapping) -> Dict[str, torch.Tensor]:
    out = {"weight": _t(np.asarray(p["kernel"]).transpose(2, 1, 0))}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def _dense(p: Mapping) -> Dict[str, torch.Tensor]:
    return {"weight": _t(np.asarray(p["kernel"]).T), "bias": _t(p["bias"])}


def _pointwise(p: Mapping) -> Dict[str, torch.Tensor]:
    """A Dense applied per frame -> a kernel-1 conv (out, in, 1)."""
    return {"weight": _t(np.asarray(p["kernel"]).T[:, :, None]),
            "bias": _t(p["bias"])}


def _norm(p: Mapping) -> Dict[str, torch.Tensor]:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def _put(sd: Dict[str, torch.Tensor], prefix: str, tensors: Mapping) -> None:
    for k, v in tensors.items():
        sd[f"{prefix}.{k}"] = v


def jax_synth_to_torch(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Synthesizer flax variables {'params', 'constants'} -> state_dict, for
    Sins, CombSub and CombSubFast alike: each holds one Unit2Control, and
    they differ only in the width of its output layer (dense_out)."""
    p = variables["params"]["unit2ctrl"]
    consts = variables["constants"]["unit2ctrl"]["decoder"]
    sd: Dict[str, torch.Tensor] = {}
    u = "unit2ctrl"
    _put(sd, f"{u}.unit_prenet.1", _conv(p["prenet_conv0"]["Conv_0"]))
    _put(sd, f"{u}.unit_prenet.2", _norm(p["prenet_gn"]))
    _put(sd, f"{u}.unit_prenet.4", _conv(p["prenet_conv1"]["Conv_0"]))
    for name in ("f0_embed", "phase_embed", "volume_embed"):
        _put(sd, f"{u}.{name}", _dense(p[name]))
    sd[f"{u}.spk_embed.weight"] = _t(p["spk_embed"]["embedding"])
    _put(sd, f"{u}.dec_post.1", _norm(p["norm"]))
    wn = p["dense_out"]
    sd[f"{u}.dec_post.2.weight_g"] = _t(np.asarray(wn["g"])[:, None])
    sd[f"{u}.dec_post.2.weight_v"] = _t(np.asarray(wn["v"]).T)
    sd[f"{u}.dec_post.2.bias"] = _t(wn["bias"])
    layers = p["decoder"]
    for i in range(len(layers)):
        lp = f"{u}.dec_post.0.net.{i}"
        layer = layers[f"layer_{i}"]
        _put(sd, f"{lp}.norm", _norm(layer["norm"]))
        for name in ("to_q", "to_k", "to_v", "to_out"):
            _put(sd, f"{lp}.attn.{name}", _dense(layer["attn"][name]))
        sd[f"{lp}.attn.fast_attention.projection_matrix"] = _t(
            consts[f"layer_{i}"]["attn"]["projection"])
        conv = layer["conv"]
        _put(sd, f"{lp}.local_mixer.net.0", _norm(conv["LayerNorm_0"]))
        _put(sd, f"{lp}.local_mixer.net.2", _pointwise(conv["Dense_0"]))
        _put(sd, f"{lp}.local_mixer.net.4", _conv(conv["Conv1d_0"]["Conv_0"]))
        _put(sd, f"{lp}.local_mixer.net.6", _pointwise(conv["Dense_1"]))
    return sd


def jax_nsf_to_torch(params: Mapping, h: Mapping) -> Dict[str, torch.Tensor]:
    """NSF-HiFiGAN Generator flax params (the 'params' collection) ->
    state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _put(sd, "conv_pre", _conv(params["conv_pre"]))
    _put(sd, "conv_post", _conv(params["conv_post"]))
    _put(sd, "m_source.l_linear", _dense(params["source_linear"]))
    n_k = len(h["resblock_kernel_sizes"])
    n_dil = len(h["resblock_dilation_sizes"][0])
    for i in range(len(h["upsample_rates"])):
        up = params[f"up_{i}"]
        sd[f"ups.{i}.weight"] = _t(np.asarray(up["kernel"]).transpose(1, 2, 0))
        sd[f"ups.{i}.bias"] = _t(up["bias"])
        _put(sd, f"noise_convs.{i}", _conv(params[f"noise_conv_{i}"]))
        for j in range(n_k):
            block = params[f"resblock_{i}_{j}"]
            rp = f"resblocks.{i * n_k + j}"
            for m in range(n_dil):
                _put(sd, f"{rp}.convs1.{m}", _conv(block[f"conv1_{m}"]))
                _put(sd, f"{rp}.convs2.{m}", _conv(block[f"conv2_{m}"]))
    return sd


def jax_hubert_to_torch(variables: Mapping) -> Dict[str, torch.Tensor]:
    """HubertSoft flax variables ({'params': ...}) -> the port's
    `nn/hubert.py` state_dict (the bshall names, positional conv folded),
    for any variant: the layers present and `proj` if there is one."""
    p = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    fe = p["feature_extractor"]
    for i in range(7):
        sd[f"feature_extractor.conv{i}.weight"] = _conv(fe[f"conv{i}"])["weight"]
    sd["feature_extractor.norm0.weight"] = _t(fe["norm0_scale"])
    sd["feature_extractor.norm0.bias"] = _t(fe["norm0_bias"])
    fp = p["feature_projection"]
    _put(sd, "feature_projection.norm", _norm(fp["norm"]))
    _put(sd, "feature_projection.projection", _dense(fp["projection"]))
    _put(sd, "positional_embedding.conv", _conv(p["positional_embedding"]["conv"]))
    _put(sd, "norm", _norm(p["norm"]))
    i = 0
    while f"layer_{i}" in p:
        layer, lp = p[f"layer_{i}"], f"encoder.layers.{i}"
        sd[f"{lp}.self_attn.in_proj_weight"] = _t(
            np.asarray(layer["in_proj"]["kernel"]).T)
        sd[f"{lp}.self_attn.in_proj_bias"] = _t(layer["in_proj"]["bias"])
        _put(sd, f"{lp}.self_attn.out_proj", _dense(layer["out_proj"]))
        for name in ("linear1", "linear2"):
            _put(sd, f"{lp}.{name}", _dense(layer[name]))
        for name in ("norm1", "norm2"):
            _put(sd, f"{lp}.{name}", _norm(layer[name]))
        i += 1
    if "proj" in p:
        _put(sd, "proj", _dense(p["proj"]))
    return sd


def jax_crepe_to_torch(variables: Mapping) -> Dict[str, torch.Tensor]:
    """CrepeFull flax variables ({'params': ...}, BatchNorm folded) -> the
    port's `nn/crepe.py` state_dict."""
    p = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for i in range(1, 7):
        _put(sd, f"conv{i}", _conv(p[f"conv{i}"]))
        sd[f"bn{i}_scale"] = _t(p[f"bn{i}_scale"])
        sd[f"bn{i}_bias"] = _t(p[f"bn{i}_bias"])
    _put(sd, "classifier", _dense(p["classifier"]))
    return sd
