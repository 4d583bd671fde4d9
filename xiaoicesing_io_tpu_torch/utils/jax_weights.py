"""JAX param tree (numpy arrays) -> the port's state dict.

Carries weights from the JAX package's flax modules into the port by
inverting the JAX package's torch -> flax layout rules:

* Dense kernel ``[in, out]``           -> ``Linear`` weight ``[out, in]``
* Dense kernel of a 1x1 conv           -> ``Conv1d`` weight ``[out, in, 1]``
* Conv kernel ``[k, in, out]``         -> ``Conv1d`` weight ``[out, in, k]``
  (depthwise ``[k, 1, C]`` -> ``[C, 1, k]``)
* transposed-conv kernel ``[k, in, out]``, taps flipped -> ``ConvTranspose1d``
  weight ``[in, out, k]``, taps un-flipped
* Embed ``embedding``                  -> ``Embedding`` weight
* LayerNorm ``scale`` / ``bias``       -> ``weight`` / ``bias``

The JAX package is not imported: its trees arrive as nested dicts of arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_VARIANCES = ("energy", "breathiness", "voicing", "tension")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _linear(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _conv1x1(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None])
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _conv(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _conv_transpose(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(1, 2, 0)[:, :, ::-1])
    out[f"{name}.bias"] = _t(p["bias"])


def _layer_norm(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])


def _root(params: dict) -> dict:
    return params["params"] if "params" in params else params


def fs2_encoder_state_dict(p: dict, prefix: str, num_layers: int) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for i in range(num_layers):
        lp, lq = f"{prefix}.layers.{i}.op", p[f"layers_{i}"]
        _layer_norm(out, f"{lp}.layer_norm1", lq["layer_norm1"])
        _layer_norm(out, f"{lp}.layer_norm2", lq["layer_norm2"])
        _linear(out, f"{lp}.self_attn.in_proj", lq["self_attn"]["in_proj"])
        _linear(out, f"{lp}.self_attn.out_proj", lq["self_attn"]["out_proj"])
        _conv(out, f"{lp}.ffn.ffn_1", lq["ffn"]["ffn_1"])
        _linear(out, f"{lp}.ffn.ffn_2", lq["ffn"]["ffn_2"])
    _layer_norm(out, f"{prefix}.layer_norm", p["layer_norm"])
    return out


def lynxnet_state_dict(p: dict, prefix: str, num_layers: int) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    _conv1x1(out, f"{prefix}.input_projection", p["input_projection"])
    _linear(out, f"{prefix}.diffusion_embedding.1", p["diff_mlp_0"])
    _linear(out, f"{prefix}.diffusion_embedding.3", p["diff_mlp_1"])
    _layer_norm(out, f"{prefix}.norm", p["norm"])
    _conv1x1(out, f"{prefix}.output_projection", p["output_projection"])
    for i in range(num_layers):
        lp, lq = f"{prefix}.residual_layers.{i}", p[f"residual_layers_{i}"]
        _conv1x1(out, f"{lp}.diffusion_projection", lq["diffusion_projection"])
        _conv1x1(out, f"{lp}.conditioner_projection", lq["conditioner_projection"])
        cm, cq = f"{lp}.convmodule.net", lq["convmodule"]
        _layer_norm(out, f"{cm}.0", cq["norm"])
        _conv1x1(out, f"{cm}.2", cq["pw_in"])
        _conv(out, f"{cm}.4", cq["dw_conv"])
        if "act" in cq:
            out[f"{cm}.5.weight"] = _t(cq["act"]["alpha"])
        _conv1x1(out, f"{cm}.6", cq["pw_out"])
    return out


def convnext_state_dict(p: dict, prefix: str, num_layers: int) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    _conv(out, f"{prefix}.inconv", p["inconv"])
    _conv(out, f"{prefix}.outconv", p["outconv"])
    for i in range(num_layers):
        lp, lq = f"{prefix}.conv.{i}", p[f"conv_{i}"]
        _conv(out, f"{lp}.dwconv", lq["dwconv"])
        _layer_norm(out, f"{lp}.norm", lq["norm"])
        _linear(out, f"{lp}.pwconv1", lq["pwconv1"])
        _linear(out, f"{lp}.pwconv2", lq["pwconv2"])
        out[f"{lp}.gamma"] = _t(lq["gamma"])
    return out


def fs2_acoustic_state_dict(fs2: dict, prefix: str, enc_layers: int) -> Dict[str, torch.Tensor]:
    """A ``FastSpeech2Acoustic`` param tree -> state dict entries under ``prefix``."""
    out: Dict[str, torch.Tensor] = {f"{prefix}.txt_embed.weight": _t(fs2["txt_embed"]["embedding"])}
    _linear(out, f"{prefix}.dur_embed", fs2["dur_embed"])
    if "embedding" in fs2["pitch_embed"]:
        out[f"{prefix}.pitch_embed.weight"] = _t(fs2["pitch_embed"]["embedding"])
    else:
        _linear(out, f"{prefix}.pitch_embed", fs2["pitch_embed"])
    out.update(fs2_encoder_state_dict(fs2["encoder"], f"{prefix}.encoder", enc_layers))
    for v in _VARIANCES:
        if f"variance_embed_{v}" in fs2:
            _linear(out, f"{prefix}.variance_embeds.{v}", fs2[f"variance_embed_{v}"])
    for name in ("key_shift_embed", "speed_embed"):
        if name in fs2:
            _linear(out, f"{prefix}.{name}", fs2[name])
    if "spk_embed" in fs2:
        out[f"{prefix}.spk_embed.weight"] = _t(fs2["spk_embed"]["embedding"])
    return out


def acoustic_state_dict_from_jax(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """An ``AcousticModel`` param tree -> the port ``AcousticModel`` state dict."""
    p = _root(params)
    out = fs2_acoustic_state_dict(p["fs2"], "fs2", cfg.get("enc_layers", 4))
    backbone_type = cfg.get("backbone_type", "wavenet")
    if backbone_type != "lynxnet":
        raise NotImplementedError(f"backbone {backbone_type!r} is not ported yet")
    out.update(lynxnet_state_dict(p["backbone"], "diffusion.velocity_fn",
                                  cfg.get("backbone_args", {}).get("num_layers", 6)))
    if "aux_decoder" in p:
        shallow = cfg.get("shallow_diffusion_args", {})
        out.update(convnext_state_dict(
            p["aux_decoder"], "aux_decoder.decoder",
            shallow.get("aux_decoder_args", {}).get("num_layers", 6),
        ))
    return out


def nsf_hifigan_state_dict_from_jax(params: dict, vcfg) -> Dict[str, torch.Tensor]:
    """A NSF-HiFiGAN ``Generator`` param tree -> the port ``Generator`` state dict."""
    p = _root(params)
    out: Dict[str, torch.Tensor] = {}
    _conv(out, "conv_pre", p["conv_pre"])
    _conv(out, "conv_post", p["conv_post"])
    for i in range(len(vcfg.upsample_rates)):
        _conv_transpose(out, f"ups.{i}", p[f"ups_{i}"])
        if not vcfg.mini_nsf:
            _conv(out, f"noise_convs.{i}", p[f"noise_convs_{i}"])
    if vcfg.mini_nsf:
        _conv(out, "source_conv", p["source_conv"])
    else:
        _linear(out, "m_source.l_linear", p["source_linear"])
    n_blocks = len(vcfg.upsample_rates) * len(vcfg.resblock_kernel_sizes)
    for bi in range(n_blocks):
        block = p[f"resblocks_{bi}"]
        if vcfg.resblock == "1":
            for j in range(len(vcfg.resblock_dilation_sizes[bi % len(vcfg.resblock_kernel_sizes)])):
                _conv(out, f"resblocks.{bi}.convs1.{j}", block[f"convs1_{j}"])
                _conv(out, f"resblocks.{bi}.convs2.{j}", block[f"convs2_{j}"])
        else:
            for j in range(len(vcfg.resblock_dilation_sizes[bi % len(vcfg.resblock_kernel_sizes)])):
                _conv(out, f"resblocks.{bi}.convs.{j}", block[f"convs_{j}"])
    return out
