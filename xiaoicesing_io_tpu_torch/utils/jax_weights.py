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
* 2-D Conv kernel ``[kh, kw, in, out]`` -> ``Conv2d`` weight ``[out, in, kh, kw]``
* RMVPE's transposed-conv kernel ``[kh, kw, in, out]``, taps flipped ->
  ``ConvTranspose2d`` weight ``[in, out, kh, kw]``, taps un-flipped
* BatchNorm ``scale / bias / mean / var`` -> ``weight / bias / running_mean /
  running_var``
* GRU / LSTM ``w_ih`` ``[in, G*H]`` and ``w_hh`` ``[H, G*H]`` (torch's gate
  order) -> ``weight_ih_l0`` / ``weight_hh_l0`` ``[G*H, in]``, the backward
  direction under ``_reverse``

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


def wavenet_state_dict(p: dict, prefix: str, num_layers: int) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    _conv1x1(out, f"{prefix}.input_projection", p["input_projection"])
    _linear(out, f"{prefix}.mlp.0", p["mlp_0"])
    _linear(out, f"{prefix}.mlp.2", p["mlp_2"])
    _conv1x1(out, f"{prefix}.skip_projection", p["skip_projection"])
    _conv1x1(out, f"{prefix}.output_projection", p["output_projection"])
    for i in range(num_layers):
        lp, lq = f"{prefix}.residual_layers.{i}", p[f"residual_layers_{i}"]
        _conv(out, f"{lp}.dilated_conv", lq["dilated_conv"])
        _linear(out, f"{lp}.diffusion_projection", lq["diffusion_projection"])
        _conv1x1(out, f"{lp}.conditioner_projection", lq["conditioner_projection"])
        _conv1x1(out, f"{lp}.output_projection", lq["output_projection"])
    return out


_BACKBONES = {"lynxnet": lynxnet_state_dict, "wavenet": wavenet_state_dict}


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
    # DDPM names its net denoise_fn, rectified flow velocity_fn
    net = "denoise_fn" if cfg.get("diffusion_type", "ddpm") == "ddpm" else "velocity_fn"
    out.update(_BACKBONES[backbone_type](p["backbone"], f"diffusion.{net}",
                                         cfg.get("backbone_args", {}).get("num_layers", 20)))
    if "aux_decoder" in p:
        shallow = cfg.get("shallow_diffusion_args", {})
        out.update(convnext_state_dict(
            p["aux_decoder"], "aux_decoder.decoder",
            shallow.get("aux_decoder_args", {}).get("num_layers", 6),
        ))
    return out


def variance_state_dict_from_jax(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """A ``VarianceModel`` param tree -> the port ``VarianceModel`` state dict."""
    p = _root(params)
    fs2 = p["fs2"]
    out: Dict[str, torch.Tensor] = {"fs2.txt_embed.weight": _t(fs2["txt_embed"]["embedding"])}
    out.update(fs2_encoder_state_dict(fs2["encoder"], "fs2.encoder", cfg.get("enc_layers", 4)))
    for name in ("onset_embed", "midi_embed"):
        if name in fs2:
            out[f"fs2.{name}.weight"] = _t(fs2[name]["embedding"])
    for name in ("word_dur_embed", "ph_dur_embed"):
        if name in fs2:
            _linear(out, f"fs2.{name}", fs2[name])
    if "dur_predictor" in fs2:
        dp = fs2["dur_predictor"]
        for i in range(cfg.get("dur_prediction_args", {}).get("num_layers", 5)):
            _conv(out, f"fs2.dur_predictor.conv.{i}.1", dp[f"conv_{i}"])
            _layer_norm(out, f"fs2.dur_predictor.conv.{i}.3", dp[f"ln_{i}"])
        _linear(out, "fs2.dur_predictor.linear", dp["linear"])
    for name in ("spk_embed", "pitch_retake_embed"):
        if name in p:
            out[f"{name}.weight"] = _t(p[name]["embedding"])
    for name in ("base_pitch_embed", "delta_pitch_embed", "pitch_embed"):
        if name in p:
            _linear(out, name, p[name])
    for v in _VARIANCES:
        if f"variance_embed_{v}" in p:
            _linear(out, f"variance_embeds.{v}", p[f"variance_embed_{v}"])
    # DDPM names its nets denoise_fn, rectified flow velocity_fn
    net = "denoise_fn" if cfg.get("diffusion_type", "ddpm") == "ddpm" else "velocity_fn"
    for head, tree, default_layers in (("pitch", "pitch_backbone", 20),
                                       ("variances", "variance_backbone", 10)):
        if tree in p:
            args = cfg.get(f"{head}_prediction_args", {})
            predictor = "pitch_predictor" if head == "pitch" else "variance_predictor"
            out.update(_BACKBONES[args.get("backbone_type", "wavenet")](
                p[tree], f"{predictor}.{net}",
                args.get("backbone_args", {}).get("num_layers", default_layers)))
    if "melody_encoder" in p:
        me = p["melody_encoder"]
        _linear(out, "melody_encoder.note_midi_embed", me["note_midi_embed"])
        _linear(out, "melody_encoder.note_dur_embed", me["note_dur_embed"])
        if "note_glide_embed" in me:
            out["melody_encoder.note_glide_embed.weight"] = _t(me["note_glide_embed"]["embedding"])
        out.update(fs2_encoder_state_dict(
            me["encoder"], "melody_encoder.encoder",
            cfg.get("melody_encoder_args", {}).get("enc_layers", 4)))
        _linear(out, "melody_encoder.out_proj", me["out_proj"])
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


# ---------------------------------------------------------------------------
# the binarizers' nets: RMVPE (E2E0) and the vocal remover (CascadedNet)
# ---------------------------------------------------------------------------

def _conv2d(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _batch_norm(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])
    out[f"{name}.running_mean"] = _t(p["mean"])
    out[f"{name}.running_var"] = _t(p["var"])


def _recurrent(out: dict, name: str, fwd: dict, bwd: dict) -> None:
    for suffix, p in (("", fwd), ("_reverse", bwd)):
        out[f"{name}.weight_ih_l0{suffix}"] = _t(np.asarray(p["w_ih"]).T)
        out[f"{name}.weight_hh_l0{suffix}"] = _t(np.asarray(p["w_hh"]).T)
        out[f"{name}.bias_ih_l0{suffix}"] = _t(p["b_ih"])
        out[f"{name}.bias_hh_l0{suffix}"] = _t(p["b_hh"])


def _conv_block_res(out: dict, name: str, p: dict) -> None:
    _conv2d(out, f"{name}.conv.0", p["conv1"])
    _batch_norm(out, f"{name}.conv.1", p["bn1"])
    _conv2d(out, f"{name}.conv.3", p["conv2"])
    _batch_norm(out, f"{name}.conv.4", p["bn2"])
    if "shortcut" in p:
        _conv2d(out, f"{name}.shortcut", p["shortcut"])


def rmvpe_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """The JAX ``E2E0`` tree -> the reference ``E2E0`` state dict (the
    inverse of the JAX package's ``convert_rmvpe``); depth and width follow
    the tree.  ``unet.tf`` has no JAX counterpart and is left out."""
    p = _root(params)
    out: Dict[str, torch.Tensor] = {}
    _batch_norm(out, "unet.encoder.bn", p["in_bn"])

    def blocks(layer: dict, name: str) -> None:
        for j in range(sum(k.startswith("conv_") for k in layer)):
            _conv_block_res(out, f"{name}.{j}", layer[f"conv_{j}"])

    for i in range(sum(k.startswith("enc_") for k in p)):
        blocks(p[f"enc_{i}"], f"unet.encoder.layers.{i}.conv")
    for i in range(sum(k.startswith("inter_") for k in p)):
        blocks(p[f"inter_{i}"], f"unet.intermediate.layers.{i}.conv")
    for i in range(sum(k.startswith("dec_") for k in p)):
        name = f"unet.decoder.layers.{i}"
        kernel = np.asarray(p[f"dec_{i}"]["tconv_kernel"])  # [kh, kw, in, out], taps flipped
        out[f"{name}.conv1.0.weight"] = _t(kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
        _batch_norm(out, f"{name}.conv1.1", p[f"dec_{i}"]["tbn"])
        blocks(p[f"dec_{i}"], f"{name}.conv2")
    _conv2d(out, "cnn", p["cnn"])
    _recurrent(out, "fc.0.gru", p["gru"]["fwd"], p["gru"]["bwd"])
    _linear(out, "fc.1", p["fc"])
    return out


def _conv_bn_activ(out: dict, name: str, p: dict) -> None:
    _conv2d(out, f"{name}.conv.0", p["conv"])
    _batch_norm(out, f"{name}.conv.1", p["bn"])


def _vr_basenet(out: dict, name: str, p: dict) -> None:
    _conv_bn_activ(out, f"{name}.enc1", p["enc1"])
    for enc in ("enc2", "enc3", "enc4", "enc5"):
        _conv_bn_activ(out, f"{name}.{enc}.conv1", p[enc]["conv1"])
        _conv_bn_activ(out, f"{name}.{enc}.conv2", p[enc]["conv2"])
    aspp = p["aspp"]
    _conv_bn_activ(out, f"{name}.aspp.conv1.1", aspp["conv1"])
    for conv in ("conv2", "conv3", "conv4", "conv5", "bottleneck"):
        _conv_bn_activ(out, f"{name}.aspp.{conv}", aspp[conv])
    for dec in ("dec4", "dec3", "dec2", "dec1"):
        _conv_bn_activ(out, f"{name}.{dec}.conv1", p[dec]["conv1"])
    lstm = p["lstm_dec2"]
    _conv_bn_activ(out, f"{name}.lstm_dec2.conv", lstm["conv"])
    _recurrent(out, f"{name}.lstm_dec2.lstm", lstm["fwd"], lstm["bwd"])
    _linear(out, f"{name}.lstm_dec2.dense.0", lstm["dense"])
    _batch_norm(out, f"{name}.lstm_dec2.dense.1", lstm["dense_bn"])


def cascaded_net_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """The JAX ``CascadedNet`` tree -> the reference state dict (the inverse of
    the JAX package's ``convert_cascaded_net``).  The reference's training
    head ``aux_out`` has no JAX counterpart and is left out."""
    p = _root(params)
    out: Dict[str, torch.Tensor] = {}
    for jax_name, name in (("stg1_low", "stg1_low_band_net.0"),
                           ("stg1_high", "stg1_high_band_net"),
                           ("stg2_low", "stg2_low_band_net.0"),
                           ("stg2_high", "stg2_high_band_net"),
                           ("stg3_full", "stg3_full_band_net")):
        _vr_basenet(out, name, p[jax_name])
    _conv_bn_activ(out, "stg1_low_band_net.1", p["stg1_low_out"])
    _conv_bn_activ(out, "stg2_low_band_net.1", p["stg2_low_out"])
    _conv2d(out, "out", p["out"])
    return out
