"""Reference state dict -> the JAX package's flax parameter tree.

The port's copy of the JAX package's ``utils/torch_ckpt.py`` (the acoustic
and variance models), in numpy.  It maps the tensor names and layouts of a
reference-format ``model_ckpt_steps_*.ckpt`` onto the flax tree the JAX
package trains and saves, which is what the JAX-checkpoint bridge
(``training/jax_bridge.py``) holds a converted checkpoint against: the
inverse of ``utils/jax_weights.py``.  It takes torch tensors or numpy arrays
and returns numpy arrays.

Layout rules:
* torch ``Linear``  W [out, in]        -> Dense kernel [in, out] = W.T
* torch ``Conv1d``  W [out, in, k]     -> flax Conv kernel [k, in, out]
* torch depthwise Conv1d W [C, 1, k]   -> flax kernel [k, 1, C]
* torch ``ConvTranspose1d`` W [in, out, k] -> kernel [k, in, out] with
  taps flipped
* torch ``Embedding`` W                -> Embed embedding (unchanged)
* torch ``LayerNorm`` weight/bias      -> scale/bias
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def linear(sd, name):
    out = {"kernel": _np(sd[f"{name}.weight"]).T}
    if f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def conv1d(sd, name):
    w = _np(sd[f"{name}.weight"])  # [out, in, k]
    out = {"kernel": w.transpose(2, 1, 0)}
    if f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def conv1d_as_dense(sd, name):
    """1x1 Conv1d -> Dense."""
    w = _np(sd[f"{name}.weight"])  # [out, in, 1]
    out = {"kernel": w[:, :, 0].T}
    if f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def conv_transpose1d(sd, name):
    w = _np(sd[f"{name}.weight"])  # [in, out, k]
    kernel = w[:, :, ::-1].transpose(2, 0, 1)  # [k, in, out], taps flipped
    out = {"kernel": np.ascontiguousarray(kernel)}
    if f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def embedding(sd, name):
    return {"embedding": _np(sd[f"{name}.weight"])}


def layer_norm(sd, name):
    return {"scale": _np(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])}


# ---------------------------------------------------------------------------
# FastSpeech2 encoder
# ---------------------------------------------------------------------------

def convert_fs2_encoder(sd, prefix: str, num_layers: int) -> Dict:
    out = {}
    for i in range(num_layers):
        lp = f"{prefix}.layers.{i}.op"
        layer = {
            "layer_norm1": layer_norm(sd, f"{lp}.layer_norm1"),
            "layer_norm2": layer_norm(sd, f"{lp}.layer_norm2"),
        }
        # torch MultiheadAttention packs in_proj_weight [3C, C]; the RoPE
        # variant (and the port) names it in_proj.weight
        if f"{lp}.self_attn.in_proj_weight" in sd:
            w_in = _np(sd[f"{lp}.self_attn.in_proj_weight"])
        else:
            w_in = _np(sd[f"{lp}.self_attn.in_proj.weight"])
        layer["self_attn"] = {
            "in_proj": {"kernel": w_in.T},
            "out_proj": {"kernel": _np(sd[f"{lp}.self_attn.out_proj.weight"]).T},
        }
        layer["ffn"] = {
            "ffn_1": conv1d(sd, f"{lp}.ffn.ffn_1"),
            "ffn_2": linear(sd, f"{lp}.ffn.ffn_2"),
        }
        out[f"layers_{i}"] = layer
    out["layer_norm"] = layer_norm(sd, f"{prefix}.layer_norm")
    return out


# ---------------------------------------------------------------------------
# Denoiser backbones
# ---------------------------------------------------------------------------

def convert_wavenet(sd, prefix: str, num_layers: int) -> Dict:
    out = {
        "input_projection": conv1d_as_dense(sd, _join(prefix, "input_projection")),
        "mlp_0": linear(sd, _join(prefix, "mlp.0")),
        "mlp_2": linear(sd, _join(prefix, "mlp.2")),
        "skip_projection": conv1d_as_dense(sd, _join(prefix, "skip_projection")),
        "output_projection": conv1d_as_dense(sd, _join(prefix, "output_projection")),
    }
    for i in range(num_layers):
        lp = _join(prefix, f"residual_layers.{i}")
        out[f"residual_layers_{i}"] = {
            "dilated_conv": conv1d(sd, f"{lp}.dilated_conv"),
            "diffusion_projection": linear(sd, f"{lp}.diffusion_projection"),
            "conditioner_projection": conv1d_as_dense(sd, f"{lp}.conditioner_projection"),
            "output_projection": conv1d_as_dense(sd, f"{lp}.output_projection"),
        }
    return out


def convert_lynxnet(sd, prefix: str, num_layers: int) -> Dict:
    """torch Sequential indices: diffusion_embedding = [SinusoidalPosEmb,
    Linear(1), GELU, Linear(3)]; convmodule.net = [LN(0), Transpose,
    Conv1x1(2), SwiGLU, DWConv(4), PReLU(5), Conv1x1(6), Transpose,
    Dropout]."""
    out = {
        "input_projection": conv1d_as_dense(sd, _join(prefix, "input_projection")),
        "diff_mlp_0": linear(sd, _join(prefix, "diffusion_embedding.1")),
        "diff_mlp_1": linear(sd, _join(prefix, "diffusion_embedding.3")),
        "norm": layer_norm(sd, _join(prefix, "norm")),
        "output_projection": conv1d_as_dense(sd, _join(prefix, "output_projection")),
    }
    for i in range(num_layers):
        lp = _join(prefix, f"residual_layers.{i}")
        cm = f"{lp}.convmodule.net"
        dw = _np(sd[f"{cm}.4.weight"])  # [inner, 1, k]
        layer = {
            "diffusion_projection": conv1d_as_dense(sd, f"{lp}.diffusion_projection"),
            "conditioner_projection": conv1d_as_dense(sd, f"{lp}.conditioner_projection"),
            "convmodule": {
                "norm": layer_norm(sd, f"{cm}.0"),
                "pw_in": conv1d_as_dense(sd, f"{cm}.2"),
                "dw_conv": {
                    "kernel": dw.transpose(2, 1, 0),
                    "bias": _np(sd[f"{cm}.4.bias"]),
                },
                "pw_out": conv1d_as_dense(sd, f"{cm}.6"),
            },
        }
        if f"{cm}.5.weight" in sd:  # PReLU
            layer["convmodule"]["act"] = {"alpha": _np(sd[f"{cm}.5.weight"])}
        out[f"residual_layers_{i}"] = layer
    return out


def convert_backbone(sd, prefix: str, backbone_type: str, num_layers: int) -> Dict:
    if backbone_type == "wavenet":
        return convert_wavenet(sd, prefix, num_layers)
    if backbone_type == "lynxnet":
        return convert_lynxnet(sd, prefix, num_layers)
    raise NotImplementedError(backbone_type)


# ---------------------------------------------------------------------------
# ConvNeXt aux decoder
# ---------------------------------------------------------------------------

def convert_convnext(sd, prefix: str, num_layers: int) -> Dict:
    out = {
        "inconv": conv1d(sd, _join(prefix, "inconv")),
        "outconv": conv1d(sd, _join(prefix, "outconv")),
    }
    for i in range(num_layers):
        lp = _join(prefix, f"conv.{i}")
        dw = _np(sd[f"{lp}.dwconv.weight"])  # [C, 1, 7]
        out[f"conv_{i}"] = {
            "dwconv": {"kernel": dw.transpose(2, 1, 0), "bias": _np(sd[f"{lp}.dwconv.bias"])},
            "norm": layer_norm(sd, f"{lp}.norm"),
            "pwconv1": linear(sd, f"{lp}.pwconv1"),
            "pwconv2": linear(sd, f"{lp}.pwconv2"),
            "gamma": _np(sd[f"{lp}.gamma"]),
        }
    return out


# ---------------------------------------------------------------------------
# Acoustic model
# ---------------------------------------------------------------------------

def convert_acoustic(state_dict: Dict, cfg) -> Dict:
    """state dict (with 'model.' prefix stripped or present) -> params."""
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    pitch = _np(sd["fs2.pitch_embed.weight"])
    fs2 = {
        "txt_embed": embedding(sd, "fs2.txt_embed"),
        "dur_embed": linear(sd, "fs2.dur_embed"),
        # legacy checkpoints (f0_embed_type: discrete) store a [256, H]
        # embedding table instead of a Linear(1, H)
        "pitch_embed": (
            embedding(sd, "fs2.pitch_embed")
            if pitch.ndim == 2 and pitch.shape[1] != 1 and "fs2.pitch_embed.bias" not in sd
            else linear(sd, "fs2.pitch_embed")
        ),
        "encoder": convert_fs2_encoder(sd, "fs2.encoder", cfg.get("enc_layers", 4)),
    }
    for v in ("energy", "breathiness", "voicing", "tension"):
        if f"fs2.variance_embeds.{v}.weight" in sd:
            fs2[f"variance_embed_{v}"] = linear(sd, f"fs2.variance_embeds.{v}")
    if "fs2.key_shift_embed.weight" in sd:
        fs2["key_shift_embed"] = linear(sd, "fs2.key_shift_embed")
    if "fs2.speed_embed.weight" in sd:
        fs2["speed_embed"] = linear(sd, "fs2.speed_embed")
    if "fs2.spk_embed.weight" in sd:
        fs2["spk_embed"] = embedding(sd, "fs2.spk_embed")

    backbone_type = cfg.get("backbone_type", "wavenet")
    n_layers = cfg.get("backbone_args", {}).get("num_layers", 20)
    # ddpm names its net denoise_fn; rectified flow names it velocity_fn
    net = "denoise_fn" if any(
        k.startswith("diffusion.denoise_fn.") for k in sd
    ) else "velocity_fn"
    params = {
        "fs2": fs2,
        "backbone": convert_backbone(sd, f"diffusion.{net}", backbone_type, n_layers),
    }
    if any(k.startswith("aux_decoder.") for k in sd):
        shallow = cfg.get("shallow_diffusion_args", {})
        params["aux_decoder"] = convert_convnext(
            sd, "aux_decoder.decoder",
            shallow.get("aux_decoder_args", {}).get("num_layers", 6),
        )
    return {"params": params}


# ---------------------------------------------------------------------------
# Variance model
# ---------------------------------------------------------------------------

def convert_variance(state_dict: Dict, cfg) -> Dict:
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    fs2 = {
        "txt_embed": embedding(sd, "fs2.txt_embed"),
        "encoder": convert_fs2_encoder(sd, "fs2.encoder", cfg.get("enc_layers", 4)),
    }
    if "fs2.onset_embed.weight" in sd:
        fs2["onset_embed"] = embedding(sd, "fs2.onset_embed")
        fs2["word_dur_embed"] = linear(sd, "fs2.word_dur_embed")
    if "fs2.ph_dur_embed.weight" in sd:
        fs2["ph_dur_embed"] = linear(sd, "fs2.ph_dur_embed")
    if "fs2.midi_embed.weight" in sd:
        fs2["midi_embed"] = embedding(sd, "fs2.midi_embed")
    if any(k.startswith("fs2.dur_predictor.") for k in sd):
        dur_args = cfg.get("dur_prediction_args", {})
        dp = {"linear": linear(sd, "fs2.dur_predictor.linear")}
        for i in range(dur_args.get("num_layers", 5)):
            # torch Sequential: [Identity, Conv1d(1), ReLU, LayerNorm(3), Dropout]
            dp[f"conv_{i}"] = conv1d(sd, f"fs2.dur_predictor.conv.{i}.1")
            dp[f"ln_{i}"] = layer_norm(sd, f"fs2.dur_predictor.conv.{i}.3")
        fs2["dur_predictor"] = dp

    params: Dict = {"fs2": fs2}
    if "spk_embed.weight" in sd:
        params["spk_embed"] = embedding(sd, "spk_embed")
    if "pitch_retake_embed.weight" in sd:
        params["pitch_retake_embed"] = embedding(sd, "pitch_retake_embed")
    if "base_pitch_embed.weight" in sd:
        params["base_pitch_embed"] = linear(sd, "base_pitch_embed")
    if "delta_pitch_embed.weight" in sd:
        params["delta_pitch_embed"] = linear(sd, "delta_pitch_embed")
    if "pitch_embed.weight" in sd:
        params["pitch_embed"] = linear(sd, "pitch_embed")
    for v in ("energy", "breathiness", "voicing", "tension"):
        if f"variance_embeds.{v}.weight" in sd:
            params[f"variance_embed_{v}"] = linear(sd, f"variance_embeds.{v}")

    def _net(prefix):
        return "denoise_fn" if any(
            k.startswith(f"{prefix}.denoise_fn.") for k in sd
        ) else "velocity_fn"

    if any(k.startswith("pitch_predictor.") for k in sd):
        pargs = cfg.get("pitch_prediction_args", {})
        params["pitch_backbone"] = convert_backbone(
            sd, f"pitch_predictor.{_net('pitch_predictor')}",
            pargs.get("backbone_type", "wavenet"),
            pargs.get("backbone_args", {}).get("num_layers", 20),
        )
    if any(k.startswith("variance_predictor.") for k in sd):
        vargs = cfg.get("variances_prediction_args", {})
        params["variance_backbone"] = convert_backbone(
            sd, f"variance_predictor.{_net('variance_predictor')}",
            vargs.get("backbone_type", "wavenet"),
            vargs.get("backbone_args", {}).get("num_layers", 10),
        )
    if any(k.startswith("melody_encoder.") for k in sd):
        margs = cfg.get("melody_encoder_args", {})
        me = {
            "note_midi_embed": linear(sd, "melody_encoder.note_midi_embed"),
            "note_dur_embed": linear(sd, "melody_encoder.note_dur_embed"),
            "encoder": convert_fs2_encoder(
                sd, "melody_encoder.encoder", margs.get("enc_layers", 4)
            ),
            "out_proj": linear(sd, "melody_encoder.out_proj"),
        }
        if "melody_encoder.note_glide_embed.weight" in sd:
            me["note_glide_embed"] = embedding(sd, "melody_encoder.note_glide_embed")
        params["melody_encoder"] = me
    return {"params": params}
