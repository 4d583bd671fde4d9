"""Toplevel models (counterparts of the JAX ``AcousticModel`` and ``VarianceModel``).

:class:`AcousticModel` holds ``fs2``, the denoiser backbone as
``diffusion.denoise_fn`` (DDPM) or ``diffusion.velocity_fn`` (rectified
flow) and ``aux_decoder.decoder``; :class:`VarianceModel` holds ``fs2``
(encoder and duration head), the pitch and multi-variance denoisers as
``pitch_predictor.*`` and ``variance_predictor.*``, the melody encoder and
the condition embeddings.  Both use the reference DiffSinger names, so a
reference ``model_ckpt_steps_*.ckpt`` state dict loads with
:func:`load_acoustic_state_dict` or :func:`load_variance_state_dict`.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops.seq import gather_frames
from .aux_decoder import build_aux_decoder
from .backbones import build_backbone
from .diffusion.core import SpecNormalizer
from .fastspeech.acoustic import FastSpeech2Acoustic
from .fastspeech.variance import FastSpeech2Variance, MelodyEncoder

VARIANCE_CHECKLIST = ["energy", "breathiness", "voicing", "tension"]

# keys a reference checkpoint may carry that alias or duplicate ours
_ALIASES = ("fs2.encoder.embed_tokens.weight",)
_VARIANCE_ALIASES = _ALIASES + ("melody_encoder.encoder.embed_tokens.weight",)


def _is_core_buffer(key: str, cores: Sequence[str] = ("diffusion",)) -> bool:
    """A buffer the reference diffusion core registers on itself (``spec_min``
    / ``spec_max``, and for DDPM the schedule: ``betas``, ``alphas_cumprod``,
    ...): a tensor directly under a core (``diffusion.``, or the variance
    model's ``pitch_predictor.`` and ``variance_predictor.``).  The port's
    cores hold the schedule as numpy, so the loader skips these."""
    head, _, rest = key.partition(".")
    return head in cores and rest != "" and "." not in rest


def reference_core_buffers(schedule) -> Dict[str, torch.Tensor]:
    """The schedule buffers of a reference ``GaussianDiffusion`` state dict
    (f32, under their names without the ``diffusion.`` prefix), for making
    reference-format checkpoints."""
    out = {f.name: torch.tensor(getattr(schedule, f.name), dtype=torch.float32)
           for f in fields(schedule)}
    out["log_one_minus_alphas_cumprod"] = torch.tensor(
        np.log(1.0 - schedule.alphas_cumprod), dtype=torch.float32)
    return out


class _Diffusion(nn.Module):
    """Holds the denoiser as ``denoise_fn`` (DDPM) or ``velocity_fn``
    (rectified flow), the reference's names."""

    def __init__(self, net: nn.Module, diffusion_type: str):
        super().__init__()
        self.net_name = "denoise_fn" if diffusion_type == "ddpm" else "velocity_fn"
        self.add_module(self.net_name, net)

    @property
    def net(self) -> nn.Module:
        return getattr(self, self.net_name)


class AcousticModel(nn.Module):
    def __init__(self, fs2: FastSpeech2Acoustic, backbone: nn.Module,
                 aux_decoder: Optional[nn.Module] = None, diffusion_type: str = "reflow"):
        super().__init__()
        self.fs2 = fs2
        self.diffusion = _Diffusion(backbone, diffusion_type)
        self.aux_decoder = aux_decoder

    @property
    def category(self) -> str:
        return "acoustic"

    @property
    def backbone(self) -> nn.Module:
        return self.diffusion.net

    def condition(self, txt_tokens, mel2ph, f0, key_shift=None, speed=None,
                  spk_embed_id=None, spk_mix_embed=None, variances=None) -> torch.Tensor:
        return self.fs2(txt_tokens, mel2ph, f0, key_shift=key_shift, speed=speed,
                        spk_embed_id=spk_embed_id, spk_mix_embed=spk_mix_embed,
                        variances=variances)

    def aux_out(self, condition: torch.Tensor) -> torch.Tensor:
        """Normalised-domain aux mel ``[B, T, M]``."""
        return self.aux_decoder(condition)

    def denoise(self, x, t, cond) -> torch.Tensor:
        """x ``[B, F, T, M]``; t ``[B]``; cond ``[B, T, H]``."""
        return self.backbone(x, t, cond)

    @staticmethod
    def from_config(cfg, vocab_size: int) -> "AcousticModel":
        from ..compat import get_backbone_args, get_backbone_type

        fs2 = FastSpeech2Acoustic(
            vocab_size=vocab_size,
            hidden_size=cfg.get("hidden_size", 256),
            enc_layers=cfg.get("enc_layers", 4),
            enc_ffn_kernel_size=cfg.get("enc_ffn_kernel_size", 9),
            ffn_act=cfg.get("ffn_act", "gelu"),
            dropout=cfg.get("dropout", 0.1),
            num_heads=cfg.get("num_heads", 2),
            use_pos_embed=cfg.get("use_pos_embed", True),
            use_rope=cfg.get("use_rope", False),
            rel_pos=cfg.get("rel_pos", False),
            variance_embeds=tuple(v for v in VARIANCE_CHECKLIST
                                  if cfg.get(f"use_{v}_embed", False)),
            use_key_shift_embed=cfg.get("use_key_shift_embed", False),
            use_speed_embed=cfg.get("use_speed_embed", False),
            use_spk_id=cfg.get("use_spk_id", False),
            num_spk=cfg.get("num_spk", 1),
            f0_embed_type=cfg.get("f0_embed_type", "continuous"),
        )
        backbone_type = get_backbone_type(cfg)
        backbone = build_backbone(
            out_dims=cfg["audio_num_mel_bins"], num_feats=1, backbone_type=backbone_type,
            backbone_args=get_backbone_args(cfg, backbone_type) or {},
            cond_dims=cfg.get("hidden_size", 256),
        )
        aux = None
        if cfg.get("use_shallow_diffusion", False):
            shallow = cfg.get("shallow_diffusion_args", {})
            aux = build_aux_decoder(
                in_dims=cfg.get("hidden_size", 256), out_dims=cfg["audio_num_mel_bins"],
                arch=shallow.get("aux_decoder_arch", "convnext"),
                args=shallow.get("aux_decoder_args", {}),
            )
        return AcousticModel(fs2=fs2, backbone=backbone, aux_decoder=aux,
                             diffusion_type=cfg.get("diffusion_type", "ddpm"))


class VarianceModel(nn.Module):
    """Duration, pitch and variance-curve prediction; the methods are the
    stages the variance runner composes (counterpart of the JAX
    ``VarianceModel``)."""

    def __init__(self, fs2: FastSpeech2Variance, pitch_backbone: Optional[nn.Module] = None,
                 variance_backbone: Optional[nn.Module] = None,
                 melody_encoder: Optional[nn.Module] = None,
                 variance_prediction_list: Sequence[str] = (), hidden_size: int = 256,
                 use_spk_id: bool = False, num_spk: int = 1, use_melody_encoder: bool = False,
                 predict_pitch: bool = True, pitch_diffusion_type: str = "reflow",
                 variance_diffusion_type: str = "reflow"):
        super().__init__()
        H = hidden_size
        self.fs2 = fs2
        self.variance_prediction_list = tuple(variance_prediction_list)
        self.use_spk_id = use_spk_id
        self.use_melody_encoder = use_melody_encoder
        self.predict_pitch = predict_pitch
        if use_spk_id:
            self.spk_embed = nn.Embedding(num_spk, H)
        if predict_pitch:
            self.pitch_retake_embed = nn.Embedding(2, H)
            if use_melody_encoder:
                self.melody_encoder = melody_encoder
                self.delta_pitch_embed = nn.Linear(1, H)
            else:
                self.base_pitch_embed = nn.Linear(1, H)
            self.pitch_predictor = _Diffusion(pitch_backbone, pitch_diffusion_type)
        if self.variance_prediction_list:
            self.pitch_embed = nn.Linear(1, H)
            self.variance_embeds = nn.ModuleDict(
                {v: nn.Linear(1, H) for v in self.variance_prediction_list})
            self.variance_predictor = _Diffusion(variance_backbone, variance_diffusion_type)

    @property
    def category(self) -> str:
        return "variance"

    @property
    def predict_variances(self) -> bool:
        return len(self.variance_prediction_list) > 0

    @property
    def pitch_backbone(self) -> nn.Module:
        return self.pitch_predictor.net

    @property
    def variance_backbone(self) -> nn.Module:
        return self.variance_predictor.net

    def _spk(self, spk_id, mix_embed):
        return mix_embed if mix_embed is not None else self.spk_embed(spk_id)[:, None, :]

    def encode(self, txt_tokens, midi, ph2word, ph_dur=None, word_dur=None, spk_id=None,
               ph_spk_mix_embed=None, infer: bool = True):
        """-> (encoder_out ``[B, T_ph, H]``, durations ``[B, T_ph]`` or None)."""
        spk = self._spk(spk_id, ph_spk_mix_embed) if self.use_spk_id else None
        return self.fs2(txt_tokens, midi, ph2word, ph_dur=ph_dur, word_dur=word_dur,
                        spk_embed=spk, infer=infer)

    def frame_condition(self, encoder_out, mel2ph, spk_id=None, spk_mix_embed=None):
        """Token states gathered to frames, plus the speaker embedding."""
        condition = gather_frames(encoder_out, mel2ph)
        if self.use_spk_id:
            condition = condition + self._spk(spk_id, spk_mix_embed)
        return condition

    def pitch_condition(self, condition, mel2ph, base_pitch, pitch=None, pitch_retake=None,
                        pitch_expr=None, note_midi=None, note_rest=None, note_dur=None,
                        note_glide=None, mel2note=None) -> torch.Tensor:
        """The pitch head's condition: the melody encoder's notes at frame
        level (when on), the retake embedding (mixed by ``pitch_expr`` when
        given) and the base or delta pitch embedding."""
        pitch_cond = condition
        if self.use_melody_encoder:
            notes = self.melody_encoder(note_midi, note_rest, note_dur, glide=note_glide)
            pitch_cond = pitch_cond + gather_frames(notes, mel2note)
        retake_unset = pitch_retake is None
        if retake_unset:
            pitch_retake = torch.ones_like(mel2ph, dtype=torch.bool)
        table = self.pitch_retake_embed.weight
        if pitch_expr is None:
            retake_embed = self.pitch_retake_embed(pitch_retake.long())
        else:
            expr = (pitch_expr * pitch_retake)[:, :, None]
            retake_embed = expr * table[1] + (1.0 - expr) * table[0]
        pitch_cond = pitch_cond + retake_embed
        if self.use_melody_encoder:
            delta = torch.zeros_like(base_pitch) if retake_unset \
                else (pitch - base_pitch) * ~pitch_retake
            return pitch_cond + self.delta_pitch_embed(delta[:, :, None])
        if not retake_unset:
            base_pitch = base_pitch * pitch_retake + pitch * ~pitch_retake
        return pitch_cond + self.base_pitch_embed(base_pitch[:, :, None])

    def variance_condition(self, condition, pitch, variances: Dict[str, torch.Tensor],
                           variance_retake: Optional[Dict[str, torch.Tensor]] = None):
        """The multi-variance head's condition: the pitch embedding, plus each
        given curve where it is not retaken."""
        var_cond = condition + self.pitch_embed(pitch[:, :, None])
        if variance_retake is not None:
            for v in self.variance_prediction_list:
                emb = self.variance_embeds[v](variances[v][:, :, None])
                var_cond = var_cond + emb * (~variance_retake[v])[:, :, None]
        return var_cond

    def denoise_pitch(self, x, t, cond) -> torch.Tensor:
        return self.pitch_backbone(x, t, cond)

    def denoise_variance(self, x, t, cond) -> torch.Tensor:
        return self.variance_backbone(x, t, cond)

    @staticmethod
    def from_config(cfg, vocab_size: int) -> "VarianceModel":
        from ..compat import get_backbone_args, get_backbone_type

        hidden = cfg.get("hidden_size", 256)
        dur_args = cfg.get("dur_prediction_args", {})
        fs2 = FastSpeech2Variance(
            vocab_size=vocab_size, hidden_size=hidden,
            enc_layers=cfg.get("enc_layers", 4),
            enc_ffn_kernel_size=cfg.get("enc_ffn_kernel_size", 9),
            ffn_act=cfg.get("ffn_act", "gelu"),
            dropout=cfg.get("dropout", 0.1),
            num_heads=cfg.get("num_heads", 2),
            use_pos_embed=cfg.get("use_pos_embed", True),
            use_rope=cfg.get("use_rope", False),
            rel_pos=cfg.get("rel_pos", False),
            predict_dur=cfg.get("predict_dur", True),
            dur_hidden_size=dur_args.get("hidden_size", 512),
            dur_num_layers=dur_args.get("num_layers", 5),
            dur_kernel_size=dur_args.get("kernel_size", 3),
            dur_dropout=dur_args.get("dropout", 0.1),
            dur_log_offset=dur_args.get("log_offset", 1.0),
        )
        diffusion_type = cfg.get("diffusion_type", "ddpm")

        def head(args, out_dims, num_feats):
            bt = get_backbone_type(cfg, args)
            return build_backbone(out_dims=out_dims, num_feats=num_feats, backbone_type=bt,
                                  backbone_args=get_backbone_args(args, bt) or {},
                                  cond_dims=hidden)

        predict_pitch = cfg.get("predict_pitch", True)
        pitch_backbone = melody_encoder = None
        if predict_pitch:
            pitch_backbone = head(cfg.get("pitch_prediction_args", {}),
                                  cfg.get("pitch_prediction_args", {}).get("repeat_bins", 64), 1)
            if cfg.get("use_melody_encoder", False):
                margs = cfg.get("melody_encoder_args", {})

                def menc(key, default):  # melody_encoder_args over the top-level key
                    return margs.get(key, cfg.get(key, default))

                melody_encoder = MelodyEncoder(
                    hidden_size=menc("hidden_size", 256), out_size=hidden,
                    enc_layers=menc("enc_layers", 4),
                    enc_ffn_kernel_size=menc("enc_ffn_kernel_size", 9),
                    ffn_act=menc("ffn_act", "gelu"), dropout=menc("dropout", 0.1),
                    num_heads=menc("num_heads", 2), use_pos_embed=menc("use_pos_embed", True),
                    use_rope=menc("use_rope", False), rel_pos=menc("rel_pos", False),
                    use_glide_embed=cfg.get("use_glide_embed", False),
                    num_glide_types=len(cfg.get("glide_types", ["up", "down"])),
                    glide_embed_scale=cfg.get("glide_embed_scale", 11.313708498984760),
                )
        prediction_list = tuple(v for v in VARIANCE_CHECKLIST if cfg.get(f"predict_{v}", False))
        variance_backbone = None
        if prediction_list:
            vargs = cfg.get("variances_prediction_args", {})
            total_bins = vargs.get("total_repeat_bins", 48)
            assert total_bins % len(prediction_list) == 0
            variance_backbone = head(vargs, total_bins // len(prediction_list),
                                     len(prediction_list))
        return VarianceModel(
            fs2=fs2, pitch_backbone=pitch_backbone, variance_backbone=variance_backbone,
            melody_encoder=melody_encoder, variance_prediction_list=prediction_list,
            hidden_size=hidden, use_spk_id=cfg.get("use_spk_id", False),
            num_spk=cfg.get("num_spk", 1),
            use_melody_encoder=cfg.get("use_melody_encoder", False),
            predict_pitch=predict_pitch, pitch_diffusion_type=diffusion_type,
            variance_diffusion_type=diffusion_type,
        )


def build_variance_normalizers(cfg) -> Dict[str, SpecNormalizer]:
    """The pitch head's normalizer (``pitd_norm_*``, clamped to
    ``pitd_clip_*``) and the multi-variance head's (per feature: dB curves
    over ``{v}_db_min/max`` clamped to ``[min, 0]``, tension over its logit
    range clamped to it)."""
    out = {}
    if cfg.get("predict_pitch", True):
        p = cfg.get("pitch_prediction_args", {})
        out["pitch"] = SpecNormalizer(
            spec_min=[p.get("pitd_norm_min", -8.0)], spec_max=[p.get("pitd_norm_max", 8.0)],
            num_feats=1, repeat_bins=p.get("repeat_bins", 64),
            clamps=[(p.get("pitd_clip_min", -12.0), p.get("pitd_clip_max", 12.0))],
        )
    prediction_list = [v for v in VARIANCE_CHECKLIST if cfg.get(f"predict_{v}", False)]
    if prediction_list:
        ranges, clamps = [], []
        for v in prediction_list:
            if v == "tension":
                lo, hi = cfg.get("tension_logit_min", -10.0), cfg.get("tension_logit_max", 10.0)
                ranges.append((lo, hi))
                clamps.append((lo, hi))
            else:
                lo, hi = cfg.get(f"{v}_db_min", -96.0), cfg.get(f"{v}_db_max", -12.0)
                ranges.append((lo, hi))
                clamps.append((lo, 0.0))
        total_bins = cfg.get("variances_prediction_args", {}).get("total_repeat_bins", 48)
        out["variances"] = SpecNormalizer(
            spec_min=[r[0] for r in ranges], spec_max=[r[1] for r in ranges],
            num_feats=len(prediction_list), repeat_bins=total_bins // len(prediction_list),
            clamps=clamps,
        )
    return out


def _reference_state_dict(state_dict: Dict[str, torch.Tensor], aliases, cores):
    """A reference-format state dict (``model.`` prefix optional) without the
    reference's aliases and diffusion-core buffers, under the port's names."""
    sd = {}
    for k, v in state_dict.items():
        k = k.removeprefix("model.")
        if k in aliases or _is_core_buffer(k, cores):
            continue
        if k.endswith(".self_attn.in_proj_weight"):
            k = k.replace(".self_attn.in_proj_weight", ".self_attn.in_proj.weight")
        sd[k] = v
    return sd


def load_acoustic_state_dict(model: AcousticModel, state_dict: Dict[str, torch.Tensor]) -> None:
    """Load a reference-format acoustic state dict strictly."""
    model.load_state_dict(_reference_state_dict(state_dict, _ALIASES, ("diffusion",)),
                          strict=True)


def load_variance_state_dict(model: VarianceModel, state_dict: Dict[str, torch.Tensor]) -> None:
    """Load a reference-format variance state dict strictly."""
    model.load_state_dict(_reference_state_dict(
        state_dict, _VARIANCE_ALIASES, ("pitch_predictor", "variance_predictor")), strict=True)
