"""Acoustic toplevel model (counterpart of the JAX ``AcousticModel``).

Holds ``fs2``, ``diffusion.velocity_fn`` (the denoiser backbone) and
``aux_decoder.decoder`` under the reference DiffSinger names, so a reference
``model_ckpt_steps_*.ckpt`` state dict loads with :func:`load_acoustic_state_dict`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from .aux_decoder import build_aux_decoder
from .backbones import build_backbone
from .fastspeech.acoustic import FastSpeech2Acoustic

VARIANCE_CHECKLIST = ["energy", "breathiness", "voicing", "tension"]

# keys a reference checkpoint may carry that alias or duplicate ours
_ALIASES = ("fs2.encoder.embed_tokens.weight", "diffusion.spec_min", "diffusion.spec_max")


class _Diffusion(nn.Module):
    """Holds the denoiser as ``velocity_fn`` (rectified flow)."""

    def __init__(self, velocity_fn: nn.Module):
        super().__init__()
        self.velocity_fn = velocity_fn


class AcousticModel(nn.Module):
    def __init__(self, fs2: FastSpeech2Acoustic, backbone: nn.Module,
                 aux_decoder: Optional[nn.Module] = None):
        super().__init__()
        self.fs2 = fs2
        self.diffusion = _Diffusion(backbone)
        self.aux_decoder = aux_decoder

    @property
    def backbone(self) -> nn.Module:
        return self.diffusion.velocity_fn

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
        return AcousticModel(fs2=fs2, backbone=backbone, aux_decoder=aux)


def load_acoustic_state_dict(model: AcousticModel, state_dict: Dict[str, torch.Tensor]) -> None:
    """Load a reference-format state dict (``model.`` prefix optional)."""
    sd = {}
    for k, v in state_dict.items():
        k = k.removeprefix("model.")
        if k in _ALIASES:
            continue
        if k.endswith(".self_attn.in_proj_weight"):
            k = k.replace(".self_attn.in_proj_weight", ".self_attn.in_proj.weight")
        sd[k] = v
    model.load_state_dict(sd, strict=True)
