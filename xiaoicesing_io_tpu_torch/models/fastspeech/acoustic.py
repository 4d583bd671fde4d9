"""Acoustic-model linguistic encoder (counterpart of the JAX ``FastSpeech2Acoustic``).

Token + duration embeddings -> transformer encoder -> frame-level gather by
``mel2ph`` -> additive speaker / pitch / variance / key-shift / speed
embeddings: the diffusion condition ``[B, T_frames, H]``.  Parameter names
follow the reference (``txt_embed``, ``dur_embed``, ``pitch_embed``,
``variance_embeds.*``, ...).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from ...ops.seq import gather_frames, mel2ph_to_dur
from .encoder import FastSpeech2Encoder

# legacy coarse-f0 quantisation
_F0_BIN = 256
_F0_MEL_MIN = 1127.0 * math.log(1.0 + 50.0 / 700.0)
_F0_MEL_MAX = 1127.0 * math.log(1.0 + 1100.0 / 700.0)


def f0_to_coarse(f0: torch.Tensor) -> torch.Tensor:
    """Quantise f0 (Hz) into the legacy 256-bin coarse mel scale."""
    f0_mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    a = (_F0_BIN - 2) / (_F0_MEL_MAX - _F0_MEL_MIN)
    b = _F0_MEL_MIN * a - 1.0
    f0_mel = torch.where(f0_mel > 0, f0_mel * a - b, f0_mel)
    f0_mel = torch.clamp(f0_mel, 1.0, float(_F0_BIN - 1))
    return torch.round(f0_mel).long()


class FastSpeech2Acoustic(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int = 256, enc_layers: int = 4,
                 enc_ffn_kernel_size: int = 9, ffn_act: str = "gelu", dropout: float = 0.1,
                 num_heads: int = 2, use_pos_embed: bool = True, use_rope: bool = True,
                 rel_pos: bool = True, variance_embeds: Sequence[str] = (),
                 use_key_shift_embed: bool = False, use_speed_embed: bool = False,
                 use_spk_id: bool = False, num_spk: int = 1,
                 f0_embed_type: str = "continuous"):
        super().__init__()
        H = hidden_size
        self.f0_embed_type = f0_embed_type
        self.txt_embed = nn.Embedding(vocab_size, H, padding_idx=0)
        self.dur_embed = nn.Linear(1, H)
        self.encoder = FastSpeech2Encoder(
            hidden_size=H, num_layers=enc_layers, ffn_kernel_size=enc_ffn_kernel_size,
            ffn_act=ffn_act, dropout=dropout, num_heads=num_heads,
            use_pos_embed=use_pos_embed, use_rope=use_rope, rel_pos=rel_pos,
        )
        self.use_spk_id = use_spk_id
        if use_spk_id:
            self.spk_embed = nn.Embedding(num_spk, H)
        if f0_embed_type == "discrete":
            self.pitch_embed = nn.Embedding(_F0_BIN, H)
        else:
            self.pitch_embed = nn.Linear(1, H)
        self.variance_embed_list = tuple(variance_embeds)
        if self.variance_embed_list:
            self.variance_embeds = nn.ModuleDict({v: nn.Linear(1, H) for v in variance_embeds})
        self.use_key_shift_embed = use_key_shift_embed
        if use_key_shift_embed:
            self.key_shift_embed = nn.Linear(1, H)
        self.use_speed_embed = use_speed_embed
        if use_speed_embed:
            self.speed_embed = nn.Linear(1, H)

    def forward(self, txt_tokens, mel2ph, f0, key_shift=None, speed=None, spk_embed_id=None,
                spk_mix_embed=None, variances: Optional[dict] = None) -> torch.Tensor:
        txt_embed = self.txt_embed(txt_tokens)
        dur = mel2ph_to_dur(mel2ph, txt_tokens.shape[1]).float()
        dur_embed = self.dur_embed(dur[:, :, None])
        encoder_out = self.encoder(txt_embed, dur_embed, txt_tokens == 0)
        condition = gather_frames(encoder_out, mel2ph)

        if self.use_spk_id:
            spk = spk_mix_embed if spk_mix_embed is not None \
                else self.spk_embed(spk_embed_id)[:, None, :]
            condition = condition + spk
        if self.f0_embed_type == "discrete":
            condition = condition + self.pitch_embed(f0_to_coarse(f0))
        else:
            f0_mel = torch.log(1.0 + f0 / 700.0)
            condition = condition + self.pitch_embed(f0_mel[:, :, None])
        for v_name in self.variance_embed_list:
            condition = condition + self.variance_embeds[v_name](variances[v_name][:, :, None])
        if self.use_key_shift_embed:
            condition = condition + self.key_shift_embed(key_shift[:, :, None])
        if self.use_speed_embed:
            condition = condition + self.speed_embed(speed[:, :, None])
        return condition
