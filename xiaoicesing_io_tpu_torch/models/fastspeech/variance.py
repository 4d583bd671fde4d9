"""Variance-model encoders (counterparts of the JAX ``models/fastspeech/variance.py``).

* :class:`DurationPredictor` -- a conv stack over the encoder output that
  predicts log-domain phoneme durations and returns them in frames;
* :class:`FastSpeech2Variance` -- the linguistic encoder: token embedding plus
  word onsets and word durations (word mode, with the duration head) or
  phoneme durations (phoneme mode), through the transformer encoder;
* :class:`MelodyEncoder` -- a small transformer over the notes (MIDI pitch,
  duration and, optionally, the glide type) for the pitch head.

Parameter names follow the reference (``txt_embed``, ``onset_embed``,
``word_dur_embed``, ``ph_dur_embed``, ``midi_embed``,
``dur_predictor.conv.{i}.{1,3}``, ``dur_predictor.linear``,
``note_midi_embed``, ``note_dur_embed``, ``note_glide_embed``, ``out_proj``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import same_pad
from .encoder import FastSpeech2Encoder


class DurationPredictor(nn.Module):
    """Conv (SAME) -> ReLU -> LayerNorm (eps 1e-12) -> mask, ``n_layers``
    times, then a linear head; ``exp(x) - offset`` in frames, clamped at 0
    for inference.  Each layer is the reference's ``Sequential(Identity,
    Conv1d, ReLU, LayerNorm, Dropout)``."""

    def __init__(self, in_dims: int, n_layers: int = 2, n_chans: int = 384,
                 kernel_size: int = 3, dropout_rate: float = 0.1, offset: float = 1.0):
        super().__init__()
        self.kernel_size = kernel_size
        self.offset = offset
        self.conv = nn.ModuleList([
            nn.Sequential(nn.Identity(), nn.Conv1d(in_dims if i == 0 else n_chans, n_chans,
                                                   kernel_size),
                          nn.ReLU(), nn.LayerNorm(n_chans, eps=1e-12), nn.Dropout(dropout_rate))
            for i in range(n_layers)
        ])
        self.linear = nn.Linear(n_chans, 1)

    def forward(self, xs: torch.Tensor, x_masks: torch.Tensor, infer: bool = True):
        """xs ``[B, T, H]``, x_masks bool ``[B, T]`` (True at padding) ->
        durations ``[B, T]`` in frames."""
        nonpad = (1.0 - x_masks.float())[..., None]
        for layer in self.conv:
            _, conv, act, norm, drop = layer
            h = conv(F.pad(xs.transpose(1, 2), same_pad(self.kernel_size))).transpose(1, 2)
            xs = drop(norm(act(h))) * nonpad
        xs = self.linear(xs) * nonpad
        dur = torch.exp(xs[..., 0]) - self.offset
        return torch.clamp(dur, min=0.0) if infer else dur


class FastSpeech2Variance(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int = 256, enc_layers: int = 4,
                 enc_ffn_kernel_size: int = 3, ffn_act: str = "gelu", dropout: float = 0.1,
                 num_heads: int = 2, use_pos_embed: bool = True, use_rope: bool = True,
                 rel_pos: bool = True, predict_dur: bool = True, dur_hidden_size: int = 512,
                 dur_num_layers: int = 5, dur_kernel_size: int = 3, dur_dropout: float = 0.1,
                 dur_log_offset: float = 1.0):
        super().__init__()
        H = hidden_size
        self.predict_dur = predict_dur
        self.txt_embed = nn.Embedding(vocab_size, H, padding_idx=0)
        if predict_dur:
            self.onset_embed = nn.Embedding(2, H)
            self.word_dur_embed = nn.Linear(1, H)
        else:
            self.ph_dur_embed = nn.Linear(1, H)
        self.encoder = FastSpeech2Encoder(
            hidden_size=H, num_layers=enc_layers, ffn_kernel_size=enc_ffn_kernel_size,
            ffn_act=ffn_act, dropout=dropout, num_heads=num_heads,
            use_pos_embed=use_pos_embed, use_rope=use_rope, rel_pos=rel_pos,
        )
        if predict_dur:
            self.midi_embed = nn.Embedding(128, H)
            self.dur_predictor = DurationPredictor(
                H, n_layers=dur_num_layers, n_chans=dur_hidden_size,
                kernel_size=dur_kernel_size, dropout_rate=dur_dropout, offset=dur_log_offset,
            )

    def forward(self, txt_tokens, midi, ph2word, ph_dur=None, word_dur=None, spk_embed=None,
                infer: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """txt_tokens, midi, ph2word (1-based) ``[B, T_ph]``; ``ph_dur``
        ``[B, T_ph]`` or ``word_dur`` ``[B, T_w]`` in frames; ``spk_embed``
        ``[B, T_ph|1, H]`` -> (encoder_out ``[B, T_ph, H]``, durations
        ``[B, T_ph]`` or None)."""
        txt_embed = self.txt_embed(txt_tokens)
        if self.predict_dur:
            onset = F.pad(ph2word[:, 1:] > ph2word[:, :-1], (1, 0), value=True) & (ph2word > 0)
            onset_embed = self.onset_embed(onset.long())
            if word_dur is None or not infer:
                word_dur = torch.zeros(ph2word.shape[0], ph2word.shape[1] + 1,
                                       device=ph2word.device)
                word_dur = word_dur.scatter_add_(1, ph2word.long(), ph_dur.float())[:, 1:]
            ph_word_dur = torch.gather(F.pad(word_dur.float(), (1, 0)), 1, ph2word.long())
            extra = onset_embed + self.word_dur_embed(ph_word_dur[:, :, None])
        else:
            extra = self.ph_dur_embed(ph_dur.float()[:, :, None])
        encoder_out = self.encoder(txt_embed, extra, txt_tokens == 0)
        if not self.predict_dur:
            return encoder_out, None
        dur_cond = encoder_out + self.midi_embed(midi)
        if spk_embed is not None:
            dur_cond = dur_cond + spk_embed
        return encoder_out, self.dur_predictor(dur_cond, txt_tokens == 0, infer=infer)


class MelodyEncoder(nn.Module):
    def __init__(self, hidden_size: int = 128, out_size: int = 256, enc_layers: int = 4,
                 enc_ffn_kernel_size: int = 3, ffn_act: str = "gelu", dropout: float = 0.1,
                 num_heads: int = 2, use_pos_embed: bool = True, use_rope: bool = True,
                 rel_pos: bool = True, use_glide_embed: bool = False, num_glide_types: int = 2,
                 glide_embed_scale: float = 11.313708498984760):
        super().__init__()
        H = hidden_size
        self.use_glide_embed = use_glide_embed
        self.glide_embed_scale = glide_embed_scale
        self.note_midi_embed = nn.Linear(1, H)
        self.note_dur_embed = nn.Linear(1, H)
        if use_glide_embed:
            self.note_glide_embed = nn.Embedding(num_glide_types + 1, H, padding_idx=0)
        self.encoder = FastSpeech2Encoder(
            hidden_size=H, num_layers=enc_layers, ffn_kernel_size=enc_ffn_kernel_size,
            ffn_act=ffn_act, dropout=dropout, num_heads=num_heads,
            use_pos_embed=use_pos_embed, use_rope=use_rope, rel_pos=rel_pos,
        )
        self.out_proj = nn.Linear(H, out_size)

    def forward(self, note_midi, note_rest, note_dur, glide=None) -> torch.Tensor:
        """note_midi float ``[B, T_n]`` (-1 at padding), note_rest bool,
        note_dur int (frames), glide int (0 none) -> ``[B, T_n, out_size]``."""
        midi_embed = self.note_midi_embed(note_midi[:, :, None]) * (~note_rest)[:, :, None]
        extra = self.note_dur_embed(note_dur.float()[:, :, None])
        if self.use_glide_embed:
            extra = extra + self.note_glide_embed(glide) * self.glide_embed_scale
        return self.out_proj(self.encoder(midi_embed, extra, note_midi < 0))
