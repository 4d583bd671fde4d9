"""Alignment ops on ``[B, T]`` tensors (counterparts of the JAX package's ``ops/seq.py``).

* :func:`length_regulator` -- token durations (optionally scaled by
  ``alpha``) -> 1-based frame-to-token map ``mel2ph`` with a fixed output
  length (0 = no phoneme);
* :func:`mel2ph_to_dur` -- the inverse count, optionally clipped at
  ``max_dur``;
* :func:`rhythm_regulator` -- phoneme durations rescaled so that each word's
  total matches the given word duration;
* :func:`gather_frames` -- token states to frame level, ``mel2ph == 0``
  gathering a zero vector;
* :func:`stretch_regulator` -- the progress of each frame within its
  phoneme, in ``[0, 1)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def length_regulator(dur: torch.Tensor, out_len: int,
                     alpha: Optional[float] = None) -> torch.Tensor:
    """int ``[B, T_txt]`` durations -> int64 ``mel2ph`` ``[B, out_len]``.
    ``alpha`` scales the durations first, rounding the f32 product half to
    even."""
    if alpha is not None:
        dur = torch.round(dur.float() * alpha)
    dur = dur.long()
    dur_cumsum = torch.cumsum(dur, dim=1)
    dur_cumsum_prev = dur_cumsum - dur
    pos = torch.arange(out_len, device=dur.device)[None, None, :]
    token_mask = (pos >= dur_cumsum_prev[:, :, None]) & (pos < dur_cumsum[:, :, None])
    token_idx = torch.arange(1, dur.shape[1] + 1, device=dur.device)[None, :, None]
    return (token_idx * token_mask.long()).sum(dim=1)


def mel2ph_to_dur(mel2ph: torch.Tensor, t_txt: int,
                  max_dur: Optional[int] = None) -> torch.Tensor:
    """Frames per token, ``[B, t_txt]``; ``mel2ph`` is 1-based, 0 = padding.
    ``max_dur`` clips each count."""
    B = mel2ph.shape[0]
    dur = torch.zeros(B, t_txt + 1, dtype=torch.long, device=mel2ph.device)
    dur.scatter_add_(1, mel2ph.long(), torch.ones_like(mel2ph, dtype=torch.long))
    dur = dur[:, 1:]
    return dur if max_dur is None else dur.clamp(max=max_dur)


def rhythm_regulator(ph_dur: torch.Tensor, ph2word: torch.Tensor, word_dur: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Scale ``ph_dur`` ``[B, T_ph]`` so that each word's phonemes sum to its
    ``word_dur`` ``[B, T_w]``; ``ph2word`` is the 1-based word of each
    phoneme (0 = padding).  -> int64 rounded durations ``[B, T_ph]``."""
    ph2word = ph2word.long()
    ph_dur = ph_dur.float() * (ph2word > 0)
    word_dur_in = torch.zeros(ph_dur.shape[0], word_dur.shape[1] + 1, device=ph_dur.device)
    word_dur_in.scatter_add_(1, ph2word, ph_dur)
    alpha_w = word_dur.float() / torch.clamp(word_dur_in[:, 1:], min=eps)
    alpha_ph = torch.gather(F.pad(alpha_w, (1, 0)), 1, ph2word)
    return torch.round(ph_dur * alpha_ph).long()


def gather_frames(encoder_out: torch.Tensor, mel2ph: torch.Tensor) -> torch.Tensor:
    """``[B, T_txt, H]`` token states -> ``[B, T_frames, H]``."""
    padded = F.pad(encoder_out, (0, 0, 1, 0))
    idx = mel2ph.long()[:, :, None].expand(-1, -1, encoder_out.shape[-1])
    return torch.gather(padded, 1, idx)


def stretch_regulator(mel2ph: torch.Tensor, dur: torch.Tensor) -> torch.Tensor:
    """f32 ``[B, T_frames]`` progress of each frame within its phoneme:
    ``mel2ph`` ``[B, T_frames]`` is 1-based, ``dur`` ``[B, T_txt]`` the
    phonemes' frame counts; padding frames (``mel2ph == 0``) get 0."""
    mel2ph = mel2ph.long()
    dur_pad = F.pad(dur.long(), (1, 0), value=1)  # padding frames divide by 1
    mel2dur = torch.gather(dur_pad, 1, mel2ph).float()
    bound = F.pad(mel2ph[:, 1:] > mel2ph[:, :-1], (0, 1), value=True)
    stretch_delta = 1.0 - bound * mel2dur
    stretch_delta = F.pad(stretch_delta[:, :-1], (1, 0))
    stretch = torch.cumsum(stretch_delta, dim=1) / mel2dur
    return stretch * (mel2ph > 0)
