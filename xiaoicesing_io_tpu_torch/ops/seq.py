"""Alignment ops on ``[B, T]`` tensors (counterparts of the JAX package's ``ops/seq.py``).

* :func:`length_regulator` -- token durations -> 1-based frame-to-token map
  ``mel2ph`` with a fixed output length (0 = no phoneme);
* :func:`mel2ph_to_dur` -- the inverse count;
* :func:`gather_frames` -- token states to frame level, ``mel2ph == 0``
  gathering a zero vector.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def length_regulator(dur: torch.Tensor, out_len: int) -> torch.Tensor:
    """int ``[B, T_txt]`` durations -> int64 ``mel2ph`` ``[B, out_len]``."""
    dur = dur.long()
    dur_cumsum = torch.cumsum(dur, dim=1)
    dur_cumsum_prev = dur_cumsum - dur
    pos = torch.arange(out_len, device=dur.device)[None, None, :]
    token_mask = (pos >= dur_cumsum_prev[:, :, None]) & (pos < dur_cumsum[:, :, None])
    token_idx = torch.arange(1, dur.shape[1] + 1, device=dur.device)[None, :, None]
    return (token_idx * token_mask.long()).sum(dim=1)


def mel2ph_to_dur(mel2ph: torch.Tensor, t_txt: int) -> torch.Tensor:
    """Frames per token, ``[B, t_txt]``; ``mel2ph`` is 1-based, 0 = padding."""
    B = mel2ph.shape[0]
    dur = torch.zeros(B, t_txt + 1, dtype=torch.long, device=mel2ph.device)
    dur.scatter_add_(1, mel2ph.long(), torch.ones_like(mel2ph, dtype=torch.long))
    return dur[:, 1:]


def gather_frames(encoder_out: torch.Tensor, mel2ph: torch.Tensor) -> torch.Tensor:
    """``[B, T_txt, H]`` token states -> ``[B, T_frames, H]``."""
    padded = F.pad(encoder_out, (0, 0, 1, 0))
    idx = mel2ph.long()[:, :, None].expand(-1, -1, encoder_out.shape[-1])
    return torch.gather(padded, 1, idx)
