"""Common layers: embeddings, positional encodings, attention, conv FFN.

Counterparts of the JAX package's ``models/common.py`` in feature-last
``[B, T, C]`` layout, with the reference DiffSinger parameter names.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def sinusoidal_step_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Diffusion-step embedding: ``[B]`` steps -> ``[B, dim]`` (sin | cos)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """tensor2tensor sinusoidal table lookup: int ``[B, T]`` -> ``[B, T, dim]``."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=positions.device) * -emb)
    ang = positions.float()[..., None] * freqs
    out = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


def rel_positional_encoding(t: int, dim: int, max_len: int = 5000,
                            device=None) -> torch.Tensor:
    """ESPnet RelPositionalEncoding table, reversed positions, interleaved
    sin/cos.  The table is built over ``max_len`` positions and sliced to the
    first ``t`` rows, so positions run max_len-1 ... max_len-t.  -> ``[1, t, dim]``."""
    if t <= max_len:
        position = torch.arange(max_len - 1, max_len - 1 - t, -1.0, dtype=torch.float32,
                                device=device)[:, None]
    else:
        position = torch.arange(t - 1, -1, -1.0, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                         * (-math.log(10000.0) / dim))
    pe = torch.stack([torch.sin(position * div_term), torch.cos(position * div_term)],
                     dim=2).reshape(t, dim)
    return pe[None]


def make_positions(tokens: torch.Tensor, padding_idx: int = 0) -> torch.Tensor:
    """Position ids counting only non-padding tokens, offset by padding_idx."""
    mask = (tokens != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


def rope_rotate(x: torch.Tensor) -> torch.Tensor:
    """Interleaved rotary rotation: (x0, x1) -> (-x1, x0) on adjacent pairs."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rope(x: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """RoPE over the full head dim of ``[B, H, T, D]``."""
    d, t = x.shape[-1], x.shape[-2]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs[None, :]
    ang = torch.repeat_interleave(ang, 2, dim=-1)
    return (x * torch.cos(ang) + rope_rotate(x) * torch.sin(ang)).to(x.dtype)


def same_pad(k: int, d: int = 1):
    """(left, right) SAME padding of a k-tap conv at dilation d."""
    total = (k - 1) * d
    return total // 2, total - total // 2


class SelfAttention(nn.Module):
    """Multi-head self-attention without biases, optionally with RoPE
    (``in_proj`` ``[3C, C]``, ``out_proj`` ``[C, C]``)."""

    def __init__(self, hidden_size: int, num_heads: int, use_rope: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.use_rope = use_rope
        self.in_proj = nn.Linear(hidden_size, 3 * hidden_size, bias=False)
        self.out_proj = nn.Linear(hidden_size, hidden_size, bias=False)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None):
        B, T, C = x.shape
        H = self.num_heads
        D = C // H
        q, k, v = self.in_proj(x).chunk(3, dim=-1)

        def heads(y):
            return y.reshape(B, T, H, D).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        if self.use_rope:
            q, k = apply_rope(q), apply_rope(k)
        scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(D)
        if padding_mask is not None:
            scores = scores.masked_fill(padding_mask[:, None, None, :],
                                        torch.finfo(torch.float32).min)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        out = (w @ v).transpose(1, 2).reshape(B, T, C)
        return self.out_proj(out)


class ConvFFN(nn.Module):
    """Transformer FFN whose first projection is a SAME-padded 1D conv,
    rescaled by k^-0.5."""

    def __init__(self, hidden_size: int, filter_size: int, kernel_size: int = 9,
                 act: str = "gelu", dropout: float = 0.0):
        super().__init__()
        if act not in ("gelu", "relu", "swish", "swiglu"):
            raise ValueError(f"unknown ffn act {act}")
        self.kernel_size = kernel_size
        self.act = act
        filter_1 = filter_size * 2 if act == "swiglu" else filter_size
        self.ffn_1 = nn.Conv1d(hidden_size, filter_1, kernel_size)
        self.ffn_2 = nn.Linear(filter_size, hidden_size)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.pad(x.transpose(1, 2), same_pad(self.kernel_size))
        h = self.ffn_1(h).transpose(1, 2) * self.kernel_size ** -0.5
        if self.act == "gelu":
            h = F.gelu(h)
        elif self.act == "relu":
            h = F.relu(h)
        elif self.act == "swish":
            h = F.silu(h)
        else:
            out, gate = h.chunk(2, dim=-1)
            h = out * F.silu(gate)
        return self.ffn_2(self.dropout(h))


class TransformerEncoderLayer(nn.Module):
    """Pre-LN self-attention + conv-FFN block, outputs zeroed at padding."""

    def __init__(self, hidden_size: int, num_heads: int, ffn_kernel_size: int = 9,
                 ffn_act: str = "gelu", dropout: float = 0.0, use_rope: bool = True):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.self_attn = SelfAttention(hidden_size, num_heads, use_rope=use_rope)
        self.layer_norm2 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.ffn = ConvFFN(hidden_size, 4 * hidden_size, kernel_size=ffn_kernel_size,
                           act=ffn_act, dropout=dropout)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        nonpad = (1.0 - padding_mask.float())[..., None]
        h = self.self_attn(self.layer_norm1(x), padding_mask)
        x = (x + self.dropout(h)) * nonpad
        h = self.ffn(self.layer_norm2(x))
        return (x + self.dropout(h)) * nonpad
