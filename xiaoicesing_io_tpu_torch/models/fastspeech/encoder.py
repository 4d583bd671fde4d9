"""FastSpeech2 transformer encoder (counterpart of the JAX ``FastSpeech2Encoder``).

Scaled main embedding + additive extra embedding, optional positional
encoding (RoPE inside attention, else ESPnet relative or absolute
sinusoidal), N pre-LN transformer layers with conv FFN, final LayerNorm, all
gated by the padding mask.  Parameter names follow the reference
(``layers.{i}.op.*``, ``layer_norm``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..common import (
    TransformerEncoderLayer,
    make_positions,
    rel_positional_encoding,
    sinusoidal_positions,
)


class _Op(nn.Module):
    """Holds a layer under the reference's ``.op`` name."""

    def __init__(self, op: nn.Module):
        super().__init__()
        self.op = op

    def forward(self, *args):
        return self.op(*args)


class FastSpeech2Encoder(nn.Module):
    def __init__(self, hidden_size: int = 256, num_layers: int = 4, ffn_kernel_size: int = 9,
                 ffn_act: str = "gelu", dropout: float = 0.1, num_heads: int = 2,
                 use_pos_embed: bool = True, use_rope: bool = True, rel_pos: bool = True):
        super().__init__()
        self.hidden_size = hidden_size
        self.use_pos_embed = use_pos_embed
        self.use_rope = use_rope
        self.rel_pos = rel_pos
        self.dropout = nn.Dropout(dropout)
        self.layers = nn.ModuleList([
            _Op(TransformerEncoderLayer(
                hidden_size, num_heads, ffn_kernel_size=ffn_kernel_size, ffn_act=ffn_act,
                dropout=dropout, use_rope=use_pos_embed and use_rope,
            ))
            for _ in range(num_layers)
        ])
        self.layer_norm = nn.LayerNorm(hidden_size, eps=1e-5)

    def forward(self, main_embed: torch.Tensor, extra_embed: Optional[torch.Tensor],
                padding_mask: torch.Tensor) -> torch.Tensor:
        """main_embed ``[B, T, H]`` (unscaled token embedding), extra_embed
        ``[B, T, H]`` or None, padding_mask bool ``[B, T]`` (True at padding)."""
        H = self.hidden_size
        x = main_embed * math.sqrt(H)
        if extra_embed is not None:
            x = x + extra_embed
        if self.use_pos_embed and not self.use_rope:
            if self.rel_pos:
                x = x * math.sqrt(H) + rel_positional_encoding(x.shape[1], H, device=x.device)
            else:
                positions = make_positions(1 - padding_mask.long(), padding_idx=0)
                x = x + sinusoidal_positions(positions, H)
        x = self.dropout(x)
        nonpad = (1.0 - padding_mask.float())[..., None]
        x = x * nonpad
        for layer in self.layers:
            x = layer(x, padding_mask) * nonpad
        return self.layer_norm(x) * nonpad
