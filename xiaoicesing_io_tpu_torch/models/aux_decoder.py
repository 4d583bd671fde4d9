"""Auxiliary (shallow-diffusion source) mel decoder: a 1D ConvNeXt stack.

Counterpart of the JAX ``ConvNeXtDecoder``; parameter names follow the
reference (``inconv``, ``conv.{i}.{dwconv,norm,pwconv1,pwconv2,gamma}``,
``outconv``).  Layout ``[B, T, C]`` at the boundary.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import same_pad


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int, layer_scale_init_value: float = 1e-6,
                 dropout: float = 0.0):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), layer_scale_init_value))
                      if layer_scale_init_value > 0 else None)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dwconv(F.pad(x.transpose(1, 2), same_pad(7))).transpose(1, 2)
        h = self.pwconv2(F.gelu(self.pwconv1(self.norm(h))))
        if self.gamma is not None:
            h = self.gamma * h
        return x + self.dropout(h)


class ConvNeXtDecoder(nn.Module):
    def __init__(self, in_dims: int, out_dims: int, num_channels: int = 512,
                 num_layers: int = 6, kernel_size: int = 7, dropout_rate: float = 0.1):
        super().__init__()
        self.kernel_size = kernel_size
        self.inconv = nn.Conv1d(in_dims, num_channels, kernel_size)
        self.conv = nn.ModuleList([
            ConvNeXtBlock(num_channels, num_channels * 4, 1e-6, dropout_rate)
            for _ in range(num_layers)
        ])
        self.outconv = nn.Conv1d(num_channels, out_dims, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, T, H]`` condition -> ``[B, T, out_dims]`` normalised-domain mel."""
        pad = same_pad(self.kernel_size)
        x = self.inconv(F.pad(x.transpose(1, 2), pad)).transpose(1, 2)
        for block in self.conv:
            x = block(x)
        return self.outconv(F.pad(x.transpose(1, 2), pad)).transpose(1, 2)


class AuxDecoderAdaptor(nn.Module):
    """Holds the decoder under the reference's ``decoder`` name."""

    def __init__(self, decoder: nn.Module):
        super().__init__()
        self.decoder = decoder

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(x)


AUX_DECODERS = {"convnext": ConvNeXtDecoder}


def build_aux_decoder(in_dims: int, out_dims: int, arch: str, args: dict) -> AuxDecoderAdaptor:
    from ..utils import filter_kwargs

    cls = AUX_DECODERS[arch]
    kwargs = dict(args or {})
    kwargs.update(in_dims=in_dims, out_dims=out_dims)
    return AuxDecoderAdaptor(cls(**filter_kwargs(kwargs, cls.__init__)))
