"""LYNXNet denoiser backbone, plain f32 module (counterpart of the JAX ``LYNXNet``).

Per-layer conditioner and diffusion-step projections feeding a residual
module of LayerNorm -> 1x1 conv (2x inner) -> SwiGLU -> depthwise conv(k) ->
PReLU -> 1x1 conv; optional ``strong_cond`` front injection; final LayerNorm;
zero-initialised output projection.  Parameter names follow the reference
(``input_projection``, ``diffusion_embedding.{1,3}``,
``residual_layers.{i}.{diffusion_projection,conditioner_projection}``,
``residual_layers.{i}.convmodule.net.{0,2,4,5,6}``, ``norm``,
``output_projection``); 1x1 convs keep the torch ``Conv1d`` weight shape.

This module is the f32 reference; the inference path with the CUDA kernel is
``lynx_cuda.lynx_denoiser_apply``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import sinusoidal_step_embedding


def dense(conv_or_linear: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``Conv1d`` or a ``Linear`` applied to feature-last ``x``, with the
    weights cast to ``x``'s dtype."""
    w = conv_or_linear.weight
    if w.dim() == 3:
        w = w[:, :, 0]
    b = conv_or_linear.bias
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


class Transpose(nn.Module):
    def __init__(self, dims=(1, 2)):
        super().__init__()
        self.dims = dims

    def forward(self, x):
        return x.transpose(*self.dims)


class SwiGLU(nn.Module):
    """``[out | gate]`` halves along ``dim``: out * silu(gate)."""

    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        out, gate = x.chunk(2, dim=self.dim)
        return out * (gate * torch.sigmoid(gate))


class DepthwiseConv1d(nn.Conv1d):
    """Depthwise conv with torch 'same' padding for even and odd k."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__(channels, channels, kernel_size, groups=channels)
        self.pads = (kernel_size // 2, kernel_size // 2 - (kernel_size + 1) % 2)

    def forward(self, x):
        return super().forward(F.pad(x, self.pads))


class LYNXConvModule(nn.Module):
    def __init__(self, dim: int, expansion_factor: int = 2, kernel_size: int = 31,
                 activation: str = "PReLU", dropout: float = 0.0):
        super().__init__()
        inner = dim * expansion_factor
        acts = {"PReLU": lambda: nn.PReLU(inner), "SiLU": nn.SiLU, "ReLU": nn.ReLU}
        if activation not in acts:
            raise ValueError(f"unknown activation {activation}")
        self.net = nn.Sequential(
            nn.LayerNorm(dim, eps=1e-5),
            Transpose((1, 2)),
            nn.Conv1d(dim, inner * 2, 1),
            SwiGLU(dim=1),
            DepthwiseConv1d(inner, kernel_size),
            acts[activation](),
            nn.Conv1d(inner, dim, 1),
            Transpose((1, 2)),
            nn.Dropout(dropout),
        )

    def forward(self, x):
        return self.net(x)


class LYNXNetResidualLayer(nn.Module):
    def __init__(self, dim: int, cond_dims: int, expansion_factor: int = 2,
                 kernel_size: int = 31, activation: str = "PReLU", dropout: float = 0.0,
                 strong_cond: bool = False):
        super().__init__()
        self.strong_cond = strong_cond
        self.diffusion_projection = nn.Conv1d(dim, dim, 1)
        self.conditioner_projection = nn.Conv1d(cond_dims, dim, 1)
        self.convmodule = LYNXConvModule(dim, expansion_factor, kernel_size, activation, dropout)

    def forward(self, x, cond, step_emb):
        cond_proj = dense(self.conditioner_projection, cond)
        if self.strong_cond:
            x = x + cond_proj
            res = x
        else:
            res = x
            x = x + cond_proj
        x = x + dense(self.diffusion_projection, step_emb)[:, None, :]
        return self.convmodule(x) + res


class LYNXNet(nn.Module):
    def __init__(self, in_dims: int, n_feats: int = 1, num_layers: int = 6,
                 num_channels: int = 512, expansion_factor: int = 2, kernel_size: int = 31,
                 activation: str = "PReLU", dropout_rate: float = 0.0,
                 strong_cond: bool = False, cond_dims: int = 256):
        super().__init__()
        C = num_channels
        self.in_dims, self.n_feats = in_dims, n_feats
        self.num_channels = C
        self.kernel_size = kernel_size
        self.activation = activation
        self.strong_cond = strong_cond
        self.input_projection = nn.Conv1d(in_dims * n_feats, C, 1)
        nn.init.kaiming_normal_(self.input_projection.weight)
        self.diffusion_embedding = nn.Sequential(
            nn.Identity(), nn.Linear(C, C * 4), nn.GELU(), nn.Linear(C * 4, C),
        )
        self.residual_layers = nn.ModuleList([
            LYNXNetResidualLayer(C, cond_dims, expansion_factor, kernel_size, activation,
                                 dropout_rate, strong_cond)
            for _ in range(num_layers)
        ])
        self.norm = nn.LayerNorm(C, eps=1e-5)
        self.output_projection = nn.Conv1d(C, in_dims * n_feats, 1)
        nn.init.zeros_(self.output_projection.weight)

    def step_embedding(self, diffusion_step: torch.Tensor, dtype=torch.float32):
        step = sinusoidal_step_embedding(diffusion_step, self.num_channels).to(dtype)
        step = F.gelu(dense(self.diffusion_embedding[1], step))
        return dense(self.diffusion_embedding[3], step)

    def forward(self, spec: torch.Tensor, diffusion_step: torch.Tensor,
                cond: torch.Tensor) -> torch.Tensor:
        """spec ``[B, F, T, M]``, diffusion_step ``[B]``, cond ``[B, T, H]`` ->
        ``[B, F, T, M]``."""
        B, F_, T, M = spec.shape
        x = spec.transpose(1, 2).reshape(B, T, F_ * M)
        x = dense(self.input_projection, x)
        if not self.strong_cond:
            x = F.gelu(x)
        step = self.step_embedding(diffusion_step)
        for layer in self.residual_layers:
            x = layer(x, cond, step)
        x = dense(self.output_projection, self.norm(x))
        return x.reshape(B, T, F_, M).transpose(1, 2)
