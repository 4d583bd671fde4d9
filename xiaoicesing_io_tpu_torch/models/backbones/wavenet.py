"""Non-causal WaveNet denoiser backbone, plain f32 module (counterpart of the JAX ``WaveNet``).

Input 1x1 projection + ReLU; sinusoidal diffusion-step embedding through a
Mish MLP; N residual blocks, each a dilated k=3 conv (dilation
2^(i % dilation_cycle_length)) of ``x`` plus the step projection, plus the
conditioner projection, gated tanh * sigmoid and a 1x1 output projection
into ``[residual | skip]``; the skip sum over sqrt(N), a 1x1 skip projection
+ ReLU and the zero-initialised output projection.  Parameter names follow
the reference (``input_projection``, ``mlp.{0,2}``,
``residual_layers.{i}.{dilated_conv,diffusion_projection,
conditioner_projection,output_projection}``, ``skip_projection``,
``output_projection``); 1x1 convs keep the torch ``Conv1d`` weight shape.

This module is the f32 reference; the inference path with the CUDA kernel is
``wavenet_cuda.wavenet_denoiser_apply``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import sinusoidal_step_embedding
from .lynxnet import dense


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


class WaveNetResidualBlock(nn.Module):
    def __init__(self, residual_channels: int, dilation: int, cond_dims: int):
        super().__init__()
        C = residual_channels
        self.dilation = dilation
        self.dilated_conv = nn.Conv1d(C, 2 * C, 3, padding=dilation, dilation=dilation)
        self.diffusion_projection = nn.Linear(C, C)
        self.conditioner_projection = nn.Conv1d(cond_dims, 2 * C, 1)
        self.output_projection = nn.Conv1d(C, 2 * C, 1)

    def forward(self, x, cond, step_emb):
        """x ``[B, T, C]``, cond ``[B, T, H]``, step_emb ``[B, C]`` ->
        (``(x + residual) / sqrt(2)``, skip), each ``[B, T, C]``."""
        C = x.shape[-1]
        y = x + dense(self.diffusion_projection, step_emb)[:, None, :]
        y = self.dilated_conv(y.transpose(1, 2)).transpose(1, 2)
        y = y + dense(self.conditioner_projection, cond)
        y = torch.sigmoid(y[..., :C]) * torch.tanh(y[..., C:])
        y = dense(self.output_projection, y)
        return (x + y[..., :C]) / math.sqrt(2.0), y[..., C:]


class WaveNet(nn.Module):
    def __init__(self, in_dims: int, n_feats: int = 1, num_layers: int = 20,
                 num_channels: int = 256, dilation_cycle_length: int = 4, cond_dims: int = 256):
        super().__init__()
        C = num_channels
        self.in_dims, self.n_feats = in_dims, n_feats
        self.num_channels = C
        self.dilation_cycle_length = dilation_cycle_length
        self.input_projection = nn.Conv1d(in_dims * n_feats, C, 1)
        nn.init.kaiming_normal_(self.input_projection.weight)
        self.mlp = nn.Sequential(nn.Linear(C, C * 4), Mish(), nn.Linear(C * 4, C))
        self.residual_layers = nn.ModuleList([
            WaveNetResidualBlock(C, 2 ** (i % dilation_cycle_length), cond_dims)
            for i in range(num_layers)
        ])
        self.skip_projection = nn.Conv1d(C, C, 1)
        nn.init.kaiming_normal_(self.skip_projection.weight)
        self.output_projection = nn.Conv1d(C, in_dims * n_feats, 1)
        nn.init.zeros_(self.output_projection.weight)

    def step_embedding(self, diffusion_step: torch.Tensor, dtype=torch.float32):
        step = sinusoidal_step_embedding(diffusion_step, self.num_channels).to(dtype)
        step = mish(dense(self.mlp[0], step))
        return dense(self.mlp[2], step)

    def forward(self, spec: torch.Tensor, diffusion_step: torch.Tensor,
                cond: torch.Tensor) -> torch.Tensor:
        """spec ``[B, F, T, M]``, diffusion_step ``[B]``, cond ``[B, T, H]`` ->
        ``[B, F, T, M]``."""
        B, F_, T, M = spec.shape
        x = spec.transpose(1, 2).reshape(B, T, F_ * M)
        x = F.relu(dense(self.input_projection, x))
        step = self.step_embedding(diffusion_step)
        skip_sum = torch.zeros_like(x)
        for layer in self.residual_layers:
            x, skip = layer(x, cond, step)
            skip_sum = skip_sum + skip
        x = skip_sum / math.sqrt(len(self.residual_layers))
        x = F.relu(dense(self.skip_projection, x))
        x = dense(self.output_projection, x)
        return x.reshape(B, T, F_, M).transpose(1, 2)
