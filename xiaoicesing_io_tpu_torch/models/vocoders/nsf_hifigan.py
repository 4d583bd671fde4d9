"""NSF-HiFiGAN generator in torch's own ``[B, C, T]`` conv layout.

Counterpart of the JAX package's stock ``Generator`` (not its time-folded
layout): ``conv_pre`` k=7 over the mel, transposed-conv upsample stages with
channel halving, each followed by ``num_kernels`` parallel ResBlock1/2
averaged, leaky-ReLU(0.1) between, leaky-ReLU(0.01) and ``conv_post`` k=7 ->
tanh at the end.  The full NSF source (``sine_gen``, harmonic merge, strided
``noise_convs``) or the mini-NSF source (``fast_sine_gen``, ``source_conv``).
Parameter names are the reference generator's (``m_source.l_linear``,
``noise_convs.{i}``, ``conv_pre``, ``ups.{i}``, ``resblocks.{j}.convs1.{n}``,
``conv_post``), weight norm removed.

``forward`` computes in the dtype it is given (f32 on the CPU, bf16 on the
card), casting the f32 weights per call.  With ResBlock1, stages 0 and 1 run
their resblock groups through ``ops/cuda/hifigan_stage.py:fused_resblock_stage``
(the CUDA kernel on the card, its plain version on the CPU), as the JAX
vocoder sends them to its TPU kernel; :meth:`Generator.prepare_stages` makes
their weights once, and the kernel keeps the K-major copies of their taps
that it builds at its first launch on those tensors (``sm90.kept_on``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.cuda.hifigan_stage import ConvSpec, fused_resblock_stage, stack_torch_conv

LRELU_SLOPE = 0.1
KERNEL_STAGES = (0, 1)  # stages whose resblock group runs fused_resblock_stage


@dataclass(frozen=True)
class NsfHifiganConfig:
    """The vocoder ``config.json`` fields the generator reads."""

    num_mels: int = 128
    sampling_rate: int = 44100
    hop_size: int = 512
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4, 4)
    upsample_initial_channel: int = 512
    resblock: str = "1"
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    mini_nsf: bool = False

    @staticmethod
    def from_json(d: dict) -> "NsfHifiganConfig":
        return NsfHifiganConfig(
            num_mels=d["num_mels"], sampling_rate=d["sampling_rate"], hop_size=d["hop_size"],
            upsample_rates=tuple(d["upsample_rates"]),
            upsample_kernel_sizes=tuple(d["upsample_kernel_sizes"]),
            upsample_initial_channel=d["upsample_initial_channel"],
            resblock=str(d["resblock"]),
            resblock_kernel_sizes=tuple(d["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(tuple(x) for x in d["resblock_dilation_sizes"]),
            mini_nsf=d.get("mini_nsf", False),
        )


def leaky_relu(x, slope=LRELU_SLOPE):
    return torch.where(x >= 0, x, slope * x)


def conv(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module`` (Conv1d or ConvTranspose1d) applied with its weights cast to
    ``x``'s dtype."""
    w = module.weight.to(x.dtype)
    b = None if module.bias is None else module.bias.to(x.dtype)
    if isinstance(module, nn.ConvTranspose1d):
        return F.conv_transpose1d(x, w, b, module.stride, module.padding)
    return F.conv1d(x, w, b, module.stride, module.padding, module.dilation, module.groups)


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        self.convs1 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=(kernel_size - 1) * d // 2) for d in dilation
        ])
        self.convs2 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2)
            for _ in dilation
        ])

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = conv(c2, leaky_relu(conv(c1, leaky_relu(x))))
            x = xt + x
        return x


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, dilation: Sequence[int] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=(kernel_size - 1) * d // 2) for d in dilation
        ])

    def forward(self, x):
        for c in self.convs:
            x = conv(c, leaky_relu(x)) + x
        return x


def sine_gen(f0: torch.Tensor, upp: int, sampling_rate: float, harmonic_num: int,
             rand_ini: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Frame-rate f0 ``[B, T]`` -> sample-rate harmonic sine bank
    ``[B, T*upp, H+1]``: within-frame linear phase ramp plus a cross-frame
    wrapped phase accumulator in f32.  Random initial phases (harmonic 0 fixed
    at 0) come from ``generator``; none without one."""
    dim = harmonic_num + 1
    f0 = f0.float()[..., None]
    n = torch.arange(1, upp + 1, dtype=torch.float32, device=f0.device)
    rad = f0 / sampling_rate * n
    rad2 = torch.fmod(rad[..., -1:] + 0.5, 1.0) - 0.5
    rad_acc = torch.fmod(torch.cumsum(rad2, dim=1), 1.0)
    rad = rad + F.pad(rad_acc[:, :-1, :], (0, 0, 1, 0))
    rad = rad.reshape(f0.shape[0], -1, 1)
    rad = rad * torch.arange(1, dim + 1, dtype=torch.float32, device=f0.device).reshape(1, 1, -1)
    if rand_ini is None:
        if generator is not None:
            rand_ini = torch.rand((1, 1, dim), generator=generator, device=f0.device)
            rand_ini[..., 0] = 0.0
        else:
            rand_ini = torch.zeros((1, 1, dim), device=f0.device)
    return torch.sin(2 * np.pi * (rad + rand_ini))


def fast_sine_gen(f0: torch.Tensor, upp: int, source_sr: float) -> torch.Tensor:
    """mini-NSF single-sine source with quadratic in-frame phase ``[B, T*upp, 1]``."""
    n = torch.arange(1, upp + 1, dtype=torch.float32, device=f0.device)
    s0 = f0.float()[..., None] / source_sr
    ds0 = F.pad(s0[:, 1:, :] - s0[:, :-1, :], (0, 0, 0, 1))
    rad = s0 * n + 0.5 * ds0 * n * (n - 1) / upp
    rad2 = torch.fmod(rad[..., -1:] + 0.5, 1.0) - 0.5
    rad_acc = torch.fmod(torch.cumsum(rad2, dim=1), 1.0)
    rad = rad + F.pad(rad_acc[:, :-1, :], (0, 0, 1, 0))
    return torch.sin(2 * np.pi * rad.reshape(f0.shape[0], -1, 1))


class SourceModule(nn.Module):
    """Harmonic merge of the NSF source: ``l_linear`` then tanh."""

    def __init__(self, harmonic_num: int = 8):
        super().__init__()
        self.l_linear = nn.Linear(harmonic_num + 1, 1)


class Generator(nn.Module):
    def __init__(self, config: NsfHifiganConfig):
        super().__init__()
        h = self.config = config
        self.num_kernels = len(h.resblock_kernel_sizes)
        if not h.mini_nsf:
            self.m_source = SourceModule(harmonic_num=8)
        self.noise_convs = nn.ModuleList()
        self.conv_pre = nn.Conv1d(h.num_mels, h.upsample_initial_channel, 7, padding=3)
        res_cls = ResBlock1 if h.resblock == "1" else ResBlock2
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = h.upsample_initial_channel
        for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
            c_in, ch = ch, ch // 2
            self.ups.append(nn.ConvTranspose1d(c_in, ch, k, u, padding=(k - u) // 2))
            if not h.mini_nsf:
                if i + 1 < len(h.upsample_rates):
                    sf = int(np.prod(h.upsample_rates[i + 1:]))
                    self.noise_convs.append(nn.Conv1d(1, ch, sf * 2, stride=sf, padding=sf // 2))
                else:
                    self.noise_convs.append(nn.Conv1d(1, ch, 1))
            elif i == 1:
                self.source_conv = nn.Conv1d(1, ch, 1)
            for rk, rd in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes):
                self.resblocks.append(res_cls(ch, rk, rd))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def stage_weights(self, stage: int, dtype) -> tuple:
        """Stage ``stage``'s resblock group in the kernel's contract: stacked
        weights in ``dtype`` (bf16 for the kernel), f32 biases, the conv
        geometry."""
        weights, biases, specs = [], [], []
        for j in range(self.num_kernels):
            block = self.resblocks[stage * self.num_kernels + j]
            branch = []
            for c1, c2 in zip(block.convs1, block.convs2):
                for c in (c1, c2):
                    weights.append(stack_torch_conv(c.weight).to(dtype).contiguous())
                    biases.append(c.bias.float().contiguous())
                branch.append(tuple(ConvSpec(k=c.kernel_size[0], d=c.dilation[0],
                                             pad_l=c.padding[0]) for c in (c1, c2)))
            specs.append(tuple(branch))
        return tuple(weights), tuple(biases), tuple(specs)

    def prepare_stages(self, dtype) -> Dict[int, tuple]:
        """``stage_weights`` of each stage in :data:`KERNEL_STAGES` (ResBlock1
        only): what :meth:`forward` takes as ``stages``."""
        if self.config.resblock != "1":
            return {}
        return {i: self.stage_weights(i, dtype) for i in KERNEL_STAGES
                if i < len(self.config.upsample_rates)}

    def source(self, f0: torch.Tensor, generator: Optional[torch.Generator] = None):
        """The harmonic source ``[B, 1, T*hop]`` (f32)."""
        h = self.config
        if h.mini_nsf:
            source_sr = h.sampling_rate / int(np.prod(h.upsample_rates[2:]))
            upp = int(np.prod(h.upsample_rates[:2]))
            return fast_sine_gen(f0, upp, source_sr).transpose(1, 2)
        upp = int(np.prod(h.upsample_rates))
        sines = sine_gen(f0, upp, h.sampling_rate, harmonic_num=8, generator=generator) * 0.1
        uv = torch.repeat_interleave((f0 > 0).float()[..., None], upp, dim=1)
        if generator is not None:
            noise_amp = uv * 0.003 + (1 - uv) * 0.1 / 3
            noise = noise_amp * torch.randn(sines.shape, generator=generator,
                                            device=sines.device)
        else:
            noise = 0.0
        sines = sines * uv + noise
        return torch.tanh(self.m_source.l_linear(sines)).transpose(1, 2)

    def forward(self, mel: torch.Tensor, f0: torch.Tensor,
                generator: Optional[torch.Generator] = None, dtype=torch.float32,
                stages: Optional[Dict[int, tuple]] = None) -> torch.Tensor:
        """mel ``[B, T, M]`` (natural-log), f0 ``[B, T]`` Hz -> wav ``[B, T*hop]`` f32.
        ``generator`` drives the NSF source randomness (None: no noise).
        ``stages`` is :meth:`prepare_stages` in ``dtype``, made here when None;
        a stage it leaves out runs its resblocks as modules."""
        h = self.config
        if stages is None:
            stages = self.prepare_stages(dtype)
        har = self.source(f0, generator).to(dtype)
        x = conv(self.conv_pre, mel.transpose(1, 2).to(dtype))
        for i in range(len(h.upsample_rates)):
            x = conv(self.ups[i], leaky_relu(x))
            if not h.mini_nsf:
                x = x + conv(self.noise_convs[i], har)[:, :, :x.shape[-1]]
            elif i == 1:
                x = x + conv(self.source_conv, har)[:, :, :x.shape[-1]]
            if i in stages:
                x = fused_resblock_stage(x.transpose(1, 2).contiguous(), *stages[i])
                x = x.transpose(1, 2)
            else:
                blocks = self.resblocks[i * self.num_kernels:(i + 1) * self.num_kernels]
                xs = None
                for block in blocks:
                    xs = block(x) if xs is None else xs + block(x)
                x = xs / self.num_kernels
        x = conv(self.conv_post, leaky_relu(x, 0.01))
        return torch.tanh(x.float())[:, 0]
