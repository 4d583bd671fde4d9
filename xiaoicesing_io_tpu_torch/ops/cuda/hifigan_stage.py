"""NSF-HiFiGAN resblock stage: CUDA kernel wrapper and its plain PyTorch version.

Replaces ``xiaoicesing_io_tpu/ops/pallas/hifigan_stage.py:fused_resblock_stage``
(the TPU kernel ``_kernel``:59).  One generator stage averages ``num_k``
ResBlock1 branches over the same input:

    out = mean_j ResBlock1_j(x),   ResBlock1 = units of
          lrelu(0.1) -> conv_{k,d} -> lrelu -> conv_{k,1} -> + residual

The contract is the JAX one: ``x`` ``[B, T, L]``, one stacked ``[L, k*L]``
weight (:func:`stack_taps`) and one ``[L]`` bias per conv, and the geometry
``specs[branch][unit] = (ConvSpec, ConvSpec)``.  Every conv has SAME zero
padding per sequence.  The products take inputs in ``x``'s dtype with f32
accumulation; the residual stream and the branch sum are f32; the output has
``x``'s dtype.  With bf16 ``x`` that is the TPU kernel's arithmetic; with f32
``x`` (CPU only) the stage is exact f32.

On a CPU tensor :func:`fused_resblock_stage` runs
:func:`fused_resblock_stage_plain`; on a CUDA tensor it launches
``csrc/hifigan_stage.cu`` once per ResBlock1 unit (9 launches per call at the
3 x 3 default) or raises.  The kernel takes any width ``L`` that is a multiple
of 16 up to :data:`MAX_WIDTH` (the source sizes its tiles from ``L``).  The
bound and the design are described in the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build

LRELU_SLOPE = 0.1
MAX_WIDTH = 512  # the CUDA kernel takes L % 16 == 0, 16 <= L <= MAX_WIDTH
MAX_CONV2_REACH = 16  # (k - 1) * d of each unit's second conv, rows the kernel stages

launches = 0  # wrapper calls that launched the CUDA kernel

_WRITE_H, _READ_ACC, _WRITE_ACC, _WRITE_OUT = 1, 2, 4, 8
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_void_p])


class ConvSpec(NamedTuple):
    """Static geometry of one conv inside the stage (weights passed separately)."""

    k: int      # taps
    d: int      # dilation
    pad_l: int  # left padding in rows; the right padding is (k - 1) * d - pad_l


def stack_taps(w) -> torch.Tensor:
    """``[k, C_in, C_out]`` taps -> stacked ``[C_in, k*C_out]`` product weight."""
    w = torch.as_tensor(np.asarray(w)) if not torch.is_tensor(w) else w
    k, ci, co = w.shape
    return w.permute(1, 0, 2).reshape(ci, k * co)


def stack_torch_conv(weight: torch.Tensor) -> torch.Tensor:
    """torch ``Conv1d`` weight ``[C_out, C_in, k]`` -> stacked ``[C_in, k*C_out]``."""
    co, ci, k = weight.shape
    return weight.permute(1, 2, 0).reshape(ci, k * co)


def _conv_plain(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, spec: ConvSpec, dtype):
    L = h.shape[-1]
    a = torch.where(h >= 0, h, LRELU_SLOPE * h).to(dtype).float()
    wt = w.to(dtype).float().reshape(L, spec.k, L).permute(2, 0, 1)  # [C_out, C_in, k]
    a = F.pad(a.transpose(1, 2), (spec.pad_l, (spec.k - 1) * spec.d - spec.pad_l))
    return F.conv1d(a, wt, b.float(), dilation=spec.d).transpose(1, 2)


def fused_resblock_stage_plain(x, weights, biases, specs) -> torch.Tensor:
    h0 = x.float()
    acc = None
    ci = 0
    for branch in specs:
        h = h0
        for s1, s2 in branch:
            t = _conv_plain(h, weights[ci], biases[ci], s1, x.dtype)
            t = _conv_plain(t, weights[ci + 1], biases[ci + 1], s2, x.dtype)
            ci += 2
            h = h + t
        acc = h if acc is None else acc + h
    return (acc / len(specs)).to(x.dtype)


def _launch(x, weights, biases, specs) -> torch.Tensor:
    global launches
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_resblock_stage kernel takes bf16 activations, got {x.dtype}")
    B, T, L = x.shape
    if L % 16 or not 16 <= L <= MAX_WIDTH:
        raise ValueError(f"fused_resblock_stage kernel takes L % 16 == 0 and 16 <= L <= "
                         f"{MAX_WIDTH}, got {L}")
    ci = 0
    for branch in specs:
        for pair in branch:
            if (pair[1].k - 1) * pair[1].d > MAX_CONV2_REACH:
                raise ValueError(f"fused_resblock_stage kernel takes (k - 1) * d <= "
                                 f"{MAX_CONV2_REACH} in a unit's second conv, got {pair[1]}")
            for s in pair:
                w, b = weights[ci], biases[ci]
                if w.device != x.device or w.dtype != torch.bfloat16 \
                        or tuple(w.shape) != (L, s.k * L) or not w.is_contiguous() \
                        or w.data_ptr() % 32:
                    # WMMA reads the tap fragments straight from device memory
                    raise ValueError(f"fused_resblock_stage: weight {ci} must be a contiguous, "
                                     f"32-byte aligned bf16 [{L}, {s.k * L}] tensor on "
                                     f"{x.device}")
                if b.device != x.device or b.dtype != torch.float32 or tuple(b.shape) != (L,):
                    raise ValueError(f"fused_resblock_stage: bias {ci} must be f32 [{L}] "
                                     f"on {x.device}")
                ci += 1
    x = x.contiguous()
    ping = torch.empty(B, T, L, dtype=torch.float32, device=x.device)
    pong = torch.empty_like(ping)
    acc = torch.empty_like(ping) if len(specs) > 1 else ping
    out = torch.empty_like(x)
    lib = build.load("hifigan_stage")
    fn = lib.resblock_unit_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    stream = build.stream_ptr(x.device)
    num_k = len(specs)
    ci = 0
    with torch.cuda.device(x.device):
        for j, branch in enumerate(specs):
            src, dst = x, ping
            for u, (s1, s2) in enumerate(branch):
                if u + 1 < len(branch):
                    mode = _WRITE_H
                elif j + 1 < num_k:
                    mode = _WRITE_ACC | (_READ_ACC if j > 0 else 0)
                else:
                    mode = _WRITE_OUT | (_READ_ACC if j > 0 else 0)
                status = fn(
                    src.data_ptr(), int(src.dtype == torch.bfloat16),
                    weights[ci].data_ptr(), biases[ci].data_ptr(),
                    weights[ci + 1].data_ptr(), biases[ci + 1].data_ptr(),
                    dst.data_ptr(), acc.data_ptr(), out.data_ptr(),
                    B, T, L, s1.k, s1.d, s1.pad_l, s2.k, s2.d, s2.pad_l, mode, float(num_k),
                    stream,
                )
                build.check(status, f"fused_resblock_stage unit {j}.{u} launch")
                ci += 2
                src, dst = dst, (pong if dst is ping else ping)
    launches += 1
    return out


def fused_resblock_stage(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor],
                         specs: Tuple[Tuple[Tuple[ConvSpec, ConvSpec], ...], ...]) -> torch.Tensor:
    """Mean over branches of ResBlock1_j(x).  CPU tensors take the plain
    version; CUDA tensors the kernel, which takes bf16 ``x``, bf16 weights and
    f32 biases."""
    if x.device.type == "cpu":
        return fused_resblock_stage_plain(x, weights, biases, specs)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock_stage: unsupported device {x.device}")
    return _launch(x, weights, biases, specs)
