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
``csrc/hifigan_stage.cu`` as :func:`launch_plan` says (a leaky-ReLU pass, then
two tap convs on the Hopper GEMM core ``csrc/sm90_gemm.cuh`` per ResBlock1
unit: 19 launches per call at the 3 x 3 default) or raises.  The kernel takes
any width ``L`` that is a multiple of 16 up to :data:`MAX_WIDTH`, any conv
geometry (raw dilated taps, or the time-folded vocoder's taps with their
asymmetric pads) with up to ``sm90.MAX_TAPS`` taps a conv that are not all
zero.  The K-major copies of each conv's kept taps and their tensor maps are
built at the first launch and kept on the stacked weight (``sm90.kept_on``).
The bound and the design are described in the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build, sm90

LRELU_SLOPE = 0.1
MAX_WIDTH = 512  # the CUDA kernel takes L % 16 == 0, 16 <= L <= MAX_WIDTH

launches = 0  # wrapper calls that launched the CUDA kernel

# the second conv's bookkeeping (csrc/hifigan_stage.cu)
WRITE_H, READ_ACC, WRITE_ACC, WRITE_OUT = 1, 2, 4, 8

_LIB = "hifigan_stage"
# one conv: map_w, kept, n_kept, d, pad_l
_CONV = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3
_ARGTYPES = ([ctypes.c_void_p] * 2 + _CONV + _CONV + [ctypes.c_void_p] * 4 + [ctypes.c_int]
             + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 4
             + [ctypes.c_void_p])
_LRELU_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
_maps = sm90.MapCache(_LIB)


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


def unstack_taps(w: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`stack_taps`: ``[C_in, k*C_out]`` -> a ``[k, C_in,
    C_out]`` view."""
    return w.view(w.shape[0], k, -1).permute(1, 0, 2)


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


class Step(NamedTuple):
    """One ResBlock1 unit's two launches of the core."""

    branch: int
    unit: int
    conv: int    # index of the unit's first conv in ``weights`` and ``biases``
    first: bool  # a branch's first unit: A = bf16(lrelu(x)), the residual bf16 x
    mode: int    # the second conv's bookkeeping: WRITE_H, READ_ACC, WRITE_ACC, WRITE_OUT


def launch_plan(specs) -> List[Step]:
    """The units in launch order, after the one leaky-ReLU pass over ``x``.
    A unit that is not its branch's last writes f32 ``h`` and the next unit's
    A; a branch's last unit adds ``h`` into the f32 sum, or (the last branch)
    writes the stage output ``bf16(sum / num_k)``."""
    steps, ci, num_k = [], 0, len(specs)
    for j, branch in enumerate(specs):
        for u in range(len(branch)):
            if u + 1 < len(branch):
                mode = WRITE_H
            else:
                mode = (WRITE_ACC if j + 1 < num_k else WRITE_OUT) | (READ_ACC if j else 0)
            steps.append(Step(j, u, ci, u == 0, mode))
            ci += 2
    return steps


def conv_operands(w: torch.Tensor, k: int) -> sm90.TapConv:
    """The GEMM core's operands of one conv's stacked ``[L, k*L]`` bf16
    weight, built at its first launch and kept on ``w``."""
    return sm90.kept_on(w, lambda t: sm90.tap_conv(_LIB, unstack_taps(t, k)))


def _launch(x, weights, biases, specs) -> torch.Tensor:
    global launches
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_resblock_stage kernel takes bf16 activations, got {x.dtype}")
    B, T, L = x.shape
    if L % 16 or not 16 <= L <= MAX_WIDTH:
        raise ValueError(f"fused_resblock_stage kernel takes L % 16 == 0 and 16 <= L <= "
                         f"{MAX_WIDTH}, got {L}")
    if not 1 <= B <= 65535:
        raise ValueError(f"fused_resblock_stage kernel takes 1 <= B <= 65535, got {B}")
    x = x.contiguous()
    sm90.check_operand("fused_resblock_stage", "x", x)
    plan = launch_plan(specs)
    convs = []
    ci = 0
    for branch in specs:
        for pair in branch:
            for s in pair:
                w, b = weights[ci], biases[ci]
                sm90.check_tap_conv(f"fused_resblock_stage: conv {ci}", s.k, s.d, s.pad_l)
                if w.device != x.device or w.dtype != torch.bfloat16 \
                        or tuple(w.shape) != (L, s.k * L) or not w.is_contiguous():
                    raise ValueError(f"fused_resblock_stage: weight {ci} must be a contiguous "
                                     f"bf16 [{L}, {s.k * L}] tensor on {x.device}")
                if b.device != x.device or b.dtype != torch.float32 or tuple(b.shape) != (L,) \
                        or not b.is_contiguous():
                    raise ValueError(f"fused_resblock_stage: bias {ci} must be a contiguous f32 "
                                     f"[{L}] tensor on {x.device}")
                convs.append(conv_operands(w, s.k))
                ci += 1
    num_k = len(specs)
    chained = any(len(branch) > 1 for branch in specs)
    a0, t2, out = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    a1 = torch.empty_like(x) if chained else None
    h = torch.empty(B, T, L, dtype=torch.float32, device=x.device) if chained else None
    acc = torch.empty(B, T, L, dtype=torch.float32, device=x.device) if num_k > 1 else None
    stream = build.stream_ptr(x.device)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        status = sm90.function(_LIB, "hifigan_stage_lrelu_launch", _LRELU_ARGTYPES)(
            x.data_ptr(), a0.data_ptr(), x.numel(), stream)
        build.check(status, "fused_resblock_stage leaky-ReLU launch")
        map_t2 = _maps.get(t2, sm90.BM)
        fn = sm90.function(_LIB, "hifigan_stage_unit_launch", _ARGTYPES)
        for step in plan:
            s1, s2 = specs[step.branch][step.unit]
            c1, c2 = convs[step.conv], convs[step.conv + 1]
            map_a = _maps.get(a0 if step.first else a1, sm90.BM)
            res = x if step.first else h
            status = fn(ctypes.addressof(map_a), ctypes.addressof(map_t2),
                        ctypes.addressof(c1.map_w), c1.kept_c, len(c1.kept), s1.d, s1.pad_l,
                        ctypes.addressof(c2.map_w), c2.kept_c, len(c2.kept), s2.d, s2.pad_l,
                        biases[step.conv].data_ptr(), biases[step.conv + 1].data_ptr(),
                        t2.data_ptr(), res.data_ptr(), int(step.first), ptr(h), ptr(a1),
                        ptr(acc), out.data_ptr(), step.mode, float(num_k), B, T, L, c1.bn,
                        stream)
            build.check(status, f"fused_resblock_stage unit {step.branch}.{step.unit} launch")
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
