"""NSF-HiFiGAN ResBlock1 unit: CUDA kernel wrapper and its plain PyTorch version.

Replaces ``xiaoicesing_io_tpu/ops/pallas/hifigan_resblock.py:resblock_unit``
(the TPU kernel ``_kernel``:45).  One unit is

    out = x + conv2(lrelu(conv1(lrelu(x)) + b1)) + b2

with torch SAME zero padding per sequence by default, or any left padding
``pad*_l`` (the right padding is ``(k - 1) * d - pad_l``), which the
time-folded vocoder's taps need.  The contract is the JAX one: ``x`` ``[B, T,
C]``, ``w1`` / ``w2`` ``[k, C, C]`` taps (``[tap, c_in, c_out]``), ``b1`` /
``b2`` ``[C]``.  The arithmetic is the TPU kernel's: the products take
``x``'s dtype with f32 accumulation, the first conv's output stays f32 until
its leaky ReLU is rounded to ``x``'s dtype, and the residual is added in f32
and rounded once.  With f32 ``x`` (CPU only) the unit is exact f32.

On a CPU tensor :func:`resblock_unit` runs :func:`resblock_unit_plain`; on a
CUDA tensor it launches ``csrc/hifigan_resblock.cu`` once (a leaky-ReLU pass
and two tap convs on the Hopper GEMM core ``csrc/sm90_gemm.cuh``), or raises.
The kernel takes bf16 ``x``, the taps of :func:`prepare_unit_weights`, a width
``C`` that is a multiple of 16 up to :data:`MAX_WIDTH`, and any reach ``(k -
1) * d`` with up to ``sm90.MAX_TAPS`` taps a conv that are not all zero.  The
K-major copies of each conv's kept taps and their tensor maps are built at
the first launch and kept on the tap tensor (``sm90.kept_on``).  The TPU
kernel's ``tile`` and ``interpret`` are schedule parameters and are not
ported.  The bound and the design are described in the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build, sm90

LRELU_SLOPE = 0.1
MAX_WIDTH = 512        # the CUDA kernel takes C % 16 == 0, 16 <= C <= MAX_WIDTH

launches = 0  # wrapper calls that launched the CUDA kernel

_LIB = "hifigan_resblock"
# one conv: map_w, kept, n_kept, d, pad_l
_CONV = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3
_ARGTYPES = ([ctypes.c_void_p] * 2 + _CONV + _CONV + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
             + [ctypes.c_void_p])
_maps = sm90.MapCache(_LIB)


def _lrelu(x):
    return torch.where(x >= 0, x, LRELU_SLOPE * x)


def _pad_left(k: int, d: int, pad_l: Optional[int]) -> int:
    return (k - 1) * d // 2 if pad_l is None else pad_l


def prepare_unit_weights(w1, b1, w2, b2, dtype=torch.bfloat16,
                         device=None) -> Tuple[torch.Tensor, ...]:
    """``(w1, b1, w2, b2)`` in the kernel's operand types: the ``[k, C, C]``
    taps contiguous in ``dtype`` (bf16 for the kernel), the biases f32.
    Takes numpy arrays or tensors.  Do this once per set of weights."""
    def t(a, dt):
        a = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
        return a.to(device=device, dtype=dt).contiguous()

    return t(w1, dtype), t(b1, torch.float32), t(w2, dtype), t(b2, torch.float32)


def _conv_plain(t, w, b, d: int, pad_l: int):
    """``t`` ``[B, T, C]`` f32, taps ``w`` ``[k, C_in, C_out]`` f32 -> ``[B, T, C_out]``."""
    k = w.shape[0]
    y = F.conv1d(F.pad(t.transpose(1, 2), (pad_l, (k - 1) * d - pad_l)), w.permute(2, 1, 0),
                 dilation=d)
    return y.transpose(1, 2) + b


def resblock_unit_plain(x, w1, b1, w2, b2, d1: int = 1, pad1_l: Optional[int] = None,
                        d2: int = 1, pad2_l: Optional[int] = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: ``F.conv1d`` in f32 on
    values rounded to ``x``'s dtype."""
    dt = x.dtype
    h = x.float()
    t = _lrelu(h).to(dt).float()
    z1 = _conv_plain(t, w1.to(dt).float(), b1.float(), d1, _pad_left(w1.shape[0], d1, pad1_l))
    t2 = _lrelu(z1).to(dt).float()
    z2 = _conv_plain(t2, w2.to(dt).float(), b2.float(), d2, _pad_left(w2.shape[0], d2, pad2_l))
    return (h + z2).to(dt)


def conv_operands(w: torch.Tensor) -> sm90.TapConv:
    """The GEMM core's operands of one conv's ``[k, C, C]`` bf16 taps, built
    at its first launch and kept on ``w``."""
    return sm90.kept_on(w, lambda t: sm90.tap_conv(_LIB, t))


def _launch(x, w1, b1, w2, b2, d1: int, p1: int, d2: int, p2: int) -> torch.Tensor:
    global launches
    if x.dtype != torch.bfloat16:
        raise TypeError(f"resblock_unit kernel takes bf16 activations, got {x.dtype}")
    B, T, L = x.shape
    if L % 16 or not 16 <= L <= MAX_WIDTH:
        raise ValueError(f"resblock_unit kernel takes C % 16 == 0 and 16 <= C <= {MAX_WIDTH}, "
                         f"got {L}")
    k1, k2 = w1.shape[0], w2.shape[0]
    sm90.check_tap_conv("resblock_unit", k1, d1, p1)
    sm90.check_tap_conv("resblock_unit", k2, d2, p2)
    if not 1 <= B <= 65535:
        raise ValueError(f"resblock_unit kernel takes 1 <= B <= 65535, got {B}")
    for name, w, k in (("w1", w1, k1), ("w2", w2, k2)):
        if w.device != x.device or w.dtype != torch.bfloat16 or tuple(w.shape) != (k, L, L) \
                or not w.is_contiguous():
            raise ValueError(f"resblock_unit: {name} must be a contiguous bf16 [{k}, {L}, {L}] "
                             f"tensor on {x.device} (see prepare_unit_weights)")
    for name, b in (("b1", b1), ("b2", b2)):
        if b.device != x.device or b.dtype != torch.float32 or tuple(b.shape) != (L,) \
                or not b.is_contiguous():
            raise ValueError(f"resblock_unit: {name} must be a contiguous f32 [{L}] tensor on "
                             f"{x.device} (see prepare_unit_weights)")
    x = x.contiguous()
    sm90.check_operand("resblock_unit", "x", x)
    c1, c2 = conv_operands(w1), conv_operands(w2)
    a, t2, out = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    with torch.cuda.device(x.device):
        map_a, map_t2 = _maps.get(a, sm90.BM), _maps.get(t2, sm90.BM)
        fn = sm90.function(_LIB, "hifigan_resblock_unit_launch", _ARGTYPES)
        status = fn(ctypes.addressof(map_a), ctypes.addressof(map_t2),
                    ctypes.addressof(c1.map_w), c1.kept_c, len(c1.kept), d1, p1,
                    ctypes.addressof(c2.map_w), c2.kept_c, len(c2.kept), d2, p2,
                    x.data_ptr(), b1.data_ptr(), b2.data_ptr(), a.data_ptr(), t2.data_ptr(),
                    out.data_ptr(), B, T, L, c1.bn, build.stream_ptr(x.device))
    build.check(status, "resblock_unit launch")
    launches += 1
    return out


def resblock_unit(x: torch.Tensor, w1, b1, w2, b2, d1: int = 1, pad1_l: Optional[int] = None,
                  d2: int = 1, pad2_l: Optional[int] = None) -> torch.Tensor:
    """``x + conv2(lrelu(conv1(lrelu(x)) + b1)) + b2`` with zero padding per
    sequence.  CPU tensors take the plain version; CUDA tensors the kernel,
    which takes bf16 ``x`` and the taps of :func:`prepare_unit_weights`."""
    if x.device.type == "cpu":
        return resblock_unit_plain(x, w1, b1, w2, b2, d1, pad1_l, d2, pad2_l)
    if x.device.type != "cuda":
        raise ValueError(f"resblock_unit: unsupported device {x.device}")
    return _launch(x, w1, b1, w2, b2, d1, _pad_left(w1.shape[0], d1, pad1_l), d2,
                   _pad_left(w2.shape[0], d2, pad2_l))
