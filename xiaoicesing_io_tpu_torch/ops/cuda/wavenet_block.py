"""WaveNet residual block: CUDA kernel wrapper and its plain PyTorch version.

Replaces ``xiaoicesing_io_tpu/ops/pallas/wavenet_block.py:wavenet_block`` (the
TPU kernel ``_kernel``:33).  Per layer of the WaveNet denoiser, with ``y = x +
step projection`` computed by the caller:

    z = dilated k=3 conv of y (SAME zero padding per sequence) + b_conv + cond_proj
    g = sigmoid(z[..., :C]) * tanh(z[..., C:])          (rounded to y's dtype)
    out = g @ out_kernel + out_bias                     ([residual | skip], y's dtype)

Arguments keep the JAX layouts: ``conv_kernel`` ``[3, C, 2C]`` (taps at t - d,
t, t + d), ``out_kernel`` ``[C, 2C]``, biases ``[2C]``, ``cond_proj`` ``[B, T,
2C]``.  The products take inputs in ``y``'s dtype: bf16 on the card, where
the kernel accumulates in f32, and f32 on the CPU, where the block is exact
f32.

:func:`wavenet_block` takes its weights from :func:`prepare_weights`.  On a
CPU tensor it runs :func:`wavenet_block_plain`; on a CUDA tensor it launches
``csrc/wavenet_block.cu`` (two launches of the Hopper GEMM core,
``csrc/sm90_gemm.cuh``: the conv with the gate in its epilogue, then the
output product) or raises.  The kernel takes C % 64 == 0, 64 <= C <= 512
and any dilation d >= 1.  The bound and the design are described in the
CUDA source.
"""

from __future__ import annotations

import ctypes
from collections import namedtuple

import torch
import torch.nn.functional as F

from . import build, sm90

MAX_CHANNELS = 512

launches = 0  # wrapper calls that launched the CUDA kernel

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_GEMM_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def wavenet_block_plain(y, cond_proj, conv_kernel, conv_bias, out_kernel, out_bias,
                        dilation: int) -> torch.Tensor:
    """The unfused chain in ``y``'s dtype: a dilated ``conv1d``, the gating in
    f32 rounded to ``y``'s dtype, and a ``linear``.  With f32 ``y`` (CPU only)
    the block is exact f32."""
    dt = y.dtype
    C = y.shape[-1]
    w = conv_kernel.to(dt).permute(2, 1, 0)  # [2C, C, 3]
    z = F.conv1d(y.transpose(1, 2), w, None, padding=dilation, dilation=dilation)
    z = z.transpose(1, 2).float() + (conv_bias.float() + cond_proj.float())
    g = (torch.sigmoid(z[..., :C]) * torch.tanh(z[..., C:])).to(dt)
    return F.linear(g, out_kernel.to(dt).t(), out_bias.to(dt))


def prepare_weights(conv_kernel, conv_bias, out_kernel, out_bias, product_dtype=torch.bfloat16):
    """The kernel's operand types, contiguous, in the JAX layouts: product
    weights in ``product_dtype`` (bf16 for the kernel), biases f32.  Do this
    once per set of weights: the K-major copies the kernel reads are built
    from it at its first launch and kept with it (:func:`kernel_operands`)."""
    f32, pd = torch.float32, product_dtype
    return sm90.Prepared((conv_kernel.to(pd).contiguous(), conv_bias.to(f32).contiguous(),
                          out_kernel.to(pd).contiguous(), out_bias.to(f32).contiguous()))


def k_major_weights(weights):
    """The conv weights ``[3, C, 2C]`` as a K-major, column-paired ``[2C, 3C]``
    (K index ``tap * C + c``; tile p: gate columns Pp.., then filter columns
    C + Pp.., P = ``sm90.pair_width(C)``) and ``out_kernel`` as K-major
    ``[2C, C]``."""
    conv_kernel, _, out_kernel, _ = weights
    C = out_kernel.shape[0]
    return (sm90.paired_k_major(conv_kernel.reshape(3 * C, 2 * C), sm90.pair_width(C)),
            sm90.k_major(out_kernel))


_Operands = namedtuple("_Operands", "device C wc wo map_wc map_wo bn_gate bn_out")
_maps = sm90.MapCache("wavenet_block")


def kernel_operands(weights) -> _Operands:
    """Checks the prepared weights once, then builds :func:`k_major_weights`,
    their tensor maps and the two products' N tiles."""
    conv_kernel, conv_bias, out_kernel, out_bias = weights
    C = out_kernel.shape[0]
    expect = {
        "conv_kernel": (conv_kernel, torch.bfloat16, (3, C, 2 * C)),
        "conv_bias": (conv_bias, torch.float32, (2 * C,)),
        "out_kernel": (out_kernel, torch.bfloat16, (C, 2 * C)),
        "out_bias": (out_bias, torch.float32, (2 * C,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != conv_kernel.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"wavenet_block: {name} must be a {dtype} {shape} tensor on {conv_kernel.device} "
                f"(weights: see prepare_weights), got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        sm90.check_operand("wavenet_block", name, t, " (see prepare_weights)")
    wc, wo = k_major_weights(weights)
    bn_gate, bn_out = 2 * sm90.pair_width(C), sm90.tile_n(2 * C)
    return _Operands(conv_kernel.device, C, wc, wo, sm90.encode("wavenet_block", wc, bn_gate),
                     sm90.encode("wavenet_block", wo, bn_out), bn_gate, bn_out)


def check_widths(C: int, d: int) -> None:
    if C % 64 or not 64 <= C <= MAX_CHANNELS or d < 1:
        raise ValueError(
            f"wavenet_block kernel needs C % 64 == 0, 64 <= C <= {MAX_CHANNELS} and d >= 1 "
            f"(C={C}, d={d})"
        )


def _launch(y, cond_proj, weights, dilation: int) -> torch.Tensor:
    global launches
    if y.dtype != torch.bfloat16:
        raise TypeError(f"wavenet_block kernel takes bf16 activations, got {y.dtype}")
    if not isinstance(weights, sm90.Prepared):
        raise ValueError("wavenet_block: weights must come from prepare_weights")
    B, T, C = y.shape
    d = int(dilation)
    check_widths(C, d)
    ops = weights.operands(kernel_operands)
    if ops.device != y.device or ops.C != C:
        raise ValueError(f"wavenet_block: weights of width {ops.C} on {ops.device} for y "
                         f"{tuple(y.shape)} on {y.device} (see prepare_weights)")
    if cond_proj.dtype != torch.bfloat16 or tuple(cond_proj.shape) != (B, T, 2 * C) \
            or cond_proj.device != y.device:
        raise ValueError(f"wavenet_block: cond_proj must be a bf16 {(B, T, 2 * C)} tensor on "
                         f"{y.device}, got {cond_proj.dtype} {tuple(cond_proj.shape)} on "
                         f"{cond_proj.device}")
    sm90.check_operand("wavenet_block", "y", y)
    sm90.check_operand("wavenet_block", "cond_proj", cond_proj)
    g = torch.empty(B, T, C, dtype=torch.bfloat16, device=y.device)
    out = torch.empty(B, T, 2 * C, dtype=torch.bfloat16, device=y.device)
    conv_bias, out_bias = weights[1], weights[3]
    with torch.cuda.device(y.device):
        map_y = _maps.get(y, sm90.BM)
        map_g = _maps.get(g.view(B * T, C), sm90.BM)
        fn = sm90.function("wavenet_block", "wavenet_block_launch", _ARGTYPES)
        status = fn(ctypes.addressof(map_y), ctypes.addressof(ops.map_wc), ctypes.addressof(map_g),
                    ctypes.addressof(ops.map_wo), cond_proj.data_ptr(), conv_bias.data_ptr(),
                    out_bias.data_ptr(), g.data_ptr(), out.data_ptr(), B, T, C, d, ops.bn_gate,
                    ops.bn_out, build.stream_ptr(y.device))
    build.check(status, "wavenet_block launch")
    launches += 1
    return out


def gemm_bf16(a, b_kmajor, bias, bn: int = 128) -> torch.Tensor:
    """The bare GEMM core: ``a [M, K] @ b_kmajor[N, K]^T + bias`` as bf16, for
    the card tests of ``csrc/sm90_gemm.cuh``; the port's paths never call it."""
    (M, K), (N, _) = a.shape, b_kmajor.shape
    for name, t in (("a", a), ("b", b_kmajor)):
        if t.dtype != torch.bfloat16 or t.shape[-1] != K or K % sm90.BK:
            raise ValueError(f"gemm_bf16: {name} must be bf16 with K % 64 == 0")
        sm90.check_operand("gemm_bf16", name, t)
    out = torch.empty(M, N, dtype=torch.bfloat16, device=a.device)
    bias = bias.float().contiguous()
    with torch.cuda.device(a.device):
        map_a = sm90.encode("wavenet_block", a, sm90.BM)
        map_b = sm90.encode("wavenet_block", b_kmajor, bn)
        fn = sm90.function("wavenet_block", "sm90_gemm_bf16_launch", _GEMM_ARGTYPES)
        status = fn(ctypes.addressof(map_a), ctypes.addressof(map_b), bias.data_ptr(),
                    out.data_ptr(), M, N, K, bn, build.stream_ptr(a.device))
    build.check(status, "sm90_gemm_bf16 launch")
    return out


def wavenet_block(y, cond_proj, weights, *, dilation: int) -> torch.Tensor:
    """``[residual | skip]`` ``[B, T, 2C]`` of one WaveNet layer.  ``weights``
    come from :func:`prepare_weights`.  CPU tensors take the plain version;
    CUDA tensors the kernel, which takes bf16 ``y`` and ``cond_proj``, bf16
    product weights and f32 biases."""
    if y.device.type == "cpu":
        return wavenet_block_plain(y, cond_proj, *weights, dilation=dilation)
    if y.device.type != "cuda":
        raise ValueError(f"wavenet_block: unsupported device {y.device}")
    return _launch(y, cond_proj, weights, dilation)
