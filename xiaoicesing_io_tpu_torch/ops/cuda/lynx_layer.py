"""Whole LYNXNet residual layer (strong_cond): two CUDA kernels and their plain version.

Replaces ``xiaoicesing_io_tpu/ops/pallas/lynx_conv2.py:lynx_layer_fused``
(K5) and ``xiaoicesing_io_tpu/ops/pallas/lynx_conv3.py:lynx_layer_fused_v3``
(K7).  Both compute one strong_cond layer of the acoustic denoiser:

    res = x + cond_proj                  rounded once to bf16
    h   = res + step[b]                  f32
    out = res + ConvModule(h)            f32 sums, rounded once to x's dtype

with the conv module's arithmetic of ``lynx_conv2.py:71-124``: f32
LayerNorm, ``xn`` rounded to the product dtype, f32-accumulated products,
f32 SwiGLU, rows outside ``[0, T)`` zeroed before the depthwise conv (f32
taps), bias, PReLU, the activation rounded to the product dtype before
``pw_out``, then ``+ b2 + res`` in f32.  This is not the v1 path's
arithmetic (``models/backbones/lynx_cuda.py``, K1), which adds the step and
the residual in bf16: the two agree to bf16 rounding only.

K5 and K7 compute the same function and differ in schedule (``csrc/
lynx_layer.cu`` says how), as v3 differs from v2 on the TPU; so
:func:`lynx_layer_fused_plain` is the plain version of both.  Arguments keep
the JAX layouts; the conv module's weights come from
:func:`prepare_layer_weights` (the layout of ``lynx_conv.prepare_weights``,
so one preparation serves K1, K5, K7 and K8).  On a CPU tensor the wrappers
run the plain version; on a CUDA tensor they launch their kernel or raise.
The kernels take bf16 ``x`` and ``cond_proj``, dim % 64 == 0 up to 1024,
inner % 64 == 0 and k <= 33.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .lynx_conv import _pads, dwconv_prelu, prepare_weights

launches_v2 = 0  # wrapper calls that launched K5
launches_v3 = 0  # wrapper calls that launched K7

MAX_DIM = 1024
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

prepare_layer_weights = prepare_weights


def lynx_layer_fused_plain(x, cond_proj, step, ln_scale, ln_bias, w_in, b_in, dw_kernel,
                           dw_bias, alpha, w2, b2, kernel_size: int = 31) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch: product inputs and ``res``
    rounded to ``x``'s dtype, f32 everything else.  With bf16 ``x`` that is
    the kernels; with f32 ``x`` (CPU only) the layer is exact f32."""
    inner = w2.shape[0]
    pd = x.dtype
    res = (x.float() + cond_proj.float()).to(pd).float()
    h = res + step.float()[:, None, :]
    mean = h.mean(-1, keepdim=True)
    var = ((h - mean) ** 2).mean(-1, keepdim=True)
    xn = (h - mean) * torch.rsqrt(var + 1e-5) * ln_scale.float() + ln_bias.float()
    y = xn.to(pd).float() @ w_in.to(pd).float()
    b_in = b_in.float()
    g = y[..., inner:] + b_in[inner:]
    u = (y[..., :inner] + b_in[:inner]) * (g * torch.sigmoid(g))
    acc = dwconv_prelu(u, dw_kernel, dw_bias, alpha, kernel_size)
    out = acc.to(pd).float() @ w2.to(pd).float() + b2.float() + res
    return out.to(x.dtype)


def weight_spec(dim: int, inner: int, k: int):
    """Name, dtype and shape of each tensor of :func:`prepare_layer_weights`."""
    f32, bf16 = torch.float32, torch.bfloat16
    return (("ln_scale", f32, (dim,)), ("ln_bias", f32, (dim,)),
            ("w_in", bf16, (dim, 2 * inner)), ("b_in", f32, (2 * inner,)),
            ("dw_kernel", f32, (k, inner)), ("dw_bias", f32, (inner,)),
            ("alpha", f32, (inner,)), ("w2", bf16, (inner, dim)), ("b2", f32, (dim,)))


def check_weights(fn: str, device, weights, spec, dim: int, inner: int, k: int) -> None:
    """Raise unless ``weights`` match ``spec`` (contiguous, on ``device``), the
    widths are the kernels' and the WMMA operands are 32-byte aligned (shared
    with K8)."""
    for t, (name, dtype, shape) in zip(weights, spec, strict=True):
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{fn}: {name} must be a contiguous {dtype} {shape} tensor on {device} "
                f"(see prepare_layer_weights), got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if dtype == torch.bfloat16 and t.data_ptr() % 32:
            raise ValueError(f"{fn}: {name} must be 32-byte aligned (WMMA loads from memory)")
    if dim % 64 or dim > MAX_DIM or inner % 64 or not 1 <= k <= 33:
        raise ValueError(
            f"{fn} kernel needs dim % 64 == 0 with dim <= {MAX_DIM}, inner % 64 == 0 and "
            f"k <= 33 (dim={dim}, inner={inner}, k={k})"
        )


def _launch(entry: str, x, cond_proj, step, weights, kernel_size: int) -> torch.Tensor:
    global launches_v2, launches_v3
    fn_name = "lynx_layer_fused" if entry == "v2" else "lynx_layer_fused_v3"
    for name, t in (("x", x), ("cond_proj", cond_proj)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{fn_name} kernel takes bf16 {name}, got {t.dtype}")
    if cond_proj.shape != x.shape or cond_proj.device != x.device:
        raise ValueError(f"{fn_name}: cond_proj {tuple(cond_proj.shape)} on {cond_proj.device} "
                         f"must match x {tuple(x.shape)} on {x.device}")
    B, T, dim = x.shape
    if tuple(step.shape) != (B, dim) or step.device != x.device:
        raise ValueError(f"{fn_name}: step must be [B, dim] = {(B, dim)} on {x.device}, got "
                         f"{tuple(step.shape)} on {step.device}")
    inner = weights[7].shape[0]
    check_weights(fn_name, x.device, weights, weight_spec(dim, inner, kernel_size), dim, inner,
                  kernel_size)
    x, cond_proj = x.contiguous(), cond_proj.contiguous()
    step = step.to(torch.float32).contiguous()
    for name, t in (("x", x), ("cond_proj", cond_proj)):
        if t.data_ptr() % 16:
            raise ValueError(f"{fn_name}: {name} must be 16-byte aligned (vector loads)")
    out = torch.empty_like(x)
    lib = build.load("lynx_layer")
    fn = getattr(lib, f"lynx_layer_{entry}_launch")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    pad_l, _ = _pads(kernel_size)
    ptrs = [t.data_ptr() for t in (x, cond_proj, step, *weights, out)]
    with torch.cuda.device(x.device):
        status = fn(*ptrs, B, T, dim, inner, kernel_size, pad_l, build.stream_ptr(x.device))
    build.check(status, f"{fn_name} launch")
    if entry == "v2":
        launches_v2 += 1
    else:
        launches_v3 += 1
    return out


def _dispatch(entry, x, cond_proj, step, weights, kernel_size):
    if x.device.type == "cpu":
        return lynx_layer_fused_plain(x, cond_proj, step, *weights, kernel_size=kernel_size)
    if x.device.type != "cuda":
        raise ValueError(f"lynx_layer_fused: unsupported device {x.device}")
    return _launch(entry, x, cond_proj, step, weights, kernel_size)


def lynx_layer_fused(x, cond_proj, step, weights, *, kernel_size: int = 31) -> torch.Tensor:
    """One strong_cond layer ``[B, T, dim]`` through K5 (one block per
    16-row tile).  ``step`` is the layer's diffusion-step projection
    ``[B, dim]``; ``weights`` come from :func:`prepare_layer_weights`."""
    return _dispatch("v2", x, cond_proj, step, weights, kernel_size)


def lynx_layer_fused_v3(x, cond_proj, step, weights, *, kernel_size: int = 31) -> torch.Tensor:
    """The same layer through K7 (persistent blocks, ``cp.async`` double
    buffering); the arguments of :func:`lynx_layer_fused`."""
    return _dispatch("v3", x, cond_proj, step, weights, kernel_size)
