"""LYNXNet conv module: CUDA kernel wrapper and its plain PyTorch version.

Replaces ``xiaoicesing_io_tpu/ops/pallas/lynx_conv.py:lynx_conv_module`` (the
TPU kernel ``_kernel``:33).  The module is the per-step hot op of the acoustic
denoiser (6 layers x K sampler steps):

    LayerNorm (f32) -> [dim -> inner] out and gate products -> SwiGLU
    -> zero rows outside the sequence -> depthwise conv (k taps, f32) + bias
    -> PReLU -> [inner -> dim] product + bias          (residual not added)

The products take inputs in ``x``'s dtype and accumulate in f32: with bf16
``x`` that is the TPU kernel's arithmetic, with f32 ``x`` (CPU only) the
module is exact f32.  The output has the input's dtype.  Arguments keep the
JAX layouts: ``w_in`` ``[dim, 2*inner]`` with columns ``[out | gate]``,
``dw_kernel`` ``[k, 1, inner]``, ``w2`` ``[inner, dim]``.

:func:`lynx_conv_module` takes its weights from :func:`prepare_weights`.  On
a CPU tensor it runs :func:`lynx_conv_module_plain`; on a CUDA tensor it
launches ``csrc/lynx_conv.cu`` (two launches: the head up to PReLU, then the
last product; the source says why) or raises.  The kernel takes dim % 64 == 0,
inner % 64 == 0 and k <= 33.  The bound and the design are described in the
CUDA source.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

launches = 0  # wrapper calls that launched the CUDA kernel

_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _pads(k: int):
    pad_l = k // 2
    pad_r = pad_l - (k + 1) % 2  # torch 'same' padding for even/odd k
    return pad_l, pad_r


def lynx_conv_module_plain(x, ln_scale, ln_bias, w_in, b_in, dw_kernel, dw_bias, alpha,
                           w2, b2, kernel_size: int = 31) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: product inputs rounded to
    ``x``'s dtype, f32 accumulation and f32 elementwise work.  With bf16 ``x``
    that is the kernel; with f32 ``x`` (CPU only) the module is exact f32."""
    B, T, dim = x.shape
    inner = w2.shape[0]
    k = kernel_size
    pad_l, pad_r = _pads(k)
    pd = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + 1e-5)
    xn = xn * ln_scale.float() + ln_bias.float()
    h = xn.to(pd).float() @ w_in.to(pd).float()
    b_in = b_in.float()
    g = h[..., inner:] + b_in[inner:]
    u = (h[..., :inner] + b_in[:inner]) * (g * torch.sigmoid(g))
    u = F.pad(u, (0, 0, pad_l, pad_r))  # the conv's zero padding acts on inner rows
    dw = dw_kernel.reshape(k, inner).float()
    acc = torch.zeros(B, T, inner, dtype=torch.float32, device=x.device)
    for tap in range(k):
        acc = acc + u[:, tap:tap + T] * dw[tap]
    acc = acc + dw_bias.float()
    acc = torch.where(acc >= 0, acc, alpha.float() * acc)
    out = acc.to(pd).float() @ w2.to(pd).float() + b2.float()
    return out.to(x.dtype)


def prepare_weights(ln_scale, ln_bias, w_in, b_in, dw_kernel, dw_bias, alpha, w2, b2,
                    product_dtype=torch.bfloat16):
    """The kernel's operand types and layouts, contiguous: product weights in
    ``product_dtype`` (bf16 for the kernel), f32 everything else.  Do this
    once per set of weights."""
    f32, pd = torch.float32, product_dtype
    inner = w2.shape[0]
    return (
        ln_scale.to(f32).contiguous(), ln_bias.to(f32).contiguous(),
        w_in.to(pd).contiguous(), b_in.to(f32).contiguous(),
        dw_kernel.reshape(-1, inner).to(f32).contiguous(), dw_bias.to(f32).contiguous(),
        alpha.to(f32).contiguous(), w2.to(pd).contiguous(), b2.to(f32).contiguous(),
    )


def _launch(x, weights, kernel_size: int) -> torch.Tensor:
    global launches
    if x.dtype != torch.bfloat16:
        raise TypeError(f"lynx_conv_module kernel takes bf16 activations, got {x.dtype}")
    B, T, dim = x.shape
    ln_scale, ln_bias, w_in, b_in, dw, dw_bias, alpha, w2, b2 = weights
    inner = w2.shape[0]
    expect = {
        "ln_scale": (ln_scale, torch.float32, (dim,)),
        "ln_bias": (ln_bias, torch.float32, (dim,)),
        "w_in": (w_in, torch.bfloat16, (dim, 2 * inner)),
        "b_in": (b_in, torch.float32, (2 * inner,)),
        "dw_kernel": (dw, torch.float32, (kernel_size, inner)),
        "dw_bias": (dw_bias, torch.float32, (inner,)),
        "alpha": (alpha, torch.float32, (inner,)),
        "w2": (w2, torch.bfloat16, (inner, dim)),
        "b2": (b2, torch.float32, (dim,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"lynx_conv_module: {name} must be a contiguous {dtype} {shape} tensor on "
                f"{x.device} (see prepare_weights), got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if dim % 64 or inner % 64 or kernel_size - 1 > 32:
        raise ValueError(
            f"lynx_conv_module kernel needs dim % 64 == 0, inner % 64 == 0 and k <= 33 "
            f"(dim={dim}, inner={inner}, k={kernel_size})"
        )
    x = x.contiguous()
    for name, t in (("x", x), ("w_in", w_in), ("w2", w2)):
        if t.data_ptr() % 16:
            raise ValueError(f"lynx_conv_module: {name} must be 16-byte aligned (vector loads)")
    act = torch.empty(B, T, inner, dtype=torch.bfloat16, device=x.device)
    out = torch.empty(B, T, dim, dtype=torch.bfloat16, device=x.device)
    lib = build.load("lynx_conv")
    fn = lib.lynx_conv_module_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    pad_l, _ = _pads(kernel_size)
    ptrs = [t.data_ptr() for t in (x, ln_scale, ln_bias, w_in, b_in, dw, dw_bias, alpha, w2, b2,
                                   act, out)]
    with torch.cuda.device(x.device):
        status = fn(*ptrs, B, T, dim, inner, kernel_size, pad_l, build.stream_ptr(x.device))
    build.check(status, "lynx_conv_module launch")
    launches += 1
    return out


def lynx_conv_module(x, weights, *, kernel_size: int = 31) -> torch.Tensor:
    """Conv-module output ``[B, T, dim]`` (residual not added).  ``weights``
    come from :func:`prepare_weights`.  CPU tensors take the plain version;
    CUDA tensors the kernel, which takes bf16 ``x`` and bf16 product weights."""
    if x.device.type == "cpu":
        return lynx_conv_module_plain(x, *weights, kernel_size=kernel_size)
    if x.device.type != "cuda":
        raise ValueError(f"lynx_conv_module: unsupported device {x.device}")
    return _launch(x, weights, kernel_size)
