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
launches ``csrc/lynx_conv.cu`` (four passes: LayerNorm, the SwiGLU product
and the output product on the Hopper GEMM core ``csrc/sm90_gemm.cuh``, the
depthwise conv between them) or raises.  The kernel takes dim % 64 == 0,
inner % 64 == 0 and k <= 33.  The bound and the design are described in the
CUDA source.
"""

from __future__ import annotations

import ctypes
from collections import namedtuple

import torch
import torch.nn.functional as F

from . import build, sm90

launches = 0  # wrapper calls that launched the CUDA kernel

_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _pads(k: int):
    pad_l = k // 2
    pad_r = pad_l - (k + 1) % 2  # torch 'same' padding for even/odd k
    return pad_l, pad_r


def lynx_conv_module_plain(x, ln_scale, ln_bias, w_in, b_in, dw_kernel, dw_bias, alpha,
                           w2, b2, kernel_size: int = 31) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: product inputs rounded to
    ``x``'s dtype, f32 accumulation and f32 elementwise work.  With bf16 ``x``
    that is the kernel; with f32 ``x`` (CPU only) the module is exact f32."""
    inner = w2.shape[0]
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
    acc = dwconv_prelu(u, dw_kernel, dw_bias, alpha, kernel_size)
    out = acc.to(pd).float() @ w2.to(pd).float() + b2.float()
    return out.to(x.dtype)


def dwconv_prelu(u, dw_kernel, dw_bias, alpha, kernel_size: int) -> torch.Tensor:
    """The kernels' depthwise conv over time (f32 taps, the conv's zero
    padding on ``u``'s rows), + bias, PReLU: ``[B, T, inner]`` f32."""
    B, T, inner = u.shape
    k = kernel_size
    pad_l, pad_r = _pads(k)
    u = F.pad(u.float(), (0, 0, pad_l, pad_r))
    dw = dw_kernel.reshape(k, inner).float()
    acc = torch.zeros(B, T, inner, dtype=torch.float32, device=u.device)
    for tap in range(k):
        acc = acc + u[:, tap:tap + T] * dw[tap]
    acc = acc + dw_bias.float()
    return torch.where(acc >= 0, acc, alpha.float() * acc)


def prepare_weights(ln_scale, ln_bias, w_in, b_in, dw_kernel, dw_bias, alpha, w2, b2,
                    product_dtype=torch.bfloat16):
    """The kernel's operand types, contiguous, in the JAX layouts: product
    weights in ``product_dtype`` (bf16 for the kernel), f32 everything else.
    Do this once per set of weights: K1, K5, K7 and K8 read the same tuple,
    and the K-major copies K1 reads are built from it at its first launch and
    kept with it (:func:`kernel_operands`)."""
    f32, pd = torch.float32, product_dtype
    inner = w2.shape[0]
    return sm90.Prepared((
        ln_scale.to(f32).contiguous(), ln_bias.to(f32).contiguous(),
        w_in.to(pd).contiguous(), b_in.to(f32).contiguous(),
        dw_kernel.reshape(-1, inner).to(f32).contiguous(), dw_bias.to(f32).contiguous(),
        alpha.to(f32).contiguous(), w2.to(pd).contiguous(), b2.to(f32).contiguous(),
    ))


def k_major_weights(weights):
    """``w_in`` ``[dim, 2 inner]`` as a K-major, column-paired ``[2 inner,
    dim]`` (tile p: out columns Pp.., then gate columns inner + Pp.., P =
    ``sm90.pair_width(inner)``) and ``w2`` as K-major ``[dim, inner]``."""
    w_in, w2 = weights[2], weights[7]
    return sm90.paired_k_major(w_in, sm90.pair_width(w2.shape[0])), sm90.k_major(w2)


_Operands = namedtuple("_Operands", "device dim inner win_t w2_t map_w_in map_w2 bn_in bn_out")
_maps = sm90.MapCache("lynx_conv")


def kernel_operands(weights) -> _Operands:
    """Checks the prepared weights once, then builds :func:`k_major_weights`,
    their tensor maps and the two products' N tiles."""
    ln_scale, ln_bias, w_in, b_in, dw, dw_bias, alpha, w2, b2 = weights
    inner, dim = w2.shape
    expect = {
        "ln_scale": (ln_scale, torch.float32, (dim,)),
        "ln_bias": (ln_bias, torch.float32, (dim,)),
        "w_in": (w_in, torch.bfloat16, (dim, 2 * inner)),
        "b_in": (b_in, torch.float32, (2 * inner,)),
        "dw_kernel": (dw, torch.float32, (dw.shape[0], inner)),
        "dw_bias": (dw_bias, torch.float32, (inner,)),
        "alpha": (alpha, torch.float32, (inner,)),
        "w2": (w2, torch.bfloat16, (inner, dim)),
        "b2": (b2, torch.float32, (dim,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != w2.device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"lynx_conv_module: {name} must be a contiguous {dtype} {shape} tensor on "
                f"{w2.device} (see prepare_weights), got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        sm90.check_operand("lynx_conv_module", name, t, " (see prepare_weights)")
    win_t, w2_t = k_major_weights(weights)
    bn_in, bn_out = 2 * sm90.pair_width(inner), sm90.tile_n(dim)
    return _Operands(w2.device, dim, inner, win_t, w2_t, sm90.encode("lynx_conv", win_t, bn_in),
                     sm90.encode("lynx_conv", w2_t, bn_out), bn_in, bn_out)


def check_widths(dim: int, inner: int, kernel_size: int, fn: str = "lynx_conv_module") -> None:
    """The widths K1's passes take (K5 and K7 take the same)."""
    if dim % 64 or inner % 64 or min(dim, inner) < 64 or not 1 <= kernel_size <= 33:
        raise ValueError(
            f"{fn} kernel needs dim % 64 == 0, inner % 64 == 0 and 1 <= k <= 33 "
            f"(dim={dim}, inner={inner}, k={kernel_size})"
        )


def _launch(x, weights, kernel_size: int) -> torch.Tensor:
    global launches
    if x.dtype != torch.bfloat16:
        raise TypeError(f"lynx_conv_module kernel takes bf16 activations, got {x.dtype}")
    if not isinstance(weights, sm90.Prepared):
        raise ValueError("lynx_conv_module: weights must come from prepare_weights")
    B, T, dim = x.shape
    inner = weights[7].shape[0]
    check_widths(dim, inner, kernel_size)
    ops = weights.operands(kernel_operands)
    dw = weights[4]
    if ops.device != x.device or ops.dim != dim or dw.shape[0] != kernel_size:
        raise ValueError(
            f"lynx_conv_module: weights of width {ops.dim} with {dw.shape[0]} taps on "
            f"{ops.device} for x {tuple(x.shape)} on {x.device}, k={kernel_size} "
            f"(see prepare_weights)")
    sm90.check_operand("lynx_conv_module", "x", x)
    rows = B * T
    xn = torch.empty(rows, dim, dtype=torch.bfloat16, device=x.device)
    u = torch.empty(rows, inner, dtype=torch.float32, device=x.device)
    act = torch.empty(rows, inner, dtype=torch.bfloat16, device=x.device)
    out = torch.empty(B, T, dim, dtype=torch.bfloat16, device=x.device)
    ln_scale, ln_bias, _, b_in, _, dw_bias, alpha, _, b2 = weights
    pad_l, _ = _pads(kernel_size)
    with torch.cuda.device(x.device):
        map_xn = _maps.get(xn, sm90.BM)
        map_act = _maps.get(act, sm90.BM)
        fn = sm90.function("lynx_conv", "lynx_conv_module_launch", _ARGTYPES)
        status = fn(ctypes.addressof(map_xn), ctypes.addressof(ops.map_w_in),
                    ctypes.addressof(map_act), ctypes.addressof(ops.map_w2),
                    *[t.data_ptr() for t in (x, ln_scale, ln_bias, b_in, dw, dw_bias, alpha, b2,
                                             xn, u, act, out)],
                    B, T, dim, inner, kernel_size, pad_l, ops.bn_in, ops.bn_out,
                    build.stream_ptr(x.device))
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
