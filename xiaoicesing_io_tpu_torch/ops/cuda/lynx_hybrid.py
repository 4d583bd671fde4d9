"""LYNXNet conv module, hybrid schedule: a PyTorch head and a CUDA conv tail.

Replaces ``xiaoicesing_io_tpu/ops/pallas/lynx_hybrid.py:lynx_conv_module_hybrid``
(K8).  The module is split where the JAX package splits it:

* head, plain PyTorch on every device (the JAX package leaves it to XLA):
  LayerNorm (f32) -> ``[rows, dim] x [dim, 2*inner]`` product -> SwiGLU (f32)
  -> ``inner`` rounded to bf16.  The product takes bf16 inputs; a bf16
  ``torch.matmul`` rounds its result to bf16 before the bias is added, which
  JAX's f32-output product does not, so the port's head rounds once more
  than JAX's (within the 5e-2 bar at which JAX holds hybrid against v1);
* tail, :func:`conv_tail` (K8): depthwise conv over the bf16 ``inner`` rows
  (f32 taps, zero rows outside each sequence), bias, PReLU, the activation
  rounded to bf16, the ``[inner -> dim]`` product (f32 accumulation) and
  ``+ b2``, written in ``inner``'s dtype.

The module output has the residual NOT added (``lynx_hybrid.py:72``).  The
weights are ``lynx_conv.prepare_weights``' tuple.  On a CPU tensor the tail
runs :func:`conv_tail_plain`; on a CUDA tensor it launches
``csrc/lynx_hybrid.cu`` or raises.  The kernel takes bf16 ``inner``,
dim % 64 == 0 up to 1024, inner % 64 == 0 and k <= 33.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .lynx_conv import _pads, dwconv_prelu

launches = 0  # conv_tail calls that launched K8

MAX_DIM = 1024  # the tail's [16, dim] f32 accumulator lives in WMMA fragments (lynx_tile.cuh)

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def weight_spec(dim: int, inner: int, k: int):
    """Name, dtype and shape of each tensor of ``prepare_weights``' tuple."""
    f32, bf16 = torch.float32, torch.bfloat16
    return (("ln_scale", f32, (dim,)), ("ln_bias", f32, (dim,)),
            ("w_in", bf16, (dim, 2 * inner)), ("b_in", f32, (2 * inner,)),
            ("dw_kernel", f32, (k, inner)), ("dw_bias", f32, (inner,)),
            ("alpha", f32, (inner,)), ("w2", bf16, (inner, dim)), ("b2", f32, (dim,)))


def check_weights(fn: str, device, weights, spec, dim: int, inner: int, k: int) -> None:
    """Raise unless K8's ``weights`` match ``spec`` (contiguous, on
    ``device``), the widths are the kernel's and its WMMA operands are
    32-byte aligned (``w2`` is read by WMMA loads from device memory)."""
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


def conv_head(x, ln_scale, ln_bias, w_in, b_in, product_dtype=torch.bfloat16) -> torch.Tensor:
    """LayerNorm -> pw_in -> SwiGLU; returns ``inner`` ``[B, T, inner]`` in
    ``product_dtype``."""
    inner = w_in.shape[1] // 2
    xn = torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), ln_scale.float(),
                                        ln_bias.float(), 1e-5)
    y = (xn.to(product_dtype) @ w_in.to(product_dtype)).float() + b_in.float()
    g = y[..., inner:]
    return (y[..., :inner] * (g * torch.sigmoid(g))).to(product_dtype)


def conv_tail_plain(inner, dw_kernel, dw_bias, alpha, w2, b2,
                    kernel_size: int = 31) -> torch.Tensor:
    """K8's arithmetic in plain PyTorch: f32 conv taps, the activation and
    the product weights rounded to ``inner``'s dtype, f32 accumulation."""
    pd = inner.dtype
    acc = dwconv_prelu(inner, dw_kernel, dw_bias, alpha, kernel_size)
    out = acc.to(pd).float() @ w2.to(pd).float() + b2.float()
    return out.to(pd)


def _launch(inner, weights, kernel_size: int) -> torch.Tensor:
    global launches
    if inner.dtype != torch.bfloat16:
        raise TypeError(f"conv_tail kernel takes bf16 inner activations, got {inner.dtype}")
    B, T, n = inner.shape
    dim = weights[3].shape[1]
    check_weights("conv_tail", inner.device, weights, weight_spec(dim, n, kernel_size)[4:],
                  dim, n, kernel_size)
    inner = inner.contiguous()
    if inner.data_ptr() % 16:
        raise ValueError("conv_tail: inner must be 16-byte aligned (vector loads)")
    out = torch.empty(B, T, dim, dtype=torch.bfloat16, device=inner.device)
    lib = build.load("lynx_hybrid")
    fn = lib.lynx_conv_tail_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    pad_l, _ = _pads(kernel_size)
    ptrs = [t.data_ptr() for t in (inner, *weights, out)]
    with torch.cuda.device(inner.device):
        status = fn(*ptrs, B, T, dim, n, kernel_size, pad_l, build.stream_ptr(inner.device))
    build.check(status, "conv_tail launch")
    launches += 1
    return out


def conv_tail(inner, tail_weights, *, kernel_size: int = 31) -> torch.Tensor:
    """K8: ``[B, T, dim]`` from the bf16 head output ``inner``;
    ``tail_weights`` are the last five of ``prepare_weights``' tuple
    (``dw_kernel``, ``dw_bias``, ``alpha``, ``w2``, ``b2``)."""
    if inner.device.type == "cpu":
        return conv_tail_plain(inner, *tail_weights, kernel_size=kernel_size)
    if inner.device.type != "cuda":
        raise ValueError(f"conv_tail: unsupported device {inner.device}")
    return _launch(inner, tail_weights, kernel_size)


def lynx_conv_module_hybrid(x, weights, *, kernel_size: int = 31) -> torch.Tensor:
    """The conv-module output ``[B, T, dim]`` in ``x``'s dtype (residual not
    added): :func:`conv_head` then :func:`conv_tail`.  ``weights`` come from
    ``lynx_conv.prepare_weights``; the head's product dtype is ``w_in``'s."""
    ln_scale, ln_bias, w_in, b_in = weights[:4]
    inner = conv_head(x, ln_scale, ln_bias, w_in, b_in, product_dtype=w_in.dtype)
    return conv_tail(inner, weights[4:], kernel_size=kernel_size).to(x.dtype)
