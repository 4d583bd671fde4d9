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
weights are ``lynx_conv.prepare_weights``' tuple, whole.  On a CPU tensor the
tail runs :func:`conv_tail_plain`; on a CUDA tensor it launches
``csrc/lynx_hybrid.cu`` (K1's conv pass over the bf16 rows, then K1's output
product on the GEMM core ``csrc/sm90_gemm.cuh``) or raises.  The kernel takes
bf16 ``inner`` (contiguous, 16-byte aligned) and K1's widths: dim % 64 == 0
and inner % 64 == 0 with no cap on dim, k <= 33.
"""

from __future__ import annotations

import ctypes
from collections import namedtuple

import torch

from . import build, sm90
from .lynx_conv import _pads, check_widths, dwconv_prelu

launches = 0  # conv_tail calls that launched K8

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_TAIL = slice(4, 9)  # dw_kernel, dw_bias, alpha, w2, b2 of the prepared tuple
_TAIL_NAMES = ("dw_kernel", "dw_bias", "alpha", "w2", "b2")


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


_Operands = namedtuple("_Operands", "device dim inner w2_t map_w2 bn_out")
_maps = sm90.MapCache("lynx_hybrid")


def kernel_operands(weights) -> _Operands:
    """K8's maker for ``Prepared.operands``: checks the tail's weights once,
    then builds ``w2``'s K-major copy, its tensor map and the N tile (the
    head's ``w_in`` is never copied)."""
    dw, dw_bias, alpha, w2, b2 = weights[_TAIL]
    inner, dim = w2.shape
    expect = ((dw, torch.float32, (dw.shape[0], inner)), (dw_bias, torch.float32, (inner,)),
              (alpha, torch.float32, (inner,)), (w2, torch.bfloat16, (inner, dim)),
              (b2, torch.float32, (dim,)))
    for name, (t, dtype, shape) in zip(_TAIL_NAMES, expect):
        if t.device != w2.device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"conv_tail: {name} must be a contiguous {dtype} {shape} tensor on {w2.device} "
                f"(see prepare_weights), got {t.dtype} {tuple(t.shape)} on {t.device}")
        sm90.check_operand("conv_tail", name, t, " (see prepare_weights)")
    w2_t = sm90.k_major(w2)
    bn_out = sm90.tile_n(dim)
    return _Operands(w2.device, dim, inner, w2_t, sm90.encode("lynx_hybrid", w2_t, bn_out), bn_out)


def _launch(inner, weights, kernel_size: int) -> torch.Tensor:
    global launches
    if inner.dtype != torch.bfloat16:
        raise TypeError(f"conv_tail kernel takes bf16 inner activations, got {inner.dtype}")
    if not isinstance(weights, sm90.Prepared):
        raise ValueError("conv_tail: weights must be the whole tuple of prepare_weights "
                         "(or prepare_layer_weights)")
    B, T, n = inner.shape
    dim = weights[7].shape[1]
    check_widths(dim, n, kernel_size, "conv_tail")
    ops = weights.operands(kernel_operands)
    dw = weights[4]
    if ops.device != inner.device or ops.inner != n or dw.shape[0] != kernel_size:
        raise ValueError(
            f"conv_tail: weights of inner width {ops.inner} with {dw.shape[0]} taps on "
            f"{ops.device} for inner {tuple(inner.shape)} on {inner.device}, k={kernel_size} "
            f"(see prepare_weights)")
    sm90.check_operand("conv_tail", "inner", inner, reader="vector loads")
    rows = B * T
    act = torch.empty(rows, n, dtype=torch.bfloat16, device=inner.device)
    out = torch.empty(B, T, dim, dtype=torch.bfloat16, device=inner.device)
    _, dw_bias, alpha, _, b2 = weights[_TAIL]
    pad_l, _ = _pads(kernel_size)
    with torch.cuda.device(inner.device):
        map_act = _maps.get(act, sm90.BM)
        fn = sm90.function("lynx_hybrid", "lynx_conv_tail_launch", _ARGTYPES)
        status = fn(ctypes.addressof(map_act), ctypes.addressof(ops.map_w2),
                    *[t.data_ptr() for t in (inner, dw, dw_bias, alpha, b2, act, out)],
                    B, T, dim, n, kernel_size, pad_l, ops.bn_out, build.stream_ptr(inner.device))
    build.check(status, "conv_tail launch")
    launches += 1
    return out


def conv_tail(inner, weights, *, kernel_size: int = 31) -> torch.Tensor:
    """K8: ``[B, T, dim]`` from the bf16 head output ``inner``; ``weights``
    are ``prepare_weights``' whole tuple (the tail reads its last five:
    ``dw_kernel``, ``dw_bias``, ``alpha``, ``w2``, ``b2``)."""
    if inner.device.type == "cpu":
        return conv_tail_plain(inner, *weights[_TAIL], kernel_size=kernel_size)
    if inner.device.type != "cuda":
        raise ValueError(f"conv_tail: unsupported device {inner.device}")
    return _launch(inner, weights, kernel_size)


def lynx_conv_module_hybrid(x, weights, *, kernel_size: int = 31) -> torch.Tensor:
    """The conv-module output ``[B, T, dim]`` in ``x``'s dtype (residual not
    added): :func:`conv_head` then :func:`conv_tail`.  ``weights`` come from
    ``lynx_conv.prepare_weights``; the head's product dtype is ``w_in``'s."""
    ln_scale, ln_bias, w_in, b_in = weights[:4]
    inner = conv_head(x, ln_scale, ln_bias, w_in, b_in, product_dtype=w_in.dtype)
    return conv_tail(inner, weights, kernel_size=kernel_size).to(x.dtype)
