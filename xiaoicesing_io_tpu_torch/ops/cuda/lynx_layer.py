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

K5 and K7 compute the same function in the same four launches (``csrc/
lynx_layer.cu``): K1's passes (``csrc/lynx_passes.cuh``) with the layer's
prologue in the LayerNorm pass and ``+ b2 + res`` in the output product's
epilogue.  They differ in the schedule of their two products on the Hopper
GEMM core ``csrc/sm90_gemm.cuh``, as v3 differs from v2 on the TPU: K5 one
tile a block, K7 persistent blocks with TMA stores.  So
:func:`lynx_layer_fused_plain` is the plain version of both.  Arguments keep
the JAX layouts; the conv module's weights come from
:func:`prepare_layer_weights` (``lynx_conv.prepare_weights``): one
preparation serves K1, K5, K7 and K8, and K5 and K7 use K1's K-major copies
and tensor maps (``lynx_conv.kernel_operands``), built once.  On a CPU tensor
the wrappers run the plain version; on a CUDA tensor they launch their
kernel or raise.  The kernels take bf16 ``x`` and ``cond_proj``, contiguous
and 16-byte aligned (they read them with vector loads, not TMA), dim % 64 ==
0, inner % 64 == 0 and k <= 33.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, sm90
from .lynx_conv import _pads, check_widths, dwconv_prelu, kernel_operands, prepare_weights

launches_v2 = 0  # wrapper calls that launched K5
launches_v3 = 0  # wrapper calls that launched K7

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 20 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_GEMM_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_maps = sm90.MapCache("lynx_layer")

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
    if not isinstance(weights, sm90.Prepared):
        raise ValueError(f"{fn_name}: weights must come from prepare_layer_weights")
    inner = weights[7].shape[0]
    check_widths(dim, inner, kernel_size, fn_name)
    ops = weights.operands(kernel_operands)
    dw = weights[4]
    if ops.device != x.device or ops.dim != dim or dw.shape[0] != kernel_size:
        raise ValueError(
            f"{fn_name}: weights of width {ops.dim} with {dw.shape[0]} taps on {ops.device} "
            f"for x {tuple(x.shape)} on {x.device}, k={kernel_size} (see prepare_layer_weights)")
    # the LayerNorm pass and the output product's epilogue index x's and cond_proj's rows
    # themselves, with 4- and 8-byte vector loads
    for name, t in (("x", x), ("cond_proj", cond_proj)):
        sm90.check_operand(fn_name, name, t, reader="vector loads")
    step = step.to(torch.float32).contiguous()
    if step.data_ptr() % 16:
        step = step.clone()
    rows = B * T
    xn = torch.empty(rows, dim, dtype=torch.bfloat16, device=x.device)
    u = torch.empty(rows, inner, dtype=torch.float32, device=x.device)
    act = torch.empty(rows, inner, dtype=torch.bfloat16, device=x.device)
    out = torch.empty(B, T, dim, dtype=torch.bfloat16, device=x.device)
    persistent = entry == "v3"
    ln_scale, ln_bias, _, b_in, _, dw_bias, alpha, _, b2 = weights
    pad_l, _ = _pads(kernel_size)
    with torch.cuda.device(x.device):
        map_xn = _maps.get(xn, sm90.BM)
        map_act = _maps.get(act, sm90.BM)
        if persistent:
            store_u = ctypes.addressof(_maps.get_store(u))
            store_out = ctypes.addressof(_maps.get_store(out.view(rows, dim)))
        else:
            store_u = store_out = None
        fn = sm90.function("lynx_layer", "lynx_layer_launch", _ARGTYPES)
        status = fn(persistent, ctypes.addressof(map_xn), ctypes.addressof(ops.map_w_in),
                    ctypes.addressof(map_act), ctypes.addressof(ops.map_w2), store_u, store_out,
                    *[t.data_ptr() for t in (x, cond_proj, step, ln_scale, ln_bias, b_in, dw,
                                             dw_bias, alpha, b2, xn, u, act, out)],
                    B, T, dim, inner, kernel_size, pad_l, ops.bn_in, ops.bn_out,
                    build.stream_ptr(x.device))
    build.check(status, f"{fn_name} launch")
    if entry == "v2":
        launches_v2 += 1
    else:
        launches_v3 += 1
    return out


def gemm_persistent_bf16(a, b_kmajor, bias, res=None, bn: int = 128) -> torch.Tensor:
    """The GEMM core's persistent entry, bare: ``a [M, K] @ b_kmajor[N, K]^T +
    bias`` (+ ``res [M, N]`` through the rows kind of epilogue) as bf16, for
    the card tests of ``csrc/sm90_gemm.cuh``; the port's paths never call
    it."""
    (M, K), (N, _) = a.shape, b_kmajor.shape
    for name, t in (("a", a), ("b", b_kmajor)):
        if t.dtype != torch.bfloat16 or t.shape[-1] != K or K % sm90.BK:
            raise ValueError(f"gemm_persistent_bf16: {name} must be bf16 with K % 64 == 0")
        sm90.check_operand("gemm_persistent_bf16", name, t)
    if res is not None:
        if res.dtype != torch.bfloat16 or tuple(res.shape) != (M, N):
            raise ValueError("gemm_persistent_bf16: res must be bf16 [M, N]")
        sm90.check_operand("gemm_persistent_bf16", "res", res)
    out = torch.empty(M, N, dtype=torch.bfloat16, device=a.device)
    bias = bias.float().contiguous()
    with torch.cuda.device(a.device):
        map_a = sm90.encode("lynx_layer", a, sm90.BM)
        map_b = sm90.encode("lynx_layer", b_kmajor, bn)
        map_out = sm90.encode_store("lynx_layer", out)
        fn = sm90.function("lynx_layer", "sm90_gemm_persistent_launch", _GEMM_ARGTYPES)
        status = fn(ctypes.addressof(map_a), ctypes.addressof(map_b), ctypes.addressof(map_out),
                    bias.data_ptr(), None if res is None else res.data_ptr(), M, N, K, bn,
                    build.stream_ptr(a.device))
    build.check(status, "sm90_gemm_persistent launch")
    return out


def _dispatch(entry, x, cond_proj, step, weights, kernel_size):
    if x.device.type == "cpu":
        return lynx_layer_fused_plain(x, cond_proj, step, *weights, kernel_size=kernel_size)
    if x.device.type != "cuda":
        raise ValueError(f"lynx_layer_fused: unsupported device {x.device}")
    return _launch(entry, x, cond_proj, step, weights, kernel_size)


def lynx_layer_fused(x, cond_proj, step, weights, *, kernel_size: int = 31) -> torch.Tensor:
    """One strong_cond layer ``[B, T, dim]`` through K5 (its products one
    tile a block).  ``step`` is the layer's diffusion-step projection ``[B,
    dim]``; ``weights`` come from :func:`prepare_layer_weights`."""
    return _dispatch("v2", x, cond_proj, step, weights, kernel_size)


def lynx_layer_fused_v3(x, cond_proj, step, weights, *, kernel_size: int = 31) -> torch.Tensor:
    """The same layer through K7 (its products on persistent blocks with TMA
    stores); the arguments of :func:`lynx_layer_fused`."""
    return _dispatch("v3", x, cond_proj, step, weights, kernel_size)
