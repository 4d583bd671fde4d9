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
``csrc/wavenet_block.cu`` once or raises.  The kernel takes C % 64 == 0,
64 <= C <= 512, and any dilation d >= 1 whose 64 + 2d staged rows fit the
block's shared memory (:func:`smem_bytes`: d <= 32 at C = 512, d <= 124 at
C = 256).  The bound and the design are described in the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

MAX_CHANNELS = 512
MAX_SMEM = 232448  # bytes of shared memory a block may use on an H100

launches = 0  # wrapper calls that launched the CUDA kernel

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def smem_bytes(C: int, d: int) -> int:
    """Shared memory of one block, as ``csrc/wavenet_block.cu:smem_bytes``
    computes it: 64 + 2d rows of y and 64 rows of g at a stride of C + 16
    bf16, plus 27,648 bytes of weight staging."""
    return (2 * 64 + 2 * d) * (C + 16) * 2 + 3 * 32 * 144 * 2


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
    """The kernel's operand types and layouts, contiguous: product weights in
    ``product_dtype`` (bf16 for the kernel), biases f32.  Do this once per set
    of weights."""
    f32, pd = torch.float32, product_dtype
    return (conv_kernel.to(pd).contiguous(), conv_bias.to(f32).contiguous(),
            out_kernel.to(pd).contiguous(), out_bias.to(f32).contiguous())


def _launch(y, cond_proj, weights, dilation: int) -> torch.Tensor:
    global launches
    if y.dtype != torch.bfloat16:
        raise TypeError(f"wavenet_block kernel takes bf16 activations, got {y.dtype}")
    B, T, C = y.shape
    d = int(dilation)
    if C % 64 or not 64 <= C <= MAX_CHANNELS or d < 1 or smem_bytes(C, d) > MAX_SMEM:
        raise ValueError(
            f"wavenet_block kernel needs C % 64 == 0, 64 <= C <= {MAX_CHANNELS} and d >= 1 with "
            f"{smem_bytes(C, max(d, 1))} <= {MAX_SMEM} bytes of shared memory (C={C}, d={d})"
        )
    conv_kernel, conv_bias, out_kernel, out_bias = weights
    expect = {
        "cond_proj": (cond_proj, torch.bfloat16, (B, T, 2 * C)),
        "conv_kernel": (conv_kernel, torch.bfloat16, (3, C, 2 * C)),
        "conv_bias": (conv_bias, torch.float32, (2 * C,)),
        "out_kernel": (out_kernel, torch.bfloat16, (C, 2 * C)),
        "out_bias": (out_bias, torch.float32, (2 * C,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != y.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"wavenet_block: {name} must be a {dtype} {shape} tensor on {y.device} "
                f"(weights: see prepare_weights), got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    y = y.contiguous()
    cond_proj = cond_proj.contiguous()
    for name, t in (("conv_kernel", conv_kernel), ("conv_bias", conv_bias),
                    ("out_kernel", out_kernel), ("out_bias", out_bias)):
        if not t.is_contiguous():
            raise ValueError(f"wavenet_block: {name} must be contiguous (see prepare_weights)")
    for name, t in (("y", y), ("cond_proj", cond_proj), ("conv_kernel", conv_kernel),
                    ("out_kernel", out_kernel)):
        if t.data_ptr() % 16:
            raise ValueError(f"wavenet_block: {name} must be 16-byte aligned (vector loads)")
    out = torch.empty(B, T, 2 * C, dtype=torch.bfloat16, device=y.device)
    lib = build.load("wavenet_block")
    fn = lib.wavenet_block_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in (y, cond_proj, conv_kernel, conv_bias, out_kernel, out_bias,
                                   out)]
    with torch.cuda.device(y.device):
        status = fn(*ptrs, B, T, C, d, build.stream_ptr(y.device))
    build.check(status, "wavenet_block launch")
    launches += 1
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
