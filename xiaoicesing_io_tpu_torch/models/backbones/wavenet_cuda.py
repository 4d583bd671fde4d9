"""WaveNet denoiser apply on the residual-block kernel (inference path).

Counterpart of the JAX package's ``models/backbones/wavenet_pallas.py``
(``wavenet_denoiser_apply``): the same math as ``WaveNet.forward``, with
``ops/cuda/wavenet_block.py:wavenet_block`` in place of each layer's dilated
conv -> gating -> output projection chain.  It rounds where the JAX apply
rounds: ``x``, the step MLP and the conditioner projections are in
``compute_dtype``; the kernel returns ``[residual | skip]`` in ``x``'s dtype;
``x = (x + residual) / sqrt(2)`` and ``skip_sum += skip`` are in
``compute_dtype``.  bf16 with the kernel on the card, f32 with its plain
version on the CPU.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...ops.cuda.wavenet_block import prepare_weights, wavenet_block
from .lynxnet import dense
from .wavenet import WaveNet


def wavenet_cond_projections(backbone: WaveNet, cond: torch.Tensor,
                             compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, ...]:
    """Per-layer conditioner projections ``[B, T, 2C]``, invariant across
    sampler steps: compute once per synthesis and pass as ``cond_projs``."""
    cond = cond.to(compute_dtype)
    return tuple(dense(layer.conditioner_projection, cond) for layer in backbone.residual_layers)


def wavenet_kernel_weights(backbone: WaveNet, compute_dtype=torch.bfloat16) -> List[tuple]:
    """Each layer's block weights in the kernel's layouts (JAX layouts, product
    weights in ``compute_dtype``): prepare once per set of weights and pass as
    ``kernel_weights``."""
    return [
        prepare_weights(layer.dilated_conv.weight.permute(2, 1, 0), layer.dilated_conv.bias,
                        layer.output_projection.weight[:, :, 0].t(), layer.output_projection.bias,
                        product_dtype=compute_dtype)
        for layer in backbone.residual_layers
    ]


def wavenet_denoiser_apply(
    backbone: WaveNet,
    spec: torch.Tensor,            # [B, F, T, M]
    diffusion_step: torch.Tensor,  # [B]
    cond: Optional[torch.Tensor] = None,  # [B, T, H]; unused when cond_projs is given
    *,
    cond_projs: Optional[Sequence[torch.Tensor]] = None,
    kernel_weights: Optional[Sequence[tuple]] = None,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    B, F_, T, M = spec.shape
    cd = compute_dtype
    if cond_projs is None:
        cond_projs = wavenet_cond_projections(backbone, cond, cd)
    if kernel_weights is None:
        kernel_weights = wavenet_kernel_weights(backbone, cd)
    x = spec.transpose(1, 2).reshape(B, T, F_ * M).to(cd)
    x = F.relu(dense(backbone.input_projection, x))
    C = x.shape[-1]
    step = backbone.step_embedding(diffusion_step, cd)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    skip_sum = torch.zeros_like(x)
    for layer, cond_proj, weights in zip(backbone.residual_layers, cond_projs, kernel_weights):
        y = x + dense(layer.diffusion_projection, step)[:, None, :]
        out = wavenet_block(y, cond_proj.to(cd), weights, dilation=layer.dilation)
        x = (x + out[..., :C].to(cd)) * inv_sqrt2
        skip_sum = skip_sum + out[..., C:].to(cd)
    x = skip_sum * (1.0 / math.sqrt(len(backbone.residual_layers)))
    x = F.relu(dense(backbone.skip_projection, x))
    out = dense(backbone.output_projection, x)
    return out.reshape(B, T, F_, M).transpose(1, 2)
