"""LYNXNet denoiser apply on the conv-module kernels (inference path).

Counterpart of the JAX package's ``models/backbones/lynx_pallas.py``: the
same math as ``LYNXNet.forward``, with a kernel in place of the LayerNorm ->
pw_in -> SwiGLU -> depthwise conv -> PReLU -> pw_out chain.  Activations
between layers, the step embedding and the conditioner projections are in
``compute_dtype`` (bf16 on the card); the final LayerNorm is f32 and the
output projection ``compute_dtype``.  The kernel is chosen as in JAX:

* ``module_impl="v1"``: ``ops/cuda/lynx_conv.py:lynx_conv_module`` (K1);
* ``module_impl="hybrid"``: ``ops/cuda/lynx_hybrid.py`` (a PyTorch head,
  then the conv tail K8);
* ``fused_layer=True`` or ``"v2"`` (K5), ``"v3"`` (K7): the whole layer,
  ``ops/cuda/lynx_layer.py``, with the step and the residual added in f32
  inside the kernel.  Only with ``strong_cond``: otherwise the layer runs
  ``module_impl``, as in JAX.

JAX's ``tile``, ``chunks`` and ``dw_impl`` are TPU schedule parameters that
change no number, and ``ablate`` gives wrong results on purpose for TPU cost
attribution: none of them is taken here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...ops.cuda.lynx_conv import lynx_conv_module, prepare_weights
from ...ops.cuda.lynx_hybrid import lynx_conv_module_hybrid
from ...ops.cuda.lynx_layer import lynx_layer_fused, lynx_layer_fused_v3
from .lynxnet import LYNXNet, dense


def lynx_cond_projections(backbone: LYNXNet, cond: torch.Tensor,
                          compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, ...]:
    """Per-layer conditioner projections, invariant across sampler steps:
    compute once per synthesis and pass as ``cond_projs``."""
    cond = cond.to(compute_dtype)
    return tuple(dense(layer.conditioner_projection, cond) for layer in backbone.residual_layers)


def lynx_kernel_weights(backbone: LYNXNet, compute_dtype=torch.bfloat16) -> List[tuple]:
    """Each layer's conv-module parameters in the kernels' layouts (JAX
    layouts, product weights in ``compute_dtype``): prepare once per set of
    weights and pass as ``kernel_weights``.  K1, K5, K7 and K8 take the same
    tuple, so one preparation serves every ``fused_layer`` and
    ``module_impl``."""
    out = []
    for layer in backbone.residual_layers:
        net = layer.convmodule.net
        out.append(prepare_weights(
            net[0].weight, net[0].bias,
            net[2].weight[:, :, 0].t(), net[2].bias,
            net[4].weight.permute(2, 1, 0), net[4].bias,
            net[5].weight,
            net[6].weight[:, :, 0].t(), net[6].bias,
            product_dtype=compute_dtype,
        ))
    return out


def lynx_denoiser_apply(
    backbone: LYNXNet,
    spec: torch.Tensor,            # [B, F, T, M]
    diffusion_step: torch.Tensor,  # [B]
    cond: Optional[torch.Tensor] = None,  # [B, T, H]; unused when cond_projs is given
    *,
    cond_projs: Optional[Sequence[torch.Tensor]] = None,
    kernel_weights: Optional[Sequence[tuple]] = None,
    compute_dtype=torch.bfloat16,
    fused_layer=False,
    module_impl: str = "v1",
) -> torch.Tensor:
    if backbone.activation != "PReLU":
        raise ValueError("the conv-module kernel implements the PReLU activation")
    if fused_layer not in (False, True, "v2", "v3"):
        raise ValueError(f"fused_layer must be False, True, 'v2' or 'v3', got {fused_layer!r}")
    if module_impl not in ("v1", "hybrid"):
        raise ValueError(f"module_impl must be 'v1' or 'hybrid', got {module_impl!r}")
    module = lynx_conv_module_hybrid if module_impl == "hybrid" else lynx_conv_module
    layer_fn = lynx_layer_fused_v3 if fused_layer == "v3" else lynx_layer_fused
    k = backbone.kernel_size
    B, F_, T, M = spec.shape
    cd = compute_dtype
    if cond_projs is None:
        cond_projs = lynx_cond_projections(backbone, cond, cd)
    if kernel_weights is None:
        kernel_weights = lynx_kernel_weights(backbone, cd)
    x = spec.transpose(1, 2).reshape(B, T, F_ * M).to(cd)
    x = dense(backbone.input_projection, x)
    if not backbone.strong_cond:
        x = F.gelu(x)
    step = backbone.step_embedding(diffusion_step, cd)
    for layer, cond_proj, weights in zip(backbone.residual_layers, cond_projs, kernel_weights):
        cond_proj = cond_proj.to(cd)
        if fused_layer and backbone.strong_cond:
            x = layer_fn(x, cond_proj, dense(layer.diffusion_projection, step), weights,
                         kernel_size=k).to(cd)
            continue
        if backbone.strong_cond:
            x = x + cond_proj
            res = x
            h = x
        else:
            res = x
            h = x + cond_proj
        h = h + dense(layer.diffusion_projection, step)[:, None, :]
        h = module(h, weights, kernel_size=k).to(cd)
        x = h + res
    xf = F.layer_norm(x.float(), (x.shape[-1],), backbone.norm.weight, backbone.norm.bias, 1e-5)
    out = dense(backbone.output_projection, xf.to(cd))
    return out.reshape(B, T, F_, M).transpose(1, 2)
