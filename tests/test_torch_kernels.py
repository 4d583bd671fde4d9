"""The port's kernel modules against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which repeats the
CUDA kernel's arithmetic (bf16-rounded product inputs, f32 accumulation); here
it is held against the Pallas kernel run with ``interpret=True``, as the JAX
package's own tests run it.  ``tests/test_torch_cuda.py`` holds the CUDA
kernels against the plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_stage as K2
from xiaoicesing_io_tpu_torch.ops.cuda import lynx_conv as K1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on shared cores; torch's
    intra-op threads then oversubscribe them and its convolutions slow down
    many-fold.  One thread per test, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _k1_args(rng, B, T, dim, inner, k):
    return [
        rng.standard_normal((B, T, dim)).astype(np.float32),
        (1.0 + 0.1 * rng.standard_normal(dim)).astype(np.float32),
        (0.1 * rng.standard_normal(dim)).astype(np.float32),
        (0.05 * rng.standard_normal((dim, 2 * inner))).astype(np.float32),
        (0.05 * rng.standard_normal(2 * inner)).astype(np.float32),
        (0.2 * rng.standard_normal((k, 1, inner))).astype(np.float32),
        (0.05 * rng.standard_normal(inner)).astype(np.float32),
        np.full(inner, 0.25, np.float32),
        (0.05 * rng.standard_normal((inner, dim))).astype(np.float32),
        (0.05 * rng.standard_normal(dim)).astype(np.float32),
    ]


@pytest.mark.parametrize("B,T,dim,inner,k", [
    (2, 257, 128, 256, 31),   # partial last tile, two sequences
    (1, 64, 128, 256, 7),     # short kernel
])
def test_lynx_conv_plain_matches_pallas(rng, B, T, dim, inner, k):
    from xiaoicesing_io_tpu.ops.pallas.lynx_conv import lynx_conv_module as pallas_k1

    args = _k1_args(rng, B, T, dim, inner, k)
    ref = np.asarray(pallas_k1(*[jnp.asarray(a) for a in args], kernel_size=k, tile=128,
                               interpret=True), np.float32)
    # the kernel takes bf16 activations, as the TPU kernel casts its input
    x = torch.from_numpy(args[0]).to(torch.bfloat16)
    params = [torch.from_numpy(a) for a in args[1:]]
    got = K1.lynx_conv_module(x, K1.prepare_weights(*params), kernel_size=k)
    assert got.shape == ref.shape == (B, T, dim)
    # both round the product inputs to bf16 and accumulate in f32 (the port
    # also rounds its output to bf16); the bar of
    # tests/test_lynx_pallas_apply.py for a bf16 module
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2, rtol=2e-2)
    # the plain version rounds the product weights to x's dtype itself: f32
    # prepared weights give the same output
    f32_weights = K1.prepare_weights(*params, product_dtype=torch.float32)
    again = K1.lynx_conv_module(x, f32_weights, kernel_size=k)
    np.testing.assert_array_equal(again.float().numpy(), got.float().numpy())


def test_lynx_denoiser_apply_bf16_matches_pallas(rng):
    """The port's bf16 kernel-path denoiser against JAX's Pallas apply."""
    from xiaoicesing_io_tpu.models.backbones import build_backbone as jbuild
    from xiaoicesing_io_tpu.models.backbones.lynx_pallas import (
        lynx_cond_projections as j_projs, lynx_denoiser_apply as j_apply,
    )
    from xiaoicesing_io_tpu_torch.models.backbones import build_backbone as pbuild
    from xiaoicesing_io_tpu_torch.models.backbones.lynx_cuda import (
        lynx_cond_projections, lynx_denoiser_apply,
    )
    from xiaoicesing_io_tpu_torch.utils import jax_weights

    B, T, M, H, C = 2, 160, 16, 64, 128
    args = {"num_layers": 2, "num_channels": C, "kernel_size": 31, "strong_cond": True}
    jm = jbuild(M, 1, "lynxnet", args, cond_dims=H)
    spec = rng.standard_normal((B, 1, T, M)).astype(np.float32)
    step = np.array([3.0, 700.0], np.float32)
    cond = rng.standard_normal((B, T, H)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(spec), jnp.asarray(step),
                     jnp.asarray(cond))
    params["params"]["output_projection"]["kernel"] = jnp.asarray(
        0.02 * rng.standard_normal((C, M)).astype(np.float32))
    projs = j_projs(params, jnp.asarray(cond), num_layers=2)
    ref = np.asarray(j_apply(params, jnp.asarray(spec), jnp.asarray(step), num_layers=2,
                             strong_cond=True, kernel_size=31, tile=128, interpret=True,
                             cond_projs=projs), np.float32)
    pm = pbuild(M, 1, "lynxnet", args, cond_dims=H).eval()
    sd = jax_weights.lynxnet_state_dict(params["params"], "b", 2)
    pm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        pprojs = lynx_cond_projections(pm, torch.from_numpy(cond))
        got = lynx_denoiser_apply(pm, torch.from_numpy(spec), torch.from_numpy(step),
                                  cond_projs=pprojs).float().numpy()
    assert got.shape == ref.shape
    # bf16 activations between layers on both sides, rounded at different
    # places by XLA and by torch: the bf16 bar of tests/test_lynx_pallas_apply.py
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999


def _stage(rng, L, kernels, dils):
    from xiaoicesing_io_tpu.ops.pallas.hifigan_stage import ConvSpec as JSpec, stack_taps

    jspecs, pspecs, weights, biases = [], [], [], []
    for k, ds in zip(kernels, dils):
        jb, pb = [], []
        for d in ds:
            jp, pp = [], []
            for dd in (d, 1):
                w = (0.1 * rng.standard_normal((k, L, L))).astype(np.float32)
                weights.append(np.asarray(stack_taps(w)))
                biases.append((0.1 * rng.standard_normal(L)).astype(np.float32))
                geom = (k, dd, (k - 1) * dd // 2)
                jp.append(JSpec(*geom))
                pp.append(K2.ConvSpec(*geom))
            jb.append(tuple(jp))
            pb.append(tuple(pp))
        jspecs.append(tuple(jb))
        pspecs.append(tuple(pb))
    return tuple(jspecs), tuple(pspecs), weights, biases


@pytest.mark.parametrize("L,T,tile,kernels,dils", [
    (128, 300, 128, (3, 7, 11), ((1, 3, 5),) * 3),   # default HiFiGAN stage
    (128, 257, 256, (3, 5), ((1, 2), (2, 6))),       # other geometry
    (256, 200, 128, (3, 7, 11), ((1, 3, 5),) * 3),   # stage-0 width
])
def test_resblock_stage_plain_matches_pallas(rng, L, T, tile, kernels, dils):
    from xiaoicesing_io_tpu.ops.pallas.hifigan_stage import fused_resblock_stage as pallas_k2

    B = 2
    x = rng.standard_normal((B, T, L)).astype(np.float32)
    jspecs, pspecs, weights, biases = _stage(rng, L, kernels, dils)
    ref = np.asarray(pallas_k2(jnp.asarray(x), tuple(jnp.asarray(w) for w in weights),
                               tuple(jnp.asarray(b) for b in biases), jspecs, tile=tile,
                               interpret=True), np.float32)
    # the kernel takes bf16 activations, as the TPU kernel casts its input
    got = K2.fused_resblock_stage(torch.from_numpy(x).to(torch.bfloat16),
                                  [torch.from_numpy(w) for w in weights],
                                  [torch.from_numpy(b) for b in biases], pspecs)
    got = got.float().numpy()
    assert got.shape == ref.shape
    # the bar of tests/test_pallas_hifigan.py: random weights grow values
    # through the residual chain and both sides are bf16 with different
    # summation orders, so the tolerance is relative to the output scale
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=6e-3)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.9999


def test_stack_taps_matches_jax(rng):
    from xiaoicesing_io_tpu.ops.pallas.hifigan_stage import stack_taps as j_stack

    w = rng.standard_normal((5, 6, 7)).astype(np.float32)  # [k, in, out]
    np.testing.assert_array_equal(K2.stack_taps(w).numpy(), j_stack(w))
    torch_w = torch.from_numpy(w.transpose(2, 1, 0).copy())  # Conv1d [out, in, k]
    np.testing.assert_array_equal(K2.stack_torch_conv(torch_w).numpy(), j_stack(w))


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 4, 128)
    with pytest.raises(ValueError, match="unsupported device"):
        K1.lynx_conv_module(x.to("meta"), [torch.zeros(1)] * 9)
    with pytest.raises(ValueError, match="unsupported device"):
        K2.fused_resblock_stage(x.to("meta"), (), (), ())
