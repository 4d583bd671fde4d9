"""The port's WaveNet backbone and residual-block kernel (K4) against the JAX package, on the CPU.

Inputs come from seeded numpy; flax ``init`` weights are carried to the port
with ``utils/jax_weights.py``.  Tolerances:

* f32 modules and the f32 kernel path: atol 2e-4, the module bar of
  ``tests/test_torch_modules.py`` (same f32 math, other summation orders);
* K4's plain version in bf16 against the Pallas kernel in interpret mode, and
  the bf16 kernel-path apply against the JAX Pallas apply: atol / rtol 0.02
  (and corr > 0.999 for the apply), the bars of ``tests/test_wavenet_pallas.py``
  -- both sides round products to bf16, at other places.

``tests/test_torch_cuda.py`` holds the CUDA kernel against the plain version
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xiaoicesing_io_tpu_torch.ops.cuda import wavenet_block as K4
from xiaoicesing_io_tpu_torch.utils import jax_weights

ATOL = 2e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on shared cores; torch's
    intra-op threads then oversubscribe them and its convolutions slow down
    many-fold.  One thread per test, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wavenet_pair(rng, C=64, layers=5, cycle=4, n_feats=1, M=16, H=24, B=2, T=45):
    from xiaoicesing_io_tpu.models.backbones import build_backbone as jbuild
    from xiaoicesing_io_tpu_torch.models.backbones import build_backbone as pbuild

    args = {"num_layers": layers, "num_channels": C, "dilation_cycle_length": cycle}
    jm = jbuild(M, n_feats, "wavenet", args, cond_dims=H)
    spec = rng.standard_normal((B, n_feats, T, M)).astype(np.float32)
    step = np.array([3.0, 700.0], np.float32)[:B]
    cond = rng.standard_normal((B, T, H)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(spec), jnp.asarray(step),
                     jnp.asarray(cond))
    # zero-initialised output projection: randomise it or the outputs are zeros
    params["params"]["output_projection"]["kernel"] = jnp.asarray(
        0.05 * rng.standard_normal((C, n_feats * M)).astype(np.float32))
    pm = pbuild(M, n_feats, "wavenet", args, cond_dims=H).eval()
    sd = jax_weights.wavenet_state_dict(params["params"], "b", layers)
    pm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return jm, params, pm, (spec, step, cond)


@pytest.mark.parametrize("C,layers,cycle,n_feats", [
    (64, 5, 4, 1),   # the acoustic layout: dilations 1, 2, 4, 8, 1
    (32, 3, 2, 2),   # two features (the variance layout), another cycle
])
def test_wavenet_matches_flax(rng, C, layers, cycle, n_feats):
    jm, params, pm, (spec, step, cond) = _wavenet_pair(rng, C, layers, cycle, n_feats)
    ref = jm.apply(params, jnp.asarray(spec), jnp.asarray(step), jnp.asarray(cond))
    with torch.no_grad():
        got = pm(torch.from_numpy(spec), torch.from_numpy(step), torch.from_numpy(cond))
    assert np.abs(np.asarray(ref)).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_wavenet_denoiser_apply_f32_matches_flax(rng):
    """The kernel-path apply in f32 (K4's plain version on the CPU) against the
    JAX f32 ``WaveNet``: the reference the JAX package's CPU runner uses."""
    from xiaoicesing_io_tpu_torch.models.backbones.wavenet_cuda import (
        wavenet_cond_projections, wavenet_denoiser_apply, wavenet_kernel_weights,
    )

    jm, params, pm, (spec, step, cond) = _wavenet_pair(rng)
    ref = jm.apply(params, jnp.asarray(spec), jnp.asarray(step), jnp.asarray(cond))
    f32 = torch.float32
    with torch.no_grad():
        projs = wavenet_cond_projections(pm, torch.from_numpy(cond), f32)
        got = wavenet_denoiser_apply(pm, torch.from_numpy(spec), torch.from_numpy(step),
                                     cond_projs=projs, kernel_weights=wavenet_kernel_weights(pm, f32),
                                     compute_dtype=f32)
    assert got.dtype == f32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_wavenet_denoiser_apply_bf16_matches_pallas(rng):
    """The port's bf16 kernel-path denoiser against JAX's Pallas apply, at
    the shape and bar of tests/test_wavenet_pallas.py."""
    from xiaoicesing_io_tpu.models.backbones.wavenet_pallas import (
        wavenet_denoiser_apply as j_apply,
    )
    from xiaoicesing_io_tpu_torch.models.backbones.wavenet_cuda import wavenet_denoiser_apply

    jm, params, pm, (spec, step, cond) = _wavenet_pair(rng, C=128, layers=5, M=16, H=64, T=160)
    ref = np.asarray(j_apply(params, jnp.asarray(spec), jnp.asarray(step), jnp.asarray(cond),
                             num_layers=5, dilation_cycle_length=4, tile=128, interpret=True),
                     np.float32)
    with torch.no_grad():
        got = wavenet_denoiser_apply(pm, torch.from_numpy(spec), torch.from_numpy(step),
                                     torch.from_numpy(cond))
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref, atol=0.02, rtol=0.02)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999


def _k4_args(rng, B, T, C):
    return [
        (0.3 * rng.standard_normal((B, T, C))).astype(np.float32),
        (0.3 * rng.standard_normal((B, T, 2 * C))).astype(np.float32),
        (0.05 * rng.standard_normal((3, C, 2 * C))).astype(np.float32),
        (0.05 * rng.standard_normal(2 * C)).astype(np.float32),
        (0.05 * rng.standard_normal((C, 2 * C))).astype(np.float32),
        (0.05 * rng.standard_normal(2 * C)).astype(np.float32),
    ]


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_wavenet_block_plain_matches_pallas(rng, d):
    from xiaoicesing_io_tpu.ops.pallas.wavenet_block import wavenet_block as pallas_k4

    B, T, C = 2, 100, 128
    y, cond, ck, cb, ok, ob = _k4_args(rng, B, T, C)
    # bf16 activations on both sides, as the kernel-path apply gives them
    y16 = torch.from_numpy(y).to(torch.bfloat16)
    cond16 = torch.from_numpy(cond).to(torch.bfloat16)
    jr, js = pallas_k4(jnp.asarray(y16.float().numpy(), jnp.bfloat16),
                       jnp.asarray(cond16.float().numpy(), jnp.bfloat16), jnp.asarray(ck),
                       jnp.asarray(cb), jnp.asarray(ok), jnp.asarray(ob), dilation=d, tile=128,
                       interpret=True)
    ref = np.concatenate([np.asarray(jr, np.float32), np.asarray(js, np.float32)], axis=-1)
    params = [torch.from_numpy(a) for a in (ck, cb, ok, ob)]
    got = K4.wavenet_block(y16, cond16, K4.prepare_weights(*params), dilation=d)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape == (B, T, 2 * C)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=0.02, rtol=0.02)
    # the plain version rounds the product weights to y's dtype itself: f32
    # prepared weights give the same output
    f32_weights = K4.prepare_weights(*params, product_dtype=torch.float32)
    again = K4.wavenet_block(y16, cond16, f32_weights, dilation=d)
    np.testing.assert_array_equal(again.float().numpy(), got.float().numpy())


def test_wavenet_block_stated_widths():
    """The widths the wrapper's docstring states the kernel takes: C % 64 ==
    0 up to 512 and any dilation d >= 1 (the taps are TMA loads, with no
    staged halo to bound d)."""
    for C, d in ((512, 32), (512, 33), (256, 124), (256, 125), (512, 4096)):
        K4.check_widths(C, d)
    for C in (64, 192, 256, 512):
        K4.check_widths(C, 16)
    for C, d in ((512, 0), (576, 1), (96, 16)):
        with pytest.raises(ValueError, match="C % 64"):
            K4.check_widths(C, d)


def test_wavenet_block_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        K4.wavenet_block(torch.zeros(1, 4, 64, device="meta"), torch.zeros(1), [torch.zeros(1)] * 4,
                         dilation=1)


def test_acoustic_wavenet_ddpm_carrier_round_trip(tmp_path):
    """port WaveNet + DDPM state_dict -> JAX convert_acoustic -> port carrier:
    identical, under the reference's ``diffusion.denoise_fn.*`` names."""
    from xiaoicesing_io_tpu.utils.torch_ckpt import convert_acoustic
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults
    from xiaoicesing_io_tpu_torch.training.acoustic import build_acoustic
    from xiaoicesing_io_tpu_torch.utils.jax_weights import acoustic_state_dict_from_jax

    cfg = acoustic_defaults()
    cfg.update(hidden_size=32, enc_layers=1, num_heads=2, backbone_type="wavenet",
               diffusion_type="ddpm",
               backbone_args={"num_channels": 32, "num_layers": 3, "dilation_cycle_length": 2})
    cfg["shallow_diffusion_args"]["aux_decoder_args"].update(num_channels=32, num_layers=1)
    torch.manual_seed(0)
    sd = build_acoustic(cfg, 20)[0].state_dict()
    assert any(k.startswith("diffusion.denoise_fn.residual_layers.2.dilated_conv") for k in sd)
    params = jax.tree_util.tree_map(np.asarray, convert_acoustic(sd, cfg))
    back = acoustic_state_dict_from_jax(params, cfg)
    assert set(sd) == set(back)
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), back[k].numpy(), err_msg=k)
