"""The port's DDPM core, samplers and the WaveNet + DDPM acoustic slice against the JAX package, on the CPU.

The samplers run with the same start noise and one fixed closed-form f32
denoiser on both sides, and agree to rtol 1e-5: the same f32 step arithmetic
over the same float64-computed coefficients, differing only in the order XLA
and torch evaluate it.  The ancestral sampler's per-step noise is injected
and its update checked against a numpy transcription (float64, so f32's
rounding over 30 steps sets its bar, rtol and atol 1e-5).  The slice test runs one ``.ds`` segment through the
port's WaveNet + DDPM runner and the JAX runner, from the start noise the JAX
runner draws, at the module bar 2e-4.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SAMPLE = sorted((ROOT / "samples").glob("00_*.ds"))[0]
DICT = ROOT / "dictionaries" / "opencpop-extension.txt"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on shared cores; torch's
    intra-op threads then oversubscribe them and its convolutions slow down
    many-fold.  One thread per test, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("schedule_type,timesteps", [("linear", 1000), ("cosine", 1000),
                                                     ("linear", 100)])
def test_schedule_matches(schedule_type, timesteps):
    from dataclasses import fields

    from xiaoicesing_io_tpu.models.diffusion.schedule import DiffusionSchedule as J
    from xiaoicesing_io_tpu_torch.models.diffusion.schedule import DiffusionSchedule as P

    j, p = J.create(schedule_type, timesteps), P.create(schedule_type, timesteps)
    assert [f.name for f in fields(p)] == [f.name for f in fields(j)]
    for f in fields(j):
        np.testing.assert_allclose(getattr(p, f.name), getattr(j, f.name), rtol=0, atol=1e-12,
                                   err_msg=f.name)
    assert p.timesteps == j.timesteps == timesteps


def _denoiser_pair():
    """One closed-form f32 noise estimate, written for each framework."""
    def jd(x, t):
        return 0.5 * jnp.sin(x) + x * (t[:, None, None, None] / 2000.0)

    def pd(x, t):
        return 0.5 * torch.sin(x) + x * (t[:, None, None, None] / 2000.0)

    return jd, pd


def _cores(timesteps, k_step):
    from xiaoicesing_io_tpu.models.diffusion.core import GaussianDiffusion as JGD
    from xiaoicesing_io_tpu.models.diffusion.schedule import DiffusionSchedule as JS
    from xiaoicesing_io_tpu_torch.models.diffusion.core import GaussianDiffusion as PGD
    from xiaoicesing_io_tpu_torch.models.diffusion.schedule import DiffusionSchedule as PS

    return (JGD(JS.create("linear", timesteps), timesteps, k_step),
            PGD(PS.create("linear", timesteps), timesteps, k_step))


@pytest.mark.parametrize("algorithm,speedup,kw", [
    ("ddim", 10, {}),
    ("pndm", 10, {}),                          # order ramps 1..4
    ("dpm-solver", 10, {"solver_order": 1}),
    ("dpm-solver", 10, {"solver_order": 2}),
    ("dpm-solver", 50, {"solver_order": 3}),   # 8 steps: lower order at the end
    ("unipc", 10, {"unipc_variant": "bh2"}),
    ("unipc", 50, {"unipc_variant": "bh1"}),
])
@pytest.mark.parametrize("depth", [400, 1000])  # shallow start from q_sample; from pure noise
def test_ddpm_samplers_match_jax(rng, algorithm, speedup, kw, depth):
    jcore, pcore = _cores(1000, 1000)
    jd, pd = _denoiser_pair()
    shape = (2, 1, 13, 8)
    noise = rng.standard_normal(shape).astype(np.float32)
    x_start = rng.uniform(-1, 1, shape).astype(np.float32)
    ref = jcore.inference(jd, jax.random.PRNGKey(0), shape, x_start=jnp.asarray(x_start),
                          depth=depth, speedup=speedup, algorithm=algorithm,
                          noise=jnp.asarray(noise), **kw)
    got = pcore.inference(pd, shape, x_start=torch.from_numpy(x_start), depth=depth,
                          speedup=speedup, algorithm=algorithm, noise=torch.from_numpy(noise), **kw)
    assert np.abs(np.asarray(ref)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_q_sample_and_shallow_start_match(rng):
    jcore, pcore = _cores(1000, 400)
    x0 = rng.uniform(-1, 1, (3, 1, 5, 4)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    t = np.array([0, 399, 999])
    np.testing.assert_allclose(
        pcore.q_sample(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise)).numpy(),
        np.asarray(jcore.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))),
        rtol=1e-6, atol=1e-7)
    # depth 0 returns the source; depth above k_step is capped at k_step
    src = torch.from_numpy(x0)
    assert pcore.inference(None, x0.shape, x_start=src, depth=0) is src
    jd, pd = _denoiser_pair()
    got = pcore.inference(pd, x0.shape, x_start=src, depth=1000, speedup=100,
                          noise=torch.from_numpy(noise))
    ref = jcore.inference(jd, jax.random.PRNGKey(0), x0.shape, x_start=jnp.asarray(x0),
                          depth=1000, speedup=100, noise=jnp.asarray(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_ancestral_sampler_matches_numpy(rng):
    """``sample_ddpm`` with injected per-step noise against a numpy
    transcription of the JAX ``sample_ddpm`` update."""
    from xiaoicesing_io_tpu_torch.models.diffusion.samplers import sample_ddpm
    from xiaoicesing_io_tpu_torch.models.diffusion.schedule import DiffusionSchedule

    sched = DiffusionSchedule.create("linear", 1000)
    t_max = 30
    shape = (2, 1, 7, 4)
    x0 = rng.standard_normal(shape).astype(np.float32)
    step_noise = rng.standard_normal((t_max,) + shape).astype(np.float32)
    _, pd = _denoiser_pair()

    x = x0.astype(np.float64)
    for i, t in enumerate(range(t_max - 1, -1, -1)):
        eps = 0.5 * np.sin(x) + x * (t / 2000.0)
        x_recon = sched.sqrt_recip_alphas_cumprod[t] * x - sched.sqrt_recipm1_alphas_cumprod[t] * eps
        mean = sched.posterior_mean_coef1[t] * x_recon + sched.posterior_mean_coef2[t] * x
        std = np.exp(0.5 * sched.posterior_log_variance_clipped[t])
        x = mean + (t != 0) * std * step_noise[i]
    got = sample_ddpm(sched, pd, torch.from_numpy(x0), t_max,
                      step_noise=[torch.from_numpy(n) for n in step_noise])
    # f32 against f64 over 30 steps
    np.testing.assert_allclose(got.numpy(), x, rtol=1e-5, atol=1e-5)

    # without injected noise the generator drives it: same seed, same result
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return sample_ddpm(sched, pd, torch.from_numpy(x0), t_max, generator=g)

    a, b = draw(3), draw(3)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, draw(4))


# ---------------------------------------------------------------------------
# checkpoints and the slice
# ---------------------------------------------------------------------------

TINY = dict(
    hidden_size=32, enc_layers=1, num_heads=2,
    backbone_type="wavenet", diffusion_type="ddpm",
    backbone_args={"num_channels": 64, "num_layers": 4, "dilation_cycle_length": 2},
    K_step=400, K_step_infer=400, diff_accelerator="ddim", diff_speedup=10,
)


def _tiny(cfg, work_dir):
    cfg.update(work_dir=str(work_dir), dictionary=str(DICT), **TINY)
    cfg["backbone_args"] = dict(TINY["backbone_args"])
    cfg["shallow_diffusion_args"]["aux_decoder_args"].update(num_channels=32, num_layers=1,
                                                            dropout_rate=0.0)
    return cfg


def _port_cfg(work_dir):
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults

    return _tiny(acoustic_defaults(), work_dir)


def _random_acoustic(cfg, seed=0):
    from xiaoicesing_io_tpu_torch.training.acoustic import build_acoustic
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    vocab = TokenTextEncoder(PhonemeDictionary.load(DICT).phoneme_list).vocab_size
    torch.manual_seed(seed)
    model, core, _ = build_acoustic(cfg, vocab)
    with torch.no_grad():
        # zero-initialised output projection and 1e-6 ConvNeXt layer scales
        # would hide the denoiser and the aux blocks: randomise them
        model.backbone.output_projection.weight.normal_(0.0, 0.05)
        for block in model.aux_decoder.decoder.conv:
            block.gamma.normal_(0.0, 0.5)
    return model.eval(), core


def _reference_state_dict(model, core):
    """``model.``-prefixed names plus what a reference DDPM checkpoint also
    carries: the core's schedule buffers, spec_min / spec_max and the
    scalar step counts."""
    from xiaoicesing_io_tpu_torch.models.toplevel import reference_core_buffers

    sd = {f"model.{k}": v for k, v in model.state_dict().items()}
    extra = dict(reference_core_buffers(core.schedule),
                 spec_min=torch.full((1, 1, 128), -12.0), spec_max=torch.zeros(1, 1, 128),
                 timesteps=torch.tensor(float(core.timesteps)),
                 timestep_range=torch.tensor(float(core.k_step)))
    sd.update({f"model.diffusion.{k}": v for k, v in extra.items()})
    return sd


def test_reference_ddpm_state_dict_loads_strict(tmp_path):
    from xiaoicesing_io_tpu_torch.models.toplevel import load_acoustic_state_dict

    cfg = _port_cfg(tmp_path)
    model, core = _random_acoustic(cfg)
    sd = _reference_state_dict(model, core)
    assert "model.diffusion.posterior_mean_coef2" in sd
    assert "model.diffusion.denoise_fn.residual_layers.3.dilated_conv.weight" in sd
    fresh, _ = _random_acoustic(cfg, seed=1)
    load_acoustic_state_dict(fresh, sd)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0, msg=k)
    # still strict about the net: a missing or unknown denoiser tensor fails
    with pytest.raises(RuntimeError, match="Missing"):
        load_acoustic_state_dict(fresh, {k: v for k, v in sd.items()
                                         if not k.endswith("skip_projection.bias")})
    with pytest.raises(RuntimeError, match="Unexpected"):
        load_acoustic_state_dict(fresh, dict(sd, **{"model.diffusion.denoise_fn.extra":
                                                    torch.zeros(1)}))


@pytest.fixture(scope="module")
def exp_dir(tmp_path_factory):
    """A work dir with a random tiny WaveNet + DDPM checkpoint in reference format."""
    wd = tmp_path_factory.mktemp("port_ddpm_exp")
    model, core = _random_acoustic(_port_cfg(wd))
    torch.save({"category": "acoustic", "state_dict": _reference_state_dict(model, core)},
               wd / "model_ckpt_steps_100.ckpt")
    return wd


def test_ds_segment_mel_matches_jax_wavenet_ddpm(exp_dir):
    """One ``.ds`` segment through the WaveNet + DDPM runner (40 DDIM steps
    from q_sample(aux, 399)) against the JAX runner's ``forward_model``."""
    from xiaoicesing_io_tpu.config import load_config
    from xiaoicesing_io_tpu.inference.acoustic import DiffSingerAcousticInfer as JInfer
    from xiaoicesing_io_tpu_torch.inference.acoustic import (
        DiffSingerAcousticInfer as PInfer, _bucket,
    )

    with open(SAMPLE, encoding="utf-8") as f:
        seg = json.load(f)[0]
    jcfg = _tiny(load_config(ROOT / "xiaoicesing_io_tpu/configs/acoustic.yaml"), exp_dir)
    jr = JInfer(jcfg, load_vocoder=False)
    pr = PInfer(_port_cfg(exp_dir), load_vocoder=False, device="cpu")
    assert pr.use_kernels  # wavenet_denoiser_apply in f32, K4's plain version
    jb, pb = jr.preprocess_input(seg), pr.preprocess_input(seg)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(pb[k]), np.asarray(jb[k]))

    seed = 1234
    length = jb["mel2ph"].shape[1]
    ref = jr.forward_model(jb, seed=seed)
    # the JAX DDPM core's start noise: drawn from the second key of split(key)
    _, nkey = jax.random.split(jax.random.PRNGKey(seed & 0xFFFFFFFF))
    noise = np.asarray(jax.random.normal(nkey, (1, 1, _bucket(length), 128), jnp.float32))
    got = pr.forward_model(pb, noise=noise)
    assert got.shape == ref.shape == (1, length, 128)
    assert np.isfinite(got).all()
    assert np.abs(ref).max() > 1.0  # random weights: not a near-zero mel
    # f32 on both sides, differing in summation order only: the module bar
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
