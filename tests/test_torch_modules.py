"""Port modules (xiaoicesing_io_tpu_torch) against the JAX package in f32 on the CPU.

Inputs come from seeded numpy; JAX weights from flax ``init`` are carried to
the port with ``utils/jax_weights.py``.  Tolerance: atol 2e-4, the bar the
JAX package holds against the reference torch modules (README "Testing");
both sides run the same f32 math and differ only in summation order and
transcendental implementations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _close(got, ref, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, _np(ref), atol=atol, rtol=0)


def _mel2ph(rng, B, T_ph, T_f):
    from xiaoicesing_io_tpu.ops.seq import length_regulator as jlr

    dur = rng.integers(1, 4, size=(B, T_ph))
    dur[1, -2:] = 0  # padded tokens in the second item
    return dur, np.asarray(jlr(jnp.asarray(dur), out_len=T_f))


def test_seq_ops_match(rng):
    from xiaoicesing_io_tpu.ops import seq as J
    from xiaoicesing_io_tpu_torch.ops import seq as P

    dur, mel2ph = _mel2ph(rng, 2, 7, 19)
    np.testing.assert_array_equal(
        P.length_regulator(torch.from_numpy(dur), 19).numpy(), mel2ph)
    np.testing.assert_array_equal(
        P.mel2ph_to_dur(torch.from_numpy(mel2ph), 7).numpy(),
        np.asarray(J.mel2ph_to_dur(jnp.asarray(mel2ph), 7)))
    enc = rng.standard_normal((2, 7, 5)).astype(np.float32)
    _close(P.gather_frames(torch.from_numpy(enc), torch.from_numpy(mel2ph)),
           J.gather_frames(jnp.asarray(enc), jnp.asarray(mel2ph)), atol=0)


def test_common_functions_match(rng):
    from xiaoicesing_io_tpu.models import common as J
    from xiaoicesing_io_tpu_torch.models import common as P

    t = np.array([0.0, 3.0, 999.0], np.float32)
    _close(P.sinusoidal_step_embedding(torch.from_numpy(t), 64),
           J.sinusoidal_step_embedding(jnp.asarray(t), 64), atol=1e-4)
    _close(P.rel_positional_encoding(11, 16), J.rel_positional_encoding(11, 16), atol=1e-4)
    toks = np.array([[3, 4, 0, 0], [1, 2, 3, 5]])
    np.testing.assert_array_equal(P.make_positions(torch.from_numpy(toks)).numpy(),
                                  np.asarray(J.make_positions(jnp.asarray(toks))))
    x = rng.standard_normal((2, 2, 9, 8)).astype(np.float32)
    _close(P.apply_rope(torch.from_numpy(x)), J.apply_rope(jnp.asarray(x)))

    from xiaoicesing_io_tpu.models.fastspeech.acoustic import f0_to_coarse as j_coarse
    from xiaoicesing_io_tpu_torch.models.fastspeech.acoustic import f0_to_coarse as p_coarse

    f0 = np.concatenate([[0.0, 30.0, 50.0, 1100.0, 3000.0],
                         rng.uniform(40, 1200, 64)]).astype(np.float32)
    np.testing.assert_array_equal(p_coarse(torch.from_numpy(f0)).numpy(),
                                  np.asarray(j_coarse(jnp.asarray(f0))))


@pytest.mark.parametrize("use_rope,rel_pos,f0_embed_type", [
    (True, True, "continuous"), (False, True, "continuous"), (False, False, "continuous"),
    (True, True, "discrete"),   # legacy coarse-f0 embedding table
])
def test_fs2_acoustic_encoder_matches(rng, use_rope, rel_pos, f0_embed_type):
    """Encoder + every embed of the acoustic embedder (variance, key shift,
    speed, speaker), on a batch with padded tokens."""
    from xiaoicesing_io_tpu.models.fastspeech.acoustic import FastSpeech2Acoustic as JFS2
    from xiaoicesing_io_tpu_torch.models.fastspeech.acoustic import FastSpeech2Acoustic as PFS2

    kw = dict(vocab_size=12, hidden_size=32, enc_layers=2, enc_ffn_kernel_size=3,
              num_heads=2, use_rope=use_rope, rel_pos=rel_pos,
              variance_embeds=("energy", "breathiness"), use_key_shift_embed=True,
              use_speed_embed=True, use_spk_id=True, num_spk=3, f0_embed_type=f0_embed_type)
    jm = JFS2(dropout=0.0, **kw)
    B, T_ph, T_f = 2, 7, 19
    _, mel2ph = _mel2ph(rng, B, T_ph, T_f)
    tokens = rng.integers(1, 12, size=(B, T_ph))
    tokens[1, -2:] = 0
    f0 = rng.uniform(100, 400, size=(B, T_f)).astype(np.float32)
    extra = {
        "key_shift": rng.uniform(-3, 3, (B, T_f)).astype(np.float32),
        "speed": rng.uniform(0.8, 1.2, (B, T_f)).astype(np.float32),
        "variances": {v: rng.standard_normal((B, T_f)).astype(np.float32)
                      for v in ("energy", "breathiness")},
    }
    spk = np.array([0, 2])
    jargs = (jnp.asarray(tokens), jnp.asarray(mel2ph), jnp.asarray(f0))
    jkw = dict(key_shift=jnp.asarray(extra["key_shift"]), speed=jnp.asarray(extra["speed"]),
               spk_embed_id=jnp.asarray(spk),
               variances={k: jnp.asarray(v) for k, v in extra["variances"].items()})
    params = jm.init(jax.random.PRNGKey(0), *jargs, **jkw)
    ref = jm.apply(params, *jargs, **jkw)

    pm = PFS2(dropout=0.0, **kw).eval()
    sd = jax_weights.fs2_acoustic_state_dict(params["params"], "f", 2)
    sd = {k[2:]: v for k, v in sd.items()}
    pm.load_state_dict(sd, strict=True)
    got = pm(torch.from_numpy(tokens), torch.from_numpy(mel2ph), torch.from_numpy(f0),
             key_shift=torch.from_numpy(extra["key_shift"]),
             speed=torch.from_numpy(extra["speed"]), spk_embed_id=torch.from_numpy(spk),
             variances={k: torch.from_numpy(v) for k, v in extra["variances"].items()})
    _close(got, ref)


def test_convnext_aux_decoder_matches(rng):
    from xiaoicesing_io_tpu.models.aux_decoder import ConvNeXtDecoder as JDec
    from xiaoicesing_io_tpu_torch.models.aux_decoder import ConvNeXtDecoder as PDec

    jm = JDec(out_dims=16, num_channels=32, num_layers=2, kernel_size=7, dropout_rate=0.0)
    x = rng.standard_normal((2, 23, 24)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # the 1e-6 layer scale would hide the blocks: randomise it
    for i in range(2):
        params["params"][f"conv_{i}"]["gamma"] = jnp.asarray(
            rng.standard_normal(32).astype(np.float32) * 0.5)
    ref = jm.apply(params, jnp.asarray(x))
    pm = PDec(in_dims=24, out_dims=16, num_channels=32, num_layers=2, kernel_size=7,
              dropout_rate=0.0).eval()
    sd = jax_weights.convnext_state_dict(params["params"], "d", 2)
    pm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    _close(pm(torch.from_numpy(x)), ref)


def _lynx_pair(rng, strong_cond, C=64, layers=2, M=16, H=24):
    from xiaoicesing_io_tpu.models.backbones import build_backbone as jbuild
    from xiaoicesing_io_tpu_torch.models.backbones import build_backbone as pbuild

    args = {"num_layers": layers, "num_channels": C, "kernel_size": 31,
            "strong_cond": strong_cond}
    jm = jbuild(M, 1, "lynxnet", args, cond_dims=H)
    B, T = 2, 45
    spec = rng.standard_normal((B, 1, T, M)).astype(np.float32)
    step = np.array([3.0, 700.0], np.float32)
    cond = rng.standard_normal((B, T, H)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(spec), jnp.asarray(step),
                     jnp.asarray(cond))
    # zero-initialised output projection: randomise it or the outputs are zeros
    params["params"]["output_projection"]["kernel"] = jnp.asarray(
        0.05 * rng.standard_normal((C, M)).astype(np.float32))
    pm = pbuild(M, 1, "lynxnet", args, cond_dims=H).eval()
    sd = jax_weights.lynxnet_state_dict(params["params"], "b", layers)
    pm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return jm, params, pm, (spec, step, cond)


@pytest.mark.parametrize("strong_cond", [True, False])
def test_lynxnet_matches(rng, strong_cond):
    jm, params, pm, (spec, step, cond) = _lynx_pair(rng, strong_cond)
    ref = jm.apply(params, jnp.asarray(spec), jnp.asarray(step), jnp.asarray(cond))
    got = pm(torch.from_numpy(spec), torch.from_numpy(step), torch.from_numpy(cond))
    assert np.abs(_np(ref)).max() > 1e-2
    _close(got, ref)


def test_lynx_denoiser_apply_f32_matches_jax_module(rng):
    """The kernel-path apply in f32 (the conv-module kernel's plain version on
    the CPU) against the JAX f32 ``LYNXNet``: the reference the JAX package's
    CPU runner uses."""
    from xiaoicesing_io_tpu_torch.models.backbones.lynx_cuda import (
        lynx_cond_projections, lynx_denoiser_apply,
    )

    jm, params, pm, (spec, step, cond) = _lynx_pair(rng, True)
    ref = jm.apply(params, jnp.asarray(spec), jnp.asarray(step), jnp.asarray(cond))
    f32 = torch.float32
    with torch.no_grad():
        projs = lynx_cond_projections(pm, torch.from_numpy(cond), f32)
        got = lynx_denoiser_apply(pm, torch.from_numpy(spec), torch.from_numpy(step),
                                  cond_projs=projs, compute_dtype=f32)
    assert got.dtype == f32
    _close(got, ref)


def _velocity_pair():
    def jv(x, t):
        return jnp.sin(x) - x * (t[:, None, None, None] / 1000.0)

    def pv(x, t):
        return torch.sin(x) - x * (t[:, None, None, None] / 1000.0)

    return jv, pv


@pytest.mark.parametrize("algorithm", ["euler", "rk2", "rk4", "rk5"])
def test_rectified_flow_sampler_matches(rng, algorithm):
    from xiaoicesing_io_tpu.models.diffusion.core import RectifiedFlow as JRF
    from xiaoicesing_io_tpu_torch.models.diffusion.core import RectifiedFlow as PRF

    jv, pv = _velocity_pair()
    shape = (2, 1, 13, 8)
    noise = rng.standard_normal(shape).astype(np.float32)
    x_end = rng.standard_normal(shape).astype(np.float32)
    ref = JRF(t_start=0.4).inference(jv, jax.random.PRNGKey(0), shape,
                                     x_end=jnp.asarray(x_end), steps=7, algorithm=algorithm,
                                     noise=jnp.asarray(noise))
    got = PRF(t_start=0.4).inference(pv, shape, x_end=torch.from_numpy(x_end), steps=7,
                                     algorithm=algorithm, noise=torch.from_numpy(noise))
    _close(got, ref)
    # from t = 0 (no shallow start)
    ref0 = JRF().inference(jv, jax.random.PRNGKey(0), shape, steps=5, algorithm=algorithm,
                           noise=jnp.asarray(noise))
    got0 = PRF().inference(pv, shape, steps=5, algorithm=algorithm,
                           noise=torch.from_numpy(noise))
    _close(got0, ref0)


def test_spec_normalizer_matches(rng):
    from xiaoicesing_io_tpu.models.diffusion.core import SpecNormalizer as J
    from xiaoicesing_io_tpu_torch.models.diffusion.core import SpecNormalizer as P

    mel = rng.uniform(-12, 0, (2, 9, 8)).astype(np.float32)
    j, p = J([-12.0], [0.0]), P([-12.0], [0.0])
    _close(p.norm(torch.from_numpy(mel)), j.norm(jnp.asarray(mel)), atol=1e-6)
    x = rng.standard_normal((2, 1, 9, 8)).astype(np.float32)
    _close(p.denorm(torch.from_numpy(x)), j.denorm(jnp.asarray(x)), atol=1e-6)
    # curves with repeat bins and clamps
    cj = J([-8.0, -96], [8.0, -12], num_feats=2, repeat_bins=4, clamps=[(-12, 12), (-96, 0)])
    cp = P([-8.0, -96], [8.0, -12], num_feats=2, repeat_bins=4, clamps=[(-12, 12), (-96, 0)])
    curves = [rng.uniform(-20, 20, (2, 9)).astype(np.float32) for _ in range(2)]
    _close(cp.norm([torch.from_numpy(c) for c in curves]),
           cj.norm([jnp.asarray(c) for c in curves]), atol=1e-6)
    y = rng.standard_normal((2, 2, 9, 4)).astype(np.float32)
    for a, b in zip(cp.denorm(torch.from_numpy(y)), cj.denorm(jnp.asarray(y))):
        _close(a, b, atol=1e-5)


VCFG_SMALL = dict(num_mels=16, sampling_rate=44100, hop_size=32, upsample_rates=(4, 4, 2),
                  upsample_kernel_sizes=(8, 8, 4), upsample_initial_channel=32,
                  resblock="1", resblock_kernel_sizes=(3, 7, 11),
                  resblock_dilation_sizes=((1, 3, 5),) * 3)


@pytest.mark.parametrize("variant", ["nsf", "mini_nsf", "resblock2"])
def test_nsf_hifigan_generator_matches(rng, variant):
    """f32 stock generator, no source noise (key=None); on the CPU the port's
    stages 0 and 1 run the resblock-stage plain version in f32."""
    from xiaoicesing_io_tpu.models.vocoders.nsf_hifigan import (
        Generator as JGen, NsfHifiganConfig as JCfg,
    )
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import (
        Generator as PGen, NsfHifiganConfig as PCfg,
    )

    kw = dict(VCFG_SMALL)
    if variant == "mini_nsf":
        kw["mini_nsf"] = True
    if variant == "resblock2":
        kw.update(resblock="2", resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3),) * 2)
    jcfg, pcfg = JCfg(**kw), PCfg(**kw)
    B, T = 2, 12
    mel = rng.standard_normal((B, T, 16)).astype(np.float32)
    f0 = rng.uniform(100, 400, (B, T)).astype(np.float32)
    f0[0, :3] = 0.0  # unvoiced frames
    jm = JGen(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(mel), jnp.asarray(f0))
    # flax's N(0, 0.01) transposed-conv init would shrink the signal to nothing
    for i in range(len(kw["upsample_rates"])):
        kern = params["params"][f"ups_{i}"]["kernel"]
        params["params"][f"ups_{i}"]["kernel"] = jnp.asarray(
            rng.standard_normal(kern.shape).astype(np.float32) * 0.3)
    ref = jm.apply(params, jnp.asarray(mel), jnp.asarray(f0))
    pm = PGen(pcfg).eval()
    pm.load_state_dict(jax_weights.nsf_hifigan_state_dict_from_jax(params, pcfg), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(mel), torch.from_numpy(f0))
    assert got.shape == (B, T * 32)
    assert np.abs(_np(ref)).max() > 1e-3
    _close(got, ref)


def test_sine_sources_match(rng):
    from xiaoicesing_io_tpu.models.vocoders import nsf_hifigan as J
    from xiaoicesing_io_tpu_torch.models.vocoders import nsf_hifigan as P

    f0 = rng.uniform(80, 600, (2, 9)).astype(np.float32)
    f0[1, 4:] = 0.0
    rand_ini = rng.uniform(0, 1, (1, 1, 9)).astype(np.float32)
    _close(P.sine_gen(torch.from_numpy(f0), 64, 44100, 8, rand_ini=torch.from_numpy(rand_ini)),
           J.sine_gen(jnp.asarray(f0), 64, 44100, 8, rand_ini=jnp.asarray(rand_ini)))
    _close(P.fast_sine_gen(torch.from_numpy(f0), 64, 11025.0),
           J.fast_sine_gen(jnp.asarray(f0), 64, 11025.0))
