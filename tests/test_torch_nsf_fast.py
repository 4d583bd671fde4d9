"""The port's time-folded vocoder and K6's plain version against the JAX package.

On the CPU, ``resblock_unit`` runs its plain PyTorch version, which repeats
the CUDA kernel's arithmetic; here it is held against the Pallas kernel run
with ``interpret=True``, as ``tests/test_pallas_hifigan.py`` runs it: f32 at
that file's 2e-4, bf16 on both sides within 6e-3 of the output scale with
correlation > 0.9999 (its bf16 stage bar).  The folded apply is held in f32
against the port's stock generator and against JAX's ``FastNsfHifigan`` at
2e-5, the bar of ``tests/test_nsf_fast.py``.  Inputs come from a numpy seed;
the NSF source is deterministic (no generator, no key) unless a test says
otherwise.  ``tests/test_torch_cuda.py`` holds the CUDA kernel against the
plain version on the card.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xiaoicesing_io_tpu.models.vocoders import nsf_fast as J
from xiaoicesing_io_tpu.models.vocoders.nsf_hifigan import (
    Generator as JGen, NsfHifiganConfig as JCfg,
)
from xiaoicesing_io_tpu.ops.pallas.hifigan_resblock import resblock_unit as j_resblock_unit
from xiaoicesing_io_tpu_torch.models.vocoders import nsf_fast as P
from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import (
    Generator as PGen, NsfHifiganConfig as PCfg,
)
from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_resblock as K6
from xiaoicesing_io_tpu_torch.utils.jax_weights import nsf_hifigan_state_dict_from_jax

FOLD_TOL = 2e-5

# tests/test_nsf_fast.py's small configurations
SMALL = dict(num_mels=16, sampling_rate=44100, hop_size=64, upsample_rates=(4, 4, 2, 2),
             upsample_kernel_sizes=(8, 8, 4, 4), upsample_initial_channel=64)
TWO_BRANCH = dict(SMALL, resblock="1", resblock_kernel_sizes=(3, 7),
                  resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))
MINI_RB2 = dict(SMALL, resblock="2", resblock_kernel_sizes=(3,),
                resblock_dilation_sizes=((1, 3),), mini_nsf=True)
ONE_BRANCH = dict(SMALL, resblock="1", resblock_kernel_sizes=(3,),
                  resblock_dilation_sizes=((1, 3, 5),))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on shared cores; torch's
    intra-op threads then oversubscribe them.  One thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rng, B, T, num_mels=16):
    mel = rng.standard_normal((B, T, num_mels)).astype(np.float32)
    f0 = rng.uniform(100, 400, (B, T)).astype(np.float32)
    return mel, f0


def _port_generator(kw, seed=0):
    torch.manual_seed(seed)
    return PGen(PCfg(**kw)).eval()


# ---------------------------------------------------------------------------
# weight folding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,d,F,stride,pad_l", [
    (3, 1, 2, 1, None),     # a resblock conv2 at fold 2
    (11, 5, 2, 1, None),    # the widest dilated conv1 (stage 2 of the shipped vocoder)
    (7, 3, 4, 1, None),
    (16, 1, 8, 8, 4),       # a noise conv: k = 2 sf, stride sf, pad sf // 2
    (1, 1, 8, 1, 0),        # the last stage's k=1 noise conv
    (11, 5, 1, 1, None),    # F = 1: the native dilated conv is kept
])
def test_fold_conv_matches_jax(rng, k, d, F, stride, pad_l):
    """Torch-layout ``Conv1d`` weights through :func:`conv_taps`, folded,
    equal JAX's fold of the same ``[k, C_in, C_out]`` taps exactly."""
    W = rng.standard_normal((k, 5, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    torch_w = torch.from_numpy(np.ascontiguousarray(W.transpose(2, 1, 0)))  # [C_out, C_in, k]
    got = P.fold_conv(P.conv_taps(torch_w), b, F, dilation=d, stride=stride, pad_l=pad_l)
    ref = J.fold_conv(W, b, F, dilation=d, stride=stride, pad_l=pad_l)
    assert got[2:] == ref[2:]
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))


@pytest.mark.parametrize("k,u,F_in", [(16, 8, 1), (16, 8, 8), (4, 2, 2), (4, 2, 16)])
def test_fold_conv_transpose_matches_jax(rng, k, u, F_in):
    """A torch ``ConvTranspose1d`` weight ``[C_in, C_out, k]`` through
    :func:`conv_transpose_taps` (taps flipped) folds as JAX folds its
    plain-conv taps, which store ``w[:, :, k-1-j]`` at ``j``."""
    W = rng.standard_normal((k, 5, 6)).astype(np.float32)  # JAX: plain-conv orientation
    b = rng.standard_normal(6).astype(np.float32)
    torch_w = torch.from_numpy(np.ascontiguousarray(W[::-1].transpose(1, 2, 0)))
    got = P.fold_conv_transpose(P.conv_transpose_taps(torch_w), b, u, F_in)
    ref = J.fold_conv_transpose(W, b, u, F_in)
    assert got[2:] == ref[2:]
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))


# ---------------------------------------------------------------------------
# the folded apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [TWO_BRANCH, MINI_RB2], ids=["nsf-resblock1", "mini-resblock2"])
def test_folded_matches_stock_generator(rng, kw):
    """f32, no source noise: the folded apply equals the port's stock
    generator (the same weights, other summation order)."""
    gen = _port_generator(kw)
    mel, f0 = _inputs(rng, 2, 12)
    mel, f0 = torch.from_numpy(mel), torch.from_numpy(f0)
    with torch.no_grad():
        ref = gen(mel, f0, stages={})
    out = P.FastNsfHifigan(gen, torch.float32, min_lanes=8, device="cpu")(mel, f0)
    assert out.shape == ref.shape == (2, 12 * 64)
    assert ref.abs().max() > 1e-2
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=FOLD_TOL, rtol=0)


def test_folded_matches_jax_fast_vocoder(rng):
    """The single-branch config against JAX's ``FastNsfHifigan`` (f32) on
    flax weights carried into the port's generator."""
    mel, f0 = _inputs(rng, 1, 10)
    jgen = JGen(JCfg(**ONE_BRANCH))
    params = jgen.init(jax.random.PRNGKey(0), jnp.asarray(mel), jnp.asarray(f0))
    # flax's N(0, 0.01) transposed-conv init would shrink the signal to nothing
    for i in range(len(SMALL["upsample_rates"])):
        kern = params["params"][f"ups_{i}"]["kernel"]
        params["params"][f"ups_{i}"]["kernel"] = jnp.asarray(
            rng.standard_normal(kern.shape).astype(np.float32) * 0.3)
    ref = np.asarray(J.FastNsfHifigan(JCfg(**ONE_BRANCH), params, dtype=jnp.float32,
                                      min_lanes=8)(jnp.asarray(mel), jnp.asarray(f0)))
    pcfg = PCfg(**ONE_BRANCH)
    gen = PGen(pcfg).eval()
    gen.load_state_dict(nsf_hifigan_state_dict_from_jax(params, pcfg), strict=True)
    out = P.FastNsfHifigan(gen, torch.float32, min_lanes=8, device="cpu")(
        torch.from_numpy(mel), torch.from_numpy(f0))
    assert out.shape == ref.shape == (1, 10 * 64)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=FOLD_TOL, rtol=0)


def test_pallas_stages_match_unit_path(rng):
    """``pallas_stages=(0, 1)`` (K2's plain version on stacked folded taps)
    equals ``()`` (K6's plain version per unit), f32 on the CPU."""
    gen = _port_generator(TWO_BRANCH)
    mel, f0 = _inputs(rng, 2, 12)
    mel, f0 = torch.from_numpy(mel), torch.from_numpy(f0)
    base = P.FastNsfHifigan(gen, torch.float32, min_lanes=8, device="cpu")(mel, f0)
    fused = P.FastNsfHifigan(gen, torch.float32, min_lanes=8, pallas_stages=(0, 1),
                             device="cpu")(mel, f0)
    np.testing.assert_allclose(fused.numpy(), base.numpy(), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="stages"):
        P.FastNsfHifigan(gen, torch.float32, min_lanes=8, pallas_stages=(4,), device="cpu")
    with pytest.raises(ValueError, match="ResBlock1"):
        P.FastNsfHifigan(_port_generator(MINI_RB2), torch.float32, pallas_stages=(0,),
                         device="cpu")


def test_folded_source_noise(rng):
    """With a ``torch.Generator`` the folded source draws SineGen's random
    initial phases and its additive noise (std 0.003 voiced, 0.1/3
    unvoiced); without one it is deterministic (the port of
    ``test_fast_vocoder_source_noise``)."""
    gen = _port_generator(ONE_BRANCH)
    fast = P.FastNsfHifigan(gen, torch.float32, min_lanes=8, device="cpu")
    mel, f0 = _inputs(rng, 1, 16)
    f0[:, 8:] = 0.0  # unvoiced second half
    mel, f0 = torch.from_numpy(mel), torch.from_numpy(f0)

    def g(seed):
        return torch.Generator().manual_seed(seed)

    base = fast(mel, f0)
    n1, n1b, n2 = fast(mel, f0, g(1)), fast(mel, f0, g(1)), fast(mel, f0, g(2))
    np.testing.assert_array_equal(n1.numpy(), n1b.numpy())  # same seed, same take
    assert (n1 - n2).abs().max() > 0
    assert (n1 - base).abs().max() > 0
    np.testing.assert_array_equal(base.numpy(), fast(mel, f0).numpy())
    # fully unvoiced: without a generator the excitation is the constant
    # tanh(bias); with one the unvoiced noise drives it
    f0_uv = torch.zeros_like(f0)
    uv_base = fast(mel, f0_uv)
    np.testing.assert_array_equal(uv_base.numpy(), fast(mel, f0_uv).numpy())
    assert (fast(mel, f0_uv, g(1)) - uv_base).abs().max() > 0
    # the draws: 9 initial phases, then one N(0, 1) value per sample, scaled
    # by the source weights' 2-norm; the unvoiced samples carry no sines
    har = fast.source(f0, g(3))
    replay = g(3)
    torch.rand(9, generator=replay)
    z = torch.randn((1, 16, 64), generator=replay).reshape(1, -1, 1)
    w_norm = float(np.linalg.norm(fast.source_w))
    want = torch.tanh(w_norm * (0.1 / 3.0) * z + fast.source_b)
    np.testing.assert_allclose(har[:, 8 * 64:].numpy(), want[:, 8 * 64:].numpy(), atol=1e-6)


def test_wrapper_folded_and_stock_agree(tmp_path):
    """A saved random checkpoint through the wrapper with
    ``use_folded_vocoder`` true (the default: K2 on stages 0 and 1, K6's
    plain version elsewhere) and false (the stock layout): the same wav."""
    from xiaoicesing_io_tpu_torch.models.vocoders.wrapper import NsfHifiGAN

    vcfg = dict(num_mels=128, sampling_rate=44100, hop_size=512, n_fft=2048, win_size=2048,
                fmin=40, fmax=16000, upsample_rates=[8, 8, 2, 2, 2],
                upsample_kernel_sizes=[16, 16, 4, 4, 4], upsample_initial_channel=64,
                resblock="1", resblock_kernel_sizes=[3, 7, 11],
                resblock_dilation_sizes=[[1, 3, 5]] * 3)
    torch.manual_seed(4)
    torch.save({"generator": PGen(PCfg.from_json(vcfg)).state_dict()}, tmp_path / "model.ckpt")
    (tmp_path / "config.json").write_text(json.dumps(vcfg))
    cfg = {"vocoder_ckpt": str(tmp_path / "model.ckpt"), "mel_base": "e"}
    folded = NsfHifiGAN(cfg, device="cpu")
    stock = NsfHifiGAN(dict(cfg, use_folded_vocoder=False), device="cpu")
    assert folded.fast is not None and folded.fast.pallas_stages == (0, 1)
    assert stock.fast is None and tuple(stock.stages) == (0, 1)
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((1, 6, 128)).astype(np.float32) - 3.0
    f0 = rng.uniform(100, 400, (1, 6)).astype(np.float32)
    got, ref = folded.spec2wav(mel, f0), stock.spec2wav(mel, f0)
    assert got.shape == ref.shape == (1, 6 * 512) and np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got, ref, atol=FOLD_TOL, rtol=0)
    no_fused = NsfHifiGAN(dict(cfg, vocoder_pallas_stages=[]), device="cpu")
    assert no_fused.fast.pallas_stages == ()
    np.testing.assert_allclose(no_fused.spec2wav(mel, f0), ref, atol=FOLD_TOL, rtol=0)


def test_wrapper_resblock2_checkpoint_default_keys(tmp_path):
    """A ResBlock2 ``model.ckpt`` + ``config.json`` through the wrapper with
    the default config keys: the folded layout with no fused stage (the fused
    stage kernel takes ResBlock1 only, so the default ``vocoder_pallas_stages``
    is ``()`` here, where the JAX wrapper's ``(0, 1)`` would fail), whose wav
    equals the stock generator's within 2e-5 (f32)."""
    from xiaoicesing_io_tpu_torch.models.vocoders.wrapper import NsfHifiGAN

    vcfg = dict(num_mels=128, sampling_rate=44100, hop_size=512, n_fft=2048, win_size=2048,
                fmin=40, fmax=16000, upsample_rates=[8, 8, 2, 2, 2],
                upsample_kernel_sizes=[16, 16, 4, 4, 4], upsample_initial_channel=64,
                resblock="2", resblock_kernel_sizes=[3, 7, 11],
                resblock_dilation_sizes=[[1, 3]] * 3)
    torch.manual_seed(6)
    torch.save({"generator": PGen(PCfg.from_json(vcfg)).state_dict()}, tmp_path / "model.ckpt")
    (tmp_path / "config.json").write_text(json.dumps(vcfg))
    voc = NsfHifiGAN({"vocoder_ckpt": str(tmp_path / "model.ckpt"), "mel_base": "e"},
                     device="cpu")
    assert voc.vcfg.resblock == "2"
    assert voc.fast is not None and voc.fast.pallas_stages == ()
    rng = np.random.default_rng(7)
    mel = rng.standard_normal((2, 6, 128)).astype(np.float32) - 3.0
    f0 = rng.uniform(100, 400, (2, 6)).astype(np.float32)
    got = voc.spec2wav(mel, f0)
    with torch.no_grad():
        ref = voc.generator(torch.from_numpy(mel), torch.from_numpy(f0), stages={}).numpy()
    assert got.shape == ref.shape == (2, 6 * 512) and np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got, ref, atol=FOLD_TOL, rtol=0)


# ---------------------------------------------------------------------------
# K6's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

UNIT_CASES = [  # tests/test_pallas_hifigan.py's raw cases and its folded-tap case
    dict(k=3, d=1, C=128, T=300, tile=128),
    dict(k=3, d=5, C=128, T=300, tile=128),
    dict(k=11, d=5, C=128, T=257, tile=128),   # largest halo of the HiFiGAN config
    dict(k=7, d=3, C=256, T=200, tile=256),    # stage-1 channel width
    dict(k=3, d=5, C=64, T=320, tile=64, F=2),  # folded taps: dilation 1, asymmetric pad
]


def _unit_case(rng, k, d, C, T, tile, F=1):
    B = 2
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w1 = (0.1 * rng.standard_normal((k, C, C))).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(C)).astype(np.float32)
    w2 = (0.1 * rng.standard_normal((k, C, C))).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(C)).astype(np.float32)
    if F == 1:
        return x, (w1, b1, w2, b2), dict(d1=d), tile
    w1f, b1f, p1, _ = P.fold_conv(w1, b1, F, dilation=d)
    w2f, b2f, p2, _ = P.fold_conv(w2, b2, F)
    geometry = dict(d1=1, pad1_l=p1, d2=1, pad2_l=p2)
    return x.reshape(B, T // F, F * C), (w1f, b1f, w2f, b2f), geometry, tile


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", UNIT_CASES,
                         ids=[f"k{c['k']}d{c['d']}C{c['C']}" + ("F2" if "F" in c else "")
                              for c in UNIT_CASES])
def test_resblock_unit_plain_matches_pallas(rng, case, dtype):
    x, weights, geometry, tile = _unit_case(rng, **case)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    w1, b1, w2, b2 = weights
    ref = np.asarray(j_resblock_unit(
        jnp.asarray(x, jdt), jnp.asarray(w1, jdt), jnp.asarray(b1), jnp.asarray(w2, jdt),
        jnp.asarray(b2), tile=tile, interpret=True, **geometry)).astype(np.float32)
    before = K6.launches
    got = K6.resblock_unit(torch.from_numpy(x).to(tdt), *K6.prepare_unit_weights(*weights, tdt),
                           **geometry)
    assert K6.launches == before  # the CPU takes the plain version
    assert got.dtype == tdt and tuple(got.shape) == ref.shape
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)
    else:
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got / scale, ref / scale, atol=6e-3)
        assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.9999
