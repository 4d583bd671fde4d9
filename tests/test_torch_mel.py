"""The port's mel module and K3's plain version against the JAX package, on the CPU.

Inputs come from seeded numpy.  Tolerances: the host path (numpy in both
packages) within 1e-6; the f32 matrix-product DFT (``.torch()`` against
``.jax()`` and the Pallas kernel in interpret mode) within 2e-4 at the small
configuration of the JAX package's mel tests (16 kHz, n_fft 256, hop 64, 64
mels) and 2e-3 at the shipped one (n_fft 2048: f32 sums of 2048 terms in two
orders), the bar at which the JAX package holds its own f32 DFT.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xiaoicesing_io_tpu.ops import mel as J
from xiaoicesing_io_tpu_torch.ops import mel as P
from xiaoicesing_io_tpu_torch.ops.cuda import mel_spec as K3

SMALL = dict(sample_rate=16000, n_mels=64, n_fft=256, win_size=256, hop_size=64,
             fmin=30.0, fmax=8000.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several worker processes share the cores: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wav(n, seed=0, sr=44100, batch=None):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    y = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 440 * t + 0.3)
    shape = (n,) if batch is None else (batch, n)
    return (y + 0.05 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("htk", [False, True])
@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (44100, 2048, 128, 40.0, 16000.0),  # the shipped configuration
    (16000, 256, 64, 30.0, 8000.0),
    (16000, 1024, 128, 30.0, 8000.0),   # the RMVPE mel's sizes
])
def test_mel_filterbank_equals_jax(htk, sr, n_fft, n_mels, fmin, fmax):
    got = P.mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk=htk)
    np.testing.assert_array_equal(got, J.mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk=htk))
    np.testing.assert_array_equal(P.hann_window(n_fft), J.hann_window(n_fft))
    np.testing.assert_array_equal(P._padded_window(n_fft * 3 // 4, n_fft),
                                  J._padded_window(n_fft * 3 // 4, n_fft))


def test_mel_helpers_equal_jax():
    for n in (44100, 44100 + 13, 512 * 100):
        assert P.num_frames(n, 2048, 512) == J.num_frames(n, 2048, 512)
    for args in ((2048, 2048, 512, 2.0, 1.0), (2048, 2048, 512, -2.0, 1.1)):
        assert P._stft_sizes(*args) == J._stft_sizes(*args)
    y = _wav(300, batch=2)
    np.testing.assert_array_equal(P.reflect_pad(y, 7, 9), J.reflect_pad(y, 7, 9))
    f = np.array([0.0, 100.0, 999.0, 1000.0, 5000.0, 16000.0])
    m = np.array([0.0, 1.5, 14.9, 15.0, 40.0, 3000.0])
    for a, b in (("hz_to_mel_slaney", "mel_to_hz_slaney"), ("hz_to_mel_htk", "mel_to_hz_htk")):
        np.testing.assert_array_equal(getattr(P, a)(f), getattr(J, a)(f))
        np.testing.assert_array_equal(getattr(P, b)(m), getattr(J, b)(m))
    cfg = {"audio_sample_rate": 44100, "audio_num_mel_bins": 128, "fft_size": 2048,
           "win_size": 2048, "hop_size": 512, "fmin": 40, "fmax": 16000}
    assert P.MelConfig.from_config(cfg) == P.MelConfig()
    assert J.MelConfig.from_config(cfg).__dict__ == P.MelConfig.from_config(cfg).__dict__


@pytest.mark.parametrize("center,htk,keyshift,speed", [
    (False, False, 0.0, 1.0),
    (True, False, 0.0, 1.0),
    (True, True, 0.0, 1.0),
    (False, False, 2.0, 1.0),
    (False, False, -2.0, 1.0),
    (False, False, 0.0, 1.1),
])
def test_numpy_path_matches_jax(center, htk, keyshift, speed):
    cfg = dict(sample_rate=44100)
    y = _wav(44100 + 333, seed=1, batch=2)
    ext = P.MelSpectrogram(P.MelConfig(**cfg), htk=htk, center=center)
    got = ext.numpy(y, keyshift=keyshift, speed=speed)
    ref = J.MelSpectrogram(J.MelConfig(**cfg), htk=htk, center=center).numpy(
        y, keyshift=keyshift, speed=speed)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    # one sequence in, one out
    assert ext.numpy(y[0], keyshift=keyshift, speed=speed).shape == ref.shape[1:]


@pytest.mark.parametrize("small,n_samples,atol", [
    (True, 2000, 2e-4), (True, 4096, 2e-4), (False, 3 * 44100 + 77, 2e-3),
])
def test_torch_path_matches_jax(small, n_samples, atol):
    kw = SMALL if small else {}
    y = _wav(n_samples, seed=2, batch=2, sr=16000 if small else 44100)
    got = P.MelSpectrogram(P.MelConfig(**kw)).torch(torch.from_numpy(y)).numpy()
    ref = np.asarray(J.MelSpectrogram(J.MelConfig(**kw)).jax(jnp.asarray(y)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("n_samples", [2000, 4096])
def test_torch_path_matches_pallas_kernel(n_samples):
    """K3's plain version against the TPU kernel, run as the JAX package's
    own test runs it (interpret mode, f32)."""
    from xiaoicesing_io_tpu.ops.pallas.mel_kernel import PallasMelSpectrogram

    rng = np.random.default_rng(0)
    y = (rng.standard_normal((2, n_samples)) * 0.3).astype(np.float32)
    ref = PallasMelSpectrogram(J.MelConfig(**SMALL), tile_t=16, freq_block=64)(
        jnp.asarray(y), interpret=True)
    got = P.MelSpectrogram(P.MelConfig(**SMALL)).torch(torch.from_numpy(y)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-4, rtol=0)


@pytest.mark.parametrize("B,T,bucket", [
    (2, 3 * 512 * 100 + 77, 64),   # off-bucket
    (1, 512 * 256, 256),           # exactly one bucket
    (3, 40000, 256),
])
def test_device_path_on_cpu_matches_jax(B, T, bucket):
    """``.device()`` on a CPU tensor (bucket padding, then K3's plain version)
    against the JAX package's ``.device()`` on the CPU (bucket padding, then
    its f32 matrix-product DFT)."""
    y = np.random.default_rng(3).uniform(-0.5, 0.5, (B, T)).astype(np.float32)
    ext = P.MelSpectrogram(P.MelConfig())
    got = ext.device(torch.from_numpy(y), bucket_frames=bucket)
    ref = J.MelSpectrogram(J.MelConfig()).device(y, bucket_frames=bucket)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3, rtol=0)
    # a numpy array is taken as a CPU tensor; plain=True is the same path here
    np.testing.assert_array_equal(ext.device(y, bucket_frames=bucket).numpy(), got.numpy())
    np.testing.assert_array_equal(ext.device(y, bucket_frames=bucket, plain=True).numpy(),
                                  got.numpy())


def test_kernel_wrapper_on_cpu_is_the_plain_version():
    y = torch.from_numpy(_wav(5000, seed=4, batch=3, sr=16000))
    prep = K3.prepare_mel(P.MelConfig(**SMALL), "cpu")
    before = K3.launches
    np.testing.assert_array_equal(K3.mel_spectrogram(y, prep).numpy(),
                                  K3.mel_spectrogram_plain(y, prep).numpy())
    assert K3.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        K3.mel_spectrogram(y.to("meta"), prep)


@pytest.mark.parametrize("small", [False, True])
def test_kernel_band_tables_rebuild_the_filterbank(small):
    """The kernel's sparse ``(first_bin, count, offset)`` bands hold every
    nonzero weight of the filterbank, and no bin past ``n_bins`` is weighted."""
    cfg = P.MelConfig(**(SMALL if small else {}))
    prep = K3.prepare_mel(cfg)
    basis = P.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    rebuilt = np.zeros_like(basis)
    for m in range(cfg.n_mels):
        f, c, o = (int(t[m]) for t in (prep.band_first, prep.band_count, prep.band_offset))
        rebuilt[m, f:f + c] = prep.weights[o:o + c].numpy()
    np.testing.assert_array_equal(rebuilt, basis)
    assert not basis[:, prep.n_bins:].any() and basis[:, prep.n_bins - 1].any()
    assert prep.nnz == len(prep.weights)
    if not small:  # the shipped filterbank's bands, as the kernel's bound counts them
        assert (prep.nnz, prep.n_bins, int(prep.band_count.max())) == (1460, 744, 43)
    # twiddles exp(-2 pi i k / n_fft) from float64, stored f32
    k = np.arange(cfg.n_fft // 2)
    tw = np.exp(-2j * np.pi * k / cfg.n_fft)
    np.testing.assert_array_equal(prep.twiddle.numpy(),
                                  np.stack([tw.real, tw.imag], 1).astype(np.float32))
    assert prep.num_frames(44100) == P.num_frames(44100, cfg.win_size, cfg.hop_size)


def test_device_paths_refuse_center():
    ext = P.MelSpectrogram(P.MelConfig(**SMALL), htk=True, center=True)
    y = torch.zeros(1, 4096)
    with pytest.raises(NotImplementedError, match="center"):
        ext.torch(y)
    with pytest.raises(NotImplementedError, match="center"):
        ext.device(y)
