"""STFT + log-mel spectrogram extraction.

The reference convention (NSF-HiFiGAN's ``nvSTFT``), as the JAX package's
``ops/mel.py`` implements it:

* periodic Hann window, ``center=False`` with manual reflect padding of
  ``((win - hop) // 2, (win - hop + 1) // 2)`` samples,
* magnitude spectrum |STFT|,
* Slaney-scale, Slaney-normalised mel filterbank (librosa's defaults),
* natural-log dynamic-range compression ``log(clip(x, 1e-5))``,
* ``keyshift`` rescales the FFT and window sizes (frequency stretch) and
  ``speed`` the hop (time stretch), for spectral-domain augmentation.

Three execution paths share the math:

* :meth:`MelSpectrogram.numpy`: the host path (numpy, any sizes, keyshift,
  speed, ``center``, HTK), the same code as the JAX package's.
* :meth:`MelSpectrogram.torch`: the DFT as one f32 matrix product (frames
  ``[.., n_fft] @ [n_fft, 2F]``) and the mel projection, on any device; the
  counterpart of the JAX package's ``.jax()`` and the plain version of the
  fused STFT -> log-mel kernel (K3, ``ops/cuda/mel_spec.py``).
* :meth:`MelSpectrogram.device`: batched, bucket-padded; on a CUDA tensor
  it launches K3, on a CPU tensor it runs the plain version.

The filterbank is computed from the librosa formula; librosa is not a
dependency.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Mel filterbank (Slaney scale + Slaney norm, librosa-compatible)
# ---------------------------------------------------------------------------


def hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    above = f >= min_log_hz
    mel = np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = m * f_sp
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
                   htk: bool = False) -> np.ndarray:
    """Triangular mel filterbank, shape [n_mels, 1 + n_fft // 2].

    Matches ``librosa.filters.mel(htk=htk, norm='slaney')`` to float32
    precision.
    """
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freqs)
    to_mel = hz_to_mel_htk if htk else hz_to_mel_slaney
    to_hz = mel_to_hz_htk if htk else mel_to_hz_slaney
    mel_pts = np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2)
    hz_pts = to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights = weights * enorm[:, None]
    return weights.astype(np.float32)


def hann_window(n: int) -> np.ndarray:
    """Periodic hann window (matches ``torch.hann_window(periodic=True)``)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


# ---------------------------------------------------------------------------
# Framing / padding helpers
# ---------------------------------------------------------------------------

def _stft_sizes(n_fft: int, win_size: int, hop: int, keyshift: float, speed: float):
    factor = 2.0 ** (keyshift / 12.0)
    n_fft_new = int(np.round(n_fft * factor))
    win_new = int(np.round(win_size * factor))
    hop_new = int(np.round(hop * speed))
    return n_fft_new, win_new, hop_new


def _padded_window(win_size: int, n_fft: int) -> np.ndarray:
    """Hann window of ``win_size`` centered in an ``n_fft`` buffer
    (torch.stft semantics when win_length < n_fft)."""
    w = hann_window(win_size)
    if win_size < n_fft:
        left = (n_fft - win_size) // 2
        w = np.pad(w, (left, n_fft - win_size - left))
    return w.astype(np.float32)


def reflect_pad(y: np.ndarray, left: int, right: int) -> np.ndarray:
    return np.pad(y, [(0, 0)] * (y.ndim - 1) + [(left, right)], mode="reflect")


def num_frames(n_samples: int, win_size: int, hop: int) -> int:
    """Frame count after the reference's padding scheme."""
    padded = n_samples + (win_size - hop) // 2 + (win_size - hop + 1) // 2
    return 1 + (padded - win_size) // hop


# ---------------------------------------------------------------------------
# Config + entry points
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 44100
    n_mels: int = 128
    n_fft: int = 2048
    win_size: int = 2048
    hop_size: int = 512
    fmin: float = 40.0
    fmax: float = 16000.0
    clip_val: float = 1e-5

    @staticmethod
    def from_config(cfg) -> "MelConfig":
        return MelConfig(
            sample_rate=cfg["audio_sample_rate"],
            n_mels=cfg["audio_num_mel_bins"],
            n_fft=cfg["fft_size"],
            win_size=cfg["win_size"],
            hop_size=cfg["hop_size"],
            fmin=cfg["fmin"],
            fmax=cfg["fmax"],
        )


class MelSpectrogram:
    """Mel extractor with a host path (numpy) and device paths (torch).

    ``center=False`` uses the reference acoustic convention (manual
    (win-hop)//2 reflect padding); ``center=True`` matches
    ``torch.stft(center=True)`` (n_fft//2 reflect padding), as the RMVPE
    16 kHz HTK mel uses it.  ``center=True`` is taken by :meth:`numpy` only.
    """

    def __init__(self, cfg: MelConfig, htk: bool = False, center: bool = False):
        self.cfg = cfg
        self.center = center
        self.mel_basis = mel_filterbank(
            cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, htk=htk
        )  # [M, F]
        self._prepared = {}

    # -- host path (numpy, any shapes) ---------------------------------------

    def numpy(self, y: np.ndarray, keyshift: float = 0.0, speed: float = 1.0) -> np.ndarray:
        """y: [T] or [B, T] in [-1, 1] -> log-mel [frames, M] (or [B, frames, M])."""
        squeeze = y.ndim == 1
        y = np.atleast_2d(np.asarray(y, dtype=np.float32))
        c = self.cfg
        n_fft_new, win_new, hop_new = _stft_sizes(c.n_fft, c.win_size, c.hop_size, keyshift, speed)
        if self.center:
            pad_l = pad_r = n_fft_new // 2
        else:
            pad_l = (win_new - hop_new) // 2
            pad_r = (win_new - hop_new + 1) // 2
        ypad = reflect_pad(y, pad_l, pad_r)
        window = _padded_window(win_new, n_fft_new)
        n_frames = 1 + (ypad.shape[-1] - n_fft_new) // hop_new
        idx = np.arange(n_fft_new)[None, :] + hop_new * np.arange(n_frames)[:, None]
        frames = ypad[:, idx] * window[None, None, :]  # [B, frames, n_fft_new]
        spec = np.abs(np.fft.rfft(frames, axis=-1)).astype(np.float32)  # [B, frames, F_new]
        if keyshift != 0:
            size = c.n_fft // 2 + 1
            if spec.shape[-1] < size:
                spec = np.pad(spec, [(0, 0), (0, 0), (0, size - spec.shape[-1])])
            spec = spec[..., :size] * (c.win_size / win_new)
        mel = spec @ self.mel_basis.T  # [B, frames, M]
        mel = np.log(np.clip(mel, c.clip_val, None))
        return mel[0] if squeeze else mel

    # -- torch paths (K3 and its plain version) ------------------------------
    # ``.cuda.mel_spec`` is imported where it is used: it imports this module.

    def prepared(self, device):
        """K3's tables on ``device`` (built once per device)."""
        from .cuda.mel_spec import prepare_mel

        device = torch.device(device)
        if device not in self._prepared:
            self._prepared[device] = prepare_mel(self.cfg, device, mel_basis=self.mel_basis)
        return self._prepared[device]

    def _check_center(self):
        if self.center:
            raise NotImplementedError(
                "the device mel paths use the reference's center=False padding; "
                "center=True runs on the host (.numpy())"
            )

    def torch(self, y):
        """y: ``[B, T]`` f32 tensor -> log-mel ``[B, frames, M]`` on y's device:
        the matrix-product DFT in f32, K3's plain version."""
        from .cuda.mel_spec import mel_spectrogram_plain

        self._check_center()
        return mel_spectrogram_plain(y, self.prepared(y.device))

    def device(self, y, bucket_frames: int = 256, plain: bool = False):
        """Batched mel for ``[B, T]`` waveforms -> ``[B, frames, M]`` on y's device.

        Pads T with zeros up to a ``bucket_frames`` hop grid, then runs K3 on
        a CUDA tensor (one launch) and its plain version on a CPU tensor.
        ``plain=True`` takes the plain version on any device: the reference
        the kernel is held against.  ``y`` may be a numpy array (taken as a
        CPU tensor).  Callers slice the true frame count off the result.
        """
        from .cuda.mel_spec import mel_spectrogram

        self._check_center()
        if not torch.is_tensor(y):
            y = torch.as_tensor(np.asarray(y, np.float32))
        y = torch.atleast_2d(y)
        bucket = bucket_frames * self.cfg.hop_size
        y = F.pad(y, (0, (-y.shape[1]) % bucket))
        if plain:
            return self.torch(y)
        return mel_spectrogram(y, self.prepared(y.device))
