"""Harmonic / aperiodic decomposition (the JAX package's ``dsp/hnsep.py``).

``world`` (the reference's pyworld default) and ``comb`` map to the comb
STFT masking here: the *full* harmonic part keeps the bins around every
harmonic ``k * f0`` (k = 1 .. Nyquist), and the aperiodic part is the
residual ``waveform - harmonic``.  Both run on the host in numpy.  ``vr``
predicts the harmonic part with the vocal-remover net
(``models/hnsep_vr.py``), whose net runs on the device the caller gives.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.curves import interp_f0

# loaded vocal-remover runners, one per (resolved checkpoint path, device)
_VR_MODELS: Dict[Tuple[str, str], object] = {}


def nuttall_window(n: int) -> np.ndarray:
    """The periodic Nuttall window."""
    phase = np.arange(n) / n * 2 * np.pi
    return (0.355768 - 0.487396 * np.cos(phase) + 0.144232 * np.cos(2 * phase)
            - 0.012604 * np.cos(3 * phase))


def stft_centered(x: np.ndarray, n_fft: int, hop: int, window: np.ndarray) -> np.ndarray:
    """``torch.stft(center=True)`` with reflect padding. -> [frames, bins]"""
    pad = n_fft // 2
    xp = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (len(xp) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    return np.fft.rfft(xp[idx] * window[None, :], axis=1)


def istft_centered(spec: np.ndarray, n_fft: int, hop: int, window: np.ndarray,
                   length: int) -> np.ndarray:
    """``torch.istft`` equivalent: windowed overlap-add normalised by the
    summed squared window, the centre padding cropped."""
    frames = np.fft.irfft(spec, n_fft, axis=1) * window[None, :]
    total = n_fft + hop * (len(spec) - 1)
    out = np.zeros(total)
    norm = np.zeros(total)
    w2 = window.astype(np.float64) ** 2
    for i in range(len(spec)):
        out[i * hop: i * hop + n_fft] += frames[i]
        norm[i * hop: i * hop + n_fft] += w2
    pad = n_fft // 2
    out = out[pad: pad + length]
    norm = norm[pad: pad + length]
    return out / np.maximum(norm, 1e-8)


def vocal_remover(model_path, device=None):
    """The vocal-remover runner of ``model_path`` on ``device``, loaded once
    per (resolved path, device)."""
    import torch

    from ..models.hnsep_vr import VocalRemover
    from ..utils import resolve_device

    dev = resolve_device(device)
    key = (str(Path(model_path).resolve()), str(torch.device(dev)))
    if key not in _VR_MODELS:
        _VR_MODELS[key] = VocalRemover(model_path, device=dev)
    return _VR_MODELS[key]


class DecomposedWaveform:
    """Harmonic / aperiodic parts and per-harmonic isolation:
    ``harmonic()``, ``harmonic(k)``, ``aperiodic()``, ``noise_gain()`` and the
    ``samplerate / hop_size / fft_size / win_size`` properties."""

    def __init__(self, waveform, samplerate, f0, *, hop_size=None, fft_size=None,
                 win_size=None, base_harmonic_radius: float = 3.5, algorithm: str = "comb",
                 model_path=None, device=None):
        self._waveform = np.asarray(waveform, np.float64)
        self._samplerate = samplerate
        self._f0 = np.asarray(f0, np.float64)
        self._hop_size = hop_size
        self._fft_size = fft_size if fft_size is not None else win_size
        self._win_size = win_size
        self._half_width = base_harmonic_radius
        self._harmonic_part: Optional[np.ndarray] = None
        self._aperiodic_part: Optional[np.ndarray] = None
        self._harmonics: Dict[int, np.ndarray] = {}
        self._algorithm = "comb" if algorithm in ("comb", "world") else algorithm
        if self._algorithm == "vr":
            self._vr = vocal_remover(model_path, device)
        elif self._algorithm != "comb":
            raise ValueError(f" [x] Unknown harmonic-noise separator: {algorithm}")

    samplerate = property(lambda self: self._samplerate)
    hop_size = property(lambda self: self._hop_size)
    fft_size = property(lambda self: self._fft_size)
    win_size = property(lambda self: self._win_size)

    def _aligned_f0(self, n_frames: int) -> np.ndarray:
        f0 = self._f0
        if len(f0) < n_frames:
            f0 = np.pad(f0, (0, n_frames - len(f0)), mode="edge")
        f0, _ = interp_f0(f0[:n_frames], uv=f0[:n_frames] == 0)
        return f0

    def _comb_mask_filter(self, harmonic_lo: int, harmonic_hi: Optional[int]) -> np.ndarray:
        """Resynthesise keeping the bins near harmonics in [lo, hi] (1-based),
        analysed at ``fft_size``."""
        n_fft, hop, sr = self._fft_size, self._hop_size, self._samplerate
        window = nuttall_window(n_fft)
        spec = stft_centered(self._waveform, n_fft, hop, window)
        n_frames, n_bins = spec.shape
        f0 = self._aligned_f0(n_frames)
        full_comb = harmonic_hi is None
        if harmonic_hi is None:
            harmonic_hi = int(np.floor((sr / 2) / max(f0.min(), 1.0))) + 1
        # a bin can only fall inside the band of a harmonic within
        # ceil(half_width / spacing) of the nearest one: test those few
        bins = np.arange(n_bins, dtype=np.float64)[None, :]
        spacing = (f0 * n_fft / sr)[:, None]
        nearest = np.round(bins / spacing)
        n_cand = int(np.ceil(self._half_width / max(spacing.min(), 1e-6))) + 1
        mask = np.zeros((n_frames, n_bins), bool)
        for d in range(-n_cand, n_cand + 1):
            k = nearest + d
            center = k * spacing
            mask |= ((k >= harmonic_lo) & (k <= harmonic_hi) & (center >= 1)
                     & (bins >= np.clip(center - self._half_width, 0, None))
                     & (bins < np.clip(center + self._half_width, None, n_bins)))
        if full_comb:
            # the share of the spectrum the comb claims, per frame (noise_gain)
            self._comb_frac = mask.mean(axis=1)
        return istft_centered(spec * mask, n_fft, hop, window, len(self._waveform))

    def harmonic(self, k: Optional[int] = None) -> np.ndarray:
        if k is not None:
            if k not in self._harmonics:
                # harmonic k + 1 of the harmonic part, at win_size
                win_size = self._win_size
                window = nuttall_window(win_size)
                spec = stft_centered(self.harmonic(), win_size, self._hop_size, window)
                n_frames, n_bins = spec.shape
                f0 = self._aligned_f0(n_frames) * (k + 1)
                bins = np.arange(n_bins)[None, :]
                center = f0 * win_size / self._samplerate
                lo = np.clip(center - self._half_width, 0, None)
                hi = np.clip(center + self._half_width, None, n_bins)
                mask = (center[:, None] >= 1) & (bins >= lo[:, None]) & (bins < hi[:, None])
                self._harmonics[k] = istft_centered(
                    spec * mask, win_size, self._hop_size, window, len(self._waveform)
                ).astype(np.float32)
            return self._harmonics[k]
        if self._harmonic_part is None:
            if self._algorithm == "vr":
                self._harmonic_part = self._vr.predict_harmonic(self._waveform.astype(np.float32))
            else:
                self._harmonic_part = self._comb_mask_filter(1, None).astype(np.float32)
        return self._harmonic_part

    def aperiodic(self) -> np.ndarray:
        if self._aperiodic_part is None:
            self._aperiodic_part = (
                self._waveform - self.harmonic().astype(np.float64)).astype(np.float32)
        return self._aperiodic_part

    def noise_gain(self, length: int) -> np.ndarray:
        """Per-frame RMS gain that maps the comb residual to full-band noise:
        the comb claims a share rho of the spectrum a frame, and with it the
        broadband noise there, so the residual's RMS is low by sqrt(1 - rho).
        ``vr`` predicts a full-band residual already (gain 1)."""
        if self._algorithm == "vr":
            return np.ones(length, np.float32)
        self.harmonic()  # the full comb sets _comb_frac
        rho = np.clip(self._comb_frac, 0.0, 0.95)
        pos = np.linspace(0, len(rho) - 1, length)
        rho_i = np.interp(pos, np.arange(len(rho)), rho)
        return (1.0 / np.sqrt(1.0 - rho_i)).astype(np.float32)
