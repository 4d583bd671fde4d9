"""Variance-curve feature extraction (energy, breathiness, voicing, tension),
on the host in numpy, as the JAX package's ``dsp/features.py`` computes them:

* energy      = RMS of the waveform per frame, in dB (``librosa.feature.rms``
                semantics: centered zero-padded frames; ``amplitude_to_db``
                with amin=1e-5 and top_db=80)
* breathiness = RMS dB of the aperiodic part
* voicing     = RMS dB of the harmonic part
* tension     = sqrt(max(E_h^2 - E_h0^2, 0)) / (E_h + 1e-5) in the logit domain
"""

from __future__ import annotations

from typing import Union

import numpy as np

from .hnsep import DecomposedWaveform


def rms_frames(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """``librosa.feature.rms`` equivalent (center=True, zero padding)."""
    pad = frame_length // 2
    yp = np.pad(np.asarray(y, np.float64), (pad, pad))
    n_frames = 1 + (len(yp) - frame_length) // hop_length
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n_frames)[:, None]
    return np.sqrt(np.mean(yp[idx] ** 2, axis=1))


def amplitude_to_db(a: np.ndarray, amin: float = 1e-5, top_db: float = 80.0) -> np.ndarray:
    """``librosa.amplitude_to_db`` equivalent (ref=1.0)."""
    db = 20.0 * np.log10(np.maximum(np.abs(a), amin))
    if top_db is not None:
        db = np.maximum(db, db.max() - top_db)
    return db


def get_energy(waveform, length, *, hop_size, win_size, domain="db") -> np.ndarray:
    energy = rms_frames(waveform, win_size, hop_size)
    if len(energy) < length:
        energy = np.pad(energy, (0, length - len(energy)))
    energy = energy[:length]
    if domain == "db":
        energy = amplitude_to_db(energy)
    elif domain != "amplitude":
        raise ValueError(f"Invalid domain: {domain}")
    return energy.astype(np.float32)


def _ensure_decomposed(waveform, samplerate, f0, hop_size, fft_size, win_size):
    if isinstance(waveform, DecomposedWaveform):
        return waveform
    return DecomposedWaveform(waveform, samplerate, f0, hop_size=hop_size,
                              fft_size=fft_size, win_size=win_size)


def get_breathiness(
    waveform: Union[np.ndarray, DecomposedWaveform], samplerate=None, f0=None,
    length=None, *, hop_size=None, fft_size=None, win_size=None,
) -> np.ndarray:
    dw = _ensure_decomposed(waveform, samplerate, f0, hop_size, fft_size, win_size)
    db = get_energy(dw.aperiodic(), length, hop_size=dw.hop_size, win_size=dw.win_size)
    # full-band noise compensation (DecomposedWaveform.noise_gain): the comb
    # residual misses the noise in the bins the comb claims
    gain = dw.noise_gain(len(db))
    return (db + 20.0 * np.log10(gain)).astype(np.float32)


def get_voicing(
    waveform: Union[np.ndarray, DecomposedWaveform], samplerate=None, f0=None,
    length=None, *, hop_size=None, fft_size=None, win_size=None,
) -> np.ndarray:
    dw = _ensure_decomposed(waveform, samplerate, f0, hop_size, fft_size, win_size)
    return get_energy(dw.harmonic(), length, hop_size=dw.hop_size, win_size=dw.win_size)


def get_tension(
    waveform: Union[np.ndarray, DecomposedWaveform], samplerate=None, f0=None,
    length=None, *, hop_size=None, fft_size=None, win_size=None, domain="logit",
) -> np.ndarray:
    dw = _ensure_decomposed(waveform, samplerate, f0, hop_size, fft_size, win_size)
    energy_base = get_energy(dw.harmonic(0), length, hop_size=dw.hop_size,
                             win_size=dw.win_size, domain="amplitude")
    energy_h = get_energy(dw.harmonic(), length, hop_size=dw.hop_size,
                          win_size=dw.win_size, domain="amplitude")
    tension = np.sqrt(np.clip(energy_h ** 2 - energy_base ** 2, 0, None)) / (energy_h + 1e-5)
    if domain == "ratio":
        tension = np.clip(tension, 0, 1)
    elif domain == "db":
        tension = amplitude_to_db(np.clip(tension, 1e-5, 1), top_db=None)
    elif domain == "logit":
        tension = np.clip(tension, 1e-4, 1 - 1e-4)
        tension = np.log(tension / (1 - tension))
    else:
        raise ValueError(f"Invalid domain: {domain}")
    return tension.astype(np.float32)
