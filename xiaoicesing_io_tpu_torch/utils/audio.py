"""WAV I/O and resampling without librosa/soundfile (scipy only).

``load_wav`` stands in for ``librosa.load(..., sr=..., mono=True)``;
``save_wav`` writes 16-bit PCM with optional peak normalisation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_wav(path, sr: Optional[int] = None, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Load a WAV file as float32 in [-1, 1]; optionally resample to ``sr``."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    file_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if mono and wav.ndim > 1:
        wav = wav.mean(axis=1)
    if sr is not None and sr != file_sr:
        g = np.gcd(int(sr), int(file_sr))
        wav = resample_poly(wav, sr // g, file_sr // g).astype(np.float32)
        file_sr = sr
    return wav, file_sr


def save_wav(wav: np.ndarray, path, sr: int, norm: bool = False) -> None:
    from scipy.io import wavfile

    wav = np.asarray(wav, dtype=np.float64)
    if norm and np.abs(wav).max() > 0:
        wav = wav / np.abs(wav).max()
    wav = wav * 32767
    wavfile.write(str(path), sr, wav.astype(np.int16))
