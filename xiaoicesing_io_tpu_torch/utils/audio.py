"""WAV output (scipy): 16-bit PCM with optional peak normalisation."""

from __future__ import annotations

import numpy as np


def save_wav(wav: np.ndarray, path, sr: int, norm: bool = False) -> None:
    from scipy.io import wavfile

    wav = np.asarray(wav, dtype=np.float64)
    if norm and np.abs(wav).max() > 0:
        wav = wav / np.abs(wav).max()
    wav = wav * 32767
    wavfile.write(str(path), sr, wav.astype(np.int16))
