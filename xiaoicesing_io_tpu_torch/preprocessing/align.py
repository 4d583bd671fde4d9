"""Duration -> frame-index alignment shared by the binarizers and the
augmentation (a copy of the JAX package's ``preprocessing/align.py``).

Seconds become integer frame durations by cumsum-round-diff, expand to a
1-based frame -> token map, and are **edge-filled** with the last token's
index (not zero padding) when the target length exceeds the cumulative
duration, truncated otherwise.
"""

from __future__ import annotations

import numpy as np


def frames_from_sec(dur_sec: np.ndarray, timestep: float) -> np.ndarray:
    """Seconds -> integer frame durations."""
    acc = np.round(np.cumsum(dur_sec) / timestep + 0.5).astype(np.int64)
    return np.diff(acc, prepend=0)


def dur_to_mel2x(dur: np.ndarray, length: int) -> np.ndarray:
    """Expand per-token frame durations into a [length] frame -> token map.

    Frames past the cumulative duration take the LAST token's index: a wav
    slightly longer than its transcription must not leave real audio frames
    marked as padding.
    """
    dur = np.asarray(dur, np.int64)
    m = np.repeat(np.arange(1, len(dur) + 1, dtype=np.int64), np.maximum(dur, 0))
    if len(m) == 0:
        return np.zeros(length, np.int64)
    if len(m) < length:
        m = np.pad(m, (0, length - len(m)), mode="edge")
    return m[:length]


def sec_to_mel2x(dur_sec: np.ndarray, length: int, timestep: float) -> np.ndarray:
    return dur_to_mel2x(frames_from_sec(dur_sec, timestep), length)
