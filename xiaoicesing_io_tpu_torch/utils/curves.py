"""f0 / curve utilities (numpy, CPU-side pre/post-processing).

Host copies of the JAX package's ``utils/curves.py``: log2-domain
interpolation over unvoiced gaps, curve resampling, crossfade.
"""

from __future__ import annotations

import numpy as np


def norm_f0(f0: np.ndarray, uv: np.ndarray | None = None) -> np.ndarray:
    f0 = np.asarray(f0, dtype=np.float64).copy()
    if uv is None:
        uv = f0 == 0
    f0 = np.log2(f0 + uv)  # +uv avoids log(0) at unvoiced frames
    f0[uv] = -np.inf
    return f0


def denorm_f0(
    f0: np.ndarray, uv: np.ndarray | None, pitch_padding: np.ndarray | None = None
) -> np.ndarray:
    f0 = 2.0 ** np.asarray(f0, dtype=np.float64)
    if uv is not None:
        f0[uv > 0] = 0
    if pitch_padding is not None:
        f0[pitch_padding] = 0
    return f0


def interp_f0(f0: np.ndarray, uv: np.ndarray | None = None):
    """Interpolate over unvoiced gaps in log2 domain; returns (f0, uv)."""
    if uv is None:
        uv = f0 == 0
    f0 = norm_f0(f0, uv)
    if uv.any() and not uv.all():
        f0[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0], f0[~uv])
    return denorm_f0(f0, uv=None), uv


def resample_align_curve(
    points: np.ndarray, original_timestep: float, target_timestep: float, align_length: int
) -> np.ndarray:
    """Resample a time-stamped curve to a new timestep and pad/trim to length."""
    points = np.asarray(points)
    t_max = (len(points) - 1) * original_timestep
    curve = np.interp(
        np.arange(0, t_max, target_timestep),
        original_timestep * np.arange(len(points)),
        points,
    ).astype(points.dtype)
    delta = align_length - len(curve)
    if delta < 0:
        curve = curve[:align_length]
    elif delta > 0:
        curve = np.concatenate([curve, np.full(delta, curve[-1], dtype=curve.dtype)])
    return curve


def cross_fade(a: np.ndarray, b: np.ndarray, idx: int) -> np.ndarray:
    """Linearly crossfade overlapping waveform segments; b starts at ``idx``."""
    result = np.zeros(idx + b.shape[0])
    fade_len = a.shape[0] - idx
    result[:idx] = a[:idx]
    k = np.linspace(0, 1.0, num=fade_len, endpoint=True)
    result[idx : a.shape[0]] = (1 - k) * a[idx:] + k * b[:fade_len]
    result[a.shape[0] :] = b[fade_len:]
    return result


def smooth_kernel_sinusoidal(width_frames: int) -> np.ndarray:
    """Half-sine FIR smoothing kernel, unit sum.

    sin(linspace(0, 1, n) * pi), normalized; note the zero-valued endpoints.
    """
    n = int(width_frames)
    w = np.sin(np.linspace(0.0, 1.0, n) * np.pi)
    return (w / w.sum()).astype(np.float32)


def smooth_curve(curve: np.ndarray, width_frames: int) -> np.ndarray:
    """'same'-padded FIR smoothing with the half-sine kernel (edge replicate)."""
    k = smooth_kernel_sinusoidal(width_frames)
    n = len(k)
    pad_l = (n - 1) // 2
    pad_r = n - 1 - pad_l
    padded = np.concatenate([np.full(pad_l, curve[0]), curve, np.full(pad_r, curve[-1])])
    return np.convolve(padded, k, mode="valid").astype(np.float32)
