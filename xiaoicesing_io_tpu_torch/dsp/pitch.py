"""f0 estimation: Boersma (1993) autocorrelation method with a Viterbi path.

The pitch tracker of the JAX package's ``dsp/pitch.py`` (Praat's ``ac``
method with voicing_threshold=0.6, pitch_floor=f0_min, pitch_ceiling=f0_max
and frame centres at ``k * hop_size``), in numpy: the candidate search and
the Viterbi path are the numpy versions of that module (this package loads
no native library).

Algorithm:
1. frames of length 3/f0_min windowed with Hanning, mean-removed;
2. normalized autocorrelation r(tau) = r_frame(tau) / r_window(tau)
   computed via FFT;
3. up to ``max_candidates`` local maxima with parabolic interpolation,
   candidate strength R = r - octave_cost * log2(f0_min / f);
   unvoiced candidate strength from the silence/voicing thresholds;
4. Viterbi over frames with octave-jump and voiced/unvoiced transition costs.
"""

from __future__ import annotations

import numpy as np

from ..utils.curves import interp_f0


def _frame_signal(x: np.ndarray, frame_len: int, centers: np.ndarray) -> np.ndarray:
    """Extract frames centered at given sample positions (zero padded)."""
    half = frame_len // 2
    pad = np.pad(x, (half, frame_len))
    idx = centers[:, None] + np.arange(frame_len)[None, :]
    return pad[idx]


def _candidates(r, lag_min, lag_max, max_candidates, octave_cost, f0_min, f0_max, samplerate,
                cand_freq, cand_str):
    """Voiced candidates: local maxima of r in [lag_min, lag_max], into columns 1..."""
    seg = r[:, lag_min : lag_max + 1]
    left = r[:, lag_min - 1 : lag_max]
    right = r[:, lag_min + 1 : lag_max + 2]
    is_peak = (seg > left) & (seg >= right)
    for fi in range(len(r)):
        peaks = np.where(is_peak[fi])[0]
        if len(peaks) == 0:
            continue
        vals = seg[fi][peaks]
        order = np.argsort(vals)[::-1][: max_candidates - 1]
        for ci, pi in enumerate(order):
            tau = lag_min + peaks[pi]
            # parabolic interpolation around the peak
            y0, y1, y2 = r[fi, tau - 1], r[fi, tau], r[fi, tau + 1]
            denom = y0 - 2 * y1 + y2
            delta = 0.5 * (y0 - y2) / denom if abs(denom) > 1e-12 else 0.0
            delta = np.clip(delta, -0.5, 0.5)
            lag = tau + delta
            freq = samplerate / lag
            if freq < f0_min or freq > f0_max:
                continue
            strength = min(y1 + 0.5 * abs(denom) * delta ** 2, 1.0)
            cand_freq[fi, ci + 1] = freq
            cand_str[fi, ci + 1] = strength - octave_cost * np.log2(f0_min / freq)


def _viterbi(cand_freq, cand_str, octave_jump_cost, voiced_unvoiced_cost) -> np.ndarray:
    F, max_candidates = cand_freq.shape
    prev_cost = -cand_str[0]
    prev_ptr = np.zeros((F, max_candidates), np.int32)
    for fi in range(1, F):
        fprev = cand_freq[fi - 1]
        fcur = cand_freq[fi]
        uv_prev = fprev == 0
        uv_cur = fcur == 0
        trans = np.zeros((max_candidates, max_candidates))
        both_voiced = (~uv_prev[:, None]) & (~uv_cur[None, :])
        with np.errstate(divide="ignore", invalid="ignore"):
            jump = np.abs(np.log2(np.where(
                both_voiced,
                fprev[:, None] / np.maximum(fcur[None, :], 1e-12), 1.0,
            )))
        trans += np.where(both_voiced, octave_jump_cost * jump, 0.0)
        trans += np.where(
            uv_prev[:, None] != uv_cur[None, :], voiced_unvoiced_cost, 0.0
        )
        total = prev_cost[:, None] + trans - cand_str[fi][None, :]
        prev_ptr[fi] = np.argmin(total, axis=0)
        prev_cost = total[prev_ptr[fi], np.arange(max_candidates)]
    path = np.zeros(F, np.int32)
    path[-1] = int(np.argmin(prev_cost))
    for fi in range(F - 1, 0, -1):
        path[fi - 1] = prev_ptr[fi, path[fi]]
    return path


def estimate_f0(
    waveform: np.ndarray,
    samplerate: int,
    length: int,
    *,
    hop_size: int,
    f0_min: float = 65.0,
    f0_max: float = 1100.0,
    voicing_threshold: float = 0.6,
    silence_threshold: float = 0.03,
    octave_cost: float = 0.01,
    octave_jump_cost: float = 0.35,
    voiced_unvoiced_cost: float = 0.14,
    max_candidates: int = 15,
):
    """-> (f0 float32 [length], uv bool [length]); f0=0 at unvoiced frames."""
    x = np.asarray(waveform, np.float64)
    n = len(x)
    window_dur = 3.0 / f0_min
    frame_len = int(round(window_dur * samplerate))
    frame_len += frame_len % 2  # even
    centers = (np.arange(length) * hop_size).astype(np.int64)
    centers = np.minimum(centers, max(n - 1, 0))

    frames = _frame_signal(x, frame_len, centers)  # [F, L]
    global_peak = np.abs(x - x.mean()).max() + 1e-12
    local_mean = frames.mean(axis=1, keepdims=True)
    frames = frames - local_mean
    local_peak = np.abs(frames).max(axis=1) + 1e-12

    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(frame_len) / (frame_len - 1))
    wframes = frames * window

    # FFT-based autocorrelation, normalized by the window's autocorrelation
    nfft = 1
    while nfft < 2 * frame_len:
        nfft *= 2
    spec = np.fft.rfft(wframes, nfft, axis=1)
    ac = np.fft.irfft(np.abs(spec) ** 2, nfft, axis=1)[:, :frame_len]
    ac0 = np.maximum(ac[:, :1], 1e-12)
    ac = ac / ac0
    wspec = np.fft.rfft(window, nfft)
    wac = np.fft.irfft(np.abs(wspec) ** 2, nfft)[:frame_len]
    wac = wac / max(wac[0], 1e-12)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = ac / np.maximum(wac[None, :], 1e-6)

    lag_min = int(np.floor(samplerate / f0_max))
    lag_max = int(np.ceil(samplerate / f0_min))
    lag_max = min(lag_max, frame_len - 2)

    F = len(frames)
    cand_freq = np.zeros((F, max_candidates), np.float64)  # 0 = unvoiced
    cand_str = np.full((F, max_candidates), -1e9, np.float64)

    # unvoiced candidate (Boersma eq. 23)
    silence_R = voicing_threshold + np.maximum(
        0.0, 2.0 - (local_peak / global_peak) / (silence_threshold / (1 + voicing_threshold))
    )
    cand_freq[:, 0] = 0.0
    cand_str[:, 0] = silence_R

    _candidates(r, lag_min, lag_max, max_candidates, octave_cost, f0_min, f0_max, samplerate,
                cand_freq, cand_str)
    path = _viterbi(cand_freq, cand_str, octave_jump_cost, voiced_unvoiced_cost)
    f0 = cand_freq[np.arange(F), path].astype(np.float32)
    uv = f0 == 0
    return f0, uv


def get_pitch(
    waveform, samplerate, length, *, hop_size,
    f0_min=65, f0_max=1100, speed=1, interp_uv=False,
):
    """Drop-in equivalent of the reference's ``get_pitch_parselmouth``:
    ``(f0 float32 [length], uv bool [length])``, f0 interpolated over the
    unvoiced frames with ``interp_uv``."""
    hop = int(np.round(hop_size * speed))
    f0, uv = estimate_f0(
        waveform, samplerate, length, hop_size=hop, f0_min=f0_min, f0_max=f0_max
    )
    if interp_uv:
        f0, uv = interp_f0(f0, uv)
    return f0.astype(np.float32), uv
