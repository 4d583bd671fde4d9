"""Harvest-style pitch extractor (``pe: harvest``), on the host in numpy and
scipy: the JAX package's ``models/pe/harvest.py``, a from-scratch
implementation of the Harvest algorithm family (M. Morise, "Harvest: A
high-performance fundamental frequency estimator from speech signals",
INTERSPEECH 2017), which the reference reaches through pyworld.

1. **Coarse candidates**: the signal is band-pass filtered at log-spaced
   boundary frequencies; in a band where the fundamental dominates, four
   event-interval estimators (rising/falling zero crossings, peaks, dips)
   agree, and their mean forms an f0 candidate whose reliability is the
   negative dispersion of the four.
2. **Refinement**: each winning candidate is refined with the instantaneous
   frequency of its harmonics: the phase advance of windowed DFTs at k*f0
   across a half-window hop, amplitude-weighted over harmonics.
3. **Fixing**: per-frame best candidate by reliability, a short median
   filter over voiced runs, and unvoiced where no stable candidate exists.
"""

from __future__ import annotations

import numpy as np

_CH_PER_OCT = 24.0


def _nuttall(n: int) -> np.ndarray:
    t = np.arange(n) / max(n - 1, 1)
    return (
        0.355768
        - 0.487396 * np.cos(2 * np.pi * t)
        + 0.144232 * np.cos(4 * np.pi * t)
        - 0.012604 * np.cos(6 * np.pi * t)
    )


def _event_f0(y: np.ndarray, fs: float, frame_times: np.ndarray) -> np.ndarray:
    """f0 track from rising zero-crossing intervals of y (0 where undefined)."""
    neg = y[:-1] < 0
    pos = y[1:] >= 0
    idx = np.nonzero(neg & pos)[0]
    if len(idx) < 3:
        return np.zeros_like(frame_times)
    denom = y[idx] - y[idx + 1]
    frac = idx + np.where(np.abs(denom) > 1e-12, y[idx] / denom, 0.5)
    t = frac / fs
    iv = np.diff(t)
    good = iv > 1e-6
    if good.sum() < 2:
        return np.zeros_like(frame_times)
    centers = ((t[:-1] + t[1:]) / 2)[good]
    f = 1.0 / iv[good]
    out = np.interp(frame_times, centers, f)
    out[(frame_times < centers[0]) | (frame_times > centers[-1])] = 0.0
    return out


def _band_candidates(x_f, freqs, fc, fs, frame_times):
    """(candidate f0, reliability, envelope amplitude) for one boundary band.

    A band-pass filter makes ANY input (noise included) locally sinusoidal at
    ~fc, so interval agreement alone cannot vouch for a candidate — the
    caller must also gate on the band's envelope amplitude relative to the
    frame's strongest band (Harvest gates candidates the same way, via the
    filtered-signal amplitude).
    """
    # Nuttall-shaped band-pass response centered at fc (width ~1 octave),
    # applied in the frequency domain
    lo, hi = fc / np.sqrt(2.0), fc * np.sqrt(2.0)
    resp = np.zeros_like(freqs)
    band = (freqs >= lo) & (freqs <= hi)
    if not band.any():
        return None
    ph = (freqs[band] - lo) / (hi - lo)
    resp[band] = (
        0.355768
        - 0.487396 * np.cos(2 * np.pi * ph)
        + 0.144232 * np.cos(4 * np.pi * ph)
        - 0.012604 * np.cos(6 * np.pi * ph)
    )
    n = 2 * (len(freqs) - 1)
    # analytic band signal: y = Re, envelope = |y + i*Hilbert(y)|
    spec = x_f * resp
    ya = np.fft.ifft(np.concatenate([spec * 2, np.zeros(n - len(spec))]), n=n)
    y = ya.real
    env = np.abs(ya)
    amp = np.interp(frame_times, np.arange(n) / fs, env)

    dy = np.diff(y)
    ests = np.stack([
        _event_f0(y, fs, frame_times),            # rising zero crossings
        _event_f0(-y, fs, frame_times),           # falling zero crossings
        _event_f0(dy, fs, frame_times),           # dips (rising of dy)
        _event_f0(-dy, fs, frame_times),          # peaks
    ])
    valid = (ests > 0).all(axis=0)
    mean = ests.mean(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        disp = ests.std(axis=0) / np.maximum(mean, 1e-9)
    # the candidate must sit inside its own band, else another fc owns it
    in_band = (mean > lo) & (mean < hi)
    ok = valid & in_band & (disp < 0.15)
    if not ok.any():
        return None
    cand = np.where(ok, mean, 0.0)
    rel = np.where(ok, 1.0 - disp, 0.0)
    return cand, rel, np.where(ok, amp, 0.0)


def _refine_if(x: np.ndarray, fs: float, frame_times: np.ndarray,
               f0: np.ndarray, n_harm: int = 6) -> np.ndarray:
    """Instantaneous-frequency refinement of voiced frames (StoneMask-style)."""
    out = f0.copy()
    n = len(x)
    for i, (tc, f) in enumerate(zip(frame_times, f0)):
        if f <= 0:
            continue
        half = int(round(1.5 * fs / f))  # 1.5 periods per half window
        c = int(round(tc * fs))
        a0, a1 = c - half, c + half
        b0, b1 = a0 + half, a1 + half  # half-window-shifted copy
        if a0 < 0 or b1 + 1 > n:
            continue
        w = _nuttall(2 * half)
        k = np.arange(1, n_harm + 1)
        tt = np.arange(2 * half) / fs
        basis = np.exp(-2j * np.pi * k[:, None] * f * tt[None, :]) * w
        s0 = basis @ x[a0:a0 + 2 * half]
        s1 = basis @ x[b0:b0 + 2 * half]
        amp = (np.abs(s0) + np.abs(s1)) * k  # Harvest weights ~ amplitude*k
        dt = half / fs
        # phase advance over dt, unwrapped around the EXPECTED advance of
        # harmonic k (2*pi*k*f*dt); the residual is the frequency deviation
        dev = np.angle(s1 * np.conj(s0) * np.exp(-2j * np.pi * k * f * dt))
        # each harmonic's instantaneous frequency, folded to the fundamental
        inst = (k * f + dev / (2 * np.pi * dt)) / k
        good = (np.abs(inst / f - 1.0) < 0.2) & (amp > 0)
        if good.sum() == 0:
            continue
        out[i] = float(np.sum(inst[good] * amp[good]) / np.sum(amp[good]))
    return out


def harvest_f0(
    waveform: np.ndarray, samplerate: int, length: int, *, hop_size: int,
    f0_min: float = 65.0, f0_max: float = 1100.0,
):
    """Returns (f0 [length] with 0 at unvoiced frames, uv bool mask)."""
    x = np.asarray(waveform, np.float64)
    fs = float(samplerate)
    frame_times = np.arange(length) * hop_size / fs

    # decimate for the candidate search (bands only reach f0_max)
    target = 2 ** int(np.ceil(np.log2(max(4 * f0_max, 3000.0))))
    dec = max(1, int(fs // (2 * target)))
    if dec > 1:
        from scipy.signal import resample_poly

        xd = resample_poly(x, 1, dec)
        fsd = fs / dec
    else:
        xd, fsd = x, fs
    n_fft = int(2 ** np.ceil(np.log2(len(xd) + 1)))
    x_f = np.fft.rfft(xd, n=n_fft)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / fsd)

    n_ch = int(np.ceil(np.log2(f0_max / f0_min) * _CH_PER_OCT)) + 1
    fcs = f0_min * 2.0 ** (np.arange(n_ch) / _CH_PER_OCT)

    cands, rels, amps = [], [], []
    for fc in fcs:
        got = _band_candidates(x_f, freqs, fc, fsd, frame_times)
        if got is None:
            continue
        cands.append(got[0])
        rels.append(got[1])
        amps.append(got[2])
    if not cands:
        return np.zeros(length, np.float32), np.ones(length, bool)
    cands = np.stack(cands)   # [n_bands, length]
    rels = np.stack(rels)
    amps = np.stack(amps)

    # gate: a candidate needs band energy comparable to the frame's loudest
    # band (kills filtered-noise phantoms), and the frame's loudest band must
    # clear an absolute floor relative to the utterance (kills silence)
    max_amp = amps.max(axis=0)
    floor = 0.06 * np.percentile(max_amp[max_amp > 0], 95) if (max_amp > 0).any() else 0.0
    ok = (rels > 0.9) & (amps > 0.12 * max_amp[None, :]) & (max_amp[None, :] > floor)
    # among surviving candidates pick the LOWEST frequency (harmonic bands at
    # k*f0 are also interval-stable; sub-f0 bands carry no energy, so the
    # lowest energetic stable band is the fundamental)
    cands_sel = np.where(ok, cands, np.inf)
    pick = np.argmin(cands_sel, axis=0)
    best_f0 = cands_sel[pick, np.arange(length)]
    voiced = np.isfinite(best_f0) & (best_f0 >= f0_min) & (best_f0 <= f0_max)
    f0 = np.where(voiced, np.nan_to_num(best_f0, posinf=0.0), 0.0)

    # fixing: median over voiced runs kills octave/interval glitches
    if voiced.any():
        from scipy.signal import medfilt

        f0v = f0.copy()
        f0v[~voiced] = np.nan
        med = medfilt(np.nan_to_num(f0v, nan=0.0), 5)
        keep = voiced & (med > 0)
        jump = np.abs(np.log2(np.maximum(f0, 1e-9) / np.maximum(med, 1e-9)))
        f0 = np.where(keep & (jump > 0.3), med, f0)

    f0 = _refine_if(x, fs, frame_times, f0)
    voiced = (f0 >= f0_min) & (f0 <= f0_max)
    f0 = np.where(voiced, f0, 0.0)
    return f0.astype(np.float32), ~voiced


class HarvestPE:
    """``pe: harvest``: the extractor above, with the other extractors' interface."""

    def get_pitch(self, waveform, samplerate, length, *, hop_size,
                  f0_min=65, f0_max=1100, speed=1, interp_uv=False):
        from ...utils.curves import interp_f0

        hop = int(np.round(hop_size * speed))
        f0, uv = harvest_f0(
            waveform, samplerate, length, hop_size=hop,
            f0_min=f0_min, f0_max=f0_max,
        )
        if interp_uv:
            f0, uv = interp_f0(f0, uv)
        return f0.astype(np.float32), uv
