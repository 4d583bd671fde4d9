"""Fused STFT -> log-mel spectrogram: CUDA kernel wrapper and its plain PyTorch version.

Replaces ``xiaoicesing_io_tpu/ops/pallas/mel_kernel.py:PallasMelSpectrogram``
(``pl.pallas_call`` at :100).  For ``y`` ``[B, T]`` f32:

    ypad   = reflect_pad(y, (win - hop) // 2, (win - hop + 1) // 2)
    frames = ypad[:, f * hop : f * hop + n_fft] * window     f < 1 + (T_pad - n_fft) // hop
    out    = log(max(|rfft(frames)| @ mel_basis.T, clip))     [B, frames, n_mels] f32

``window`` is the periodic Hann window of ``win`` samples centred in
``n_fft`` (``ops/mel.py:_padded_window``).

:func:`prepare_mel` builds the tables once per configuration and device: the
window, the FFT twiddles (computed in float64, stored f32), the filterbank's
nonzero bands as ``(first_bin, count, offset)`` runs of packed weights, and,
for the plain version, the dense filterbank and (at first use) the DFT basis.
:func:`mel_spectrogram` runs :func:`mel_spectrogram_plain` on a CPU tensor
and launches ``csrc/mel_spec.cu`` once on a CUDA tensor, or raises.  The
kernel takes f32 contiguous ``y``, any power-of-two ``n_fft`` from 256 to
2048 and ``win <= n_fft``; ``T`` must exceed both reflect pads.  The bound
and the design are described in the CUDA source.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..mel import _padded_window, mel_filterbank
from . import build

MIN_N_FFT, MAX_N_FFT = 256, 2048

launches = 0  # wrapper calls that launched the CUDA kernel

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])


@dataclass
class PreparedMel:
    """K3's tables for one mel configuration on one device."""

    n_fft: int
    win_size: int
    hop_size: int
    n_mels: int
    clip_val: float
    pad_l: int
    pad_r: int
    n_bins: int           # bins up to the last one any filter weights
    nnz: int              # filterbank weights inside the bands
    window: torch.Tensor  # [n_fft] f32
    twiddle: torch.Tensor  # [n_fft // 2, 2] f32: exp(-2 pi i k / n_fft)
    band_first: torch.Tensor   # [n_mels] int32
    band_count: torch.Tensor   # [n_mels] int32
    band_offset: torch.Tensor  # [n_mels] int32
    weights: torch.Tensor      # [nnz] f32, the bands' weights packed
    mel_basis: torch.Tensor    # [n_mels, 1 + n_fft // 2] f32 (plain version)
    _dft: Optional[torch.Tensor] = field(default=None, repr=False)

    @property
    def dft(self) -> torch.Tensor:
        """The real-input DFT as one ``[n_fft, 2F]`` f32 matrix (cos | sin),
        built at first use: the plain version's basis."""
        if self._dft is None:
            n_freqs = 1 + self.n_fft // 2
            k = np.arange(self.n_fft)[:, None]
            f = np.arange(n_freqs)[None, :]
            ang = -2.0 * np.pi * k * f / self.n_fft
            basis = np.concatenate([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
            self._dft = torch.from_numpy(basis).to(self.window.device)
        return self._dft

    def num_frames(self, n_samples: int) -> int:
        return 1 + (n_samples + self.pad_l + self.pad_r - self.n_fft) // self.hop_size


def prepare_mel(cfg, device=None, mel_basis: Optional[np.ndarray] = None) -> PreparedMel:
    """Tables for ``cfg`` (a ``MelConfig``) on ``device``.  ``mel_basis``
    defaults to the Slaney filterbank of ``cfg``."""
    device = torch.device(device or "cpu")
    if mel_basis is None:
        mel_basis = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    mel_basis = np.asarray(mel_basis, np.float32)
    firsts, counts, offsets, packed = [], [], [], []
    for row in mel_basis:
        nz = np.flatnonzero(row)
        first = int(nz[0]) if len(nz) else 0
        count = int(nz[-1]) - first + 1 if len(nz) else 0
        firsts.append(first)
        counts.append(count)
        offsets.append(sum(len(p) for p in packed))
        packed.append(row[first:first + count])
    n_bins = max([f + c for f, c in zip(firsts, counts)] + [1])
    half = cfg.n_fft // 2
    twiddle = np.exp(-2j * np.pi * np.arange(half) / cfg.n_fft)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return PreparedMel(
        n_fft=cfg.n_fft, win_size=cfg.win_size, hop_size=cfg.hop_size, n_mels=cfg.n_mels,
        clip_val=float(cfg.clip_val), pad_l=(cfg.win_size - cfg.hop_size) // 2,
        pad_r=(cfg.win_size - cfg.hop_size + 1) // 2, n_bins=n_bins, nnz=sum(counts),
        window=torch.from_numpy(_padded_window(cfg.win_size, cfg.n_fft)).to(device),
        twiddle=torch.from_numpy(np.stack([twiddle.real, twiddle.imag], axis=1)
                                 .astype(np.float32)).to(device),
        band_first=i32(firsts), band_count=i32(counts), band_offset=i32(offsets),
        weights=torch.from_numpy(np.concatenate(packed + [np.zeros(0, np.float32)])).to(device),
        mel_basis=torch.from_numpy(mel_basis).to(device),
    )


def mel_spectrogram_plain(y: torch.Tensor, prepared: PreparedMel) -> torch.Tensor:
    """The matrix-product DFT in f32 (the JAX package's ``MelSpectrogram.jax``):
    reflect-pad, frame, window, ``@ [n_fft, 2F]`` basis, magnitude, ``@`` the
    dense filterbank, clamp, log.  ``y`` ``[B, T]`` -> ``[B, frames, M]``."""
    p = prepared
    y = y.float()
    ypad = F.pad(y[:, None], (p.pad_l, p.pad_r), mode="reflect")[:, 0]
    frames = ypad.unfold(-1, p.n_fft, p.hop_size) * p.window  # [B, frames, n_fft]
    n_freqs = 1 + p.n_fft // 2
    re_im = frames @ p.dft
    power = re_im[..., :n_freqs] ** 2 + re_im[..., n_freqs:] ** 2
    spec = torch.sqrt(torch.clamp(power, min=0.0))
    mel = spec @ p.mel_basis.t()
    return torch.log(torch.clamp(mel, min=p.clip_val))


def _launch(y: torch.Tensor, p: PreparedMel) -> torch.Tensor:
    global launches
    if y.dtype != torch.float32:
        raise TypeError(f"mel_spectrogram kernel takes f32 waveforms, got {y.dtype}")
    if not y.is_contiguous():
        raise ValueError("mel_spectrogram kernel takes a contiguous [B, T] waveform")
    if y.dim() != 2:
        raise ValueError(f"mel_spectrogram: y must be [B, T], got {tuple(y.shape)}")
    n = p.n_fft
    if n & (n - 1) or not MIN_N_FFT <= n <= MAX_N_FFT or p.win_size > n:
        raise ValueError(
            f"mel_spectrogram kernel needs a power-of-two n_fft in [{MIN_N_FFT}, {MAX_N_FFT}] "
            f"and win_size <= n_fft (n_fft={n}, win_size={p.win_size})"
        )
    B, T = y.shape
    if not 1 <= B <= 65535 or T <= max(p.pad_l, p.pad_r) or T + p.pad_l + p.pad_r < n:
        raise ValueError(f"mel_spectrogram: [B, T] = [{B}, {T}] is out of range: 1 <= B <= "
                         f"65535, T > {max(p.pad_l, p.pad_r)} and at least one frame")
    tables = (p.window, p.twiddle, p.band_first, p.band_count, p.band_offset, p.weights)
    for t in tables:
        if t.device != y.device:
            raise ValueError(f"mel_spectrogram: tables on {t.device}, waveform on {y.device} "
                             "(see prepare_mel)")
    n_frames = p.num_frames(T)
    out = torch.empty(B, n_frames, p.n_mels, dtype=torch.float32, device=y.device)
    lib = build.load("mel_spec")
    fn = lib.mel_spec_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in (y,) + tables + (out,)]
    with torch.cuda.device(y.device):
        status = fn(*ptrs, B, T, n, p.hop_size, p.pad_l, n_frames, p.n_mels, p.n_bins,
                    p.clip_val, build.stream_ptr(y.device))
    build.check(status, "mel_spectrogram launch")
    launches += 1
    return out


def mel_spectrogram(y: torch.Tensor, prepared: PreparedMel) -> torch.Tensor:
    """Log-mel ``[B, frames, M]`` f32 of ``y`` ``[B, T]``.  CPU tensors take the
    plain version; CUDA tensors the kernel (f32, contiguous) or an error."""
    if y.device.type == "cpu":
        return mel_spectrogram_plain(y, prepared)
    if y.device.type != "cuda":
        raise ValueError(f"mel_spectrogram: unsupported device {y.device}")
    return _launch(y, prepared)
