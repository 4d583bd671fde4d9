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
nonzero bands in groups of 32 with their weights interleaved by lane
(:func:`mel_groups`), and,
for the plain version, the dense filterbank and (at first use) the DFT basis.
:func:`mel_spectrogram` runs :func:`mel_spectrogram_plain` on a CPU tensor
and launches ``csrc/mel_spec.cu`` once on a CUDA tensor, or raises.  The
kernel takes f32 contiguous ``y``, any power-of-two ``n_fft`` from 256 to
2048 and ``win <= n_fft``; ``T`` must exceed both reflect pads.  The bound
and the design are described in the CUDA source.

The kernel's FFT plan lives here, in plain Python that the CPU tests walk
(``tests/test_torch_fft_plan.py``): a warp transforms one frame's ``N =
n_fft / 2`` complex points ``z[n] = x[2n] + i x[2n+1]`` split as ``N = N1 x
N2`` (:func:`fft_split`), ``n = n1 + N1 n2``.  Lane ``n1`` holds ``z[n1 +
N1 n2]`` in register ``n2``, transforms it (length N2, radix 2 in
registers, :func:`register_twiddle` ``W_L^m = W_32^(m 32 / L)``), multiplies
register ``k2`` by ``W_N^(n1 k2)`` (:func:`step_twiddles`, at ``k2 * N1 +
n1``) and writes it to the exchange planes at :func:`plane_address`; lane
``k2`` reads column ``k2`` back into register ``n1``, transforms it (length
N1) and holds ``Z[k2 + N2 k1]`` in register ``k1``.  A block takes
:func:`block_plan`'s ``F`` consecutive frames of one sequence and stages
their common span (:func:`span_plan`): 16-byte loads where it is inside the
sequence (:func:`span_loads`), single loads reflected by :func:`reflect`
around them.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..mel import _padded_window, mel_filterbank
from . import build, sm90

MIN_N_FFT, MAX_N_FFT = 256, 2048
MAX_FRAMES_PER_BLOCK = 16  # warps of a block (csrc/mel_spec.cu: kMaxWarps)
SMEM_LIMIT = 232448        # dynamic shared memory a block can have on an H100
BANKS = 32                 # shared-memory banks of 4 bytes

launches = 0  # wrapper calls that launched the CUDA kernel

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])


def fft_split(n_fft: int):
    """``(N1, N2)`` of the kernel's ``N = n_fft / 2`` complex points, both <= 32:
    ``N2 = 2^floor(log2(N) / 2)``, ``N1 = N / N2``."""
    n = n_fft // 2
    n2 = 1 << (n.bit_length() - 1) // 2
    return n // n2, n2


def register_twiddles() -> np.ndarray:
    """``W_32^j = exp(-2 pi i j / 32)``, ``j < 16`` (complex128): the twiddles
    of every register FFT (length 8, 16 or 32), passed to the kernel by
    value."""
    return np.exp(-2j * np.pi * np.arange(16) / 32)


def register_twiddle(L: int, m: int) -> int:
    """Index ``j`` of ``W_L^m = W_32^j`` (``m < L / 2``), the twiddle a
    length-L register FFT reads."""
    return m * 32 // L


def step_twiddles(n_fft: int) -> np.ndarray:
    """``W_N^(n1 k2)`` at ``k2 * N1 + n1`` (complex128, ``N`` entries): lane
    ``n1``'s multiplier of its register ``k2``, contiguous across lanes."""
    n1s, n2s = fft_split(n_fft)
    n = n_fft // 2
    k2, n1 = np.meshgrid(np.arange(n2s), np.arange(n1s), indexing="ij")
    return np.exp(-2j * np.pi * (n1 * k2) / n).reshape(-1)


def plane_address(n1: int, k2: int, n2s: int) -> int:
    """Word of ``Y[n1][k2]`` in an exchange plane: rows of ``N2 + 1`` words,
    so that 32 lanes of one column or one row hit 32 banks."""
    return n1 * (n2s + 1) + k2


def smem_bytes(n_fft: int, hop: int, frames: int) -> int:
    """Shared bytes of a block of ``frames`` frames: the three tables (W_2N^k
    for k <= N / 2 and one of padding, the step twiddles, the window as
    pairs), each warp's re and im planes and the span with 3 words of
    alignment slack."""
    n1s, n2s = fft_split(n_fft)
    n = n_fft // 2
    return (8 * (n // 2 + 2) + 2 * 8 * n + 2 * 4 * n1s * (n2s + 1) * frames
            + 4 * ((frames - 1) * hop + 2 * n + 3))


def block_plan(n_fft: int, hop: int, n_frames: int):
    """``(F, shared bytes)``: the most frames a block (a power of two up to
    16, no more than the frames need) whose shared memory fits."""
    frames = MAX_FRAMES_PER_BLOCK
    while frames > 1 and (frames // 2 >= n_frames or smem_bytes(n_fft, hop, frames) > SMEM_LIMIT):
        frames //= 2
    return frames, smem_bytes(n_fft, hop, frames)


def span_plan(f0: int, frames: int, hop: int, n_fft: int, pad_l: int):
    """``(s0, S)``: the sequence index of a block's first staged sample and the
    number it stages, ``(frames - 1) * hop + n_fft``; frame ``f0 + w`` is span
    samples ``w * hop ..``."""
    return f0 * hop - pad_l, (frames - 1) * hop + n_fft


def span_loads(s0: int, S: int, T: int, word: int):
    """``(v0, v1)``: the sequence samples a block stages with 16-byte loads,
    the part of its span inside ``[0, T)`` whose addresses are 16-byte aligned
    (sample 0 at word ``word`` mod 4); the rest of the span is single loads
    through :func:`reflect`."""
    lo = max(s0, 0)
    hi = max(min(s0 + S, T), lo)
    v0 = min(lo + (4 - (word + lo) % 4) % 4, hi)
    return v0, v0 + (hi - v0) // 4 * 4


def reflect(j: np.ndarray, T: int) -> np.ndarray:
    """Reflect padding as index arithmetic (a pad shorter than ``T``)."""
    j = np.abs(j)
    return np.where(j >= T, 2 * (T - 1) - j, j)


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
    step_twiddle: torch.Tensor  # [n_fft // 2, 2] f32: step_twiddles(n_fft)
    w32: np.ndarray            # [16, 2] f32 on the host: register_twiddles()
    band_first: torch.Tensor   # [32 * groups] int32: mel_groups' first
    group_count: torch.Tensor  # [groups] int32: each group's widest band
    weights: torch.Tensor      # [32 * sum(group_count)] f32, interleaved by lane
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


def mel_groups(mel_basis: np.ndarray):
    """The kernel's mel tables: bands in groups of 32, band ``32 j + l`` on
    lane ``l``.  Returns ``(first, count, group_count, weights)``: each band's
    first weighted bin and run length (0, 0 past the last band), each group's
    widest run, and the runs interleaved by lane, ``weights[off_j + 32 c + l]``
    = band ``32 j + l``'s weight at bin ``first + c`` (zero past its run), so
    that a warp reads 32 consecutive words at each ``c``."""
    n_mels = len(mel_basis)
    groups = -(-n_mels // 32)
    first = np.zeros(32 * groups, np.int32)
    count = np.zeros(32 * groups, np.int32)
    for m, row in enumerate(mel_basis):
        nz = np.flatnonzero(row)
        if len(nz):
            first[m], count[m] = nz[0], nz[-1] - nz[0] + 1
    group_count = count.reshape(groups, 32).max(axis=1)
    blocks = []
    for j, width in enumerate(group_count):
        block = np.zeros((width, 32), np.float32)
        for lane in range(32):
            m = 32 * j + lane
            if m < n_mels:
                block[:count[m], lane] = mel_basis[m, first[m]:first[m] + count[m]]
        blocks.append(block.reshape(-1))
    return first, count, group_count, np.concatenate(blocks + [np.zeros(0, np.float32)])


def prepare_mel(cfg, device=None, mel_basis: Optional[np.ndarray] = None) -> PreparedMel:
    """Tables for ``cfg`` (a ``MelConfig``) on ``device``.  ``mel_basis``
    defaults to the Slaney filterbank of ``cfg``."""
    device = torch.device(device or "cpu")
    if mel_basis is None:
        mel_basis = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    mel_basis = np.asarray(mel_basis, np.float32)
    first, count, group_count, weights = mel_groups(mel_basis)
    half = cfg.n_fft // 2
    twiddle = np.exp(-2j * np.pi * np.arange(half) / cfg.n_fft)

    def f32_pairs(z):
        return np.ascontiguousarray(np.stack([z.real, z.imag], axis=1).astype(np.float32))

    def complex_f32(z):
        return torch.from_numpy(f32_pairs(z)).to(device)

    return PreparedMel(
        n_fft=cfg.n_fft, win_size=cfg.win_size, hop_size=cfg.hop_size, n_mels=cfg.n_mels,
        clip_val=float(cfg.clip_val), pad_l=(cfg.win_size - cfg.hop_size) // 2,
        pad_r=(cfg.win_size - cfg.hop_size + 1) // 2,
        n_bins=max(int((first + count).max()), 1), nnz=int(count.sum()),
        window=torch.from_numpy(_padded_window(cfg.win_size, cfg.n_fft)).to(device),
        twiddle=complex_f32(twiddle), step_twiddle=complex_f32(step_twiddles(cfg.n_fft)),
        w32=f32_pairs(register_twiddles()),
        band_first=torch.from_numpy(first).to(device),
        group_count=torch.from_numpy(group_count.astype(np.int32)).to(device),
        weights=torch.from_numpy(weights).to(device),
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
    tables = (p.window, p.twiddle, p.step_twiddle, p.band_first, p.group_count, p.weights)
    for t in tables:
        if t.device != y.device:
            raise ValueError(f"mel_spectrogram: tables on {t.device}, waveform on {y.device} "
                             "(see prepare_mel)")
    out = torch.empty(B, p.num_frames(T), p.n_mels, dtype=torch.float32, device=y.device)
    fn = sm90.function("mel_spec", "mel_spec_launch", _ARGTYPES)
    with torch.cuda.device(y.device):
        status = fn(*launch_args(y, p, out))
    build.check(status, "mel_spectrogram launch")
    launches += 1
    return out


def launch_args(y: torch.Tensor, p: PreparedMel, out: torch.Tensor) -> tuple:
    """``mel_spec_launch``'s arguments for checked ``y`` and ``out``: the
    pointers, the FFT split, the sizes, :func:`block_plan`'s frames a block
    and shared bytes, the clip and the current stream."""
    B, T = y.shape
    n_frames = out.shape[1]
    frames, smem = block_plan(p.n_fft, p.hop_size, n_frames)
    ptrs = [t.data_ptr() for t in (y, p.window, p.twiddle, p.step_twiddle)] + [p.w32.ctypes.data] \
        + [t.data_ptr() for t in (p.band_first, p.group_count, p.weights, out)]
    return (*ptrs, B, T, *fft_split(p.n_fft), p.hop_size, p.pad_l, n_frames, p.n_mels, frames,
            smem, p.clip_val, build.stream_ptr(y.device))


def mel_spectrogram(y: torch.Tensor, prepared: PreparedMel) -> torch.Tensor:
    """Log-mel ``[B, frames, M]`` f32 of ``y`` ``[B, T]``.  CPU tensors take the
    plain version; CUDA tensors the kernel (f32, contiguous) or an error."""
    if y.device.type == "cpu":
        return mel_spectrogram_plain(y, prepared)
    if y.device.type != "cuda":
        raise ValueError(f"mel_spectrogram: unsupported device {y.device}")
    return _launch(y, prepared)
