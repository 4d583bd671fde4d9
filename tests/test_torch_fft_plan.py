"""K3's FFT plan (``ops/cuda/mel_spec.py``) walked in numpy, on the CPU.

The kernel (``csrc/mel_spec.cu``) runs only on the card
(``tests/test_torch_cuda.py``).  What it takes from the plan is checked here:
the N1 x N2 split of each n_fft, the lane and register of each point, the
twiddle indices, the padded exchange addresses, the span a block stages and
its reflect indexing.  A numpy model that follows the plan step by step --
lane n1's length-N2 FFT in registers, the step twiddles, the exchange planes,
lane k2's length-N1 FFT, the real split of each pair (k, N - k) -- must
reproduce ``np.fft.rfft`` in f64 to 1e-9 of the spectrum's scale, and in f32
within the error of the plain version's f32 DFT product.
"""

import numpy as np
import pytest
import torch

from xiaoicesing_io_tpu_torch.ops.cuda import mel_spec as K3
from xiaoicesing_io_tpu_torch.ops.mel import MelConfig, MelSpectrogram

N_FFTS = [256, 512, 1024, 2048]


def _bitrev(i, bits):
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def _tables(n_fft, dtype):
    n = n_fft // 2  # a block keeps W_2N^k for k <= N / 2 only: the real split's
    tw = np.exp(-2j * np.pi * np.arange(n // 2 + 1) / n_fft).astype(dtype)
    return tw, K3.step_twiddles(n_fft).astype(dtype), K3.register_twiddles().astype(dtype)


def _register_fft(v, w32):
    """The kernel's ``fft_reg`` over the last axis of ``v`` (length L):
    bit-reversed renaming, then radix-2 stages; twiddle ``W_(2 half)^j`` from
    the ``W_32`` table, ``j == 0`` and ``W = -i`` exact."""
    L = v.shape[-1]
    bits = L.bit_length() - 1
    v = v[..., [_bitrev(i, bits) for i in range(L)]].copy()
    for s in range(bits):
        half = 1 << s
        for j in range(half):
            w = w32[K3.register_twiddle(2 * half, j)]
            for g in range(0, L, 2 * half):
                a, c = v[..., g + j].copy(), v[..., g + j + half]
                if j == 0:
                    b = c.copy()
                elif 2 * j == half:
                    b = (c.imag - 1j * c.real).astype(v.dtype)
                else:
                    b = c * w
                v[..., g + j] = a + b
                v[..., g + j + half] = a - b
    return v


def _frame_spectrum(x, n_fft, dtype=np.complex128):
    """The kernel's steps 1-4 for frames ``x [F, n_fft]`` (windowed): the
    complex bins ``X [F, N + 1]`` as the real split forms them."""
    n1s, n2s = K3.fft_split(n_fft)
    n = n_fft // 2
    tw, stw, w32 = _tables(n_fft, dtype)
    z = (x[:, 0::2] + 1j * x[:, 1::2]).astype(dtype)
    # 1. lane n1, register n2: z[n1 + N1 n2]
    v = z.reshape(-1, n2s, n1s).transpose(0, 2, 1)
    v = _register_fft(v, w32)
    k2 = np.arange(n2s)
    lane = np.arange(n1s)
    v[:, :, 1:] *= stw[(k2[None, 1:] * n1s + lane[:, None])]
    # 2. the exchange through the planes at their padded addresses
    plane = np.zeros((x.shape[0], n1s * (n2s + 1)), dtype)
    addr = np.array([[K3.plane_address(a, b, n2s) for b in range(n2s)] for a in range(n1s)])
    plane[:, addr] = v
    u = plane[:, addr.T]  # lane k2, register n1
    # 3. length-N1 FFT: Z[k2 + N2 k1] in lane k2, register k1, written in natural order
    u = _register_fft(u, w32)
    Z = np.zeros((x.shape[0], n), dtype)
    Z[:, k2[:, None] + n2s * np.arange(n1s)[None, :]] = u
    # 4. the real split of each pair (k, N - k), k <= N / 2
    k = np.arange(n // 2 + 1)
    zk, zr = Z[:, k], Z[:, (n - k) % n]
    e = 0.5 * (zk + np.conj(zr))
    o = -0.5j * (zk - np.conj(zr))
    t = tw[k] * o
    X = np.zeros((x.shape[0], n + 1), dtype)
    X[:, n - k] = np.conj(e - t)
    X[:, k] = e + t
    return X


@pytest.mark.parametrize("n_fft,split", [(256, (16, 8)), (512, (16, 16)), (1024, (32, 16)),
                                         (2048, (32, 32))])
def test_fft_split(n_fft, split):
    assert K3.fft_split(n_fft) == split
    n1s, n2s = split
    assert n1s * n2s == n_fft // 2 and max(split) <= 32


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_plan_reproduces_rfft_in_f64(n_fft):
    rng = np.random.default_rng(n_fft)
    x = rng.standard_normal((3, n_fft))
    got = _frame_spectrum(x, n_fft)
    ref = np.fft.rfft(x, axis=-1)
    assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_plan_in_f32_is_within_the_plain_versions_error(n_fft):
    """f32 tables and arithmetic: the plan's error against the f64 FFT is no
    larger than that of the plain version's f32 DFT product."""
    rng = np.random.default_rng(n_fft + 1)
    x = rng.uniform(-0.5, 0.5, (4, n_fft)).astype(np.float32)
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    got = _frame_spectrum(x, n_fft, np.complex64)
    prep = K3.prepare_mel(MelConfig(n_fft=n_fft, win_size=n_fft, hop_size=n_fft // 4))
    re_im = (torch.from_numpy(x) @ prep.dft).numpy()
    plain = re_im[:, :n_fft // 2 + 1] + 1j * re_im[:, n_fft // 2 + 1:]
    err_plan = np.abs(got - ref).max()
    err_plain = np.abs(plain - ref).max()
    assert 0 < err_plan <= err_plain


def _banks(words):
    return [w % K3.BANKS for w in words]


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_exchange_hits_each_bank_once(n_fft):
    """Every access of a warp to the planes, one register at a time: the
    exchange write (lanes n1, register k2), the transposed read (lanes k2,
    register n1), the natural-order write of Z and the real split's pair
    reads.  No two lanes hit one bank."""
    n1s, n2s = K3.fft_split(n_fft)
    n = n_fft // 2
    accesses = [[K3.plane_address(a, b, n2s) for a in range(n1s)] for b in range(n2s)]
    accesses += [[K3.plane_address(a, b, n2s) for b in range(n2s)] for a in range(n1s)]
    accesses += [[b + n2s * k1 for b in range(n2s)] for k1 in range(n1s)]
    for i in range(0, n // 2 + 1, 32):
        ks = [k for k in range(i, i + 32) if k <= n // 2]
        accesses += [ks, [(n - k) % n for k in ks]]
    for words in accesses:
        assert len(set(_banks(words))) == len(words)
    # without the pad, a column of the exchange would fall on few banks
    unpadded = [a * n2s for a in range(n1s)]
    assert len(set(_banks(unpadded))) < len(unpadded)


@pytest.mark.parametrize("n_fft,hop,n_frames,frames", [
    (2048, 512, 2048, 16),   # the timed shape: 16 warps, ~190 KB
    (2048, 2048, 2048, 8),   # frames that do not overlap: fewer a block
    (256, 64, 3, 4),         # no more warps than the frames need
    (1024, 256, 1, 1),
])
def test_block_plan_fits_shared_memory(n_fft, hop, n_frames, frames):
    got, smem = K3.block_plan(n_fft, hop, n_frames)
    assert got == frames and smem == K3.smem_bytes(n_fft, hop, frames)
    assert smem <= K3.SMEM_LIMIT
    if frames < K3.MAX_FRAMES_PER_BLOCK and frames < n_frames:
        assert K3.smem_bytes(n_fft, hop, 2 * frames) > K3.SMEM_LIMIT


def _stage(y_row, f0, frames, hop, n_fft, pad_l, word):
    """A block's staging as the kernel does it, for a sequence whose sample 0
    sits at word ``word`` mod 4: 16-byte loads over the aligned part inside
    the sequence, single reflected loads around it.  Returns the span and the
    number of times each span sample was written."""
    T = len(y_row)
    s0, S = K3.span_plan(f0, frames, hop, n_fft, pad_l)
    v0, v1 = K3.span_loads(s0, S, T, word)
    assert (v0 == v1 or (word + v0) % 4 == 0) and 0 <= v0 <= v1 <= T and (v1 - v0) % 4 == 0
    span = np.zeros(S)
    written = np.zeros(S, int)
    span[v0 - s0:v1 - s0] = y_row[v0:v1]
    written[v0 - s0:v1 - s0] += 1
    rest = np.r_[0:v0 - s0, v1 - s0:S]
    span[rest] = y_row[K3.reflect(s0 + rest, T)]
    written[rest] += 1
    return s0, span, written


@pytest.mark.parametrize("word", [0, 1, 2, 3])
@pytest.mark.parametrize("n_fft,win,hop", [(2048, 2048, 512), (256, 192, 64), (1024, 1024, 256)])
def test_staged_span_is_the_reflect_padded_signal(n_fft, win, hop, word):
    """At both ends of a sequence, and in its middle, the staged span equals
    ``np.pad(..., mode="reflect")``, each sample written once."""
    pad_l, pad_r = (win - hop) // 2, (win - hop + 1) // 2
    T = 37 * hop + 11
    y = np.random.default_rng(word).standard_normal(T)
    ypad = np.pad(y, (pad_l, pad_r), mode="reflect")
    n_frames = 1 + (T + pad_l + pad_r - n_fft) // hop
    frames, _ = K3.block_plan(n_fft, hop, n_frames)
    starts = range(0, n_frames, frames)
    for f0 in (starts[0], starts[len(starts) // 2], starts[-1]):
        nf = min(frames, n_frames - f0)
        s0, span, written = _stage(y, f0, nf, hop, n_fft, pad_l, word)
        assert (written == 1).all()
        np.testing.assert_array_equal(span, ypad[s0 + pad_l:s0 + pad_l + len(span)])


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_block_walk_reproduces_plain_and_host(n_fft):
    """The whole kernel in f32 numpy: blocks of ``block_plan``'s frames, the
    staged span, the window, the plan's FFT, the magnitudes, the mel bands in
    groups of 32 (weights interleaved by lane, zero-padded runs), clamp and
    log, against the plain version (2e-3 nats) and the host path (1e-3 nats)
    -- the card's bars."""
    cfg = (MelConfig(sample_rate=16000, n_mels=64, n_fft=256, win_size=192, hop_size=64,
                     fmin=30.0, fmax=8000.0) if n_fft == 256
           else MelConfig(n_fft=n_fft, win_size=n_fft * 3 // 4, hop_size=n_fft // 4))
    ext = MelSpectrogram(cfg)
    prep = K3.prepare_mel(cfg)
    rng = np.random.default_rng(n_fft + 2)
    T = cfg.hop_size * 40 + 29
    y = rng.uniform(-0.5, 0.5, T).astype(np.float32)
    n_frames = prep.num_frames(T)
    frames, _ = K3.block_plan(n_fft, cfg.hop_size, n_frames)
    window = prep.window.numpy()
    first, group_count, weights = (t.numpy() for t in (prep.band_first, prep.group_count,
                                                       prep.weights))
    n = n_fft // 2
    got = np.zeros((n_frames, cfg.n_mels), np.float32)
    for f0 in range(0, n_frames, frames):
        nf = min(frames, n_frames - f0)
        _, span, _ = _stage(y, f0, nf, cfg.hop_size, n_fft, prep.pad_l, 0)
        x = np.stack([span[w * cfg.hop_size:w * cfg.hop_size + n_fft] for w in range(nf)])
        mag = np.abs(_frame_spectrum((x * window).astype(np.float32), n_fft, np.complex64))
        # group j, lane l: band 32 j + l over the group's widest run, bins clamped to N
        off = 0
        for j, width in enumerate(group_count):
            lanes = 32 * j + np.arange(32)
            bins = np.minimum(first[lanes][:, None] + np.arange(width)[None, :], n)
            w = weights[off:off + 32 * width].reshape(width, 32).T
            acc = (mag[:, bins] * w).sum(-1)
            off += 32 * width
            keep = lanes < cfg.n_mels
            got[f0:f0 + nf, lanes[keep]] = np.log(np.maximum(acc[:, keep], cfg.clip_val))
    plain = K3.mel_spectrogram_plain(torch.from_numpy(y)[None], prep)[0].numpy()
    host = ext.numpy(y[None])[0]
    assert got.shape == plain.shape == host.shape
    assert np.abs(got - plain).max() <= 2e-3
    assert np.abs(got - host).max() <= 1e-3
