"""The host-side plan of the Hopper GEMM core (``ops/cuda/sm90.py``) that K1
and K4 trust, on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
What they take from the host is checked here: the K-major and column-paired
weight copies (undone exactly back to the JAX layouts), the tensor maps'
dims, strides and boxes, the producer's tap coordinates, and the width checks.
The numpy emulations walk the kernels' tiles as the device does -- 128-row
output tiles, 64-wide K blocks loaded at the planned coordinates with zero
fill outside ``[0, rows)``, the paired epilogue, the depthwise conv's staged
tile and zero-padded taps -- and must reproduce the plain versions in f32
(atol 1e-4: the same f32 math in another summation order).
"""

import numpy as np
import pytest
import torch

from xiaoicesing_io_tpu_torch.ops.cuda import lynx_conv as K1
from xiaoicesing_io_tpu_torch.ops.cuda import sm90
from xiaoicesing_io_tpu_torch.ops.cuda import wavenet_block as K4

ATOL = 1e-4


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


def _a_tile(a, m0, shift, col):
    """The 128 x 64 box TMA loads from ``a [rows, cols]`` at (col, m0 + shift),
    zero outside the rows."""
    rows = m0 + shift + np.arange(sm90.BM)
    valid = (rows >= 0) & (rows < a.shape[0])
    tile = np.zeros((sm90.BM, sm90.BK), a.dtype)
    tile[valid] = a[rows[valid], col:col + sm90.BK]
    return tile


def _gemm_tile(a, b_kmajor, m0, n0, bn, plan):
    """One output tile's f32 accumulator: the K blocks of ``plan`` over A's
    boxes and B's rows ``n0 .. n0 + bn`` (zero past N)."""
    acc = np.zeros((sm90.BM, bn))
    for kb, (col, shift) in enumerate(plan):
        bt = np.zeros((bn, sm90.BK))
        rows = b_kmajor[n0:n0 + bn, kb * sm90.BK:(kb + 1) * sm90.BK]
        bt[:rows.shape[0]] = rows
        acc += _a_tile(a, m0, shift, col) @ bt.T
    return acc


def _plain_gemm(a, b_kmajor, bias):
    """A plain product on the core: 2-D A, tile_n-wide N tiles, row and column guards."""
    M, N = a.shape[0], b_kmajor.shape[0]
    bn = sm90.tile_n(N)
    out = np.zeros((M, N))
    plan = sm90.tap_plan(a.shape[1], 1, 0)
    for m0 in range(0, M, sm90.BM):
        for n0 in range(0, N, bn):
            acc = _gemm_tile(a, b_kmajor, m0, n0, bn, plan)
            r, c = min(sm90.BM, M - m0), min(bn, N - n0)
            out[m0:m0 + r, n0:n0 + c] = acc[:r, :c] + bias[n0:n0 + c]
    return out


# ---------------------------------------------------------------------------
# weight copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,half,pair", [(64, 64, 64), (128, 192, 64), (1024, 2048, 64),
                                         (128, 256, 128), (1024, 2048, 128)])
def test_paired_k_major_round_trip(K, half, pair):
    w = torch.randn(K, 2 * half)
    wt = sm90.paired_k_major(w, pair)
    assert wt.shape == (2 * half, K) and wt.is_contiguous()
    for p in range(half // pair):
        cols = np.arange(pair) + pair * p
        tile = wt[2 * pair * p:2 * pair * (p + 1)]
        assert torch.equal(tile[:pair], w[:, cols].t())
        assert torch.equal(tile[pair:], w[:, half + cols].t())
    assert torch.equal(sm90.unpair_k_major(wt, pair), w)
    assert torch.equal(sm90.k_major(w).t(), w)
    with pytest.raises(ValueError, match="half % 64"):
        sm90.paired_order(96, 64)
    with pytest.raises(ValueError, match="half % 128"):
        sm90.paired_order(192, 128)


@pytest.mark.parametrize("half,pair", [(64, 64), (192, 64), (256, 128), (512, 128), (2048, 128)])
def test_pair_width(half, pair):
    """The paired tile is 2 * pair wide: 256 columns where 128 divides the half."""
    assert sm90.pair_width(half) == pair


def test_map_cache_hits_by_address_shape_and_box(monkeypatch):
    """An activation's tensor map is encoded once per (address, shape, box
    rows); a full cache starts over."""
    encoded = []

    def fake_encode(lib_name, t, box_rows):
        encoded.append((t.data_ptr(), tuple(t.shape), box_rows))
        return len(encoded)

    monkeypatch.setattr(sm90, "encode", fake_encode)
    cache = sm90.MapCache("lib", size=3)
    a = torch.zeros(256, 64, dtype=torch.bfloat16)
    assert cache.get(a, 128) == cache.get(a, 128) == 1
    assert cache.get(a.view(128, 128), 128) == 2      # same address, other shape
    assert cache.get(a, 256) == 3                     # other box
    assert cache.get(a[128:], 128) == 4               # other address: the cache was full
    assert cache.get(a, 128) == 5 and len(cache.maps) == 2


@pytest.mark.parametrize("C", [64, 192, 512])
def test_wavenet_weight_copies_undo_to_jax_layout(C):
    params = [torch.randn(3, C, 2 * C), torch.randn(2 * C), torch.randn(C, 2 * C),
              torch.randn(2 * C)]
    weights = K4.prepare_weights(*params)
    wc, wo = K4.k_major_weights(weights)
    assert wc.shape == (2 * C, 3 * C) and wo.shape == (2 * C, C)
    assert wc.dtype == wo.dtype == torch.bfloat16
    # K index tap * C + c, undone exactly
    assert torch.equal(sm90.unpair_k_major(wc, sm90.pair_width(C)).reshape(3, C, 2 * C),
                       weights[0])
    assert torch.equal(wo.t(), weights[2])


@pytest.mark.parametrize("dim,inner", [(64, 128), (192, 384), (1024, 2048)])
def test_lynx_weight_copies_undo_to_jax_layout(dim, inner):
    params = _k1_params(np.random.default_rng(0), dim, inner, 31)
    weights = K1.prepare_weights(*params)
    win_t, w2_t = K1.k_major_weights(weights)
    assert win_t.shape == (2 * inner, dim) and w2_t.shape == (dim, inner)
    assert torch.equal(sm90.unpair_k_major(win_t, sm90.pair_width(inner)), weights[2])
    assert torch.equal(w2_t.t(), weights[7])


def test_prepared_weights_stay_the_shared_tuple():
    """K5, K7 and K8 read ``prepare_weights``' tuple as it is; K1's own
    operands are built once and kept beside it."""
    params = _k1_params(np.random.default_rng(1), 64, 128, 31)
    weights = K1.prepare_weights(*params)
    assert isinstance(weights, tuple) and len(weights) == 9
    assert type(weights[4:]) is tuple and len(weights[4:]) == 5
    calls = []

    def make(w):
        calls.append(w)
        return ("operands",)

    assert weights.operands(make) == ("operands",)
    assert weights.operands(make) == ("operands",)
    assert len(calls) == 1 and calls[0] is weights
    again = K1.prepare_weights(*params)
    assert all(torch.equal(a, b) for a, b in zip(weights, again))


# ---------------------------------------------------------------------------
# tensor maps and coordinates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,box_rows", [((4, 2048, 512), 128), ((8192, 1024), 128),
                                            ((1024, 512), 256), ((3, 37, 192), 128)])
def test_map_plan_dims_strides_box(shape, box_rows):
    t = torch.zeros(shape, dtype=torch.bfloat16)
    dims, strides, box = sm90.map_plan(t, box_rows)
    if len(shape) == 2:
        shape = (1, *shape)
    assert dims == (shape[2], shape[1], shape[0])
    assert box == (64, box_rows, 1)
    es = t.element_size()
    t3 = t.view(shape)
    assert strides == (t3.stride(1) * es, t3.stride(0) * es)
    assert all(s % 16 == 0 for s in strides)


@pytest.mark.parametrize("a_k,taps,dil", [(512, 3, 1), (192, 3, 64), (1024, 1, 0), (64, 3, 5)])
def test_tap_plan(a_k, taps, dil):
    plan = sm90.tap_plan(a_k, taps, dil)
    blocks = a_k // 64
    assert len(plan) == taps * blocks
    for kb, (col, shift) in enumerate(plan):
        tap = kb // blocks
        assert col == 64 * (kb % blocks)
        assert shift == (tap - taps // 2) * dil
    if taps == 3:
        assert {s for _, s in plan} == {-dil, 0, dil}


def test_check_operand_raises_on_what_tma_refuses():
    ok = torch.zeros(16, 128, dtype=torch.bfloat16)
    sm90.check_operand("f", "x", ok)
    with pytest.raises(ValueError, match="contiguous"):
        sm90.check_operand("f", "x", ok.t())
    with pytest.raises(ValueError, match="aligned"):
        sm90.check_operand("f", "x", torch.zeros(16 * 128 + 1, dtype=torch.bfloat16)[1:]
                           .view(16, 128))
    with pytest.raises(ValueError, match="aligned"):
        sm90.check_operand("f", "x", torch.zeros(16, 4, dtype=torch.bfloat16))  # 8-byte rows


@pytest.mark.parametrize("n,bn", [(1024, 256), (384, 128), (192, 128), (4096, 256)])
def test_tile_n(n, bn):
    assert sm90.tile_n(n) == bn


# ---------------------------------------------------------------------------
# K4: the kernel's tiles in numpy against the plain version
# ---------------------------------------------------------------------------

def _k4_emulated(y, cond, weights, d):
    B, T, C = y.shape
    wc, wo = (t.double().numpy() for t in K4.k_major_weights(weights))
    bc, bo = weights[1].double().numpy(), weights[3].double().numpy()
    plan = sm90.tap_plan(C, 3, d)
    P = sm90.pair_width(C)
    g = np.zeros((B, T, C))
    for b in range(B):  # grid z: one sequence, so a tap never reads another one's rows
        for m0 in range(0, T, sm90.BM):
            rows = np.arange(m0, min(m0 + sm90.BM, T))
            for p in range(C // P):
                acc = _gemm_tile(y[b], wc, m0, 2 * P * p, 2 * P, plan)[:len(rows)]
                j = P * p + np.arange(P)
                zg = acc[:, :P] + (bc[j] + cond[b][rows][:, j])
                zf = acc[:, P:] + (bc[C + j] + cond[b][rows][:, C + j])
                g[b, rows[:, None], j] = _sigmoid(zg) * np.tanh(zf)
    return _plain_gemm(g.reshape(B * T, C), wo, bo).reshape(B, T, 2 * C)


@pytest.mark.parametrize("B,T,C,d", [
    (2, 300, 64, 1),     # two sequences, a partial last tile
    (2, 150, 128, 16),
    (1, 100, 192, 64),   # a variance width, a reach of 64 rows
    (2, 37, 64, 50),     # d >= T: both outer taps read only zeros
    (1, 260, 256, 8),
])
def test_k4_tap_plan_reproduces_plain(B, T, C, d):
    rng = np.random.default_rng(C + d)
    y = rng.standard_normal((B, T, C))
    cond = 0.5 * rng.standard_normal((B, T, 2 * C))
    params = [torch.tensor(a, dtype=torch.float32) for a in (
        0.1 * rng.standard_normal((3, C, 2 * C)), 0.1 * rng.standard_normal(2 * C),
        0.1 * rng.standard_normal((C, 2 * C)), 0.1 * rng.standard_normal(2 * C))]
    weights = K4.prepare_weights(*params, product_dtype=torch.float32)
    got = _k4_emulated(y, cond, weights, d)
    ref = K4.wavenet_block_plain(torch.tensor(y, dtype=torch.float32),
                                 torch.tensor(cond, dtype=torch.float32), *params, dilation=d)
    assert np.abs(ref.numpy()).max() > 0.1
    np.testing.assert_allclose(got, ref.numpy(), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# K1: the four passes in numpy against the plain version
# ---------------------------------------------------------------------------

def _k1_params(rng, dim, inner, k):
    arrays = [
        1.0 + 0.1 * rng.standard_normal(dim), 0.1 * rng.standard_normal(dim),
        0.05 * rng.standard_normal((dim, 2 * inner)), 0.05 * rng.standard_normal(2 * inner),
        0.2 * rng.standard_normal((k, 1, inner)), 0.05 * rng.standard_normal(inner),
        np.full(inner, 0.25), 0.05 * rng.standard_normal((inner, dim)),
        0.05 * rng.standard_normal(dim),
    ]
    return [torch.tensor(a, dtype=torch.float32) for a in arrays]


def _dwconv_emulated(u, dw, dw_bias, alpha, k):
    """The conv kernel's blocks (``csrc/lynx_conv.cu``: kDwRuns runs of
    kDwRun = 32 rows, 64 channels): 64 rows, 64 + 32 staged rows (zero
    outside the sequence and past the k - 1 halo), taps zero past k."""
    B, T, inner = u.shape
    pad_l = k // 2
    w = np.zeros((33, inner))
    w[:k] = dw
    act = np.zeros((B, T, inner))
    for b in range(B):
        for t0 in range(0, T, 64):
            r = np.arange(96)
            t = t0 - pad_l + r
            valid = (r < 64 + k - 1) & (t >= 0) & (t < T)
            staged = np.zeros((96, inner))
            staged[valid] = u[b, t[valid]]
            for run in range(2):
                acc = np.zeros((32, inner))
                for i in range(32 + 32):
                    for rr in range(32):
                        if 0 <= i - rr < 33:
                            acc[rr] += staged[32 * run + i] * w[i - rr]
                rows = t0 + 32 * run + np.arange(32)
                keep = rows < T
                s = acc[keep] + dw_bias
                act[b, rows[keep]] = np.where(s >= 0, s, alpha * s)
    return act


def _k1_emulated(x, weights, k):
    B, T, dim = x.shape
    ln_scale, ln_bias, _, b_in, dw, dw_bias, alpha, _, b2 = (t.double().numpy() for t in weights)
    win_t, w2_t = (t.double().numpy() for t in K1.k_major_weights(weights))
    inner = w2_t.shape[1]
    rows = x.reshape(B * T, dim)
    mean = rows.mean(-1, keepdims=True)
    var = ((rows - mean) ** 2).mean(-1, keepdims=True)
    xn = (rows - mean) / np.sqrt(var + 1e-5) * ln_scale + ln_bias
    u = np.zeros((B * T, inner))
    plan = sm90.tap_plan(dim, 1, 0)
    P = sm90.pair_width(inner)
    for m0 in range(0, B * T, sm90.BM):
        r = np.arange(m0, min(m0 + sm90.BM, B * T))
        for p in range(inner // P):
            acc = _gemm_tile(xn, win_t, m0, 2 * P * p, 2 * P, plan)[:len(r)]
            j = P * p + np.arange(P)
            gate = acc[:, P:] + b_in[inner + j]
            u[r[:, None], j] = (acc[:, :P] + b_in[j]) * (gate * _sigmoid(gate))
    act = _dwconv_emulated(u.reshape(B, T, inner), dw, dw_bias, alpha, k)
    return _plain_gemm(act.reshape(B * T, inner), w2_t, b2).reshape(B, T, dim)


@pytest.mark.parametrize("B,T,dim,inner,k", [
    (2, 100, 64, 128, 31),   # two sequences: the conv's halo must not cross; 256-column tiles
    (1, 150, 192, 384, 7),   # dim % 128 != 0: a column-guarded last N tile
    (2, 37, 128, 64, 32),    # an even kernel: pad_r = pad_l - 1
    (1, 170, 64, 192, 33),   # the widest kernel the conv stages, two row blocks
    (1, 65, 64, 64, 1),
])
def test_k1_passes_reproduce_plain(B, T, dim, inner, k):
    rng = np.random.default_rng(dim + k)
    x = rng.standard_normal((B, T, dim))
    params = _k1_params(rng, dim, inner, k)
    weights = K1.prepare_weights(*params, product_dtype=torch.float32)
    got = _k1_emulated(x, weights, k)
    ref = K1.lynx_conv_module_plain(torch.tensor(x, dtype=torch.float32), *params, kernel_size=k)
    assert np.abs(ref.numpy()).max() > 0.05
    np.testing.assert_allclose(got, ref.numpy(), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the widths the kernels refuse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,d,ok", [(64, 1, True), (192, 1, True), (512, 1000, True),
                                    (96, 1, False), (576, 1, False), (32, 1, False),
                                    (512, 0, False)])
def test_k4_width_checks(C, d, ok):
    if ok:
        K4.check_widths(C, d)
    else:
        with pytest.raises(ValueError, match="C % 64"):
            K4.check_widths(C, d)


@pytest.mark.parametrize("dim,inner,k,ok", [(64, 64, 31, True), (192, 384, 33, True),
                                            (1024, 2048, 1, True), (96, 192, 31, False),
                                            (128, 96, 31, False), (128, 256, 34, False),
                                            (128, 256, 0, False)])
def test_k1_width_checks(dim, inner, k, ok):
    if ok:
        K1.check_widths(dim, inner, k)
    else:
        with pytest.raises(ValueError, match="dim % 64"):
            K1.check_widths(dim, inner, k)
