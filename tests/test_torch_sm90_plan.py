"""The host-side plan of the Hopper GEMM core (``ops/cuda/sm90.py``) that K1,
K2, K4, K5, K6 and K7 trust, on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
What they take from the host is checked here: the K-major and column-paired
weight copies (undone exactly back to the JAX layouts), the tensor maps'
dims, strides and boxes, the producer's tap coordinates, and the width checks.
The numpy emulations walk the kernels' tiles as the device does -- 128-row
output tiles, 64-wide K blocks loaded at the planned coordinates with zero
fill outside ``[0, rows)``, the paired epilogue, the depthwise conv's staged
tile and zero-padded taps -- and must reproduce the plain versions in f32
(atol 1e-4: the same f32 math in another summation order).  The persistent
entry K7 runs on is modelled too: its tiles, shared memory, epilogue layout
and the ``mbarrier`` ring carried across tiles.
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
    """K8 reads ``prepare_weights``' tuple as it is; the GEMM core's operands
    of K1, K5 and K7 (``lynx_conv.kernel_operands``) are built once and kept
    beside it."""
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


def test_prepared_operands_are_kept_per_maker():
    """Each ``make`` gets its own operands, built once: a second kernel's
    maker never receives the first one's."""
    weights = K1.prepare_weights(*_k1_params(np.random.default_rng(2), 64, 128, 31))
    calls = []

    def make_a(w):
        calls.append("a")
        return ("a",)

    def make_b(w):
        calls.append("b")
        return ("b",)

    assert weights.operands(make_a) == ("a",)
    assert weights.operands(make_b) == ("b",)
    assert weights.operands(make_a) == ("a",) and weights.operands(make_b) == ("b",)
    assert calls == ["a", "b"]


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


_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_13fooEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_13fooEv
    176 bytes stack frame, 460 bytes spill stores, 420 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 176 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 384 bytes cmem[0]
"""


def test_build_log_names_each_kernels_spills():
    """``build.parse_ptxas`` ties each stack frame and register count of a
    ``-Xptxas -v`` log to its function, so that a spill names the
    instantiation it belongs to."""
    from xiaoicesing_io_tpu_torch.ops.cuda import build

    usage = build.parse_ptxas(_PTXAS_LOG)
    assert usage == [
        {"function": "_ZN12_GLOBAL__N_13fooEv", "registers": 168, "stack": 176,
         "spill_stores": 460, "spill_loads": 420},
        {"function": "_Z3barv", "registers": 40, "stack": 0, "spill_stores": 0,
         "spill_loads": 0},
    ]
    # demangled without the anonymous namespace and the signature where a demangler is
    # found, else as given; a kernel keeps its template arguments
    assert build.demangle([u["function"] for u in usage]) in (
        ["foo", "bar"], ["_ZN12_GLOBAL__N_13fooEv", "_Z3barv"])
    assert build._kernel_name("void sm90::gemm_kernel<(int)256, (bool)1, Epi>(CUtensorMap_st, "
                              "T3)") == "sm90::gemm_kernel<(int)256, (bool)1, Epi>"
    assert build.parse_ptxas("") == []


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
    # the same rule for an operand that a kernel reads with vector loads, named as such
    with pytest.raises(ValueError, match=r"contiguous \(vector loads\)"):
        sm90.check_operand("f", "x", ok.t(), reader="vector loads")


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


# ---------------------------------------------------------------------------
# K2 and K6: the tap table, the K rounding and numpy walks of their launches
# ---------------------------------------------------------------------------

def _folded(rng, C, k, d, F):
    """A random conv of width C folded by F (F = 1: the raw dilated taps):
    ``(taps [k', F*C, F*C] f32, bias, pad_l, dilation)``."""
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_fast import fold_conv

    w = (0.3 * rng.standard_normal((k, C, C)) / np.sqrt(k * C)).astype(np.float32)
    b = (0.05 * rng.standard_normal(C)).astype(np.float32)
    W2, b2, pad_l, dil = fold_conv(w, b, F, dilation=d)
    return torch.from_numpy(np.ascontiguousarray(W2)), torch.from_numpy(b2), pad_l, dil


@pytest.mark.parametrize("C,k,d,F,n_taps,kept", [
    (128, 11, 5, 1, 11, list(range(11))),   # raw dilated taps, centred: rows -25 .. 25
    (32, 7, 3, 4, 7, list(range(7))),        # folded stage 3, conv 1: every tap non-zero
    (64, 11, 5, 2, 27, None),                # folded stage 2, conv 1: 17 of 27 non-zero
    (64, 3, 1, 2, 3, [0, 1, 2]),             # folded stage 2, conv 2
])
def test_tap_table_keeps_nonzero_taps_at_their_rows(C, k, d, F, n_taps, kept):
    taps, _, pad_l, dil = _folded(np.random.default_rng(k + F), C, k, d, F)
    assert taps.shape[0] == n_taps
    got = sm90.kept_taps(taps)
    nonzero = [j for j in range(n_taps) if taps[j].abs().max() > 0]
    assert got == (kept if kept is not None else nonzero)
    if (k, d, F) == (11, 5, 2):
        assert len(got) == 17 and pad_l == 13
    rows = sm90.tap_rows(got, dil, pad_l)
    assert rows == [j * dil - pad_l for j in got]
    if F == 1:  # the raw conv's SAME padding: the taps centred on the row
        assert rows == [(j - k // 2) * d for j in range(k)]
    # the producer's plan: each tap's 64-wide blocks at its row shift
    plan = sm90.row_plan(sm90.tap_k(F * C), rows)
    blocks = sm90.tap_k(F * C) // 64
    assert [s for _, s in plan] == [r for r in rows for _ in range(blocks)]
    assert [c for c, _ in plan] == [64 * i for _ in rows for i in range(blocks)]


def test_tap_table_of_the_shipped_folded_stages():
    """Every ResBlock1 conv of the shipped vocoder's stages 2-4, folded as the
    vocoder folds them: 126 of 144, 92 of 92 and 66 of 66 taps kept."""
    rng = np.random.default_rng(0)
    for F, C, total, nonzero in ((2, 64, 144, 126), (4, 32, 92, 92), (8, 16, 66, 66)):
        n = kept = 0
        for k, dils in zip((3, 7, 11), ((1, 3, 5),) * 3):
            for d in dils:
                for dd in (d, 1):
                    taps = _folded(rng, C, k, dd, F)[0]
                    n += taps.shape[0]
                    kept += len(sm90.kept_taps(taps))
        assert (n, kept) == (total, nonzero)


def test_kept_taps_of_an_all_zero_conv_is_one_tap():
    assert sm90.kept_taps(torch.zeros(5, 16, 16)) == [0]
    taps = torch.zeros(5, 16, 16)
    taps[3, 2, 7] = 1e-30
    assert sm90.kept_taps(taps) == [3]


@pytest.mark.parametrize("L,a_k", [(48, 64), (192, 192), (16, 64), (128, 128), (320, 320),
                                   (208, 256), (512, 512)])
def test_tap_k_rounding_and_k_major_copy(L, a_k):
    """One tap's K is the width rounded up to 64; the K-major copy of the
    kept taps is zero past the width (A's columns there are TMA zeros)."""
    assert sm90.tap_k(L) == a_k
    taps = torch.randn(4, L, L)
    taps[2] = 0
    kept = sm90.kept_taps(taps)
    assert kept == [0, 1, 3]
    wk = sm90.tap_k_major(taps, kept)
    assert wk.shape == (L, 3 * a_k) and wk.is_contiguous()
    per_tap = wk.view(L, 3, a_k)
    assert torch.equal(per_tap[:, :, L:], torch.zeros(L, 3, a_k - L))
    for i, j in enumerate(kept):
        assert torch.equal(per_tap[:, i, :L], taps[j].t())


def test_tap_conv_plans_the_operands_and_refuses_too_many_taps(monkeypatch):
    monkeypatch.setattr(sm90, "encode", lambda lib, t, box_rows: ("map", tuple(t.shape), box_rows))
    taps, _, _, _ = _folded(np.random.default_rng(1), 64, 11, 5, 2)
    c = sm90.tap_conv("lib", taps.to(torch.bfloat16))
    assert len(c.kept) == 17 and list(c.kept_c) == c.kept
    assert c.L == 128 and c.bn == 128 and c.wk.shape == (128, 17 * 128)
    assert c.map_w == ("map", (128, 17 * 128), 128)
    with pytest.raises(ValueError, match="at most 64 taps"):
        sm90.tap_conv("lib", torch.ones(65, 16, 16))


def test_kept_on_builds_once_and_again_after_an_in_place_write():
    w = torch.randn(3, 16, 16)
    calls = []

    def make(t):
        calls.append(t)
        return (len(calls),)

    assert sm90.kept_on(w, make) == sm90.kept_on(w, make) == (1,)
    w.mul_(2.0)
    assert sm90.kept_on(w, make) == (2,)
    assert len(calls) == 2 and all(t is w for t in calls)


def _a_box(a, m0, shift, col):
    """The 128 x 64 box TMA loads from ``a [rows, width]`` at (col, m0 +
    shift), zero outside the rows and past the width."""
    rows = m0 + shift + np.arange(sm90.BM)
    valid = (rows >= 0) & (rows < a.shape[0])
    tile = np.zeros((sm90.BM, sm90.BK))
    part = a[rows[valid], col:col + sm90.BK]
    tile[valid, :part.shape[1]] = part
    return tile


def _conv_walk(a, taps, d, pad_l):
    """One tap conv on the core, tile by tile: ``a [B, R, L]`` -> f64 ``z [B,
    R, L]`` over the kept taps of ``taps [k, L, L]``, each sequence its own
    grid z."""
    B, R, L = a.shape
    kept = sm90.kept_taps(taps)
    wk = sm90.tap_k_major(taps, kept).double().numpy()
    plan = sm90.row_plan(sm90.tap_k(L), sm90.tap_rows(kept, d, pad_l))
    bn = sm90.tile_n(L)
    z = np.zeros((B, R, L))
    for b in range(B):
        for m0 in range(0, R, sm90.BM):
            for n0 in range(0, L, bn):
                acc = np.zeros((sm90.BM, bn))
                for kb, (col, shift) in enumerate(plan):
                    bt = np.zeros((bn, sm90.BK))
                    part = wk[n0:n0 + bn, kb * sm90.BK:(kb + 1) * sm90.BK]
                    bt[:part.shape[0]] = part
                    acc += _a_box(a[b], m0, shift, col) @ bt.T
                r, c = min(sm90.BM, R - m0), min(bn, L - n0)
                z[b, m0:m0 + r, n0:n0 + c] = acc[:r, :c]
    return z


def _lrelu(v):
    return np.where(v >= 0, v, 0.1 * v)


def _rounding(dtype):
    """The kernels' rounding to the activation dtype (none in f32)."""
    if dtype == torch.float32:
        return lambda v: v
    return lambda v: torch.from_numpy(v).to(dtype).double().numpy()


def _k6_walk(x, w1, b1, w2, b2, d1, p1, d2, p2, dtype):
    """K6's three launches: the leaky-ReLU pass, conv 1 with its bias +
    leaky-ReLU epilogue, conv 2 with the f32 residual epilogue."""
    rnd = _rounding(dtype)
    b1, b2 = b1.double().numpy(), b2.double().numpy()
    a = rnd(_lrelu(x))
    t2 = rnd(_lrelu(_conv_walk(a, w1, d1, p1) + b1))
    return rnd(x + (_conv_walk(t2, w2, d2, p2) + b2))


def _close(got, ref, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    else:  # bf16 on both sides: the card tests' bar
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= 0.02 * scale
        assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.9999


@pytest.mark.parametrize("B,T,C,k,d,F,d2,dtype", [
    (2, 300, 64, 11, 5, 2, 1, torch.float32),    # folded stage 2: 17 of 27 taps, pads 13 and 1
    (2, 150, 32, 7, 3, 4, 1, torch.float32),     # folded stage 3
    (1, 200, 16, 11, 5, 8, 1, torch.float32),    # folded stage 4
    (2, 130, 128, 11, 5, 1, 1, torch.float32),   # raw dilated taps, T off the tile
    (2, 50, 48, 15, 5, 1, 9, torch.float32),     # L % 64 != 0, reaches 70 and 18
    (1, 140, 192, 3, 1, 1, 1, torch.float32),    # a_k 192, a guarded second N tile
    (2, 5, 128, 11, 5, 1, 1, torch.float32),     # fewer rows than the reach
    (2, 300, 64, 11, 5, 2, 1, torch.bfloat16),   # the card's rounding points
])
def test_k6_launches_reproduce_plain(B, T, C, k, d, F, d2, dtype):
    from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_resblock as K6

    rng = np.random.default_rng(C + k + F)
    w1, b1, p1, d1 = _folded(rng, C, k, d, F)
    w2, b2, p2, dd2 = _folded(rng, C, 3, d2, F)
    L = F * C
    x = torch.tensor(rng.standard_normal((B, T // F if F > 1 else T, L)),
                     dtype=torch.float32).to(dtype)
    w1, b1, w2, b2 = K6.prepare_unit_weights(w1, b1, w2, b2, dtype)
    geometry = dict(d1=d1, pad1_l=p1, d2=dd2, pad2_l=p2)
    ref = K6.resblock_unit_plain(x, w1, b1, w2, b2, **geometry).double().numpy()
    got = _k6_walk(x.double().numpy(), w1, b1, w2, b2, d1, p1, dd2, p2, dtype)
    assert np.abs(ref - x.double().numpy()).max() > 0.05  # the convs add something
    _close(got, ref, dtype)


def _k2_walk(x, weights, biases, specs, dtype):
    """K2's launch sequence (``launch_plan``): one leaky-ReLU pass, then per
    unit conv 1 and conv 2 with the stage's bookkeeping in its epilogue."""
    from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_stage as K2

    rnd = _rounding(dtype)
    a0 = rnd(_lrelu(x))
    a1 = h = acc = out = None
    for step in K2.launch_plan(specs):
        s1, s2 = specs[step.branch][step.unit]
        w1 = K2.unstack_taps(weights[step.conv], s1.k)
        w2 = K2.unstack_taps(weights[step.conv + 1], s2.k)
        b1, b2 = (biases[step.conv + i].double().numpy() for i in (0, 1))
        t2 = rnd(_lrelu(_conv_walk(a0 if step.first else a1, w1, s1.d, s1.pad_l) + b1))
        v = (x if step.first else h) + (_conv_walk(t2, w2, s2.d, s2.pad_l) + b2)
        if step.mode & K2.WRITE_H:
            h, a1 = v, rnd(_lrelu(v))
        if step.mode & K2.READ_ACC:
            v = acc + v
        if step.mode & K2.WRITE_ACC:
            acc = v
        if step.mode & K2.WRITE_OUT:
            out = rnd(v / len(specs))
    return out


def _k2_stage(rng, C, kernels, dils, F, dtype):
    """Stacked weights, biases and specs of a stage of width C folded by F."""
    from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_stage as K2

    weights, biases, specs = [], [], []
    for k, ds in zip(kernels, dils):
        branch = []
        for d in ds:
            pair = []
            for dd in (d, 1):
                taps, b, pad_l, dil = _folded(rng, C, k, dd, F)
                weights.append(K2.stack_taps(taps).to(dtype).contiguous())
                biases.append(b.float())
                pair.append(K2.ConvSpec(taps.shape[0], dil, pad_l))
            branch.append(tuple(pair))
        specs.append(tuple(branch))
    return weights, biases, tuple(specs)


@pytest.mark.parametrize("B,T,C,kernels,dils,F,dtype", [
    (2, 150, 64, (3, 7, 11), ((1, 3, 5),) * 3, 1, torch.float32),  # the default, T off the tile
    (2, 200, 32, (3, 7, 11), ((1, 3, 5),) * 3, 2, torch.float32),  # folded stage-2 taps
    (2, 140, 48, (3, 5), ((1, 2), (13, 25)), 1, torch.float32),    # two branches, far reaches
    (1, 90, 192, (7,), ((1, 3),), 1, torch.float32),               # one branch, a_k 192
    (2, 70, 64, (11,), ((5,),), 1, torch.float32),                 # one branch, one unit
    (2, 150, 64, (3, 7, 11), ((1, 3, 5),) * 3, 1, torch.bfloat16),
])
def test_k2_launch_plan_reproduces_plain(B, T, C, kernels, dils, F, dtype):
    from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_stage as K2

    rng = np.random.default_rng(C + T)
    weights, biases, specs = _k2_stage(rng, C, kernels, dils, F, dtype)
    x = torch.tensor(rng.standard_normal((B, T, F * C)), dtype=torch.float32).to(dtype)
    ref = K2.fused_resblock_stage_plain(x, weights, biases, specs).double().numpy()
    got = _k2_walk(x.double().numpy(), weights, biases, specs, dtype)
    assert np.abs(ref).max() > 0.1
    _close(got, ref, dtype)


@pytest.mark.parametrize("units", [(1,), (3,), (3, 3), (3, 3, 3), (2, 1, 3)])
def test_k2_launch_plan_modes(units):
    """A branch's inner units write h and the next A; its last unit starts
    (first branch), extends or, last, finishes the f32 sum."""
    from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_stage as K2

    specs = tuple((None,) * n for n in units)
    plan = K2.launch_plan(specs)
    assert len(plan) == sum(units)
    assert [s.conv for s in plan] == list(range(0, 2 * sum(units), 2))
    for s in plan:
        last_unit = s.unit == units[s.branch] - 1
        assert s.first == (s.unit == 0)
        if not last_unit:
            assert s.mode == K2.WRITE_H
        else:
            store = K2.WRITE_OUT if s.branch == len(units) - 1 else K2.WRITE_ACC
            assert s.mode == store | (K2.READ_ACC if s.branch else 0)


@pytest.mark.parametrize("k,d,pad_l,ok", [(3, 1, 1, True), (15, 5, 70, True), (1, 1, 0, True),
                                          (11, 5, 51, False), (3, 1, -1, False), (3, 0, 0, False),
                                          (3, 1 << 29, 0, False)])
def test_tap_conv_geometry_checks(k, d, pad_l, ok):
    """Any reach and any left pad in [0, (k - 1) * d] is taken; row shifts
    stay 32-bit."""
    if ok:
        sm90.check_tap_conv("f", k, d, pad_l)
    else:
        with pytest.raises(ValueError, match="d >= 1"):
            sm90.check_tap_conv("f", k, d, pad_l)


def test_folded_convs_are_block_sparse():
    """At stages 2-4 of the shipped vocoder, a folded conv's taps are F x F
    grids of C x C blocks, and only 12.5-78.6 % of those blocks are not all
    zero (the core computes whole kept taps: the rest is work a block-sparse
    product would skip)."""
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_fast import fold_conv

    shares = []
    for F, C in ((2, 64), (4, 32), (8, 16)):
        for k, dils in zip((3, 7, 11), ((1, 3, 5),) * 3):
            for d in dils:
                for dd in (d, 1):
                    W2 = fold_conv(np.ones((k, C, C), np.float32), None, F, dilation=dd)[0]
                    blocks = W2.reshape(W2.shape[0], F, C, F, C).transpose(0, 1, 3, 2, 4)
                    shares.append((np.abs(blocks).reshape(W2.shape[0], F, F, -1).max(-1) > 0)
                                  .mean())
    assert min(shares) == 0.125 and round(max(shares), 3) == 0.786


# ---------------------------------------------------------------------------
# K5 and K7: numpy walks of the four launches against the plain version
# ---------------------------------------------------------------------------

def _k5_walk(x, cond, step, weights, k, dtype):
    """K5's (and K7's) launches (``csrc/lynx_layer.cu``): the LayerNorm of f32
    ``h = bf16(x + cond) + step[b]`` (``h`` never rounded), the paired
    SwiGLU tiles into f32 ``u``, the depthwise conv into ``act``, then the
    output product's tiles with the rows epilogue: four columns of a row at a
    time, ``(acc + b2) + res``, ``res`` recomputed from ``x`` and ``cond``."""
    rnd = _rounding(dtype)
    B, T, dim = x.shape
    ln_scale, ln_bias, _, b_in, dw, dw_bias, alpha, _, b2 = (t.double().numpy() for t in weights)
    win_t, w2_t = (t.double().numpy() for t in K1.k_major_weights(weights))
    inner = w2_t.shape[1]
    rows = B * T
    h = (rnd(x + cond) + step[:, None, :]).reshape(rows, dim)
    mean = h.mean(-1, keepdims=True)
    var = ((h - mean) ** 2).mean(-1, keepdims=True)
    xn = rnd((h - mean) / np.sqrt(var + 1e-5) * ln_scale + ln_bias)
    u = np.zeros((rows, inner))
    plan = sm90.tap_plan(dim, 1, 0)
    P = sm90.pair_width(inner)
    for m0 in range(0, rows, sm90.BM):
        r = np.arange(m0, min(m0 + sm90.BM, rows))
        for p in range(inner // P):
            acc = _gemm_tile(xn, win_t, m0, 2 * P * p, 2 * P, plan)[:len(r)]
            j = P * p + np.arange(P)
            gate = acc[:, P:] + b_in[inner + j]
            u[r[:, None], j] = (acc[:, :P] + b_in[j]) * (gate * _sigmoid(gate))
    act = rnd(_dwconv_emulated(u.reshape(B, T, inner), dw, dw_bias, alpha, k)).reshape(rows, inner)
    xr, cr = x.reshape(rows, dim), cond.reshape(rows, dim)
    out = np.full((rows, dim), np.nan)
    bn = sm90.tile_n(dim)
    tail = sm90.tap_plan(inner, 1, 0)
    for m0 in range(0, rows, sm90.BM):
        for n0 in range(0, dim, bn):
            acc = _gemm_tile(act, w2_t, m0, n0, bn, tail)
            for rr in range(sm90.BM):
                for q in range(0, bn, 4):
                    r, c = m0 + rr, n0 + q
                    if r < rows and c < dim:  # the core's piece guard (dim % 4 == 0)
                        res = rnd(xr[r, c:c + 4] + cr[r, c:c + 4])  # load4
                        out[r, c:c + 4] = rnd((acc[rr, q:q + 4] + b2[c:c + 4]) + res)
    assert not np.isnan(out).any()
    return out.reshape(B, T, dim)


@pytest.mark.parametrize("B,T,dim,inner,k,dtype", [
    (2, 100, 64, 128, 31, torch.float32),    # two sequences: the conv's halo must not cross
    (1, 150, 192, 384, 7, torch.float32),    # dim % 128 != 0: a guarded 128-column out tile
    (2, 37, 128, 64, 32, torch.float32),     # an even kernel, 128-column paired tiles
    (1, 170, 64, 192, 33, torch.float32),    # the widest kernel, two conv row blocks
    (2, 130, 128, 256, 31, torch.bfloat16),  # the card's rounding points: xn, act, res, out
    (1, 140, 256, 512, 31, torch.bfloat16),  # 256-column out tiles, a ragged row tile
])
def test_k5_launches_reproduce_plain(B, T, dim, inner, k, dtype):
    from xiaoicesing_io_tpu_torch.ops.cuda import lynx_layer as K5

    rng = np.random.default_rng(dim + inner + k)
    params = _k1_params(rng, dim, inner, k)
    x, cond = (torch.tensor(rng.standard_normal((B, T, dim)), dtype=torch.float32).to(dtype)
               for _ in range(2))
    step = torch.tensor(rng.standard_normal((B, dim)), dtype=torch.float32)
    weights = K5.prepare_layer_weights(*params, product_dtype=dtype)
    ref = K5.lynx_layer_fused_plain(x, cond, step, *weights, kernel_size=k).double().numpy()
    got = _k5_walk(x.double().numpy(), cond.double().numpy(), step.double().numpy(), weights, k,
                   dtype)
    res = (x.double() + cond.double()).numpy()
    assert np.abs(ref - res).max() > 0.05  # the conv module adds something
    _close(got, ref, dtype)


def test_k5_layer_norm_takes_unrounded_h():
    """K1's LayerNorm pass reads a bf16 input; K5's forms f32 h = bf16(x +
    cond) + step and must not round it: with a step that bf16 cannot hold
    beside res, rounding h moves xn by far more than an f32 ulp."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 4, 64)).astype(np.float32)
    res = torch.tensor(x).to(torch.bfloat16).double().numpy()[0]
    step = np.full(64, 1e-3) * rng.standard_normal(64)  # far below res's bf16 ulp
    h = res + step
    h_rounded = torch.tensor(h).to(torch.bfloat16).double().numpy()

    def norm(v):
        return (v - v.mean(-1, keepdims=True)) / np.sqrt(v.var(-1, keepdims=True) + 1e-5)

    assert np.abs(norm(h) - norm(h_rounded)).max() > 1e-4
    assert np.abs(norm(h) - norm(res)).max() > 1e-4  # and the step is not lost


def test_k5_k7_width_checks_take_k1s_widths():
    """The cap of 1024 that the WMMA versions had is gone: K5 and K7 take what K1
    takes, and name themselves when they refuse."""
    for dim, inner in ((1536, 3072), (2048, 4096), (64, 64)):
        K1.check_widths(dim, inner, 31, "lynx_layer_fused")
    with pytest.raises(ValueError, match="lynx_layer_fused_v3 kernel needs dim % 64"):
        K1.check_widths(1056 + 8, 2048, 31, "lynx_layer_fused_v3")


# ---------------------------------------------------------------------------
# the persistent entry (K7's products): its tiles, shared memory, epilogue layout and ring
# ---------------------------------------------------------------------------

PERSISTENT_SHAPES = [  # (rows, cols, bn, batch): the products' plain or paired columns
    (8192, 4096, 256, 1),   # K7's SwiGLU product at the sweep's shape: 1024 tiles, 7.8 waves
    (8192, 1024, 256, 1),   # K7's output product: 256 tiles, 1.9 waves
    (8196, 1024, 256, 1),   # a ragged last row tile
    (37, 2048, 256, 1),     # fewer tiles than SMs
    (8003, 1000, 128, 1),   # 504 tiles, not a multiple of 132
    (300, 384, 128, 3),     # three batch entries
]


@pytest.mark.parametrize("rows,cols,bn,batch", PERSISTENT_SHAPES)
def test_persistent_tiles_visit_every_tile_once(rows, cols, bn, batch):
    grid, plan = sm90.persistent_tiles(rows, cols, bn, batch)
    n_tiles, m_tiles = -(-cols // bn), -(-rows // sm90.BM)
    tiles = n_tiles * m_tiles * batch
    assert grid == min(tiles, sm90.SMS) and len(plan) == grid
    visited = [t for block in plan for t in block]
    assert len(visited) == tiles
    assert set(visited) == {(b, m, n) for b in range(batch) for m in range(m_tiles)
                            for n in range(n_tiles)}
    # blocks' loads differ by at most one tile; N fastest, so neighbouring blocks share A's rows
    assert max(map(len, plan)) - min(map(len, plan)) <= 1
    if grid > 1:
        assert plan[0][0] == (0, 0, 0) and plan[1][0] == (0, 1 // n_tiles, 1 % n_tiles)


@pytest.mark.parametrize("bn,paired,out_bytes,stages", [
    (256, True, 4, 4),    # K7's SwiGLU product, f32 u: half of a warpgroup's 32 KB, 4 stages
    (256, False, 2, 4),   # K7's output product, bf16
    (256, True, 2, 4),    # a paired bf16 output: one box a round
    (256, False, 4, 3),   # a plain f32 output: 32 KB a warpgroup's round leaves 3 stages
    (128, True, 4, 5),    # 128-column tiles: 5 stages, the most the ring takes
    (128, False, 2, 5),
    (128, False, 4, 5),
])
def test_persistent_shared_memory_fits(bn, paired, out_bytes, stages):
    got, buf, smem = sm90.persistent_config(bn, paired, out_bytes)
    out_cols = bn // 2 if paired else bn
    assert got == stages
    # a warpgroup's 64 rows of one round: half its columns
    assert buf == 64 * out_cols * out_bytes // sm90.PERSISTENT_ROUNDS
    assert smem <= sm90.SMEM_LIMIT
    # a stage more would not fit beside the buffers, unless the ring is at its cap of 5
    stage = (sm90.BM + bn) * sm90.BK * 2
    assert stages == 5 or smem + stage > sm90.SMEM_LIMIT


def test_persistent_config_refuses_a_round_of_partial_boxes():
    """A paired bf16 output at BN 128 has 64 bytes a row in each round: half a
    store box, which the kernel's static_assert refuses too."""
    with pytest.raises(ValueError, match="whole boxes"):
        sm90.persistent_config(128, True, 2)


def test_store_map_plan_boxes():
    u = torch.zeros(8192, 2048)
    out = torch.zeros(4, 2048, 1024, dtype=torch.bfloat16)
    assert sm90.store_map_plan(u) == ((2048, 8192, 1), (8192, 8192 * 8192), (32, 64, 1))
    assert sm90.store_map_plan(out) == ((1024, 2048, 4), (2048, 2048 * 2048), (64, 64, 1))


def _swizzled(row, byte):
    """``sm90::swizzled``: a round's (row, byte) in a warpgroup's buffer, boxes of
    64 rows x 128 bytes in TMA's 128-byte swizzle."""
    return (byte // 128) * 64 * 128 + row * 128 + (((byte % 128) // 16) ^ (row % 8)) * 16 \
        + byte % 16


def _acc_position(t, i):
    """(row, column) in a warpgroup's 64 x BN tile of accumulator element i of
    its thread t (wgmma's layout, as the core's comments give it)."""
    lane = t % 32
    return 16 * (t // 32) + lane // 4 + 8 * ((i // 2) % 2), 8 * (i // 4) + 2 * (lane % 4) + i % 2


@pytest.mark.parametrize("bn,rnd", [(256, 0), (256, 1), (128, 0), (128, 1)])
def test_persistent_rows_shuffle_gives_four_columns_of_a_row(bn, rnd):
    """The rows kind's one shuffle (lanes l and l ^ 1 swap a pair): in
    epilogue round ``rnd`` each thread ends with four adjacent columns of one
    row for each of the round's j, a warpgroup's pieces cover the round's
    half of its 64 x BN block exactly once, and their places in the round's
    buffer (bf16 outputs) cover it exactly once too."""
    kj = bn // 8 // sm90.PERSISTENT_ROUNDS
    covered = np.zeros((64, bn), int)
    placed = np.zeros(64 * bn // sm90.PERSISTENT_ROUNDS * 2, int)
    for t in range(128):
        lane, odd = t % 32, t % 2
        partner = t ^ 1
        for jj in range(kj):
            j = rnd * kj + jj
            mine = [_acc_position(t, 4 * j + e) for e in range(4)]
            theirs = [_acc_position(partner, 4 * j + e) for e in range(4)]
            send = theirs[0:2] if partner % 2 else theirs[2:4]  # what the partner sends
            z = send + mine[2:4] if odd else mine[0:2] + send
            rr = 16 * (t // 32) + lane // 4 + 8 * odd
            c = 8 * j + 4 * ((lane % 4) // 2)
            assert z == [(rr, c + e) for e in range(4)]
            covered[rr, c:c + 4] += 1
            start = _swizzled(rr, (8 * jj + 4 * ((lane % 4) // 2)) * 2)
            placed[start:start + 8] += 1
    half = bn // sm90.PERSISTENT_ROUNDS
    assert (covered[:, rnd * half:(rnd + 1) * half] == 1).all()
    assert covered.sum() == 64 * half
    assert (placed == 1).all()


@pytest.mark.parametrize("out_bytes,rows_kind", [(4, False), (2, False), (2, True)])
def test_persistent_epilogue_writes_whole_wavefronts(out_bytes, rows_kind):
    """The swizzled buffer takes a warp's epilogue writes in the fewest
    128-byte wavefronts (pairs: 8 rows x 4 lanes; rows kind: 16 rows x 2
    pieces), and a round's bytes map one to one onto the buffer."""
    chunk = 128 * out_bytes // 1  # 128 output columns of a round
    seen = {_swizzled(r, b) for r in range(64) for b in range(0, chunk)}
    assert len(seen) == 64 * chunk and max(seen) < 64 * chunk
    for warp in range(4):
        for j in range(chunk // out_bytes // 8):
            banks = {}
            for lane in range(32):
                if rows_kind:
                    row = 16 * warp + lane // 4 + 8 * (lane % 2)
                    col, width = 8 * j + 4 * ((lane % 4) // 2), 4 * out_bytes
                else:
                    row = 16 * warp + lane // 4
                    col, width = 8 * j + 2 * (lane % 4), 2 * out_bytes
                start = _swizzled(row, col * out_bytes)
                for b in range(start, start + width, 4):
                    banks.setdefault(b // 4 % 32, set()).add(b // 128)
            requested = 32 * width
            assert max(len(v) for v in banks.values()) == max(1, requested // 128)


class _Barrier:
    """An mbarrier: a phase completes when ``count`` arrivals came;
    ``try_wait.parity(p)`` passes once the phase of parity ``p`` completed."""

    def __init__(self, count):
        self.count, self.pending, self.phase = count, count, 0

    def arrive(self):
        self.pending -= 1
        assert self.pending >= 0
        if self.pending == 0:
            self.phase, self.pending = self.phase + 1, self.count

    def ready(self, parity):
        return (self.phase & 1) != parity


def _run_persistent_block(tiles, k_blocks, stages, rounds, seed, release_last=True,
                          wait_store=True):
    """One block of ``sm90::gemm_persistent_kernel`` as three actors (the
    producer thread, two consumer warpgroups of four warps) and the TMA
    unit, interleaved at random.  Checks that every K block lands in a
    stage no warpgroup still reads and is read as the right (tile, K block),
    and that an epilogue buffer is written only when its last store has read
    it.  Returns the (tile, warpgroup) order of the epilogues; raises on a
    deadlock."""
    rng = np.random.default_rng(seed)
    full = [_Barrier(1) for _ in range(stages)]
    empty = [_Barrier(8) for _ in range(stages)]
    ring = [None] * stages
    reading = [set(), set()]      # stages a warpgroup's products may still read
    loads = []                    # TMA loads in flight: (stage, data)
    stores = [0, 0]               # store groups still reading a warpgroup's buffer
    epilogues = []

    def producer():
        stage = phase = 0
        for tile in tiles:
            for kb in range(k_blocks):
                yield lambda s=stage, p=phase: empty[s].ready(p ^ 1)
                loads.append((stage, (tile, kb)))
                stage, phase = (0, phase ^ 1) if stage + 1 == stages else (stage + 1, phase)

    def consumer(wg):
        stage = phase = 0
        for tile in tiles:
            prev = None
            for kb in range(k_blocks):
                yield lambda s=stage, p=phase: full[s].ready(p)
                assert ring[stage] == (tile, kb)
                reading[wg].add(stage)
                if kb > 0:
                    reading[wg].discard(prev)
                    for _ in range(4):
                        empty[prev].arrive()
                prev = stage
                stage, phase = (0, phase ^ 1) if stage + 1 == stages else (stage + 1, phase)
            reading[wg].discard(prev)
            if release_last:
                for _ in range(4):
                    empty[prev].arrive()
            for _ in range(rounds):
                if wait_store:
                    yield lambda: stores[wg] == 0  # cp.async.bulk.wait_group.read 0
                assert stores[wg] == 0, "the buffer is written while a store reads it"
                epilogues.append((tile, wg))
                stores[wg] += 1                    # the round's store group, committed

    actors = [producer(), consumer(0), consumer(1)]
    waits = [None] * 3
    done = [False] * 3
    while not all(done) or loads or any(stores):
        choices = [("actor", i) for i in range(3)
                   if not done[i] and (waits[i] is None or waits[i]())]
        choices += [("load", i) for i in range(len(loads))]
        choices += [("store", wg) for wg in (0, 1) if stores[wg]]
        assert choices, "deadlock"
        kind, i = choices[rng.integers(len(choices))]
        if kind == "load":
            stage, data = loads.pop(i)
            assert not any(stage in r for r in reading), "a load overwrote a stage being read"
            ring[stage] = data
            full[stage].arrive()
        elif kind == "store":
            stores[i] -= 1
        else:
            try:
                waits[i] = next(actors[i])
            except StopIteration:
                done[i], waits[i] = True, None
    return epilogues


@pytest.mark.parametrize("rows,cols,bn,batch", PERSISTENT_SHAPES)
@pytest.mark.parametrize("ring", ["configured", "two stages"])
def test_persistent_ring_carries_across_tiles(rows, cols, bn, batch, ring):
    """The ring's stage and phase run on across tile boundaries in the
    producer and the consumers alike, every stage goes back once a tile is
    done with it, and each epilogue round waits for its buffer's last store:
    the first, a middle and the last block of each shape, with a K of 2-16
    blocks and the stage count of its configuration or a ring of two, whose
    phase flips at every other K block."""
    rounds = sm90.PERSISTENT_ROUNDS
    grid, plan = sm90.persistent_tiles(rows, cols, bn, batch)
    paired = cols == 4096  # the SwiGLU product's f32 u, else a bf16 output
    stages = sm90.persistent_config(bn, paired, 4 if paired else 2)[0] if ring == "configured" \
        else 2
    k_blocks = 16 if cols == 4096 else 2 + (rows % 7)
    for block in sorted({0, grid // 2, grid - 1}):
        order = _run_persistent_block(plan[block], k_blocks, stages, rounds, seed=block)
        assert sorted(order) == sorted((t, wg) for t in plan[block] for wg in (0, 1)
                                       for _ in range(rounds))
        for wg in (0, 1):  # each warpgroup's epilogues in the block's tile order
            assert [t for t, w in order if w == wg] == [t for t in plan[block]
                                                        for _ in range(rounds)]


def test_persistent_model_catches_a_lost_stage_and_an_early_write():
    """The model is strict enough to see the two faults the kernel guards
    against: a tile's last stage never handed back (the producer starves)
    and an epilogue buffer rewritten before its store has read it."""
    tiles = [(0, m, 0) for m in range(4)]
    with pytest.raises(AssertionError, match="deadlock"):
        _run_persistent_block(tiles, 3, 3, sm90.PERSISTENT_ROUNDS, seed=0, release_last=False)
    with pytest.raises(AssertionError, match="while a store reads it"):
        for seed in range(20):  # some interleaving lets the write overtake the store
            _run_persistent_block(tiles, 3, 3, sm90.PERSISTENT_ROUNDS, seed=seed,
                                  wait_store=False)
