"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: both sides take bf16 product inputs and accumulate in f32, in
different orders; the kernel rounds its output to bf16.  So max |kernel -
plain| <= 2 % of max |plain| (a bf16 ulp is 0.4 %; an order-flipped rounding
of an intermediate can cost a few) and correlation > 0.9999, the bar of
``chip_smoke.py``.  TF32 is off, so the plain versions' f32 products and
convolutions are exact f32.
"""

import numpy as np
import pytest
import torch

from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_resblock as K6
from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_stage as K2
from xiaoicesing_io_tpu_torch.ops.cuda import lynx_conv as K1
from xiaoicesing_io_tpu_torch.ops.cuda import lynx_hybrid as K8
from xiaoicesing_io_tpu_torch.ops.cuda import lynx_layer as K5
from xiaoicesing_io_tpu_torch.ops.cuda import mel_spec as K3
from xiaoicesing_io_tpu_torch.ops.cuda import wavenet_block as K4

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_close(got, ref, tol=0.02, min_corr=0.9999):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= tol * scale
    assert torch.corrcoef(torch.stack([got.flatten(), ref.flatten()]))[0, 1] > min_corr


def _k1_params(rng, dim, inner, k, device):
    arrays = [
        1.0 + 0.1 * rng.standard_normal(dim), 0.1 * rng.standard_normal(dim),
        0.05 * rng.standard_normal((dim, 2 * inner)), 0.05 * rng.standard_normal(2 * inner),
        0.2 * rng.standard_normal((k, 1, inner)), 0.05 * rng.standard_normal(inner),
        np.full(inner, 0.25), 0.05 * rng.standard_normal((inner, dim)),
        0.05 * rng.standard_normal(dim),
    ]
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


@pytest.mark.parametrize("B,T,dim,inner,k", [
    (1, 300, 256, 512, 31),    # a partial last row tile
    (2, 1000, 256, 512, 31),   # two sequences: no halo may cross between them
    (3, 77, 128, 256, 7),      # short kernel, one tile per sequence
    (2, 150, 192, 384, 31),    # dim % 128 != 0: a partial last column tile
    (2, 300, 128, 192, 31),    # inner % 128 != 0: 128-column paired tiles
])
def test_lynx_conv_kernel_matches_plain(cuda, B, T, dim, inner, k):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((B, T, dim)), dtype=torch.float32,
                     device=cuda).to(torch.bfloat16)
    params = _k1_params(rng, dim, inner, k, cuda)
    before = K1.launches
    got = K1.lynx_conv_module(x, K1.prepare_weights(*params), kernel_size=k)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, dim)
    _rel_close(got, K1.lynx_conv_module_plain(x, *params, kernel_size=k))


@pytest.mark.parametrize("k", [3, 31, 32])
@pytest.mark.parametrize("dim,inner", [(256, 512), (1024, 2048)])
@pytest.mark.parametrize("T", [37, 1000, 2048, 2049])
@pytest.mark.parametrize("B", [1, 4])
def test_lynx_conv_edge_shapes_match_plain(cuda, B, T, dim, inner, k):
    """The GEMM-core K1 at the main path's width and a narrow one, T off the
    128-row tile and the conv's 64-row block, odd and even kernels."""
    rng = np.random.default_rng(B + T + dim + k)
    x = torch.tensor(rng.standard_normal((B, T, dim)), dtype=torch.float32,
                     device=cuda).to(torch.bfloat16)
    params = _k1_params(rng, dim, inner, k, cuda)
    before = K1.launches
    got = K1.lynx_conv_module(x, K1.prepare_weights(*params), kernel_size=k)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    _rel_close(got, K1.lynx_conv_module_plain(x, *params, kernel_size=k))


def test_lynx_conv_raises_on_tma_operands(cuda):
    """A non-contiguous x and widths the kernel does not take."""
    rng = np.random.default_rng(13)
    weights = K1.prepare_weights(*_k1_params(rng, 128, 256, 31, cuda))
    x = torch.zeros(1, 128, 16, device=cuda, dtype=torch.bfloat16).transpose(1, 2)
    before = K1.launches
    with pytest.raises(ValueError, match="contiguous"):
        K1.lynx_conv_module(x, weights)
    for dim, inner, k in ((128, 96, 31), (128, 256, 35)):
        w = K1.prepare_weights(*_k1_params(rng, dim, inner, k, cuda))
        with pytest.raises(ValueError, match="dim % 64"):
            K1.lynx_conv_module(torch.zeros(1, 16, dim, device=cuda, dtype=torch.bfloat16), w,
                                kernel_size=k)
    assert K1.launches == before


@pytest.mark.parametrize("M,N,K,bn", [
    (8192, 4096, 1024, 128), (8192, 4096, 1024, 256),   # the main-path product size
    (1000, 1024, 512, 256), (37, 512, 64, 128),         # ragged M: one partial row tile
    (129, 384, 192, 128),                               # one row past a tile
    (300, 192, 128, 128),                               # N off the tile: a guarded last column tile
    (8003, 1000, 512, 256),                             # both ragged: 16-byte pieces up to N
])
def test_gemm_core_matches_matmul(cuda, M, N, K, bn):
    """The bare TMA + wgmma core (``csrc/sm90_gemm.cuh``) against
    ``torch.matmul`` in f32 on the same bf16 inputs: a wrong swizzle or
    descriptor gives plausible wrong numbers, a ragged M a wrong tail."""
    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    a = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    b = (torch.randn(N, K, generator=g, device=cuda) / K ** 0.5).to(torch.bfloat16)
    bias = torch.randn(N, generator=g, device=cuda)
    got = K4.gemm_bf16(a, b, bias, bn=bn)
    torch.cuda.synchronize()
    ref = a.float() @ b.float().t() + bias
    assert got.shape == (M, N)
    _rel_close(got, ref)
    # a bf16 output is within one rounding of the f32 product
    assert ((got.float() - ref).abs() <= 1e-2 * ref.abs() + 1e-2).all()


@pytest.mark.parametrize("rows_kind", [False, True])
@pytest.mark.parametrize("M,N,K,bn", [
    (8192, 1024, 2048, 256),   # the layer's output product: 256 tiles, 1.9 waves of 132 blocks
    (1000, 512, 256, 256),     # ragged M, 16 tiles: fewer tiles than SMs
    (37, 192, 64, 128),        # one partial row tile (one warpgroup's rows), a guarded N tile
    (129, 384, 192, 128),      # one row past a tile
    (8003, 1000, 512, 128),    # both ragged: 63 x 8 = 504 tiles, not a multiple of 132
])
def test_gemm_core_persistent_matches_matmul(cuda, M, N, K, bn, rows_kind):
    """The core's persistent entry (``sm90::launch_persistent``: blocks walking
    the tiles, the ring carried across them, TMA stores from a swizzled
    buffer) against ``torch.matmul`` in f32, with a pairs epilogue (``+
    bias``) and a rows epilogue (``+ bias + res``, a plain residual load)."""
    from xiaoicesing_io_tpu_torch.ops.cuda import lynx_layer

    g = torch.Generator(device=cuda).manual_seed(M + N + K + bn)
    a = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    b = (torch.randn(N, K, generator=g, device=cuda) / K ** 0.5).to(torch.bfloat16)
    bias = torch.randn(N, generator=g, device=cuda)
    res = torch.randn(M, N, generator=g, device=cuda).to(torch.bfloat16) if rows_kind else None
    got = lynx_layer.gemm_persistent_bf16(a, b, bias, res, bn=bn)
    torch.cuda.synchronize()
    ref = a.float() @ b.float().t() + bias
    if rows_kind:
        ref = ref + res.float()
    assert got.shape == (M, N)
    _rel_close(got, ref)
    assert ((got.float() - ref).abs() <= 1e-2 * ref.abs() + 1e-2).all()


def _stage(rng, L, kernels, dils, device, F=1):
    """A stage of width L: raw dilated taps (F = 1), or the taps of width
    L / F folded by F as the vocoder folds them (asymmetric pads, all-zero
    taps)."""
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_fast import fold_conv

    C = L // F
    specs, weights, biases = [], [], []
    for k, ds in zip(kernels, dils):
        branch = []
        for d in ds:
            pair = []
            for dd in (d, 1):
                w = (0.1 * rng.standard_normal((k, C, C)) / np.sqrt(k * F)).astype(np.float32)
                b = (0.1 * rng.standard_normal(C)).astype(np.float32)
                taps, b, pad_l, dil = fold_conv(w, b, F, dilation=dd)
                weights.append(K2.stack_taps(taps).to(device, torch.bfloat16).contiguous())
                biases.append(torch.tensor(b, dtype=torch.float32, device=device))
                pair.append(K2.ConvSpec(taps.shape[0], dil, pad_l))
            branch.append(tuple(pair))
        specs.append(tuple(branch))
    return tuple(specs), weights, biases


@pytest.mark.parametrize("L,T,kernels,dils,F", [
    (128, 777, (3, 7, 11), ((1, 3, 5),) * 3, 1),   # the HiFiGAN default, ragged T
    (256, 300, (3, 7, 11), ((1, 3, 5),) * 3, 1),   # stage-0 width
    (128, 257, (3, 5), ((1, 2), (2, 6)), 1),       # other geometry, two branches
    (64, 200, (3, 7, 11), ((1, 3, 5),) * 3, 1),    # one 128-column tile, half of it guarded
    (192, 130, (3, 7, 11), ((1, 3, 5),) * 3, 1),   # a guarded second N tile
    (384, 100, (3, 7, 11), ((1, 3, 5),) * 3, 1),   # three N tiles
    (512, 100, (3, 7, 11), ((1, 3, 5),) * 3, 1),   # the widest: 256-column tiles
    (128, 300, (3, 19), ((1, 7), (25,)), 1),       # far reaches: 450 and a second conv's 18
    (48, 150, (3, 7), ((1, 3), (5,)), 1),          # L % 64 != 0: TMA zeros past the width
    (128, 1000, (3, 7, 11), ((1, 3, 5),) * 3, 2),  # folded stage 2: 126 of 144 taps kept
])
def test_resblock_stage_kernel_matches_plain(cuda, L, T, kernels, dils, F):
    rng = np.random.default_rng(1)
    specs, w, b = _stage(rng, L, kernels, dils, cuda, F)
    x = torch.tensor(rng.standard_normal((2, T, L)), dtype=torch.float32,
                     device=cuda).to(torch.bfloat16)
    before = K2.launches
    got = K2.fused_resblock_stage(x, w, b, specs)
    torch.cuda.synchronize()
    assert K2.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _rel_close(got, K2.fused_resblock_stage_plain(x, w, b, specs))


# ---------------------------------------------------------------------------
# K6: one ResBlock1 unit, raw dilated taps or time-folded taps
# ---------------------------------------------------------------------------

def _unit(rng, C, k, d, F, device, d2=1):
    """Unit weights of width C folded by F (F = 1: the raw dilated taps) in
    the kernel's operand types, and their geometry; the second conv's
    dilation is d2."""
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_fast import fold_conv

    w1, w2 = (0.1 * rng.standard_normal((k, C, C)) / np.sqrt(k) for _ in range(2))
    b1, b2 = (0.1 * rng.standard_normal(C) for _ in range(2))
    f1 = fold_conv(w1.astype(np.float32), b1.astype(np.float32), F, dilation=d)
    f2 = fold_conv(w2.astype(np.float32), b2.astype(np.float32), F, dilation=d2)
    weights = K6.prepare_unit_weights(f1[0], f1[1], f2[0], f2[1], torch.bfloat16, device)
    return weights, dict(d1=f1[3], pad1_l=f1[2], d2=f2[3], pad2_l=f2[2])


@pytest.mark.parametrize("B,T,C,k,d,F,d2", [
    (2, 1000, 64, 11, 5, 2, 1),    # folded stage 2: 17 of 27 + 3 taps at L = 128, T off the tile
    (2, 777, 32, 7, 3, 4, 1),      # folded stage 3
    (1, 300, 16, 3, 1, 8, 1),      # folded stage 4: L = 128
    (2, 300, 256, 11, 5, 1, 1),    # raw dilated taps at L = 256 (stage 0): reach 50 and 2
    (2, 257, 128, 7, 3, 1, 1),     # raw, L = 128 (stage 1)
    (3, 5, 128, 11, 5, 1, 1),      # fewer rows than the reach
    (2, 200, 48, 3, 1, 1, 1),      # L % 64 != 0: TMA zeros past the width
    (2, 150, 192, 3, 5, 1, 1),     # a guarded second N tile
    (1, 130, 512, 3, 5, 1, 1),     # the widest: 256-column tiles
    (2, 300, 128, 15, 5, 1, 1),    # a first-conv reach of 14 * 5 = 70
    (2, 300, 128, 3, 1, 1, 9),     # a second-conv reach of 2 * 9 = 18
])
def test_resblock_unit_kernel_matches_plain(cuda, B, T, C, k, d, F, d2):
    rng = np.random.default_rng(9)
    weights, geometry = _unit(rng, C, k, d, F, cuda, d2)
    x = _bf16(rng, (B, T // F, F * C), cuda)
    before = K6.launches
    got = K6.resblock_unit(x, *weights, **geometry)
    torch.cuda.synchronize()
    assert K6.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _rel_close(got, K6.resblock_unit_plain(x, *weights, **geometry))


def test_resblock_unit_raises_instead_of_falling_back(cuda):
    rng = np.random.default_rng(10)
    weights, geometry = _unit(rng, 128, 3, 1, 1, cuda)
    x = _bf16(rng, (1, 64, 128), cuda)
    before = K6.launches
    with pytest.raises(TypeError, match="bf16"):
        K6.resblock_unit(x.float(), *weights, **geometry)
    # taps that were not prepared: f32, a non-contiguous view, f32 biases missing
    w1, b1, w2, b2 = weights
    with pytest.raises(ValueError, match="prepare_unit_weights"):
        K6.resblock_unit(x, w1.float(), b1, w2, b2, **geometry)
    with pytest.raises(ValueError, match="prepare_unit_weights"):
        K6.resblock_unit(x, w1.transpose(1, 2), b1, w2, b2, **geometry)
    with pytest.raises(ValueError, match="prepare_unit_weights"):
        K6.resblock_unit(x, w1, b1.to(torch.bfloat16), w2, b2, **geometry)
    # widths the kernel does not take
    for C in (120, 640):
        wc, gc = _unit(rng, C, 3, 1, 1, cuda)
        with pytest.raises(ValueError, match="C % 16"):
            K6.resblock_unit(_bf16(rng, (1, 16, C), cuda), *wc, **gc)
    # an input the kernel's vector loads cannot read
    shifted = torch.zeros(64 * 128 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(1, 64, 128)
    with pytest.raises(ValueError, match="aligned"):
        K6.resblock_unit(shifted, *weights, **geometry)
    assert K6.launches == before


def test_folded_vocoder_on_card(cuda, tmp_path):
    """A narrow random vocoder through the wrapper's default folded layout on
    the card: K2 on stages 0 and 1, K6 on the 27 units of stages 2-4; the wav
    against the f32 stock module path on the card (corr > 0.99, the bar of
    ``chip_smoke.py``)."""
    import json

    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import (
        Generator, NsfHifiganConfig,
    )
    from xiaoicesing_io_tpu_torch.models.vocoders.wrapper import NsfHifiGAN

    vcfg = dict(num_mels=128, sampling_rate=44100, hop_size=512, n_fft=2048, win_size=2048,
                fmin=40, fmax=16000, upsample_rates=[8, 8, 2, 2, 2],
                upsample_kernel_sizes=[16, 16, 4, 4, 4], upsample_initial_channel=64,
                resblock="1", resblock_kernel_sizes=[3, 7, 11],
                resblock_dilation_sizes=[[1, 3, 5]] * 3)
    torch.manual_seed(0)
    torch.save({"generator": Generator(NsfHifiganConfig.from_json(vcfg)).state_dict()},
               tmp_path / "model.ckpt")
    (tmp_path / "config.json").write_text(json.dumps(vcfg))
    voc = NsfHifiGAN({"vocoder_ckpt": str(tmp_path / "model.ckpt"), "mel_base": "e"},
                     device="cuda")
    rng = np.random.default_rng(11)
    mel = torch.tensor(rng.standard_normal((2, 300, 128)) - 3.0, dtype=torch.float32, device=cuda)
    f0 = torch.tensor(rng.uniform(100, 400, (2, 300)), dtype=torch.float32, device=cuda)
    k2, k6 = K2.launches, K6.launches
    wav = voc.spec2wav_torch(mel, f0)
    torch.cuda.synchronize()
    assert (K2.launches - k2, K6.launches - k6) == (2, 27)
    ref = voc.spec2wav_torch(mel, f0, _f32_module=True)
    assert wav.shape == ref.shape == (2, 300 * 512) and torch.isfinite(wav).all()
    assert torch.corrcoef(torch.stack([wav.flatten(), ref.flatten()]))[0, 1] > 0.99


def test_wrappers_raise_instead_of_falling_back(cuda):
    """A CUDA tensor the kernel does not take raises; it never reaches the
    plain version."""
    rng = np.random.default_rng(2)
    x = torch.zeros(1, 16, 128, device=cuda)
    params = _k1_params(rng, 128, 256, 31, cuda)
    weights = K1.prepare_weights(*params)
    before, before2 = K1.launches, K2.launches
    with pytest.raises(TypeError, match="bf16"):
        K1.lynx_conv_module(x, weights)
    # weights that were not prepared
    with pytest.raises(ValueError, match="prepare_weights"):
        K1.lynx_conv_module(x.to(torch.bfloat16), params)
    with pytest.raises(ValueError, match="dim % 64"):
        K1.lynx_conv_module(torch.zeros(1, 16, 96, device=cuda, dtype=torch.bfloat16),
                            K1.prepare_weights(*_k1_params(rng, 96, 192, 31, cuda)))
    # an operand that is not aligned for TMA
    shifted = torch.zeros(16 * 128 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(1, 16, 128)
    with pytest.raises(ValueError, match="aligned"):
        K1.lynx_conv_module(shifted, weights)
    specs, w, b = _stage(rng, 128, (3,), ((1,),), cuda)
    with pytest.raises(TypeError, match="bf16"):
        K2.fused_resblock_stage(x, w, b, specs)
    # an input the kernel's vector loads cannot read (the weights are copied on the host)
    x_shifted = torch.zeros(16 * 128 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(1, 16, 128)
    with pytest.raises(ValueError, match="aligned"):
        K2.fused_resblock_stage(x_shifted, w, b, specs)
    # widths the kernel does not take
    for L in (120, 640):
        specs, w, b = _stage(rng, L, (3,), ((1,),), cuda)
        with pytest.raises(ValueError, match="L % 16"):
            K2.fused_resblock_stage(torch.zeros(1, 16, L, device=cuda, dtype=torch.bfloat16),
                                    w, b, specs)
    assert (K1.launches, K2.launches) == (before, before2)


def test_lynx_denoiser_apply_on_card_matches_cpu(cuda):
    """The bf16 denoiser apply with the kernel on the card against the same
    apply on the CPU, where the conv module is the plain version; both bf16,
    rounded at different places, so corr > 0.999 and 5 % of the scale."""
    from xiaoicesing_io_tpu_torch.models.backbones import build_backbone
    from xiaoicesing_io_tpu_torch.models.backbones.lynx_cuda import lynx_denoiser_apply

    torch.manual_seed(0)
    M, H, C = 32, 64, 256
    net = build_backbone(M, 1, "lynxnet", {"num_channels": C, "num_layers": 2,
                                           "kernel_size": 31, "strong_cond": True},
                         cond_dims=H).eval()
    with torch.no_grad():
        net.output_projection.weight.normal_(0.0, 0.05)
    spec = torch.randn(2, 1, 384, M)
    step = torch.tensor([30.0, 700.0])
    cond = torch.randn(2, 384, H)
    with torch.no_grad():
        ref = lynx_denoiser_apply(net, spec, step, cond)
        before = K1.launches
        got = lynx_denoiser_apply(net.to(cuda), spec.to(cuda), step.to(cuda), cond.to(cuda))
        torch.cuda.synchronize()
    assert K1.launches == before + 2
    _rel_close(got.cpu(), ref, tol=0.05, min_corr=0.999)


# ---------------------------------------------------------------------------
# K5 and K7 (the whole strong_cond layer) and K8 (the hybrid conv tail)
# ---------------------------------------------------------------------------

LAYER_SHAPES = [
    (1, 300, 256, 512, 31),     # a partial last row tile
    (2, 1000, 256, 512, 31),    # two sequences: no halo may cross between them
    (3, 77, 128, 256, 7),       # short kernel
    (2, 150, 192, 384, 31),     # dim % 128 != 0: 128-column output tiles, a guarded last one
    (1, 5, 64, 128, 31),        # fewer rows than the halo, the narrowest width: one tile
    (2, 4100, 256, 512, 31),    # more tiles than SMs, a ragged last row tile
    (3, 2500, 1024, 2048, 31),  # the main-path width, T off any bucket
]
# K5 and K7 only (K8 keeps its cap at 1024): widths above the cap K5 and K7 had before the GEMM core
WIDE_LAYER_SHAPES = [
    (2, 700, 1536, 3072, 31),
    (1, 1000, 2048, 4096, 31),
]


def _bf16(rng, shape, device, std=1.0):
    return torch.tensor(std * rng.standard_normal(shape), dtype=torch.float32,
                        device=device).to(torch.bfloat16)


@pytest.mark.parametrize("entry", ["v2", "v3"])
@pytest.mark.parametrize("B,T,dim,inner,k", LAYER_SHAPES + WIDE_LAYER_SHAPES)
def test_lynx_layer_kernels_match_plain(cuda, entry, B, T, dim, inner, k):
    rng = np.random.default_rng(6)
    x, cond = _bf16(rng, (B, T, dim), cuda), _bf16(rng, (B, T, dim), cuda)
    step = torch.tensor(rng.standard_normal((B, dim)), dtype=torch.float32, device=cuda)
    params = _k1_params(rng, dim, inner, k, cuda)
    fn = K5.lynx_layer_fused if entry == "v2" else K5.lynx_layer_fused_v3
    counter = f"launches_{entry}"
    before = getattr(K5, counter)
    got = fn(x, cond, step, K5.prepare_layer_weights(*params), kernel_size=k)
    torch.cuda.synchronize()
    assert getattr(K5, counter) == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, dim)
    _rel_close(got, K5.lynx_layer_fused_plain(x, cond, step, *params, kernel_size=k))


@pytest.mark.parametrize("B,T,dim,inner,k", LAYER_SHAPES)
def test_conv_tail_kernel_matches_plain(cuda, B, T, dim, inner, k):
    rng = np.random.default_rng(7)
    act = _bf16(rng, (B, T, inner), cuda, std=0.5)
    params = _k1_params(rng, dim, inner, k, cuda)
    before = K8.launches
    got = K8.conv_tail(act, K1.prepare_weights(*params)[4:], kernel_size=k)
    torch.cuda.synchronize()
    assert K8.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, dim)
    _rel_close(got, K8.conv_tail_plain(act, *params[4:], kernel_size=k))


def test_lynx_variants_raise_instead_of_falling_back(cuda):
    rng = np.random.default_rng(8)
    x, cond = _bf16(rng, (1, 16, 128), cuda), _bf16(rng, (1, 16, 128), cuda)
    step = torch.zeros(1, 128, device=cuda)
    params = _k1_params(rng, 128, 256, 31, cuda)
    weights = K5.prepare_layer_weights(*params)
    counts = (K5.launches_v2, K5.launches_v3, K8.launches)
    for fn in (K5.lynx_layer_fused, K5.lynx_layer_fused_v3):
        with pytest.raises(TypeError, match="bf16"):
            fn(x.float(), cond, step, weights)
        with pytest.raises(TypeError, match="bf16"):
            fn(x, cond.float(), step, weights)
        with pytest.raises(ValueError, match="step"):
            fn(x, cond, torch.zeros(2, 128, device=cuda), weights)
        # weights that were not prepared
        with pytest.raises(ValueError, match="prepare_layer_weights"):
            fn(x, cond, step, params)
        # widths the kernels do not take: dim % 64, inner % 64, k > 33
        for dim, inner, k in ((96, 192, 31), (128, 96, 31), (128, 256, 35)):
            xd, cd = _bf16(rng, (1, 16, dim), cuda), _bf16(rng, (1, 16, dim), cuda)
            wd = K5.prepare_layer_weights(*_k1_params(rng, dim, inner, k, cuda))
            with pytest.raises(ValueError, match="dim % 64"):
                fn(xd, cd, torch.zeros(1, dim, device=cuda), wd, kernel_size=k)
        # x and cond_proj are read with vector loads: contiguous and 16-byte aligned
        with pytest.raises(ValueError, match="contiguous"):
            fn(_bf16(rng, (1, 128, 16), cuda).transpose(1, 2), cond, step, weights)
        shifted = torch.zeros(16 * 128 + 1, device=cuda, dtype=torch.bfloat16)[1:]
        with pytest.raises(ValueError, match="aligned"):
            fn(x, shifted.view(1, 16, 128), step, weights)
    tail = weights[4:]
    with pytest.raises(TypeError, match="bf16"):
        K8.conv_tail(torch.zeros(1, 16, 256, device=cuda), tail)
    with pytest.raises(ValueError, match="prepare_layer_weights"):
        K8.conv_tail(_bf16(rng, (1, 16, 256), cuda), params[4:])
    with pytest.raises(ValueError, match="inner % 64"):
        K8.conv_tail(_bf16(rng, (1, 16, 96), cuda),
                     K1.prepare_weights(*_k1_params(rng, 128, 96, 31, cuda))[4:])
    assert (K5.launches_v2, K5.launches_v3, K8.launches) == counts


@pytest.mark.parametrize("options,module,counter", [
    ({"fused_layer": True}, K5, "launches_v2"),
    ({"fused_layer": "v3"}, K5, "launches_v3"),
    ({"module_impl": "hybrid"}, K8, "launches"),
])
def test_lynx_denoiser_apply_variants_on_card_match_cpu(cuda, options, module, counter):
    """The bf16 apply with K5, K7 or K8 on the card against the same apply
    on the CPU (plain versions): the bar of the v1 apply above."""
    from xiaoicesing_io_tpu_torch.models.backbones import build_backbone
    from xiaoicesing_io_tpu_torch.models.backbones.lynx_cuda import lynx_denoiser_apply

    torch.manual_seed(0)
    M, H, C = 32, 64, 256
    net = build_backbone(M, 1, "lynxnet", {"num_channels": C, "num_layers": 2,
                                           "kernel_size": 31, "strong_cond": True},
                         cond_dims=H).eval()
    with torch.no_grad():
        net.output_projection.weight.normal_(0.0, 0.05)
    spec = torch.randn(2, 1, 384, M)
    step = torch.tensor([30.0, 700.0])
    cond = torch.randn(2, 384, H)
    with torch.no_grad():
        ref = lynx_denoiser_apply(net, spec, step, cond, **options)
        before = getattr(module, counter)
        got = lynx_denoiser_apply(net.to(cuda), spec.to(cuda), step.to(cuda), cond.to(cuda),
                                  **options)
        torch.cuda.synchronize()
    assert getattr(module, counter) == before + 2
    _rel_close(got.cpu(), ref, tol=0.05, min_corr=0.999)


def _k4_params(rng, C, device):
    arrays = [0.05 * rng.standard_normal((3, C, 2 * C)), 0.05 * rng.standard_normal(2 * C),
              0.05 * rng.standard_normal((C, 2 * C)), 0.05 * rng.standard_normal(2 * C)]
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


def _k4_acts(rng, B, T, C, device):
    return [torch.tensor(0.5 * rng.standard_normal(shape), dtype=torch.float32,
                         device=device).to(torch.bfloat16)
            for shape in ((B, T, C), (B, T, 2 * C))]


@pytest.mark.parametrize("d", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("C", [192, 256, 512])  # variance predictors' widths, the acoustic one
def test_wavenet_block_kernel_matches_plain(cuda, C, d):
    """Two sequences of 300 rows: a partial last row tile, and halos that
    must not cross from one sequence into the other."""
    rng = np.random.default_rng(3)
    y, cond = _k4_acts(rng, 2, 300, C, cuda)
    params = _k4_params(rng, C, cuda)
    before = K4.launches
    got = K4.wavenet_block(y, cond, K4.prepare_weights(*params), dilation=d)
    torch.cuda.synchronize()
    assert K4.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (2, 300, 2 * C)
    _rel_close(got, K4.wavenet_block_plain(y, cond, *params, dilation=d))


def test_wavenet_block_raises_instead_of_falling_back(cuda):
    rng = np.random.default_rng(4)
    y, cond = _k4_acts(rng, 1, 64, 128, cuda)
    params = _k4_params(rng, 128, cuda)
    weights = K4.prepare_weights(*params)
    before = K4.launches
    with pytest.raises(TypeError, match="bf16"):
        K4.wavenet_block(y.float(), cond, weights, dilation=1)
    with pytest.raises(ValueError, match="prepare_weights"):
        K4.wavenet_block(y, cond, params, dilation=1)
    # widths and dilations the kernel does not take (any d >= 1 is taken)
    for C, d in ((96, 1), (576, 1), (512, 0)):
        yc, cc = _k4_acts(rng, 1, 64, C, cuda)
        with pytest.raises(ValueError, match="C % 64"):
            K4.wavenet_block(yc, cc, K4.prepare_weights(*_k4_params(rng, C, cuda)), dilation=d)
    assert K4.launches == before


@pytest.mark.parametrize("T", [100, 2048, 2049])
@pytest.mark.parametrize("d", [1, 2, 4, 8, 16, 64])
@pytest.mark.parametrize("C", [192, 256, 512])
def test_wavenet_block_edge_shapes_match_plain(cuda, C, d, T):
    """The GEMM-core K4 at the widths and dilations its tap loads must get
    right: T off the 128-row tile, and reaches past a whole tile."""
    rng = np.random.default_rng(C + d + T)
    y, cond = _k4_acts(rng, 2, T, C, cuda)
    params = _k4_params(rng, C, cuda)
    before = K4.launches
    got = K4.wavenet_block(y, cond, K4.prepare_weights(*params), dilation=d)
    torch.cuda.synchronize()
    assert K4.launches == before + 1
    _rel_close(got, K4.wavenet_block_plain(y, cond, *params, dilation=d))


def test_wavenet_block_raises_on_tma_operands(cuda):
    """Operands TMA cannot read: a misaligned or a non-contiguous y or cond_proj."""
    rng = np.random.default_rng(12)
    y, cond = _k4_acts(rng, 1, 64, 128, cuda)
    weights = K4.prepare_weights(*_k4_params(rng, 128, cuda))
    before = K4.launches
    shifted = torch.zeros(64 * 128 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(1, 64, 128)
    with pytest.raises(ValueError, match="aligned"):
        K4.wavenet_block(shifted, cond, weights, dilation=1)
    with pytest.raises(ValueError, match="contiguous"):
        K4.wavenet_block(torch.zeros(1, 128, 64, device=cuda, dtype=torch.bfloat16)
                         .transpose(1, 2), cond, weights, dilation=1)
    with pytest.raises(ValueError, match="contiguous"):
        K4.wavenet_block(y, torch.zeros(1, 256, 64, device=cuda, dtype=torch.bfloat16)
                         .transpose(1, 2), weights, dilation=1)
    assert K4.launches == before


def test_wavenet_denoiser_apply_on_card_matches_f32_module(cuda):
    """The bf16 kernel-path WaveNet apply against the f32 module on the card
    (TF32 off): bf16 compounded over 8 layers, so corr > 0.999 and 5 % of
    the scale, the bar of the LYNX apply above."""
    from xiaoicesing_io_tpu_torch.models.backbones import build_backbone
    from xiaoicesing_io_tpu_torch.models.backbones.wavenet_cuda import wavenet_denoiser_apply

    torch.manual_seed(0)
    M, H, C = 32, 64, 256
    net = build_backbone(M, 1, "wavenet", {"num_channels": C, "num_layers": 8,
                                           "dilation_cycle_length": 4},
                         cond_dims=H).eval().to(cuda)
    with torch.no_grad():
        net.output_projection.weight.normal_(0.0, 0.05)
    spec = torch.randn(2, 1, 384, M, device=cuda)
    step = torch.tensor([30.0, 700.0], device=cuda)
    cond = torch.randn(2, 384, H, device=cuda)
    with torch.no_grad():
        ref = net(spec, step, cond)
        before = K4.launches
        got = wavenet_denoiser_apply(net, spec, step, cond)
        torch.cuda.synchronize()
    assert K4.launches == before + 8
    _rel_close(got, ref, tol=0.05, min_corr=0.999)


# ---------------------------------------------------------------------------
# K3: the fused STFT -> log-mel kernel.  f32 on both sides: against the plain
# matrix-product DFT (f32, TF32 off) within 2e-3 nats, the bar at which the
# JAX package holds its own f32 DFT against numpy; against the host path
# (numpy, f64 FFT) within 1e-3 nats.  Frame counts must be equal.
# ---------------------------------------------------------------------------

K3_TOL_PLAIN = 2e-3
K3_TOL_NUMPY = 1e-3


def _mel_cfg(n_fft, win):
    from xiaoicesing_io_tpu_torch.ops.mel import MelConfig

    if n_fft == 256:  # the small configuration of the mel tests
        return MelConfig(sample_rate=16000, n_mels=64, n_fft=256, win_size=win, hop_size=64,
                         fmin=30.0, fmax=8000.0)
    return MelConfig(n_fft=n_fft, win_size=win, hop_size=n_fft // 4)


@pytest.mark.parametrize("B", [1, 2, 4])
@pytest.mark.parametrize("win_quarters", [4, 3])
@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048])
def test_mel_spec_kernel_matches_plain_and_numpy(cuda, n_fft, win_quarters, B):
    from xiaoicesing_io_tpu_torch.ops.mel import MelSpectrogram

    cfg = _mel_cfg(n_fft, n_fft * win_quarters // 4)
    ext = MelSpectrogram(cfg)
    rng = np.random.default_rng(n_fft + B)
    T = cfg.hop_size * 150 + 77 + B  # off any bucket
    y_np = rng.uniform(-0.5, 0.5, (B, T)).astype(np.float32)
    y = torch.from_numpy(y_np).to(cuda)
    before = K3.launches
    got = K3.mel_spectrogram(y, ext.prepared(cuda))
    torch.cuda.synchronize()
    assert K3.launches == before + 1
    plain = ext.torch(y)
    ref = ext.numpy(y_np)
    assert got.shape == plain.shape == ref.shape
    assert torch.isfinite(got).all()
    assert (got - plain).abs().max().item() <= K3_TOL_PLAIN
    assert np.abs(got.cpu().numpy() - ref).max() <= K3_TOL_NUMPY


def test_mel_spec_kernel_raises_instead_of_falling_back(cuda):
    from xiaoicesing_io_tpu_torch.ops.mel import MelConfig

    y = torch.zeros(2, 8192, device=cuda)
    before = K3.launches
    for n_fft in (384, 4096, 128):  # not a power of two, too large, too small
        prep = K3.prepare_mel(MelConfig(sample_rate=16000, n_mels=32, n_fft=n_fft,
                                        win_size=n_fft, hop_size=64, fmin=30.0, fmax=8000.0),
                              cuda)
        with pytest.raises(ValueError, match="power-of-two n_fft"):
            K3.mel_spectrogram(y, prep)
    prep = K3.prepare_mel(_mel_cfg(256, 256), cuda)
    for dtype in (torch.float16, torch.bfloat16):
        with pytest.raises(TypeError, match="f32"):
            K3.mel_spectrogram(y.to(dtype), prep)
    with pytest.raises(ValueError, match="contiguous"):
        K3.mel_spectrogram(torch.zeros(8192, 2, device=cuda).t(), prep)
    with pytest.raises(ValueError, match="prepare_mel"):
        K3.mel_spectrogram(y, K3.prepare_mel(_mel_cfg(256, 256), "cpu"))
    assert K3.launches == before


def test_mel_device_launches_once_per_call(cuda):
    """``MelSpectrogram.device`` on a CUDA tensor: bucket padding, then one
    K3 launch, whatever B; the true frames match the host path."""
    from xiaoicesing_io_tpu_torch.ops.mel import MelConfig, MelSpectrogram, num_frames

    cfg = MelConfig()
    ext = MelSpectrogram(cfg)
    rng = np.random.default_rng(5)
    for B in (1, 2):
        T = 3 * cfg.hop_size * 100 + 77
        y = rng.uniform(-0.5, 0.5, (B, T)).astype(np.float32)
        before = K3.launches
        got = ext.device(torch.from_numpy(y).to(cuda), bucket_frames=64)
        torch.cuda.synchronize()
        assert K3.launches == before + 1
        n = num_frames(T, cfg.win_size, cfg.hop_size)
        assert got.shape == (B, num_frames(-(-T // (64 * 512)) * 64 * 512, 2048, 512), 128)
        ref = ext.numpy(y)
        # bucket padding changes the reflected tail: the last 2 true frames differ
        assert np.abs(got[:, : n - 2].cpu().numpy() - ref[:, : n - 2]).max() <= K3_TOL_NUMPY


def test_copy_synthesis_on_card_launches_k3_once(cuda, tmp_path):
    """One short file through ``copy_synthesis`` on the card with a random
    narrow vocoder: one K3 launch (the scored pair), K2 on stages 0 and 1."""
    import json

    from scipy.io import wavfile

    from xiaoicesing_io_tpu_torch.inference.val_vocoder import copy_synthesis
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import (
        Generator, NsfHifiganConfig,
    )
    from xiaoicesing_io_tpu_torch.ops.mel import num_frames
    from xiaoicesing_io_tpu_torch.utils.audio import save_wav

    vcfg = dict(num_mels=128, sampling_rate=44100, hop_size=512, n_fft=2048, win_size=2048,
                fmin=40, fmax=16000, upsample_rates=[8, 8, 2, 2, 2],
                upsample_kernel_sizes=[16, 16, 4, 4, 4], upsample_initial_channel=64,
                resblock="1", resblock_kernel_sizes=[3, 7, 11],
                resblock_dilation_sizes=[[1, 3, 5]] * 3)
    torch.manual_seed(0)
    torch.save({"generator": Generator(NsfHifiganConfig.from_json(vcfg)).state_dict()},
               tmp_path / "model.ckpt")
    (tmp_path / "config.json").write_text(json.dumps(vcfg))
    cfg = {"audio_sample_rate": 44100, "audio_num_mel_bins": 128, "fft_size": 2048,
           "win_size": 2048, "hop_size": 512, "fmin": 40, "fmax": 16000, "f0_min": 65,
           "f0_max": 1100, "mel_base": "e", "vocoder_ckpt": str(tmp_path / "model.ckpt")}
    t = np.arange(44100) / 44100
    save_wav(0.3 * np.sin(2 * np.pi * 220 * t), tmp_path / "tone.wav", 44100)
    k2, k3 = K2.launches, K3.launches
    (res,) = copy_synthesis([tmp_path / "tone.wav"], cfg, tmp_path / "out", device="cuda")
    assert K3.launches == k3 + 1
    assert K2.launches > k2
    assert np.isfinite(res["mel_mae"]) and np.isfinite(res["pesq"])
    sr, rec = wavfile.read(res["out"])
    assert sr == 44100 and len(rec) == num_frames(44100, 2048, 512) * 512
