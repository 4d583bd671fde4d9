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

from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_stage as K2
from xiaoicesing_io_tpu_torch.ops.cuda import lynx_conv as K1

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


def _stage(rng, L, kernels, dils, device):
    specs, weights, biases = [], [], []
    for k, ds in zip(kernels, dils):
        branch = []
        for d in ds:
            pair = []
            for dd in (d, 1):
                w = 0.1 * rng.standard_normal((k, L, L)) / np.sqrt(k)
                weights.append(K2.stack_taps(w.astype(np.float32)).to(device, torch.bfloat16)
                               .contiguous())
                biases.append(torch.tensor(0.1 * rng.standard_normal(L), dtype=torch.float32,
                                           device=device))
                pair.append(K2.ConvSpec(k, dd, (k - 1) * dd // 2))
            branch.append(tuple(pair))
        specs.append(tuple(branch))
    return tuple(specs), weights, biases


@pytest.mark.parametrize("L,T,kernels,dils", [
    (128, 777, (3, 7, 11), ((1, 3, 5),) * 3),   # the HiFiGAN default, ragged T
    (256, 300, (3, 7, 11), ((1, 3, 5),) * 3),   # stage-0 width
    (128, 257, (3, 5), ((1, 2), (2, 6))),       # other geometry, two branches
    (64, 200, (3, 7, 11), ((1, 3, 5),) * 3),    # fewer column fragments than warps
    (192, 130, (3, 7, 11), ((1, 3, 5),) * 3),   # warps with one and two fragments
    (384, 100, (3, 7, 11), ((1, 3, 5),) * 3),   # three fragments per warp, 64-row tiles
    (512, 100, (3, 7, 11), ((1, 3, 5),) * 3),   # the widest
])
def test_resblock_stage_kernel_matches_plain(cuda, L, T, kernels, dils):
    rng = np.random.default_rng(1)
    specs, w, b = _stage(rng, L, kernels, dils, cuda)
    x = torch.tensor(rng.standard_normal((2, T, L)), dtype=torch.float32,
                     device=cuda).to(torch.bfloat16)
    before = K2.launches
    got = K2.fused_resblock_stage(x, w, b, specs)
    torch.cuda.synchronize()
    assert K2.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _rel_close(got, K2.fused_resblock_stage_plain(x, w, b, specs))


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
    # an operand that is not aligned for the kernel's vector and WMMA loads
    shifted = torch.zeros(16 * 128 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(1, 16, 128)
    with pytest.raises(ValueError, match="aligned"):
        K1.lynx_conv_module(shifted, weights)
    specs, w, b = _stage(rng, 128, (3,), ((1,),), cuda)
    with pytest.raises(TypeError, match="bf16"):
        K2.fused_resblock_stage(x, w, b, specs)
    w_shifted = [torch.cat([torch.zeros(8, device=cuda, dtype=torch.bfloat16), t.flatten()])[8:]
                 .view(t.shape) for t in w]
    with pytest.raises(ValueError, match="aligned"):
        K2.fused_resblock_stage(x.to(torch.bfloat16), w_shifted, b, specs)
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
