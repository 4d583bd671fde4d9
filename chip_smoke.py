#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the card (name and power limit, from nvidia-smi);
  2. the build of every CUDA kernel from ``xiaoicesing_io_tpu_torch/csrc``,
     then one line a compiled kernel from its ``-Xptxas -v`` log: its name
     with its template arguments, registers, stack frame and spill bytes
     (marked ``SPILLS`` where it spills);
  3. K1 ``lynx_conv_module`` against its plain PyTorch version at three edge
     shapes (T off the 128-row tile and the conv's 64-row block, k 31, 32
     and 3, dim 1024 and 256) and at the LYNXNet path's shape (B=4, T=2048,
     dim 1024, inner 2048, k 31; bf16); at the latter its time, the time of
     its two products as cuBLAS bf16 products (``gemm_library_ms``, the
     yardstick of the GEMM core ``csrc/sm90_gemm.cuh``), the host
     microseconds per wrapper call and the device time of each of its passes
     (``torch.profiler``);
  4. K2 ``fused_resblock_stage`` against its plain version at vocoder stages 0
     and 1 of the same batch (L=256 at T*8 rows, L=128 at T*64 rows; bf16);
     per stage its time, the unfused bf16 cuDNN chain's, ``gemm_library_ms``
     (each conv's taps as one cuBLAS product ``[rows, L] @ [L, k L]``, the
     products alone), the host microseconds per call and the device split of
     its leaky-ReLU pass, first convs and second convs;
  5. K4 ``wavenet_block`` against its plain version at three edge shapes (T
     off the tile, d 64, C 192 and 256) and at the WaveNet path's shape (B=4,
     T=2048, C=512) for each dilation d of its cycle, 1, 2, 4, 8; its
     ``gemm_library_ms`` (the three tap products and the output product as
     cuBLAS bf16 products), host microseconds per call and per-launch device
     times as for K1;
  6. the LYNXNet + rectified-flow configuration (``configs/acoustic.json``)
     at full width with random weights: one sample ``.ds``, every segment,
     through the port's ``DiffSingerAcousticInfer.run_inference`` and the
     NSF-HiFiGAN vocoder in its default time-folded layout (the launch
     counters are zeroed just before it and read just after); the wav must
     be finite and of the right length, K1 must have launched once per layer
     per step per segment (6 x 20 x 10), and per segment's vocoder call K2
     exactly twice (stages 0 and 1) and K6 exactly 27 times (the ResBlock1
     units of stages 2-4).  Then one segment through the kernel path and
     through the f32 module path (the stock generator in f32): mel and wav
     must agree.  Then a batched timing at B=4, T=2048, 20 Euler steps;
  7. the WaveNet + DDPM configuration (the same file with a 512 x 20 WaveNet,
     dilation cycle 4, and a linear 1000-step DDPM core, K_step 400, DDIM at
     speedup 10: 40 steps), at full width with random weights saved under the
     reference names (``diffusion.denoise_fn.*`` and the schedule buffers):
     the same ``.ds`` run, where K4 must launch 20 x 40 times per segment
     and K2 and K6 as in phase 6, the same kernel-path vs f32 check, and a
     batched timing at B=4, T=2048, 40 DDIM steps;
  8. vocoder copy-synthesis (``inference/val_vocoder.copy_synthesis`` on the
     card) with the random full-width vocoder of phase 6, on two files: the
     wav phase 6 rendered from the sample ``.ds`` and a synthetic 2048-frame
     (23.8 s) harmonic tone with vibrato around 220 Hz and noise at -40 dB,
     written at 22.05 kHz so that loading resamples it.  Each output wav must
     be finite with frames*hop samples, K3 must launch once per file, K2
     twice and K6 27 times per file; each file's K3-scored mel MAE must
     agree with the same pair scored through K3's plain version within
     1e-4, and the synthetic clip's tracked f0 must be within 50 cents RMSE
     of its known curve, with voicing agreement > 0.9.  Per-file stage
     times are printed;
  9. the sampler sweep (``tools/perf_sweep.py``, the cell lynx_variants):
     the shipped LYNXNet 1024 x 6 with random weights, B=4, T=2048, 50
     Euler steps from T_start 0.4, in every mode (module, v1, v2, v3,
     hybrid), with the launch counters zeroed just before each mode's call
     and read just after: v1 must launch K1, v2 K5, v3 K7 and hybrid K8
     6 x 50 = 300 times, and nothing else; the module mode none.  The
     denormed mel of v2, v3 and hybrid must agree with v1's within 5 % of
     its scale, corr > 0.999 (the module mode's is recorded).  Then ms per
     step for each mode.
 10. the vocoder sweep (``tools/perf_sweep.py vocoder``, the cell
     vocoder_variants): the shipped NSF-HiFiGAN with random weights, a mel
     ~ N(0, 1) [4, 2048, 128] and f0 = 220 Hz, in the folded layout at each
     ``pallas_stages`` config (), (1,), (0,), (0, 1), (0, 1, 2), with the
     launch counters zeroed just before each config's call and read just
     after: K2 must launch len(stages) times and K6 9 x (5 - len(stages))
     times, and nothing else.  Each config's wav must agree with ()'s within
     2e-2, corr > 0.999.  The stock layout on the same weights and inputs
     (K2 twice, no K6) must agree with (0, 1)'s at corr > 0.99.  Then ms per
     call and audio-s/s of each.

Phase 5d (after phase 5c, so ``--kernels-only`` covers it) holds K6
``resblock_unit`` against its plain version on the folded stage-2 unit with
the widest taps (k 11, d 5: 27 + 7 folded taps, 17 + 7 of them not all
zero, L = 128) at B=4 x 131072 rows, a raw dilated unit at L = 256 (k 11,
d 5, 16384 rows a sequence) and
a folded unit at a T off the kernel's 128-row tile; then it times the 45
ResBlock1 units of one random full-width folded generator at B=4, T=2048,
stage by stage, against the plain version, the unfused cuDNN bf16 chain
(the folded layout's arithmetic in the JAX package) and ``gemm_library_ms``
(each conv's kept taps as one cuBLAS product); then the host microseconds
per call and the device split of the 27 units' leaky-ReLU passes, first and
second convs.  K6's ``ms``, ``plain_ms``, ``bound_ms`` and
``gemm_library_ms`` are the sums over the 27 units of stages 2-4, which the
wrapper's default sends to K6.

Phase 5c (after phase 5b, so ``--kernels-only`` covers it) holds K5
``lynx_layer_fused`` and K7 ``lynx_layer_fused_v3`` (both on the GEMM core,
K7's products on its persistent entry) against their plain version at four
edge shapes (fewer tiles than SMs, a ragged last row tile, dim 1536 and dim
2048 with inner 4096) and at B=4, T=2048, dim 1024, inner 2048, k 31; at the
latter each one's time, ``gemm_library_ms`` (the layer's two products as
cuBLAS bf16 products alone), host microseconds per call and the device
split of its four launches (LayerNorm, SwiGLU product, conv, output
product), then K7's two products beside K5's.  Then K8 ``conv_tail`` (on
the GEMM core too, since its redesign) against its plain version on the
PyTorch head's output at the same four edge shapes and at the sweep's shape
(the head's output for the same ``x``); at the latter its time, the head's,
``gemm_library_ms`` (its output product ``act @ w2`` as one cuBLAS bf16
product), host microseconds per call and the device split of its two
launches (conv, output product).

Phase 5b (after phase 5, so ``--kernels-only`` covers it) holds K3
``mel_spectrogram`` at the shipped ``MelConfig`` (44.1 kHz, n_fft = win 2048,
hop 512, 128 Slaney mels) against its plain version (the f32 matrix-product
DFT, TF32 off) within 2e-3 nats and against the host path (numpy, f64 FFT)
within 1e-3 nats over the true frames less the last 2 (bucket padding
changes the reflected tail), at B=4 x 2048 frames of uniform noise in
[-0.5, 0.5] and at B=2 with an off-bucket length; shapes must be equal.
Its ``library_ms`` is ``torch.stft`` (cuFFT) + the dense mel product + log on
the same input, timed here only.  Then, at the timed shape, K3's host
microseconds per call and its per-phase split (``[K3 split]``: copies of
``csrc/mel_spec.cu`` cut after each of its phases, built beside the kernels
and timed in turns with it).

Tolerance of a kernel against its plain version (same inputs, bf16 products,
TF32 off): max |kernel - plain| <= 0.02 * max |plain| and correlation >
0.9999.  K1 and K2 differ from their plain versions by f32 summation order
and the bf16 rounding of intermediates that the order flips, about one bf16
ulp (0.4 %) on a few elements; K4's plain version is the unfused bf16 chain,
which also rounds the conv output to bf16 before the gating.  The bf16 kernel
path against the f32 path compounds bf16 rounding over the layers and
steps: mel within 5 % of its scale, corr > 0.999; wav corr > 0.99.

Since the redesign of K1 and K4 on the Hopper GEMM core, phases 3 and 5
also cover the edge shapes above and print ``gemm_library_ms``, the host
cost per call and the per-pass device split; since that of K2 and K6 on the
same core, phases 4 and 5d do too, and since that of K5, K7 and K8, phase 5c.
The entries of K1, K2, K4, K5, K6, K7 and K8 in the kernels line carry
``gemm_library_ms`` and ``host_us`` (K2's and K6's also ``cudnn_bf16_ms``);
K3's carries ``host_us``.
Phases 6 and 7 print the device's busy share of ``synthesize`` and phase 9
that of the ``module``, ``v1``, ``v2`` and ``v3`` sweep calls: the kernel
time of one call in a device-only ``torch.profiler`` window over the host
time of the same work.

Any failure raises: the script exits non-zero and prints no result.  The
line before the last lists the kernels as JSON (``ms``, ``plain_ms`` and
``bound_ms`` at the phase 3-5 shapes; K2's are the sum of its two stage
calls, K4's the mean over its four dilations, K6's the sum over the 27
units of stages 2-4; ``launches`` are wrapper calls in the ``.ds`` run of
the configuration that runs the kernel: phase 6 for K1, K2 and K6, phase 7
for K4; phase 8 for K3; phase 9, in the mode that runs it, for K5, K7 and
K8).  The last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
HBM_BYTES = 3.35e12   # H100 SXM HBM3 bandwidth
TOL_REL = 0.02
TOL_CORR = 0.9999

B_TIME, T_TIME = 4, 2048


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int, rounds: int = 3) -> float:
    """Device ms per call of ``fn``: ``reps`` calls back to back between two
    events, the median of ``rounds`` such rounds (a host stall inside one
    round idles the device and would count as kernel time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def compare(name: str, got, ref) -> float:
    import torch

    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    corr = torch.corrcoef(torch.stack([got.flatten(), ref.flatten()]))[0, 1].item()
    log(f"[check] {name}: max_abs_err={err:.6g} max_abs_ref={scale:.6g} corr={corr:.8f} "
        f"(tolerance: err <= {TOL_REL} * max_abs_ref, corr > {TOL_CORR})")
    if not (err <= TOL_REL * scale and corr > TOL_CORR):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def bound_ms(bytes_moved: float, bf16_flops: float, f32_flops: float = 0.0):
    """The least time for the work: the largest of the bytes over the memory
    rate, the bf16 products over the tensor cores' rate and the f32 work over
    the CUDA cores' rate (separate pipes, which can overlap)."""
    t_bytes = bytes_moved / HBM_BYTES * 1e3
    t_ops = max(bf16_flops / BF16_FLOPS, f32_flops / F32_FLOPS) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def counters():
    """(name in the kernels line, wrapper module, counter attribute) of every
    kernel."""
    from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_resblock as K6
    from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_stage as K2
    from xiaoicesing_io_tpu_torch.ops.cuda import lynx_conv as K1
    from xiaoicesing_io_tpu_torch.ops.cuda import lynx_hybrid as K8
    from xiaoicesing_io_tpu_torch.ops.cuda import lynx_layer as K5
    from xiaoicesing_io_tpu_torch.ops.cuda import mel_spec as K3
    from xiaoicesing_io_tpu_torch.ops.cuda import wavenet_block as K4

    return (("lynx_conv_module", K1, "launches"), ("fused_resblock_stage", K2, "launches"),
            ("mel_spectrogram", K3, "launches"), ("wavenet_block", K4, "launches"),
            ("lynx_layer_fused", K5, "launches_v2"), ("lynx_layer_fused_v3", K5, "launches_v3"),
            ("lynx_conv_tail", K8, "launches"), ("resblock_unit", K6, "launches"))


def zero_launch_counts() -> None:
    for _, module, attr in counters():
        setattr(module, attr, 0)


def launch_counts() -> dict:
    return {name: getattr(module, attr) for name, module, attr in counters()}


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def k1_inputs(B: int, T: int, dim: int = 1024, inner: int = 2048, k: int = 31, seed: int = 0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    x = rn(B, T, dim).to(torch.bfloat16)
    params = (
        1.0 + rn(dim, std=0.1), rn(dim, std=0.1),
        rn(dim, 2 * inner, std=dim ** -0.5), rn(2 * inner, std=0.05),
        rn(k, 1, inner, std=k ** -0.5), rn(inner, std=0.05),
        torch.full((inner,), 0.25, device="cuda"),
        rn(inner, dim, std=inner ** -0.5), rn(dim, std=0.05),
    )
    return x, params


def k1_bound(B, T, dim=1024, inner=2048, k=31):
    rows = B * T
    mm = 2 * rows * dim * 2 * inner + 2 * rows * inner * dim
    conv = 2 * rows * inner * k
    nbytes = rows * dim * 2 * 2 + (dim * 2 * inner + inner * dim) * 2 + (2 * dim + 5 * inner
                                                                          + k * inner) * 4
    return bound_ms(nbytes, mm, conv)


def _kernel_us(fn, calls: int) -> dict:
    """Device microseconds per call of each kernel (or copy) ``fn`` launches,
    from a device-only ``torch.profiler`` window over ``calls`` calls (with
    host activity on too, the trace undercounts the kernels launched through
    ctypes); the entries without host time are the device's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / calls for e in prof.key_averages()
            if e.self_cpu_time_total == 0 and e.self_device_time_total > 0}


def device_split(fn, calls: int = 10) -> str:
    """Device microseconds per call of each kernel ``fn`` launches; "not
    measured" when the trace holds no device time."""
    parts = _kernel_us(fn, calls)
    if not parts:
        return "not measured (no device time in the trace)"
    return "; ".join(f"{name[:90]}: {us:.1f} us"
                     for name, us in sorted(parts.items(), key=lambda kv: -kv[1]))


def labelled_split(fn, labels: dict, calls: int = 3):
    """Device microseconds per call of ``fn``'s kernels summed under
    ``labels`` (label -> pieces of the kernels' names); None when the trace
    holds no device time."""
    parts = _kernel_us(fn, calls)
    if not parts:
        return None
    out = {label: 0.0 for label in labels}
    for name, us in parts.items():
        label = next((k for k, pieces in labels.items() if any(p in name for p in pieces)),
                     "other")
        out[label] = out.get(label, 0.0) + us
    return out


def split_text(split) -> str:
    if split is None:
        return "not measured (no device time in the trace)"
    total = sum(split.values())
    return "; ".join(f"{k}: {us:.1f} us ({us / total:.3f})" for k, us in split.items())


# the launches of K2 and K6: the leaky-ReLU pass, conv 1 (bias + lrelu epilogue), conv 2
TAPCONV_PARTS = {"lrelu pass": ("lrelu_kernel",), "conv 1": ("BiasLreluBf16",),
                 "conv 2": ("ResidualBf16", "StageEpi")}


def device_busy_ms(fn) -> float:
    """Device milliseconds of the kernels and copies of one call of ``fn``
    (their sum: one stream, so they do not overlap); 0 when not measured."""
    return sum(_kernel_us(fn, 1).values()) / 1e3


def host_us(fn, calls: int = 50) -> float:
    """Host microseconds per call of a wrapper, the device left running: the
    enqueue alone (checks, tensor maps, allocation, the ctypes call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


# K1's edge shapes: T off the 128-row tile and the conv's 64-row block, odd and even kernels
K1_EDGES = ((1, 37, 1024, 2048, 31), (4, 2049, 1024, 2048, 32), (1, 1000, 256, 512, 3))


def check_k1(reps: int = 20) -> dict:
    import torch

    from xiaoicesing_io_tpu_torch.ops.cuda import lynx_conv as K1

    errs = []
    for B, T, dim, inner, k in K1_EDGES:
        x, params = k1_inputs(B, T, dim, inner, k, seed=T)
        got = K1.lynx_conv_module(x, K1.prepare_weights(*params), kernel_size=k)
        torch.cuda.synchronize()
        errs.append(compare(f"K1 lynx_conv_module [B={B},T={T},dim={dim},inner={inner},k={k}]",
                            got, K1.lynx_conv_module_plain(x, *params, kernel_size=k)))
    B, T, k = B_TIME, T_TIME, 31
    x, params = k1_inputs(B, T)
    weights = K1.prepare_weights(*params)
    got = K1.lynx_conv_module(x, weights, kernel_size=k)
    torch.cuda.synchronize()
    ref = K1.lynx_conv_module_plain(x, *params, kernel_size=k)
    errs.append(compare("K1 lynx_conv_module [B=4,T=2048,dim=1024,inner=2048,k=31]", got, ref))
    ms = cuda_ms(lambda: K1.lynx_conv_module(x, weights, kernel_size=k), reps)
    plain_ms = cuda_ms(lambda: K1.lynx_conv_module_plain(x, *params, kernel_size=k), 3)
    # the yardstick of the GEMM core: the module's two products as cuBLAS bf16 products
    xn, act = x.reshape(B * T, -1), torch.zeros(B * T, 2048, dtype=torch.bfloat16, device="cuda")
    w_in, w2 = weights[2], weights[7]
    gemm_ms = cuda_ms(lambda: (torch.matmul(xn, w_in), torch.matmul(act, w2)), reps)
    us = host_us(lambda: K1.lynx_conv_module(x, weights, kernel_size=k))
    log(f"[K1 split] {device_split(lambda: K1.lynx_conv_module(x, weights, kernel_size=k))}")
    bms, by = k1_bound(B, T)
    log(f"[K1] ms={ms:.4f} plain_ms={plain_ms:.4f} gemm_library_ms={gemm_ms:.4f} "
        f"bound_ms={bms:.4f} ({by}) share_of_bound={bms / ms:.3f} host_us_per_call={us:.1f}")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "gemm_library_ms": gemm_ms, "host_us": us}


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def k2_inputs(B: int, T: int, L: int, seed: int = 0):
    import torch

    from xiaoicesing_io_tpu_torch.ops.cuda.hifigan_stage import ConvSpec

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, T, L, generator=g, device="cuda").to(torch.bfloat16)
    weights, biases, specs = [], [], []
    for k, dils in zip((3, 7, 11), ((1, 3, 5),) * 3):
        branch = []
        for d in dils:
            pair = []
            for dd in (d, 1):
                w = torch.randn(L, k * L, generator=g, device="cuda") * (0.5 / math.sqrt(k * L))
                weights.append(w.to(torch.bfloat16).contiguous())
                biases.append(torch.randn(L, generator=g, device="cuda") * 0.05)
                pair.append(ConvSpec(k=k, d=dd, pad_l=(k - 1) * dd // 2))
            branch.append(tuple(pair))
        specs.append(tuple(branch))
    return x, tuple(weights), tuple(biases), tuple(specs)


def k2_bound(B, T, L, specs):
    rows = B * T
    taps = sum(s.k for branch in specs for pair in branch for s in pair)
    mm = 2 * rows * L * L * taps
    nbytes = rows * L * 2 * 2 + taps * L * L * 2 + len(specs) * 6 * L * 4
    return bound_ms(nbytes, mm)


def products(a, weights) -> None:
    """``a @ w`` for each ``w`` (cuBLAS), each output dropped before the next."""
    import torch

    for w in weights:
        torch.matmul(a, w)


def cudnn_bf16_stage(x, convs, biases, specs):
    """The stage as unfused bf16 cuDNN convolutions (each conv's output, the
    residual stream and the branch sum in bf16), timed beside K2; ``convs``
    are ``[C_out, C_in, k]`` bf16, ``biases`` bf16."""
    import torch.nn.functional as F

    acc, ci = None, 0
    for branch in specs:
        h = x
        for pair in branch:
            t = h
            for s in pair:
                t = F.leaky_relu(t, 0.1).transpose(1, 2)
                t = F.conv1d(F.pad(t, (s.pad_l, (s.k - 1) * s.d - s.pad_l)), convs[ci],
                             dilation=s.d).transpose(1, 2) + biases[ci]
                ci += 1
            h = h + t
        acc = h if acc is None else acc + h
    return acc / len(specs)


def check_k2(reps: int = 3) -> dict:
    import torch

    from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_stage as K2

    total = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "stage_ms": [],
             "gemm_library_ms": 0.0, "cudnn_bf16_ms": 0.0, "host_us": 0.0}
    by = "operations"
    for stage, (T, L) in enumerate(((T_TIME * 8, 256), (T_TIME * 64, 128))):
        x, w, b, specs = k2_inputs(B_TIME, T, L, seed=stage)
        got = K2.fused_resblock_stage(x, w, b, specs)
        torch.cuda.synchronize()
        ref = K2.fused_resblock_stage_plain(x, w, b, specs)
        err = compare(f"K2 fused_resblock_stage stage {stage} [B={B_TIME},T={T},L={L}]", got, ref)
        del got, ref
        ms = cuda_ms(lambda: K2.fused_resblock_stage(x, w, b, specs), reps)
        plain_ms = cuda_ms(lambda: K2.fused_resblock_stage_plain(x, w, b, specs), 1)
        ks = [s.k for branch in specs for pair in branch for s in pair]
        convs = [K2.unstack_taps(wi, k).permute(2, 1, 0).contiguous() for wi, k in zip(w, ks)]
        b16 = [bi.to(x.dtype) for bi in b]
        cudnn_ms = cuda_ms(lambda: cudnn_bf16_stage(x, convs, b16, specs), reps)
        # the yardstick of the GEMM core: each conv's taps as one cuBLAS product [rows, L] @ [L, kL]
        rows = x.reshape(-1, L)
        gemm_ms = cuda_ms(lambda: products(rows, w), reps)
        us = host_us(lambda: K2.fused_resblock_stage(x, w, b, specs), calls=20)
        split = labelled_split(lambda: K2.fused_resblock_stage(x, w, b, specs), TAPCONV_PARTS)
        bms, by_s = k2_bound(B_TIME, T, L, specs)
        log(f"[K2 stage {stage}] ms={ms:.4f} plain_ms={plain_ms:.4f} cudnn_bf16_ms={cudnn_ms:.4f} "
            f"gemm_library_ms={gemm_ms:.4f} bound_ms={bms:.4f} ({by_s}) "
            f"share_of_bound={bms / ms:.3f} host_us_per_call={us:.1f}")
        log(f"[K2 stage {stage} split] {split_text(split)}")
        total["max_abs_err"] = max(total["max_abs_err"], err)
        total["stage_ms"].append(ms)
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bms),
                       ("gemm_library_ms", gemm_ms), ("cudnn_bf16_ms", cudnn_ms), ("host_us", us)):
            total[key] += v
        by = by_s if by_s == "bytes" else by
        del x, w, b, b16, convs, rows
    total["host_us"] /= 2
    log(f"[K2] stages 0 + 1: ms={total['ms']:.4f} plain_ms={total['plain_ms']:.4f} "
        f"cudnn_bf16_ms={total['cudnn_bf16_ms']:.4f} gemm_library_ms="
        f"{total['gemm_library_ms']:.4f} bound_ms={total['bound_ms']:.4f} "
        f"share_of_bound={total['bound_ms'] / total['ms']:.3f} host_us_per_call (mean of the "
        f"stages)={total['host_us']:.1f}")
    torch.cuda.empty_cache()
    return dict(total, bound_by=by)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

K4_DILATIONS = (1, 2, 4, 8)


def k4_inputs(B: int, T: int, C: int = 512, seed: int = 0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    y = rn(B, T, C, std=0.5).to(torch.bfloat16)
    cond = rn(B, T, 2 * C, std=0.5).to(torch.bfloat16)
    params = (rn(3, C, 2 * C, std=(3 * C) ** -0.5), rn(2 * C, std=0.05),
              rn(C, 2 * C, std=C ** -0.5), rn(2 * C, std=0.05))
    return y, cond, params


def k4_bound(B, T, C=512):
    rows = B * T
    mm = 4 * 2 * rows * C * 2 * C
    nbytes = rows * C * 2 + 2 * rows * 2 * C * 2 + 4 * C * 2 * C * 2 + 2 * 2 * C * 4
    return bound_ms(nbytes, mm)


# K4's edge shapes: T off the tile, a reach past a whole tile, the variance widths
K4_EDGES = ((2, 2049, 512, 64), (1, 100, 192, 16), (4, 2048, 256, 8))


def check_k4(reps: int = 20) -> dict:
    import torch

    from xiaoicesing_io_tpu_torch.ops.cuda import wavenet_block as K4

    errs, times, plain_times = [], [], []
    for B, T, C, d in K4_EDGES:
        y, cond, params = k4_inputs(B, T, C, seed=T + d)
        got = K4.wavenet_block(y, cond, K4.prepare_weights(*params), dilation=d)
        torch.cuda.synchronize()
        errs.append(compare(f"K4 wavenet_block [B={B},T={T},C={C},d={d}]", got,
                            K4.wavenet_block_plain(y, cond, *params, dilation=d)))
    B, T = B_TIME, T_TIME
    y, cond, params = k4_inputs(B, T)
    weights = K4.prepare_weights(*params)
    bms, by = k4_bound(B, T)
    for d in K4_DILATIONS:
        got = K4.wavenet_block(y, cond, weights, dilation=d)
        torch.cuda.synchronize()
        ref = K4.wavenet_block_plain(y, cond, *params, dilation=d)
        errs.append(compare(f"K4 wavenet_block [B={B},T={T},C=512,d={d}]", got, ref))
        del got, ref
        times.append(cuda_ms(lambda: K4.wavenet_block(y, cond, weights, dilation=d), reps))
        plain_times.append(cuda_ms(lambda: K4.wavenet_block_plain(y, cond, *params, dilation=d),
                                   reps))
        log(f"[K4 d={d}] ms={times[-1]:.4f} plain_ms={plain_times[-1]:.4f} bound_ms={bms:.4f} "
            f"({by}) share_of_bound={bms / times[-1]:.3f}")
    # the yardstick of the GEMM core: the three tap products and the output product as cuBLAS
    # bf16 products at C = 512
    rows = y.reshape(B * T, -1)
    taps, w_out = weights[0], weights[2]
    gemm_ms = cuda_ms(lambda: [torch.matmul(rows, w) for w in (taps[0], taps[1], taps[2], w_out)],
                      reps)
    us = host_us(lambda: K4.wavenet_block(y, cond, weights, dilation=1))
    log(f"[K4 split] d=1: {device_split(lambda: K4.wavenet_block(y, cond, weights, dilation=1))}")
    ms = sum(times) / len(times)
    log(f"[K4] ms={ms:.4f} (mean of d = {K4_DILATIONS}) gemm_library_ms={gemm_ms:.4f} "
        f"bound_ms={bms:.4f} share_of_bound={bms / ms:.3f} host_us_per_call={us:.1f}")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": sum(plain_times) / len(plain_times),
            "bound_ms": bms, "bound_by": by, "gemm_library_ms": gemm_ms, "host_us": us}


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

K3_TOL_PLAIN = 2e-3   # nats, kernel vs the f32 matrix-product DFT
K3_TOL_NUMPY = 1e-3   # nats, kernel vs the host path (f64 FFT)
K3_FRAMES = 2048


def k3_bound(prep, B: int, T: int):
    """A real FFT (2.5 n log2 n), the sparse mel projection (2 per weight) and
    the magnitudes (~3 per bin used) per frame, against the waveform read
    once and the log-mel written once."""
    frames = B * prep.num_frames(T)
    flop = frames * (2.5 * prep.n_fft * math.log2(prep.n_fft) + 2 * prep.nnz + 3 * prep.n_bins)
    nbytes = B * T * 4 + frames * prep.n_mels * 4
    return bound_ms(nbytes, 0.0, flop)


# K3's phases, in the order its source marks them; a copy of the source cut at a marker ends the
# kernel there, writing what the last kept phase left (the frame's samples or the planes' first
# words) so that nothing before it is optimised away
K3_PHASES = (("staging", "  // 1. lane n1", "x[m]"), ("step 1", "  // 2.-3. lane k2", "re[m]"),
             ("step 3", "  // 4. the real split", "re[m]"),
             ("real split", "  // 5. sparse mel", "re[m]"))


def k3_phase_split(prep, y, reps: int = 20) -> dict:
    """Device microseconds of each of K3's phases (staging, step 1, step 3,
    real split, mel projection) at ``y``'s shape: copies of
    ``csrc/mel_spec.cu`` cut after each phase, built beside the kernels and
    timed in turns with the whole kernel; a phase is the difference of two
    cuts' times."""
    import ctypes

    import torch

    from xiaoicesing_io_tpu_torch.ops.cuda import build
    from xiaoicesing_io_tpu_torch.ops.cuda import mel_spec as K3

    src = (build.CSRC / "mel_spec.cu").read_text()
    end = src.index("\ntemplate <int N1, int N2>\ncudaError_t launch")
    work = build.BUILD_DIR / "mel_phases"
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, marker, kept in K3_PHASES:
        cut = src[:src.index(marker)] + (
            "  __syncwarp();\n  float* ob = out + (static_cast<size_t>(b) * n_frames + f0 + warp)"
            f" * n_mels;\n  for (int m = lane; m < n_mels; m += 32) ob[m] = {kept};\n}}\n"
        ) + src[end:]
        cu = work / f"{name.replace(' ', '_')}.cu"
        cu.write_text(cut)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def entry(lib):
        fn = lib.mel_spec_launch
        fn.argtypes, fn.restype = K3._ARGTYPES, ctypes.c_int
        return fn

    fns = {"whole": entry(build.load("mel_spec"))}
    for name, proc in procs.items():
        log_text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"K3 split: the cut after {name} did not build:\n{log_text[-2000:]}")
        fns[name] = entry(ctypes.CDLL(str(work / f"{name.replace(' ', '_')}.so")))
    out = torch.empty(y.shape[0], prep.num_frames(y.shape[1]), prep.n_mels, device=y.device)
    args = K3.launch_args(y, prep, out)
    order = [name for name, _, _ in K3_PHASES] + ["whole"]
    ms = {name: [] for name in order}
    for rnd in range(2):  # in turns, forward then backward
        for name in (order if rnd == 0 else order[::-1]):
            ms[name].append(cuda_ms(lambda fn=fns[name]: build.check(fn(*args), "K3 split"), reps))
    t = {name: sum(v) / len(v) * 1e3 for name, v in ms.items()}
    split = {"staging": t["staging"]}
    for (prev, _, _), (name, _, _) in zip(K3_PHASES, K3_PHASES[1:]):
        split[name] = t[name] - t[prev]
    split["mel projection"] = t["whole"] - t["real split"]
    return split


def check_k3(reps: int = 20) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from xiaoicesing_io_tpu_torch.ops.cuda import mel_spec as K3
    from xiaoicesing_io_tpu_torch.ops.mel import MelConfig, MelSpectrogram, num_frames

    cfg = MelConfig()
    ext = MelSpectrogram(cfg)
    prep = ext.prepared("cuda")
    rng = np.random.default_rng(0)
    errs = []
    for B, T in ((B_TIME, K3_FRAMES * cfg.hop_size), (2, 3 * cfg.hop_size * 100 + 77)):
        y_np = rng.uniform(-0.5, 0.5, (B, T)).astype(np.float32)
        y = torch.from_numpy(y_np).cuda()
        got = ext.device(y)
        torch.cuda.synchronize()
        plain = ext.device(y, plain=True)
        ref = ext.numpy(y_np)
        n = num_frames(T, cfg.win_size, cfg.hop_size)
        if not (got.shape == plain.shape and ref.shape == (B, n, cfg.n_mels)
                and got.shape[1] >= n and torch.isfinite(got).all()):
            raise AssertionError(f"K3 shapes: kernel {tuple(got.shape)}, plain "
                                 f"{tuple(plain.shape)}, host {ref.shape}")
        err_plain = (got - plain).abs().max().item()
        err_np = float(np.abs(got[:, : n - 2].cpu().numpy() - ref[:, : n - 2]).max())
        log(f"[check] K3 mel_spectrogram [B={B},T={T},{n} frames, {got.shape[1]} bucketed]: "
            f"max_abs_err vs plain={err_plain:.6g} (tolerance {K3_TOL_PLAIN}), vs host "
            f"numpy={err_np:.6g} over {n - 2} frames (tolerance {K3_TOL_NUMPY}); "
            f"mel range [{got.min().item():.3f}, {got.max().item():.3f}]")
        if err_plain > K3_TOL_PLAIN or err_np > K3_TOL_NUMPY:
            raise AssertionError("K3 disagrees with its plain version or the host path")
        errs.append(err_plain)
        if B == B_TIME:
            y_time = y
    y = y_time
    window = torch.hann_window(cfg.win_size, device="cuda")
    pad_l, pad_r = prep.pad_l, prep.pad_r

    def library():
        ypad = F.pad(y[:, None], (pad_l, pad_r), mode="reflect")[:, 0]
        spec = torch.stft(ypad, cfg.n_fft, hop_length=cfg.hop_size, win_length=cfg.win_size,
                          window=window, center=False, return_complex=True).abs()
        return torch.log(torch.clamp(prep.mel_basis @ spec, min=cfg.clip_val)).transpose(1, 2)

    lib_err = (library() - K3.mel_spectrogram(y, prep)).abs().max().item()
    ms = cuda_ms(lambda: K3.mel_spectrogram(y, prep), reps)
    plain_ms = cuda_ms(lambda: ext.torch(y), 5)
    library_ms = cuda_ms(library, reps)
    bms, by = k3_bound(prep, B_TIME, y.shape[1])
    us = host_us(lambda: K3.mel_spectrogram(y, prep))
    frames, smem = K3.block_plan(prep.n_fft, prep.hop_size, prep.num_frames(y.shape[1]))
    log(f"[K3] ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={bms:.4f} ({by}) share_of_bound={bms / ms:.3f} host_us_per_call={us:.1f} "
        f"[B={B_TIME}, {K3_FRAMES} frames, {frames} a block, {smem} B of shared memory, FFT "
        f"{' x '.join(map(str, K3.fft_split(prep.n_fft)))}; library = torch.stft + mel product "
        f"+ log, max |library - kernel| {lib_err:.6g}]")
    log(f"[K3 split] {split_text(k3_phase_split(prep, y))} (copies of the kernel cut after "
        f"each phase, timed in turns)")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": library_ms, "host_us": us}


# ---------------------------------------------------------------------------
# K5, K7, K8: the LYNX sampler's kernel variants
# ---------------------------------------------------------------------------

def layer_bound(B, T, dim=1024, inner=2048, k=31):
    """K5 and K7: the three products and the f32 conv, against x, cond_proj
    and the output (bf16) and the weights read once."""
    rows = B * T
    mm = 2 * rows * dim * 2 * inner + 2 * rows * inner * dim
    conv = 2 * rows * inner * k
    nbytes = 3 * rows * dim * 2 + B * dim * 4 + (dim * 2 * inner + inner * dim) * 2 \
        + (2 * dim + 5 * inner + k * inner) * 4
    return bound_ms(nbytes, mm, conv)


def tail_bound(B, T, dim=1024, inner=2048, k=31):
    """K8: the [inner -> dim] product and the f32 conv, against the bf16
    inner rows, the output and the tail's weights read once."""
    rows = B * T
    nbytes = rows * inner * 2 + rows * dim * 2 + inner * dim * 2 + (3 * inner + k * inner
                                                                      + dim) * 4
    return bound_ms(nbytes, 2 * rows * inner * dim, 2 * rows * inner * k)


# K5's, K7's and K8's edge shapes: fewer tiles than SMs, a ragged last row tile, dims above the
# cap of 1024 that their WMMA versions had
LAYER_EDGES = ((1, 37, 1024, 2048, 31), (4, 2049, 1024, 2048, 31), (2, 1000, 1536, 3072, 31),
               (1, 2048, 2048, 4096, 31))
# the launches of K5 and K7: LayerNorm, the SwiGLU product, the conv, the output product
LAYER_PARTS = {"layer norm": ("layer_norm_kernel",), "SwiGLU product": ("SwigluEpi",),
               "conv": ("dwconv_prelu",), "output product": ("LayerOut",)}
# the launches of K8: the conv over the bf16 head output, the output product
TAIL_PARTS = {"conv": ("dwconv_prelu",), "output product": ("StoreBiasBf16",)}


def layer_inputs(B: int, T: int, dim: int = 1024, inner: int = 2048, k: int = 31, seed: int = 0):
    import torch

    x, params = k1_inputs(B, T, dim, inner, k, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    cond = torch.randn(B, T, dim, generator=g, device="cuda").to(torch.bfloat16)
    step = torch.randn(B, dim, generator=g, device="cuda").to(torch.bfloat16).float()
    return x, cond, step, params


def check_variants(reps: int = 10) -> dict:
    """K5 and K7 against their plain version at their edge shapes and at the
    sweep's shape (B=4, T=2048, dim 1024, inner 2048, k 31), where each is
    timed with its cuBLAS products, host cost and per-pass split; K8 on the
    head's output for the same x."""
    import torch

    from xiaoicesing_io_tpu_torch.ops.cuda import lynx_layer as K5

    entries = (("K5", "lynx_layer_fused", K5.lynx_layer_fused),
               ("K7", "lynx_layer_fused_v3", K5.lynx_layer_fused_v3))
    errs = {"K5": [], "K7": []}
    for B, T, dim, inner, k in LAYER_EDGES:
        x, cond, step, params = layer_inputs(B, T, dim, inner, k, seed=T + dim)
        weights = K5.prepare_layer_weights(*params)
        ref = K5.lynx_layer_fused_plain(x, cond, step, *params, kernel_size=k)
        for key, name, fn in entries:
            got = fn(x, cond, step, weights, kernel_size=k)
            torch.cuda.synchronize()
            errs[key].append(compare(f"{key} {name} [B={B},T={T},dim={dim},inner={inner},k={k}]",
                                     got, ref))
        del x, cond, weights, ref, got
    B, T, k = B_TIME, T_TIME, 31
    x, cond, step, params = layer_inputs(B, T)
    weights = K5.prepare_layer_weights(*params)
    shape = "[B=4,T=2048,dim=1024,inner=2048,k=31]"
    out = {}
    ref = K5.lynx_layer_fused_plain(x, cond, step, *params, kernel_size=k)
    for key, name, fn in entries:
        got = fn(x, cond, step, weights, kernel_size=k)
        torch.cuda.synchronize()
        errs[key].append(compare(f"{key} {name} {shape}", got, ref))
        del got
        ms = cuda_ms(lambda: fn(x, cond, step, weights, kernel_size=k), reps)
        out[key] = {"max_abs_err": max(errs[key]), "ms": ms}
    del ref
    plain_ms = cuda_ms(lambda: K5.lynx_layer_fused_plain(x, cond, step, *params, kernel_size=k),
                       3)
    # the GEMM core's yardstick: the layer's two products as cuBLAS bf16 products
    xn = x.reshape(B * T, -1)
    act = torch.zeros(B * T, weights[7].shape[0], dtype=torch.bfloat16, device="cuda")
    gemm_ms = cuda_ms(lambda: (torch.matmul(xn, weights[2]), torch.matmul(act, weights[7])), reps)
    bms, by = layer_bound(B, T)
    splits = {}
    for key, name, fn in entries:
        call = (lambda fn=fn: fn(x, cond, step, weights, kernel_size=k))
        us = host_us(call)
        splits[key] = labelled_split(call, LAYER_PARTS)
        out[key].update(plain_ms=plain_ms, bound_ms=bms, bound_by=by, gemm_library_ms=gemm_ms,
                        host_us=us)
        log(f"[{key}] ms={out[key]['ms']:.4f} plain_ms={plain_ms:.4f} "
            f"gemm_library_ms={gemm_ms:.4f} bound_ms={bms:.4f} ({by}) "
            f"share_of_bound={bms / out[key]['ms']:.3f} host_us_per_call={us:.1f}")
        log(f"[{key} split] {split_text(splits[key])}")
    if splits["K5"] is not None and splits["K7"] is not None:
        log("[K7 vs K5 products] " + "; ".join(
            f"{part}: K5 {splits['K5'][part]:.1f} us, K7 {splits['K7'][part]:.1f} us"
            for part in ("SwiGLU product", "output product")))

    out["K8"] = check_k8(x, weights, reps)
    return out


def check_k8(x, weights, reps: int) -> dict:
    """K8 ``conv_tail`` on the PyTorch head's output against its plain
    version at the edge shapes of K5 and K7, then at the sweep's shape on the
    head's output for ``x`` and ``weights``, where it is timed with its
    cuBLAS product, the head, its host cost and its per-pass split."""
    import torch

    from xiaoicesing_io_tpu_torch.ops.cuda import lynx_conv as K1
    from xiaoicesing_io_tpu_torch.ops.cuda import lynx_hybrid as K8

    errs = []
    for B, T, dim, inner, k in LAYER_EDGES:
        xe, params = k1_inputs(B, T, dim, inner, k, seed=T + dim + 8)
        we = K1.prepare_weights(*params)
        head = K8.conv_head(xe, *we[:4])
        got = K8.conv_tail(head, we, kernel_size=k)
        torch.cuda.synchronize()
        errs.append(compare(f"K8 conv_tail [B={B},T={T},dim={dim},inner={inner},k={k}]", got,
                            K8.conv_tail_plain(head, *we[4:], kernel_size=k)))
        del xe, we, head, got
    B, T, k = B_TIME, T_TIME, 31
    head = K8.conv_head(x, *weights[:4])

    def call():
        return K8.conv_tail(head, weights, kernel_size=k)

    got = call()
    torch.cuda.synchronize()
    errs.append(compare("K8 conv_tail [B=4,T=2048,dim=1024,inner=2048,k=31]", got,
                        K8.conv_tail_plain(head, *weights[4:], kernel_size=k)))
    del got
    ms = cuda_ms(call, reps)
    plain_ms = cuda_ms(lambda: K8.conv_tail_plain(head, *weights[4:], kernel_size=k), 3)
    # the GEMM core's yardstick: the output product act @ w2 as one cuBLAS bf16 product
    act = torch.zeros(B * T, weights[7].shape[0], dtype=torch.bfloat16, device="cuda")
    gemm_ms = cuda_ms(lambda: torch.matmul(act, weights[7]), reps)
    bms, by = tail_bound(B, T)
    head_ms = cuda_ms(lambda: K8.conv_head(x, *weights[:4]), reps)
    us = host_us(call)
    log(f"[K8] ms={ms:.4f} plain_ms={plain_ms:.4f} gemm_library_ms={gemm_ms:.4f} "
        f"bound_ms={bms:.4f} ({by}) share_of_bound={bms / ms:.3f} host_us_per_call={us:.1f} "
        f"(the torch head before it: {head_ms:.4f} ms)")
    log(f"[K8 split] {split_text(labelled_split(call, TAIL_PARTS))}")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "gemm_library_ms": gemm_ms, "host_us": us}


# ---------------------------------------------------------------------------
# K6: one ResBlock1 unit of the time-folded vocoder
# ---------------------------------------------------------------------------

def k6_unit(B: int, T: int, C: int, k: int, d: int, F: int, seed: int = 0):
    """A random unit of width C folded by F (F = 1: raw dilated taps) in the
    kernel's operand types, its geometry, and a bf16 input [B, T/F, F*C]."""
    import numpy as np
    import torch

    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_fast import fold_conv
    from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_resblock as K6

    rng = np.random.default_rng(seed)
    w1, w2 = (rng.standard_normal((k, C, C)) * (0.5 / math.sqrt(k * C)) for _ in range(2))
    b1, b2 = (rng.standard_normal(C) * 0.05 for _ in range(2))
    f1 = fold_conv(w1.astype(np.float32), b1.astype(np.float32), F, dilation=d)
    f2 = fold_conv(w2.astype(np.float32), b2.astype(np.float32), F)
    weights = K6.prepare_unit_weights(f1[0], f1[1], f2[0], f2[1], torch.bfloat16, "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, T // F, F * C, generator=g, device="cuda").to(torch.bfloat16)
    return x, weights, dict(d1=f1[3], pad1_l=f1[2], d2=f2[3], pad2_l=f2[2])


def nonzero_taps(w) -> int:
    return int((w.float().abs().amax(dim=(1, 2)) > 0).sum().item())


def k6_bound(rows: int, weights):
    """One unit: the products of its taps that are not all zero, against the
    bf16 input and output and the weights read once."""
    w1, _, w2, _ = weights
    L = w1.shape[-1]
    taps = nonzero_taps(w1) + nonzero_taps(w2)
    return 2 * rows * L * L * taps, rows * L * 2 * 2 + taps * L * L * 2 + 2 * L * 4


def cudnn_bf16_unit(x, weights, d1, pad1_l, d2, pad2_l):
    """The unit as unfused bf16 cuDNN convolutions (outputs rounded to bf16,
    bias and residual added in bf16): the folded layout's arithmetic in the
    JAX package (``nsf_fast._conv_folded``), timed beside K6."""
    import torch.nn.functional as F

    w1, b1, w2, b2 = weights
    out = x
    for w, b, d, p in ((w1, b1, d1, pad1_l), (w2, b2, d2, pad2_l)):
        k = w.shape[0]
        t = F.leaky_relu(out, 0.1).transpose(1, 2)
        t = F.conv1d(F.pad(t, (p, (k - 1) * d - p)), w.permute(2, 1, 0), dilation=d)
        out = t.transpose(1, 2) + b.to(x.dtype)
    return x + out


def kept_stacked(w):
    """The taps of ``[k, L, L]`` that are not all zero, stacked ``[L, kept L]``."""
    from xiaoicesing_io_tpu_torch.ops.cuda import sm90
    from xiaoicesing_io_tpu_torch.ops.cuda.hifigan_stage import stack_taps

    return stack_taps(w[sm90.kept_taps(w)]).contiguous()


def check_k6(reps: int = 3) -> dict:
    """Phase 5d: K6 against its plain version, then the 45 ResBlock1 units of
    a random full-width folded generator at B=4, T=2048, stage by stage."""
    import torch

    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_fast import FastNsfHifigan
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import (
        Generator, NsfHifiganConfig,
    )
    from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_resblock as K6

    errs = []
    for label, shape in (
            ("folded stage 2, k11 d5 (17 of 27 + 7 taps kept), L=128",
             (B_TIME, T_TIME * 128, 64, 11, 5, 2)),
            ("raw stage 0, k11 d5, L=256", (B_TIME, T_TIME * 8, 256, 11, 5, 1)),
            ("folded stage 3, k7 d3, L=128, off-tile T", (3, 4 * 4099, 32, 7, 3, 4))):
        x, w, geometry = k6_unit(*shape, seed=len(errs))
        got = K6.resblock_unit(x, *w, **geometry)
        torch.cuda.synchronize()
        ref = K6.resblock_unit_plain(x, *w, **geometry)
        errs.append(compare(f"K6 resblock_unit {label} [B={x.shape[0]},T={x.shape[1]}]", got,
                            ref))
        del x, got, ref

    vcfg = NsfHifiganConfig()
    torch.manual_seed(0)
    fast = FastNsfHifigan(Generator(vcfg).cuda(), torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    total = {"ms": 0.0, "plain_ms": 0.0, "cudnn_ms": 0.0, "gemm_ms": 0.0, "flop": 0.0,
             "bytes": 0.0, "dense_flop": 0.0}
    stage_ms = []
    samples = T_TIME
    k6_runs = []  # (x, units) of stages 2-4, for the device split of the 27 units
    for i, (u, stage) in enumerate(zip(vcfg.upsample_rates, fast.stages)):
        samples *= u
        t = {"ms": 0.0, "plain_ms": 0.0, "cudnn_ms": 0.0, "gemm_ms": 0.0, "flop": 0.0,
             "bytes": 0.0}
        units = [unit for branch in stage["units"] for unit in branch]
        L = units[0][0][0].shape[-1]
        x = torch.randn(B_TIME, samples // stage["F"], L, generator=g, device="cuda")
        x = x.to(torch.bfloat16)
        rows = x.shape[0] * x.shape[1]
        x2d = x.reshape(rows, L)
        for weights, geometry in units:
            t["ms"] += cuda_ms(lambda: K6.resblock_unit(x, *weights, **geometry), reps)
            t["plain_ms"] += cuda_ms(lambda: K6.resblock_unit_plain(x, *weights, **geometry), 1)
            t["cudnn_ms"] += cuda_ms(lambda: cudnn_bf16_unit(x, weights, **geometry), reps)
            # the yardstick of the GEMM core: each conv's kept taps as one cuBLAS product
            kept = [kept_stacked(weights[0]), kept_stacked(weights[2])]
            t["gemm_ms"] += cuda_ms(lambda: products(x2d, kept), reps)
            del kept
            flop, nbytes = k6_bound(rows, weights)
            t["flop"] += flop
            t["bytes"] += nbytes
            if i >= 2:
                w1, _, w2, _ = weights
                total["dense_flop"] += 2 * rows * L * L * (w1.shape[0] + w2.shape[0])
        bms, by = bound_ms(t["bytes"], t["flop"])
        log(f"[K6 stage {i}] {len(units)} units, L={L}, {rows} rows: ms={t['ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} cudnn_bf16_ms={t['cudnn_ms']:.4f} "
            f"gemm_library_ms={t['gemm_ms']:.4f} bound_ms={bms:.4f} ({by}) "
            f"share_of_bound={bms / t['ms']:.3f} tflop={t['flop'] / 1e12:.4f}")
        stage_ms.append(t["ms"])
        if i >= 2:  # the units the wrapper's default sends to K6
            for key in t:
                total[key] += t[key]
            k6_runs.append((x, units))
        del x, x2d

    def k6_units():
        for x, units in k6_runs:
            for weights, geometry in units:
                K6.resblock_unit(x, *weights, **geometry)

    x2, units2 = k6_runs[0]
    us = host_us(lambda: K6.resblock_unit(x2, *units2[-1][0], **units2[-1][1]))
    split = labelled_split(k6_units, TAPCONV_PARTS, calls=2)
    bms, by = bound_ms(total["bytes"], total["flop"])
    dense_ms = total["dense_flop"] / BF16_FLOPS * 1e3
    log(f"[K6] stages 2-4, 27 units: ms={total['ms']:.4f} plain_ms={total['plain_ms']:.4f} "
        f"cudnn_bf16_ms={total['cudnn_ms']:.4f} gemm_library_ms={total['gemm_ms']:.4f} "
        f"bound_ms={bms:.4f} ({by}, {total['flop'] / 1e12:.4f} TFLOP of non-zero taps, the "
        f"ones the kernel computes; {dense_ms:.4f} ms counting the all-zero folded taps too) "
        f"share_of_bound={bms / total['ms']:.3f} host_us_per_call={us:.1f}")
    log(f"[K6 split] 27 units: {split_text(split)}")
    del fast, k6_runs, x2, units2
    torch.cuda.empty_cache()
    return {"max_abs_err": max(errs), "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": bms, "bound_by": by, "gemm_library_ms": total["gemm_ms"],
            "cudnn_bf16_ms": total["cudnn_ms"], "host_us": us, "stage_ms": stage_ms}


SWEEP_STEPS = 50
SWEEP_MODE_KERNEL = {"v1": "lynx_conv_module", "v2": "lynx_layer_fused",
                     "v3": "lynx_layer_fused_v3", "hybrid": "lynx_conv_tail"}


def run_sampler_sweep(name_limit: str, reps: int = 2) -> dict:
    """Phase 9: the sweep's sampler at full width, every mode; the launch
    counters are zeroed just before each mode's checked call and read just
    after.  Returns the launches of each variant kernel in its mode."""
    import torch

    from xiaoicesing_io_tpu_torch.tools import perf_sweep

    t0 = time.perf_counter()
    sweep = perf_sweep.SamplerSweep.random(device="cuda", B=B_TIME, T=T_TIME,
                                           steps=SWEEP_STEPS)
    layers = len(sweep.model.backbone.residual_layers)
    want = layers * SWEEP_STEPS
    log(f"[setup lynx_variants] shipped LYNXNet {sweep.model.backbone.num_channels} x {layers}, "
        f"random weights, B={B_TIME} T={T_TIME} {SWEEP_STEPS} Euler steps; built in "
        f"{time.perf_counter() - t0:.1f}s")
    mels, launches = {}, {}
    for mode in perf_sweep.MODES:
        zero_launch_counts()
        mel = sweep.run(mode)
        torch.cuda.synchronize()
        counts = launch_counts()
        kernel = SWEEP_MODE_KERNEL.get(mode)
        log(f"[sweep {mode}] launches {counts}; expected {kernel}: {want} "
            f"({layers} layers x {SWEEP_STEPS} steps), every other kernel 0")
        others = [v for k, v in counts.items() if k != kernel]
        if (kernel is not None and counts[kernel] != want) or any(others):
            raise AssertionError(f"sweep mode {mode} did not launch its kernel as expected")
        if kernel is not None:
            launches[kernel] = counts[kernel]
        if mel.shape != (B_TIME, T_TIME, sweep.cfg["audio_num_mel_bins"]) \
                or not torch.isfinite(mel).all():
            raise AssertionError(f"sweep mode {mode}: mel {tuple(mel.shape)}, finite "
                                 f"{bool(torch.isfinite(mel).all())}")
        mels[mode] = mel
    ref = mels["v1"]
    for mode in ("module", "v2", "v3", "hybrid"):
        err = (mels[mode] - ref).abs().max().item()
        scale = ref.abs().max().item()
        c = corr(mels[mode], ref)
        checked = mode != "module"
        log(f"[check] sweep mel, {mode} vs v1: max_abs_err={err:.6g} max_abs_ref={scale:.6g} "
            f"corr={c:.6f} " + (f"(tolerance: err <= {MEL_TOL_REL} * max_abs_ref, corr > "
                               f"{MEL_TOL_CORR})" if checked else "(record only)"))
        if checked and not (err <= MEL_TOL_REL * scale and c > MEL_TOL_CORR):
            raise AssertionError(f"the {mode} sweep's mel disagrees with v1's")
    del mels
    times = perf_sweep.sweep_sampler(perf_sweep.MODES, sweep=sweep, reps=reps)
    log(f"[timing lynx_variants] card={name_limit} B={B_TIME} T={T_TIME} steps={SWEEP_STEPS} "
        f"(mean of {reps}): " + " ".join(f"{m}_ms_per_step={t['ms_per_step']:.4f}"
                                          for m, t in times.items()))
    for mode in ("module", "v1", "v2", "v3"):
        busy = device_busy_ms(lambda: sweep.run(mode)) / SWEEP_STEPS
        log(f"[busy lynx_variants] {mode}: device busy {busy:.4f} ms per step of "
            f"{times[mode]['ms_per_step']:.4f} (share {busy / times[mode]['ms_per_step']:.3f})")
    del sweep
    torch.cuda.empty_cache()
    return launches


VOCODER_REPS = 3
VOCODER_ATOL = 2e-2      # each folded config vs (), the JAX bar of the fused-stage test
VOCODER_CORR = 0.999


def run_vocoder_sweep(name_limit: str, k2_stage_ms, k6_stage_ms) -> None:
    """Phase 10: the vocoder sweep at full size in every ``pallas_stages``
    config, then the stock layout; the launch counters are zeroed just before
    each checked call and read just after.  ``k2_stage_ms`` (stages 0, 1,
    phase 4) and ``k6_stage_ms`` (stages 0-4, phase 5d) are the kernels'
    times alone, which split the default config's call by stage."""
    import torch

    from xiaoicesing_io_tpu_torch.tools import perf_sweep

    t0 = time.perf_counter()
    sweep = perf_sweep.VocoderSweep.random(device="cuda", B=B_TIME, T=T_TIME)
    h = sweep.generator.config
    stages = len(h.upsample_rates)
    units = len(h.resblock_kernel_sizes) * len(h.resblock_dilation_sizes[0])
    log(f"[setup vocoder_variants] shipped NSF-HiFiGAN {h.upsample_initial_channel} ch, "
        f"random weights, mel ~ N(0, 1) [{B_TIME}, {T_TIME}, {h.num_mels}], f0 "
        f"{perf_sweep.VOCODER_F0} Hz; built in {time.perf_counter() - t0:.1f}s")
    wavs = {}
    for config in perf_sweep.VOCODER_CONFIGS + (None,):
        name = "stock" if config is None else f"stages={config}"
        want = ({"fused_resblock_stage": 2, "resblock_unit": 0} if config is None else
                {"fused_resblock_stage": len(config),
                 "resblock_unit": units * (stages - len(config))})
        if config is not None:
            sweep.folded(config)  # fold the weights outside the counted call
        zero_launch_counts()
        wav = sweep.run(config)
        torch.cuda.synchronize()
        counts = launch_counts()
        log(f"[vocoder {name}] launches {counts}; expected {want}, every other kernel 0")
        if any(counts[k] != want.get(k, 0) for k in counts):
            raise AssertionError(f"vocoder {name} did not launch its kernels as expected")
        if wav.shape != (B_TIME, T_TIME * h.hop_size) or not torch.isfinite(wav).all():
            raise AssertionError(f"vocoder {name}: wav {tuple(wav.shape)}, finite "
                                 f"{bool(torch.isfinite(wav).all())}")
        wavs[config] = wav
    ref = wavs[()]
    for config in perf_sweep.VOCODER_CONFIGS[1:]:
        err = (wavs[config] - ref).abs().max().item()
        c = corr(wavs[config], ref)
        log(f"[check] vocoder wav, stages={config} vs (): max_abs_err={err:.6g} corr={c:.8f} "
            f"(tolerance: err <= {VOCODER_ATOL}, corr > {VOCODER_CORR})")
        if not (err <= VOCODER_ATOL and c > VOCODER_CORR):
            raise AssertionError(f"the vocoder's stages={config} wav disagrees with ()'s")
    err = (wavs[None] - wavs[(0, 1)]).abs().max().item()
    c = corr(wavs[None], wavs[(0, 1)])
    log(f"[check] vocoder wav, stock layout vs folded (0, 1): max_abs_err={err:.6g} corr={c:.8f} "
        f"(tolerance: corr > {WAV_TOL_CORR})")
    if not c > WAV_TOL_CORR:
        raise AssertionError("the stock layout's wav disagrees with the folded layout's")
    del wavs, ref
    times = perf_sweep.sweep_vocoder(sweep=sweep, reps=VOCODER_REPS)
    log(f"[timing vocoder_variants] card={name_limit} B={B_TIME} T={T_TIME} audio_s="
        f"{sweep.audio_s:.3f} (mean of {VOCODER_REPS}): "
        + " ".join(f"{k.replace('stages=', '').replace(' ', '')}_ms={v['ms']:.4f}"
                   for k, v in times.items()))
    ms = {k: v["ms"] for k, v in times.items()}
    # K2 on folded stage 2 has no timing of its own: K6's stage 2 plus the
    # (0, 1, 2) - (0, 1) difference of whole calls
    k2_stage2 = k6_stage_ms[2] + ms["stages=(0, 1, 2)"] - ms["stages=(0, 1)"]
    resblocks = k2_stage_ms[0] + k2_stage_ms[1] + sum(k6_stage_ms[2:])
    log(f"[split vocoder_variants] default config (0, 1), {ms['stages=(0, 1)']:.4f} ms a call: "
        f"resblocks of stage 0 (K2) {k2_stage_ms[0]:.4f}, stage 1 (K2) {k2_stage_ms[1]:.4f}, "
        + ", ".join(f"stage {i} (K6) {k6_stage_ms[i]:.4f}" for i in range(2, len(k6_stage_ms)))
        + f"; the rest (source, conv_pre, upsampling, noise convs, conv_post, adds) "
          f"{ms['stages=(0, 1)'] - resblocks:.4f}.  K6 against K2 per stage (kernel alone; "
          f"call differences in brackets): stage 0 {k6_stage_ms[0]:.4f} vs {k2_stage_ms[0]:.4f} "
          f"({ms['stages=(0,)'] - ms['stages=()']:+.4f}), stage 1 {k6_stage_ms[1]:.4f} vs "
          f"{k2_stage_ms[1]:.4f} ({ms['stages=(1,)'] - ms['stages=()']:+.4f}), stage 2 "
          f"{k6_stage_ms[2]:.4f} vs {k2_stage2:.4f} (from the calls)")
    del sweep
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the main path: .ds -> wav through the port's runner, for each configuration
# ---------------------------------------------------------------------------

SAMPLE = "samples/04_仙瑶.ds"
MEL_TOL_REL = 0.05     # bf16 kernel path vs the f32 module path
MEL_TOL_CORR = 0.999
WAV_TOL_CORR = 0.99    # bf16 vocoder (kernel stages) vs the f32 vocoder

# the WaveNet + DDPM acoustic configuration, over configs/acoustic.json
WAVENET_DDPM = dict(
    backbone_type="wavenet",
    backbone_args={"num_channels": 512, "num_layers": 20, "dilation_cycle_length": 4},
    diffusion_type="ddpm", schedule_type="linear", timesteps=1000, K_step=400,
    K_step_infer=400, diff_accelerator="ddim", diff_speedup=10,
)


def make_experiment(work: Path, overrides=None, seed: int = 0):
    """A reference-format acoustic checkpoint and NSF-HiFiGAN ``model.ckpt``
    at the full width of ``configs/acoustic.json`` (with ``overrides``), with
    random weights.  A DDPM checkpoint also carries the schedule buffers the
    reference core registers."""
    import torch

    from xiaoicesing_io_tpu_torch.config import acoustic_defaults
    from xiaoicesing_io_tpu_torch.models.diffusion.core import GaussianDiffusion
    from xiaoicesing_io_tpu_torch.models.toplevel import reference_core_buffers
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import (
        Generator, NsfHifiganConfig,
    )
    from xiaoicesing_io_tpu_torch.training.acoustic import build_acoustic
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    cfg = acoustic_defaults()
    cfg.update(overrides or {})
    cfg.update(work_dir=str(work / "exp"), vocoder_ckpt=str(work / "vocoder" / "model.ckpt"),
               dictionary=str(ROOT / cfg["dictionary"]))
    vocab = TokenTextEncoder(PhonemeDictionary.load(cfg["dictionary"]).phoneme_list).vocab_size
    torch.manual_seed(seed)
    model, core, _ = build_acoustic(cfg, vocab)
    with torch.no_grad():
        # the zero-initialised output projection and the 1e-6 ConvNeXt layer
        # scales would hide the denoiser and the aux blocks
        model.backbone.output_projection.weight.normal_(0.0, 0.02)
        for block in model.aux_decoder.decoder.conv:
            block.gamma.normal_(0.0, 0.1)
    state = {f"model.{k}": v for k, v in model.state_dict().items()}
    if isinstance(core, GaussianDiffusion):
        state.update({f"model.diffusion.{k}": v
                      for k, v in reference_core_buffers(core.schedule).items()})
    (work / "exp").mkdir(parents=True)
    torch.save({"category": "acoustic", "state_dict": state},
               work / "exp" / "model_ckpt_steps_0.ckpt")
    vcfg = NsfHifiganConfig()
    (work / "vocoder").mkdir()
    torch.save({"generator": Generator(vcfg).state_dict()}, work / "vocoder" / "model.ckpt")
    (work / "vocoder" / "config.json").write_text(json.dumps({
        "num_mels": vcfg.num_mels, "sampling_rate": vcfg.sampling_rate,
        "hop_size": vcfg.hop_size, "n_fft": cfg["fft_size"], "win_size": cfg["win_size"],
        "fmin": cfg["fmin"], "fmax": cfg["fmax"], "upsample_rates": list(vcfg.upsample_rates),
        "upsample_kernel_sizes": list(vcfg.upsample_kernel_sizes),
        "upsample_initial_channel": vcfg.upsample_initial_channel, "resblock": vcfg.resblock,
        "resblock_kernel_sizes": list(vcfg.resblock_kernel_sizes),
        "resblock_dilation_sizes": [list(d) for d in vcfg.resblock_dilation_sizes],
    }))
    return cfg


def corr(a, b) -> float:
    import torch

    return torch.corrcoef(torch.stack([a.flatten().float(), b.flatten().float()]))[0, 1].item()


def vocoder_calls(vocoder) -> dict:
    """The K2 and K6 launches of one call of the wrapper's folded vocoder:
    one K2 call per fused stage, one K6 call per other ResBlock1 unit (2 and
    27 for the shipped vocoder at the default stages 0 and 1)."""
    stages = vocoder.fast.stages
    return {"fused_resblock_stage": sum("fused" in st for st in stages),
            "resblock_unit": sum(len(branch) for st in stages for branch in st.get("units", ()))}


def drive_main_path(runner, out_dir: Path) -> tuple:
    """Every segment of one sample ``.ds`` through ``run_inference``; returns
    the kernels' launch counts of that run, its number of segments and the
    wav it wrote."""
    import numpy as np
    from scipy.io import wavfile

    from xiaoicesing_io_tpu_torch.inference.acoustic import load_ds

    params = load_ds(ROOT / SAMPLE)
    vocode = runner.run_vocoder
    segments = []

    def run_vocoder(mel, f0, seed=None):
        wav = vocode(mel, f0, seed=seed)
        if not np.isfinite(wav).all():
            raise AssertionError("the vocoder gave non-finite samples")
        segments.append((mel.shape[1], wav.shape[0]))
        return wav

    runner.run_vocoder = run_vocoder
    zero_launch_counts()
    t0 = time.perf_counter()
    (path,) = runner.run_inference(params, out_dir=out_dir, title="smoke", seed=0)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    runner.run_vocoder = vocode

    hop, sr = runner.cfg["hop_size"], runner.cfg["audio_sample_rate"]
    if len(segments) != len(params):
        raise AssertionError(f"{len(segments)} segments vocoded, {len(params)} in the .ds")
    for frames, n in segments:
        if n != frames * hop:
            raise AssertionError(f"a segment of {frames} frames gave {n} samples, not "
                                 f"{frames * hop}")
    expect = 0
    for param, (_, n) in zip(params, segments):  # run_inference's placement of segments
        expect = round(param.get("offset", 0) * sr) + n
    rate, wav = wavfile.read(path)
    if rate != sr or wav.shape != (expect,) or not np.abs(wav).max() > 0:
        raise AssertionError(f"wav: {rate} Hz, shape {wav.shape}, peak {np.abs(wav).max()}; "
                             f"expected {sr} Hz, ({expect},), non-silent")
    log(f"[ds] {SAMPLE}: {len(params)} segments, {sum(f for f, _ in segments)} frames -> "
        f"{wav.shape[0]} samples ({wav.shape[0] / sr:.2f} s) at {rate} Hz, finite, "
        f"each segment frames*{hop} samples; {seconds:.2f}s host; launches {launches}")
    return launches, len(params), path


def check_against_f32(runner, seed: int = 0) -> None:
    """One segment through the kernel path (bf16) and the f32 module path on
    the card, from the same start noise: mel and wav must agree."""
    import torch

    from xiaoicesing_io_tpu_torch.inference.acoustic import _bucket, load_ds

    batch = runner.preprocess_input(load_ds(ROOT / SAMPLE)[0])
    frames = batch["mel2ph"].shape[1]
    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randn(1, 1, _bucket(frames), runner.cfg["audio_num_mel_bins"],
                        generator=g, device="cuda").cpu().numpy()
    mel_k = torch.from_numpy(runner.forward_model(batch, noise=noise))
    mel_f = torch.from_numpy(runner.forward_model(batch, noise=noise, _f32_module=True))
    err = (mel_k - mel_f).abs().max().item()
    scale = mel_f.abs().max().item()
    c = corr(mel_k, mel_f)
    log(f"[check] mel, kernel path vs f32 path [{frames} frames]: max_abs_err={err:.6g} "
        f"max_abs_ref={scale:.6g} corr={c:.6f} (tolerance: err <= {MEL_TOL_REL} * "
        f"max_abs_ref, corr > {MEL_TOL_CORR})")
    if not (torch.isfinite(mel_k).all() and err <= MEL_TOL_REL * scale and c > MEL_TOL_CORR):
        raise AssertionError("the kernel path's mel disagrees with the f32 path")

    voc = runner.vocoder
    mel = mel_f.cuda()
    f0 = torch.from_numpy(batch["f0"]).cuda()
    wav_k = voc.spec2wav_torch(mel, f0)
    wav_f = voc.spec2wav_torch(mel, f0, _f32_module=True)
    c = corr(wav_k, wav_f)
    log(f"[check] wav, bf16 vocoder with kernel stages vs f32 vocoder [{frames} frames]: "
        f"max_abs_err={(wav_k - wav_f).abs().max().item():.6g} corr={c:.6f} "
        f"(tolerance: corr > {WAV_TOL_CORR})")
    if not (torch.isfinite(wav_k).all() and c > WAV_TOL_CORR):
        raise AssertionError("the bf16 vocoder disagrees with the f32 vocoder")


# ---------------------------------------------------------------------------
# batched timing
# ---------------------------------------------------------------------------

def batched_timing(runner, name_limit: str, label: str, steps: int, kernels: dict,
                   reps: int = 3) -> dict:
    """B=4 sequences of T=2048 frames through ``steps`` sampler steps, then
    the vocoder; the line also carries the kernels' phase 3-5 times against
    their bounds."""
    import torch

    cfg = runner.cfg
    B, T = B_TIME, T_TIME
    g = torch.Generator(device="cuda").manual_seed(0)
    n_ph = T // 8
    tokens = torch.randint(1, runner.ph_encoder.vocab_size, (B, n_ph), generator=g,
                           device="cuda")
    mel2ph = torch.arange(T, device="cuda").div(8, rounding_mode="floor").add(1).expand(B, T)
    f0 = 100.0 + 300.0 * torch.rand(B, T, generator=g, device="cuda")
    runs = []
    for rep in range(reps + 1):  # the first run warms up
        timings = {}
        mel = runner.synthesize(tokens, mel2ph.contiguous(), f0, generator=g, timings=timings)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = runner.vocoder.spec2wav_torch(mel, f0, generator=g)
        torch.cuda.synchronize()
        timings["vocoder"] = time.perf_counter() - t0
        if rep:
            runs.append(timings)
    if wav.shape != (B, T * cfg["hop_size"]) or not torch.isfinite(wav).all():
        raise AssertionError(f"batched wav: shape {tuple(wav.shape)}, finite "
                             f"{bool(torch.isfinite(wav).all())}")
    mean = {k: sum(r[k] for r in runs) / len(runs) for k in runs[0]}
    total = sum(mean.values())
    # the device's busy share of the acoustic stages (condition + aux + sampler): the kernel time of
    # one profiled call over the unprofiled host time of the same stages
    busy = device_busy_ms(lambda: runner.synthesize(tokens, mel2ph.contiguous(), f0, generator=g))
    audio_s = B * T * cfg["hop_size"] / cfg["audio_sample_rate"]
    out = {
        "cond_aux_ms": mean["cond_aux"] * 1e3,
        "sampler_ms_per_step": mean["sampler"] * 1e3 / steps,
        "vocoder_ms": mean["vocoder"] * 1e3,
        "audio_s_per_s": audio_s / total,
        "device_busy_share_synth": busy / ((mean["cond_aux"] + mean["sampler"]) * 1e3),
    }
    log(f"[timing {label}] card={name_limit} B={B} T={T} steps={steps} (mean of {reps}): "
        + " ".join(f"{k}={v:.4f}" for k, v in out.items())
        + f" sampler_ms={mean['sampler'] * 1e3:.4f} total_ms={total * 1e3:.4f} "
          f"audio_s={audio_s:.3f} "
        + " ".join(f"{k}_ms={v['ms']:.4f} {k}_bound_ms={v['bound_ms']:.4f}"
                   for k, v in kernels.items()))
    for k, v in out.items():
        log(f"[timing {label}] {k}={v:.4f}")
    return out


def run_configuration(label: str, work: Path, overrides, name_limit: str,
                      kernels: dict) -> tuple:
    """Phases 6 and 7: a random full-width experiment, the ``.ds`` run, the
    kernel-path vs f32 check and the batched timing of one configuration;
    returns the ``.ds`` run's launch counts, the configuration, the wav and
    the vocoder's launches per call.  The denoiser's kernel (K1 for LYNXNet,
    K4 for WaveNet) must launch once per layer per sampler step per segment,
    K2 and K6 as :func:`vocoder_calls` says per segment."""
    import torch

    from xiaoicesing_io_tpu_torch.inference.acoustic import DiffSingerAcousticInfer
    from xiaoicesing_io_tpu_torch.models.diffusion.core import GaussianDiffusion

    t0 = time.perf_counter()
    cfg = make_experiment(work, overrides)
    runner = DiffSingerAcousticInfer(cfg, device="cuda")
    log(f"[setup {label}] random full-width acoustic model and vocoder saved and loaded in "
        f"{time.perf_counter() - t0:.1f}s; runner on {runner.device}, "
        f"kernels {'on' if runner.use_kernels else 'off'}")
    if not runner.use_kernels:
        raise AssertionError("the runner does not take the kernel path")
    if isinstance(runner.core, GaussianDiffusion):
        if cfg["diff_accelerator"] != "ddim":
            raise AssertionError("the launch count and the timing assume DDIM")
        steps = len(range(0, min(cfg["K_step_infer"], runner.core.k_step), cfg["diff_speedup"]))
    else:
        if cfg["sampling_algorithm"] != "euler":
            raise AssertionError("the launch count and the timing assume Euler")
        steps = cfg["sampling_steps"]
    launches, segments, wav = drive_main_path(runner, work / "out")
    denoiser = "wavenet_block" if runner.backbone_type == "wavenet" else "lynx_conv_module"
    want = {denoiser: len(runner.model.backbone.residual_layers) * steps * segments}
    want.update({k: v * segments for k, v in vocoder_calls(runner.vocoder).items()})
    log(f"[ds {label}] launches {', '.join(f'{k}: {launches[k]}' for k in want)}; expected "
        f"{want} (layers x {steps} steps x {segments} segments; per segment's vocoder call "
        f"{vocoder_calls(runner.vocoder)})")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"the {label} path did not launch its kernels as expected")
    check_against_f32(runner)
    batched_timing(runner, name_limit, label, steps, kernels)
    per_call = vocoder_calls(runner.vocoder)
    del runner
    torch.cuda.empty_cache()
    return launches, cfg, wav, per_call


# ---------------------------------------------------------------------------
# copy-synthesis: wav -> mel -> f0 -> NSF-HiFiGAN -> wav, scored (K3, K2)
# ---------------------------------------------------------------------------

SYNTH_FILE_SR = 22050
SYNTH_F0 = 220.0
F0_TOL_CENTS = 50.0
F0_MIN_AGREEMENT = 0.9
MAE_TOL = 1e-4


def synthetic_clip(path: Path, hop: int, sr: int, frames: int = K3_FRAMES, seed: int = 0):
    """A harmonic tone with +-50 cent vibrato at 5.5 Hz around 220 Hz and
    white noise 40 dB below it, ``frames * hop`` samples at ``sr`` once
    resampled, written at 22.05 kHz; returns its f0 at the frame centres."""
    import numpy as np

    from xiaoicesing_io_tpu_torch.utils.audio import save_wav

    def f0_at(t):
        return SYNTH_F0 * 2.0 ** (0.5 * np.sin(2 * np.pi * 5.5 * t) / 12)

    n = frames * hop * SYNTH_FILE_SR // sr
    t = np.arange(n) / SYNTH_FILE_SR
    phase = 2 * np.pi * np.cumsum(f0_at(t)) / SYNTH_FILE_SR
    x = sum(np.sin(k * phase) / k for k in range(1, 9))
    x = 0.5 * x / np.abs(x).max()
    rms = np.sqrt(np.mean(x ** 2))
    x = x + np.random.default_rng(seed).standard_normal(n) * rms * 10 ** (-40 / 20)
    save_wav(x, path, SYNTH_FILE_SR)
    return f0_at(np.arange(frames) * hop / sr)


def run_copy_synthesis(cfg, ds_wav: Path, work: Path, name_limit: str, per_call: dict) -> dict:
    """Phase 8: ``copy_synthesis`` on the card (the launch counters are zeroed
    just before it and read just after); ``per_call`` is the vocoder's K2 and
    K6 launches per call.  Returns its launch counts."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from xiaoicesing_io_tpu_torch.eval.metrics import f0_rmse_cents
    from xiaoicesing_io_tpu_torch.inference import val_vocoder as V

    hop, sr = cfg["hop_size"], cfg["audio_sample_rate"]
    work.mkdir(parents=True)
    synth = work / "synthetic_tone.wav"
    known_f0 = synthetic_clip(synth, hop, sr)
    pairs, pitches = [], []
    score, pitch = V._score_pair, V.get_pitch

    def score_pair(extractor, wav, rec, mel, device, plain=False):
        pairs.append((extractor, wav, rec, mel, device))
        return score(extractor, wav, rec, mel, device, plain)

    def get_pitch(*args, **kwargs):
        out = pitch(*args, **kwargs)
        pitches.append(out)
        return out

    V._score_pair, V.get_pitch = score_pair, get_pitch
    try:
        zero_launch_counts()
        t0 = time.perf_counter()
        results = V.copy_synthesis([ds_wav, synth], cfg, work / "out", device="cuda")
        seconds = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        V._score_pair, V.get_pitch = score, pitch

    want = {"mel_spectrogram": 2, **{k: 2 * v for k, v in per_call.items()}}
    log(f"[copysyn] launches {launches}; expected {want} (two files: one K3 call and one "
        f"vocoder call each)")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError("copy-synthesis did not launch its kernels as expected")
    audio_s = 0.0
    for res, (extractor, wav, rec, mel, device), (f0, uv) in zip(results, pairs, pitches):
        rate, out = wavfile.read(res["out"])
        if (device is None or device.type != "cuda" or not np.isfinite(rec).all()
                or len(rec) != len(mel) * hop or rate != sr or out.shape != rec.shape):
            raise AssertionError(f"{res['file']}: reconstruction of {len(rec)} samples "
                                 f"({len(mel)} frames, scored on {device}) written as "
                                 f"{out.shape} at {rate} Hz")
        plain = score(extractor, wav, rec, mel, device, plain=True)
        host = score(extractor, wav, rec, mel, None)
        audio_s += len(wav) / sr
        st = res["seconds"]
        log(f"[copysyn] {Path(res['file']).name}: {len(mel)} frames ({len(wav) / sr:.3f} s), "
            f"mel_mae K3={res['mel_mae']:.6f} plain={plain:.6f} |diff|="
            f"{abs(res['mel_mae'] - plain):.3g} (tolerance {MAE_TOL}); host-path mel_mae="
            f"{host:.6f} (record only: its tail frames are not bucket-padded); "
            f"pesq*={res['pesq']:.4f}")
        log(f"[copysyn stages] {Path(res['file']).name}: "
            + " ".join(f"{k}_s={v:.4f}" for k, v in st.items())
            + f" (load, GT mel, pitch, save, PESQ* on the host; vocoder and K3 pair on the "
              f"card) total_s={sum(st.values()):.4f}")
        if not abs(res["mel_mae"] - plain) <= MAE_TOL:
            raise AssertionError("the K3-scored mel MAE disagrees with the plain version's")
    f0, uv = pitches[1]
    rmse, agreement = f0_rmse_cents(np.where(uv, 0.0, f0), known_f0)
    log(f"[copysyn] synthetic clip f0 vs its known curve: rmse={rmse:.4f} cents "
        f"(tolerance < {F0_TOL_CENTS}), voicing agreement={agreement:.4f} "
        f"(tolerance > {F0_MIN_AGREEMENT})")
    if not (rmse < F0_TOL_CENTS and agreement > F0_MIN_AGREEMENT):
        raise AssertionError("the pitch tracker missed the synthetic clip's f0")
    log(f"[timing copysyn] card={name_limit} files=2 audio_s={audio_s:.3f} "
        f"seconds={seconds:.4f} audio_s_per_s={audio_s / seconds:.4f}")
    torch.cuda.empty_cache()
    return launches


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "xiaoicesing_io_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name_limit = card()
    print(name_limit, flush=True)
    log(f"[card] {name_limit} torch={torch.__version__} cuda={torch.version.cuda} "
        f"devices={torch.cuda.device_count()}")

    from xiaoicesing_io_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    seconds = build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f}s wall; per source: "
        + ", ".join(f"{k}={v:.1f}s" for k, v in seconds.items()))
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "error" in line.lower():
                log(f"[build:{name}] {line.strip()}")
        for u in build.resource_usage(name):  # one line a kernel, marked where it spills
            spills = "SPILLS " if u["spill_stores"] or u["spill_loads"] else ""
            log(f"[build:{name}] {spills}{u['kernel']}: registers {u['registers']}, stack frame "
                f"{u['stack']} B, spill stores {u['spill_stores']} B, spill loads "
                f"{u['spill_loads']} B")

    k1 = check_k1()
    k2 = check_k2()
    k4 = check_k4()
    k3 = check_k3()
    variants = check_variants()
    k6 = check_k6()
    k2_stage_ms, k6_stage_ms = k2.pop("stage_ms"), k6.pop("stage_ms")
    if "--kernels-only" in argv:
        log(f"[done] kernels only, {time.perf_counter() - t_start:.1f}s")
        return 0

    work = ROOT / ".work" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        lynx, lynx_cfg, ds_wav, per_call = run_configuration(
            "lynx_reflow", work / "lynx", None, name_limit, {"K1": k1, "K2": k2, "K6": k6})
        wavenet, _, _, _ = run_configuration("wavenet_ddpm", work / "wavenet", WAVENET_DDPM,
                                             name_limit, {"K4": k4, "K2": k2, "K6": k6})
        copysyn = run_copy_synthesis(lynx_cfg, ds_wav, work / "copysyn", name_limit, per_call)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    sweep = run_sampler_sweep(name_limit)
    run_vocoder_sweep(name_limit, k2_stage_ms, k6_stage_ms)

    kernels = [
        dict(name="lynx_conv_module", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/lynx_conv.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/lynx_conv.py:116",
             launches=lynx["lynx_conv_module"], library_ms=None, **k1),
        dict(name="fused_resblock_stage", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/hifigan_stage.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/hifigan_stage.py:120",
             launches=lynx["fused_resblock_stage"], library_ms=None, **k2),
        dict(name="wavenet_block", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/wavenet_block.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/wavenet_block.py:75",
             launches=wavenet["wavenet_block"], library_ms=None, **k4),
        dict(name="mel_spectrogram", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/mel_spec.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/mel_kernel.py:100",
             launches=copysyn["mel_spectrogram"], **k3),
        dict(name="lynx_layer_fused", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/lynx_layer.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/lynx_conv2.py:132",
             launches=sweep["lynx_layer_fused"], library_ms=None, **variants["K5"]),
        dict(name="lynx_layer_fused_v3", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/lynx_layer.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/lynx_conv3.py:113",
             launches=sweep["lynx_layer_fused_v3"], library_ms=None, **variants["K7"]),
        dict(name="lynx_conv_tail", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/lynx_hybrid.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/lynx_hybrid.py:58",
             launches=sweep["lynx_conv_tail"], library_ms=None, **variants["K8"]),
        dict(name="resblock_unit", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/hifigan_resblock.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/hifigan_resblock.py:105",
             launches=lynx["resblock_unit"], library_ms=None, **k6),
    ]
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
