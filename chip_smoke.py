#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the card (name and power limit, from nvidia-smi);
  2. the build of every CUDA kernel from ``xiaoicesing_io_tpu_torch/csrc``;
  3. K1 ``lynx_conv_module`` against its plain PyTorch version at the
     main-path shape (B=4, T=2048, dim 1024, inner 2048, k 31; bf16);
  4. K2 ``fused_resblock_stage`` against its plain version at vocoder stages 0
     and 1 of the same batch (L=256 at T*8 rows, L=128 at T*64 rows; bf16);
  5. one sample ``.ds``, every segment, through the port's
     ``DiffSingerAcousticInfer.run_inference`` and NSF-HiFiGAN vocoder at the
     full width of ``configs/acoustic.json`` with random weights (the main
     path; the launch counters are zeroed just before it and read just
     after); the wav must be finite and of the right length, and both
     kernels must have been launched.  Then one segment through the kernel
     path and through the f32 module path: mel and wav must agree;
  6. a batched timing at B=4, T=2048, 20 Euler steps.

Tolerance of a kernel against its plain version (same inputs, both bf16
products with f32 accumulation, TF32 off): max |kernel - plain| <=
0.02 * max |plain| and correlation > 0.9999.  The two differ by f32
summation order and by the bf16 rounding of intermediates that the order
flips, which is about one bf16 ulp (0.4 %) on a few elements.  The bf16
kernel path against the f32 path compounds bf16 rounding over 6 layers and
20 steps: mel within 5 % of its scale, corr > 0.999; wav corr > 0.99.

Any failure raises: the script exits non-zero and prints no result.  The
line before the last lists the kernels as JSON (``ms``, ``plain_ms`` and
``bound_ms`` at the phase 3/4 shapes; K2's are the sum of its two stage
calls; ``launches`` are wrapper calls in phase 5).  The last line is
``{"ok": true, "device": {...}}``.
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

B_TIME, T_TIME, STEPS_TIME = 4, 2048, 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def check_k1(reps: int = 20) -> dict:
    import torch

    from xiaoicesing_io_tpu_torch.ops.cuda import lynx_conv as K1

    B, T, k = B_TIME, T_TIME, 31
    x, params = k1_inputs(B, T)
    weights = K1.prepare_weights(*params)
    got = K1.lynx_conv_module(x, weights, kernel_size=k)
    torch.cuda.synchronize()
    ref = K1.lynx_conv_module_plain(x, *params, kernel_size=k)
    err = compare("K1 lynx_conv_module [B=4,T=2048,dim=1024,inner=2048,k=31]", got, ref)
    ms = cuda_ms(lambda: K1.lynx_conv_module(x, weights, kernel_size=k), reps)
    plain_ms = cuda_ms(lambda: K1.lynx_conv_module_plain(x, *params, kernel_size=k), 3)
    bms, by = k1_bound(B, T)
    log(f"[K1] ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}) "
        f"share_of_bound={bms / ms:.3f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}


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


def check_k2(reps: int = 3) -> dict:
    import torch

    from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_stage as K2

    total = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
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
        bms, by_s = k2_bound(B_TIME, T, L, specs)
        log(f"[K2 stage {stage}] ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} "
            f"({by_s}) share_of_bound={bms / ms:.3f}")
        total["max_abs_err"] = max(total["max_abs_err"], err)
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += bms
        by = by_s if by_s == "bytes" else by
    return dict(total, bound_by=by)


# ---------------------------------------------------------------------------
# the main path: .ds -> wav through the port's runner
# ---------------------------------------------------------------------------

SAMPLE = "samples/04_仙瑶.ds"
MEL_TOL_REL = 0.05     # bf16 kernel path vs the f32 module path, 20 sampler steps
MEL_TOL_CORR = 0.999
WAV_TOL_CORR = 0.99    # bf16 vocoder (kernel stages) vs the f32 vocoder


def make_experiment(work: Path, seed: int = 0):
    """A reference-format acoustic checkpoint and NSF-HiFiGAN ``model.ckpt``
    at the full width of ``configs/acoustic.json``, with random weights."""
    import torch

    from xiaoicesing_io_tpu_torch.config import acoustic_defaults
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import (
        Generator, NsfHifiganConfig,
    )
    from xiaoicesing_io_tpu_torch.training.acoustic import build_acoustic
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    cfg = acoustic_defaults()
    cfg.update(work_dir=str(work / "exp"), vocoder_ckpt=str(work / "vocoder" / "model.ckpt"),
               dictionary=str(ROOT / cfg["dictionary"]))
    vocab = TokenTextEncoder(PhonemeDictionary.load(cfg["dictionary"]).phoneme_list).vocab_size
    torch.manual_seed(seed)
    model, _, _ = build_acoustic(cfg, vocab)
    with torch.no_grad():
        # the zero-initialised output projection and the 1e-6 ConvNeXt layer
        # scales would hide the denoiser and the aux blocks
        model.backbone.output_projection.weight.normal_(0.0, 0.02)
        for block in model.aux_decoder.decoder.conv:
            block.gamma.normal_(0.0, 0.1)
    (work / "exp").mkdir(parents=True)
    torch.save({"category": "acoustic",
                "state_dict": {f"model.{k}": v for k, v in model.state_dict().items()}},
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


def drive_main_path(runner, out_dir: Path) -> dict:
    """Every segment of one sample ``.ds`` through ``run_inference``; returns
    the kernels' launch counts of that run."""
    import numpy as np
    from scipy.io import wavfile

    from xiaoicesing_io_tpu_torch.inference.acoustic import load_ds
    from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_stage as K2
    from xiaoicesing_io_tpu_torch.ops.cuda import lynx_conv as K1

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
    K1.launches = K2.launches = 0
    t0 = time.perf_counter()
    (path,) = runner.run_inference(params, out_dir=out_dir, title="smoke", seed=0)
    seconds = time.perf_counter() - t0
    launches = {"lynx_conv_module": K1.launches, "fused_resblock_stage": K2.launches}
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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path did not launch {name}")
    return launches


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

def batched_timing(runner, name_limit: str, k1: dict, k2: dict, reps: int = 3) -> dict:
    """B=4 sequences of T=2048 frames, 20 Euler steps, then the vocoder; the
    line also carries the kernels' phase 3/4 times against their bounds."""
    import torch

    cfg = runner.cfg
    B, T = B_TIME, T_TIME
    if cfg["sampling_steps"] != STEPS_TIME or cfg["sampling_algorithm"] != "euler":
        raise AssertionError("the timing expects the default 20 Euler steps")
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
    audio_s = B * T * cfg["hop_size"] / cfg["audio_sample_rate"]
    out = {
        "cond_aux_ms": mean["cond_aux"] * 1e3,
        "sampler_ms_per_step": mean["sampler"] * 1e3 / STEPS_TIME,
        "vocoder_ms": mean["vocoder"] * 1e3,
        "audio_s_per_s": audio_s / total,
    }
    log(f"[timing] card={name_limit} B={B} T={T} steps={STEPS_TIME} (mean of {reps}): "
        + " ".join(f"{k}={v:.4f}" for k, v in out.items())
        + f" sampler_ms={mean['sampler'] * 1e3:.4f} total_ms={total * 1e3:.4f} "
          f"audio_s={audio_s:.3f} K1_ms={k1['ms']:.4f} K1_bound_ms={k1['bound_ms']:.4f} "
          f"K2_ms={k2['ms']:.4f} K2_bound_ms={k2['bound_ms']:.4f}")
    return out


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
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build:{name}] {line.strip()}")

    k1 = check_k1()
    k2 = check_k2()
    if "--kernels-only" in argv:
        log(f"[done] kernels only, {time.perf_counter() - t_start:.1f}s")
        return 0

    from xiaoicesing_io_tpu_torch.inference.acoustic import DiffSingerAcousticInfer

    work = ROOT / ".work" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        cfg = make_experiment(work)
        runner = DiffSingerAcousticInfer(cfg, device="cuda")
        log(f"[setup] random full-width acoustic model and vocoder saved and loaded in "
            f"{time.perf_counter() - t0:.1f}s; runner on {runner.device}, "
            f"kernels {'on' if runner.use_kernels else 'off'}")
        if not runner.use_kernels:
            raise AssertionError("the runner does not take the kernel path")
        launches = drive_main_path(runner, work / "out")
        check_against_f32(runner)
        batched_timing(runner, name_limit, k1, k2)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [
        dict(name="lynx_conv_module", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/lynx_conv.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/lynx_conv.py:116",
             launches=launches["lynx_conv_module"], library_ms=None, **k1),
        dict(name="fused_resblock_stage", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/hifigan_stage.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/hifigan_stage.py:120",
             launches=launches["fused_resblock_stage"], library_ms=None, **k2),
    ]
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
