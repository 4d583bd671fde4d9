"""Deployment latency micro-benchmarks.

Counterpart of the JAX package's ``deployment/benchmarks.py``: timed loops of
the acoustic model (10 tokens, 100 frames, 20 runs) and of the vocoder (1000
frames, 20 runs) at the reference's deployment-harness shapes, through the
modules in bf16 (``torch.autocast`` for the acoustic model, the stock
generator at bf16 for the vocoder), with random weights unless given.  Each
loop is timed on the host clock from after a warm-up run to a device
synchronise after the last run; both return seconds per run and print
milliseconds per run.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..utils import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def bench_acoustic(cfg, params: Optional[dict] = None, tokens_n: int = 10, frames: int = 100,
                   runs: int = 20, steps: int = 20, vocab: int = 62, device=None) -> float:
    """Seconds per run of condition, aux decoder (with shallow diffusion)
    and sampler for one segment of ``tokens_n`` tokens and ``frames``
    frames.  ``params``: the model's state dict (default: random from seed
    0).  A DDPM core runs DDIM at ``diff_speedup`` (default ``1000 //
    steps``), a rectified-flow core ``steps`` Euler steps."""
    from ..models.diffusion.core import GaussianDiffusion
    from ..training.acoustic import build_acoustic

    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model, core, normalizer = build_acoustic(cfg, vocab)
    if params is not None:
        model.load_state_dict(params)
    model.to(device).eval()
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(1, vocab, (1, tokens_n)), device=device)
    mel2ph = torch.as_tensor(np.clip(np.sort(rng.integers(1, tokens_n + 1, (1, frames))),
                                     1, tokens_n), device=device)
    f0 = torch.as_tensor(rng.uniform(100, 500, (1, frames)).astype(np.float32), device=device)
    shape = (1, 1, frames, cfg["audio_num_mel_bins"])
    use_shallow = cfg.get("use_shallow_diffusion", False) and model.aux_decoder is not None
    generator = torch.Generator(device=device)
    generator.manual_seed(1)

    def run():
        with torch.autocast(device.type, dtype=torch.bfloat16):
            cond = model.condition(tokens, mel2ph, f0)
            aux = model.aux_out(cond).float()[:, None] if use_shallow else None

            def fn(x, t):
                return model.denoise(x, t, cond).float()

            if isinstance(core, GaussianDiffusion):
                x = core.inference(fn, shape, x_start=aux,
                                   speedup=max(1, cfg.get("diff_speedup", 1000 // max(1, steps))),
                                   algorithm=cfg.get("diff_accelerator", "ddim"),
                                   generator=generator, device=device)
            else:
                x = core.inference(fn, shape, x_end=aux,
                                   t_start=cfg.get("T_start_infer", 0.4) if use_shallow else 0.0,
                                   steps=steps, generator=generator, device=device)
        return normalizer.denorm(x)

    run()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(runs):
        run()
    _sync(device)
    dt = (time.perf_counter() - t0) / runs
    print(f"| acoustic: {tokens_n} tokens / {frames} frames / {steps} steps: "
          f"{dt * 1000:.2f} ms/run")
    return dt


@torch.no_grad()
def bench_vocoder(cfg=None, params: Optional[dict] = None, frames: int = 1000, runs: int = 20,
                  device=None) -> float:
    """Seconds per run of the shipped NSF-HiFiGAN generator on ``frames``
    frames of a random mel.  ``cfg`` is ignored, as in the JAX package;
    ``params``: the generator's state dict (default: random from seed 0)."""
    from ..models.vocoders.nsf_hifigan import Generator, NsfHifiganConfig

    device = resolve_device(device)
    vcfg = NsfHifiganConfig()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        gen = Generator(vcfg)
    if params is not None:
        gen.load_state_dict(params)
    gen.to(device).eval()
    rng = np.random.default_rng(0)
    mel = torch.as_tensor(rng.standard_normal((1, frames, vcfg.num_mels)).astype(np.float32),
                          device=device)
    f0 = torch.as_tensor(rng.uniform(100, 500, (1, frames)).astype(np.float32), device=device)

    def run():
        return gen(mel, f0, dtype=torch.bfloat16, stages={})

    run()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(runs):
        run()
    _sync(device)
    dt = (time.perf_counter() - t0) / runs
    audio_s = frames * vcfg.hop_size / vcfg.sampling_rate
    print(f"| vocoder: {frames} frames: {dt * 1000:.2f} ms/run ({audio_s / dt:.1f} audio-s/s)")
    return dt
