"""Sampler sweep over the LYNXNet denoiser's kernel variants, and vocoder
sweep over the time-folded vocoder's stage kernels.

Sampler: the counterpart of the JAX package's ``tools/perf_sweep.py sampler``: the shipped
``configs/acoustic.json`` acoustic model (LYNXNet 1024 x 6, k 31,
strong_cond) with random weights from a seed, B=4 sequences of T=2048
frames, 50 Euler steps of the rectified flow from T_start 0.4 with the aux
decoder's output as ``x_end``, then the normaliser's ``denorm``; one call per
mode, timed on the host clock around work that ends in a device synchronise.

    python -m xiaoicesing_io_tpu_torch.tools.perf_sweep sampler [base|v3|hybrid|all]
        [--device cuda|cpu] [--batch B] [--frames T] [--steps K] [--reps N]
    python -m xiaoicesing_io_tpu_torch.tools.perf_sweep vocoder
        [--device cuda|cpu] [--batch B] [--frames T] [--reps N]

Modes (the JAX sweep's names in brackets):

* ``module`` (``xla``): the unfused ``nn.Module`` denoiser under
  ``torch.autocast`` in the compute dtype;
* ``v1``: ``lynx_denoiser_apply`` on K1 (``ops/cuda/lynx_conv.py``);
* ``v2``: ``fused_layer=True``, K5 (``ops/cuda/lynx_layer.py``);
* ``v3``: ``fused_layer="v3"``, K7;
* ``hybrid``: ``module_impl="hybrid"``, a PyTorch head and K8
  (``ops/cuda/lynx_hybrid.py``).

Sets: ``base`` runs module, v1 and v2; ``v3`` runs v1 and v3; ``hybrid``
runs v1 and hybrid; ``all`` runs every mode.  Each mode prints one line with
its ms per call and ms per step.  JAX's ``tile``, ``chunks``, ``dw_impl``
and ``ablate`` sweeps are TPU schedule parameters (the last one wrong on
purpose) and are not ported.

The model's zero-initialised output projection and 1e-6 ConvNeXt layer
scales are randomised as ``chip_smoke.py`` does, so that the modes' mels
differ where their arithmetic does; the timing does not depend on it.

Vocoder: the counterpart of the JAX script's ``vocoder`` sweep: the shipped
NSF-HiFiGAN (``NsfHifiganConfig()``: 512 channels, rates 8·8·2·2·2,
ResBlock1 3/7/11 x 1/3/5) with random weights from a seed, a mel ~ N(0, 1)
``[B, T, 128]`` from a numpy seed and f0 = 220 Hz, no source noise, through
the time-folded layout (``models/vocoders/nsf_fast.py``) once per
``pallas_stages`` config of :data:`VOCODER_CONFIGS`: the stages listed run
the resblock-stage kernel K2, every other ResBlock1 unit the resblock-unit
kernel K6.  JAX's three ``(1,)`` configs differ only in the TPU tile and are
one here.  Then the stock layout (``use_folded_vocoder: false``, K2 on
stages 0 and 1) on the same weights and inputs.  One line each: ms per call
and audio seconds per second.  The compute dtype is bf16 on the card and
f32 on the CPU, as in the vocoder wrapper.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import acoustic_defaults
from ..models.vocoders.nsf_fast import FastNsfHifigan
from ..models.vocoders.nsf_hifigan import Generator, NsfHifiganConfig
from ..models.backbones.lynx_cuda import (
    lynx_cond_projections, lynx_denoiser_apply, lynx_kernel_weights,
)
from ..training.acoustic import build_acoustic
from ..utils import resolve_device

MODES = ("module", "v1", "v2", "v3", "hybrid")
SETS = {"base": ("module", "v1", "v2"), "v3": ("v1", "v3"), "hybrid": ("v1", "hybrid"),
        "all": MODES}
VOCAB = 62  # the JAX sweep's token vocabulary
_APPLY = {"v1": {}, "v2": {"fused_layer": True}, "v3": {"fused_layer": "v3"},
          "hybrid": {"module_impl": "hybrid"}}


def _mean_ms(call, reps: int, device: torch.device) -> float:
    """Mean host ms of ``reps`` calls after one warm-up call, the run ended
    by a device synchronise."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    call()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    sync()
    return (time.perf_counter() - t0) * 1e3 / reps


def sweep_inputs(B: int, T: int, vocab: int = VOCAB, seed: int = 0):
    """The JAX sweep's inputs, from a numpy seed: tokens ``[B, 64]``, a sorted
    ``mel2ph`` over them and a random f0 (100-500 Hz)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, size=(B, 64)).astype(np.int64)
    mel2ph = np.clip(np.sort(rng.integers(1, 65, size=(B, T))), 1, 64).astype(np.int64)
    f0 = rng.uniform(100, 500, size=(B, T)).astype(np.float32)
    return tokens, mel2ph, f0


class SamplerSweep:
    """One acoustic model, one batch and one start noise, sampled in any mode.

    ``model`` is an eval-mode port ``AcousticModel`` on ``device`` and
    ``core`` / ``normalizer`` its rectified-flow core and normaliser; the
    inputs are numpy arrays and ``noise`` the start noise ``[B, 1, T, M]``.
    The kernels' weights are prepared once, here."""

    def __init__(self, cfg, model, core, normalizer, tokens, mel2ph, f0, noise, *,
                 steps: int = 50, device=None, compute_dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.cfg, self.model, self.core, self.normalizer = cfg, model, core, normalizer
        self.steps = steps
        self.compute_dtype = compute_dtype
        dev = self.device
        self.tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        self.mel2ph = torch.as_tensor(mel2ph, dtype=torch.long, device=dev)
        self.f0 = torch.as_tensor(f0, dtype=torch.float32, device=dev)
        self.noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
        self.kernel_weights = lynx_kernel_weights(model.backbone, compute_dtype)

    @classmethod
    def random(cls, *, device=None, B: int = 4, T: int = 2048, steps: int = 50,
               overrides: Optional[dict] = None, seed: int = 0,
               compute_dtype=torch.bfloat16) -> "SamplerSweep":
        """The shipped configuration (with ``overrides``) and random weights
        from ``seed``."""
        device = resolve_device(device)
        cfg = acoustic_defaults()
        cfg.update(overrides or {})
        torch.manual_seed(seed)
        model, core, normalizer = build_acoustic(cfg, VOCAB)
        with torch.no_grad():
            model.backbone.output_projection.weight.normal_(0.0, 0.02)
            for block in model.aux_decoder.decoder.conv:
                block.gamma.normal_(0.0, 0.1)
        tokens, mel2ph, f0 = sweep_inputs(B, T, seed=seed)
        noise = np.random.default_rng(seed + 1).standard_normal(
            (B, 1, T, cfg["audio_num_mel_bins"])).astype(np.float32)
        return cls(cfg, model.to(device).eval(), core, normalizer, tokens, mel2ph, f0, noise,
                   steps=steps, device=device, compute_dtype=compute_dtype)

    @torch.no_grad()
    def run(self, mode: str) -> torch.Tensor:
        """One sampler call in ``mode``: the denormed mel ``[B, T, M]``, f32."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; modes: {', '.join(MODES)}")
        model, cd = self.model, self.compute_dtype
        cond = model.condition(self.tokens, self.mel2ph, self.f0)
        aux = model.aux_out(cond) * (self.mel2ph > 0)[:, :, None]
        if mode == "module":
            autocast = torch.autocast(self.device.type, dtype=cd) \
                if cd != torch.float32 else contextlib.nullcontext()

            def velocity_fn(x, t):
                with autocast:
                    return model.denoise(x, t, cond).float()
        else:
            backbone = model.backbone
            cond_projs = lynx_cond_projections(backbone, cond, cd)
            options = _APPLY[mode]

            def velocity_fn(x, t):
                return lynx_denoiser_apply(backbone, x, t, cond_projs=cond_projs,
                                           kernel_weights=self.kernel_weights,
                                           compute_dtype=cd, **options).float()

        x = self.core.inference(velocity_fn, tuple(self.noise.shape),
                                x_end=aux.float()[:, None],
                                t_start=self.cfg.get("T_start_infer", 0.4), steps=self.steps,
                                algorithm="euler", noise=self.noise)
        return self.normalizer.denorm(x)

    def time(self, mode: str, reps: int = 3) -> Dict[str, float]:
        """Mean host ms of ``reps`` calls (:func:`_mean_ms`); ms per call and
        per step."""
        ms = _mean_ms(lambda: self.run(mode), reps, self.device)
        return {"ms": ms, "ms_per_step": ms / self.steps}


def sweep_sampler(modes: Sequence[str] = SETS["base"], *, device=None, B: int = 4,
                  T: int = 2048, steps: int = 50, reps: int = 3,
                  overrides: Optional[dict] = None, seed: int = 0,
                  sweep: Optional[SamplerSweep] = None) -> Dict[str, Dict[str, float]]:
    """Time every mode of ``modes`` on one random model (or on ``sweep``);
    prints one line per mode and returns ``{mode: {"ms", "ms_per_step"}}``."""
    sweep = sweep or SamplerSweep.random(device=device, B=B, T=T, steps=steps,
                                         overrides=overrides, seed=seed)
    out = {}
    for mode in modes:
        out[mode] = sweep.time(mode, reps)
        print(f"sampler {mode}: {out[mode]['ms']:.4f} ms per call, "
              f"{out[mode]['ms_per_step']:.4f} ms per step "
              f"[B={sweep.noise.shape[0]}, T={sweep.noise.shape[2]}, {sweep.steps} steps, "
              f"{sweep.device}]", flush=True)
    return out


VOCODER_CONFIGS = ((), (1,), (0,), (0, 1), (0, 1, 2))
VOCODER_F0 = 220.0


class VocoderSweep:
    """One random vocoder, one mel and one f0, vocoded in the folded layout
    with any ``pallas_stages`` config (built once per config) or in the stock
    layout (``stages=None``)."""

    def __init__(self, generator: Generator, mel: np.ndarray, f0: np.ndarray, *, device=None):
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.generator = generator.to(self.device).eval()
        self.mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        self.f0 = torch.as_tensor(f0, dtype=torch.float32, device=self.device)
        self._folded: Dict[tuple, FastNsfHifigan] = {}
        self._stock = None

    @classmethod
    def random(cls, *, device=None, B: int = 4, T: int = 2048, seed: int = 0) -> "VocoderSweep":
        device = resolve_device(device)
        vcfg = NsfHifiganConfig()
        torch.manual_seed(seed)
        generator = Generator(vcfg)
        mel = np.random.default_rng(seed).standard_normal((B, T, vcfg.num_mels))
        return cls(generator, mel.astype(np.float32), np.full((B, T), VOCODER_F0, np.float32),
                   device=device)

    @property
    def audio_s(self) -> float:
        h = self.generator.config
        return self.mel.shape[0] * self.mel.shape[1] * h.hop_size / h.sampling_rate

    def folded(self, stages: Sequence[int]) -> FastNsfHifigan:
        key = tuple(stages)
        if key not in self._folded:
            self._folded[key] = FastNsfHifigan(self.generator, self.dtype, pallas_stages=key,
                                               device=self.device)
        return self._folded[key]

    @torch.no_grad()
    def run(self, stages: Optional[Sequence[int]]) -> torch.Tensor:
        """One vocoder call: the wav ``[B, T*hop]`` f32; ``stages=None`` runs
        the stock layout."""
        if stages is not None:
            return self.folded(stages)(self.mel, self.f0)
        if self._stock is None:
            self._stock = self.generator.prepare_stages(self.dtype)
        return self.generator(self.mel, self.f0, dtype=self.dtype, stages=self._stock)

    def time(self, stages: Optional[Sequence[int]], reps: int = 3) -> Dict[str, float]:
        """Mean host ms of ``reps`` calls (:func:`_mean_ms`); ms per call and
        audio-s/s."""
        ms = _mean_ms(lambda: self.run(stages), reps, self.device)
        return {"ms": ms, "audio_s_per_s": self.audio_s / (ms * 1e-3)}


def sweep_vocoder(*, device=None, B: int = 4, T: int = 2048, reps: int = 3, seed: int = 0,
                  sweep: Optional[VocoderSweep] = None) -> Dict[str, Dict[str, float]]:
    """Time the folded layout at every config of :data:`VOCODER_CONFIGS`,
    then the stock layout, on one random vocoder (or on ``sweep``); prints
    one line each and returns ``{name: {"ms", "audio_s_per_s"}}`` with names
    ``stages=(...)`` and ``stock``."""
    sweep = sweep or VocoderSweep.random(device=device, B=B, T=T, seed=seed)
    runs = [(f"stages={c}", c) for c in VOCODER_CONFIGS] + [("stock", None)]
    out = {}
    for name, stages in runs:
        out[name] = sweep.time(stages, reps)
        print(f"vocoder {name}: {out[name]['ms']:.4f} ms per call, "
              f"{out[name]['audio_s_per_s']:.4f} audio-s/s "
              f"[B={sweep.mel.shape[0]}, T={sweep.mel.shape[1]}, {sweep.device}]", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m xiaoicesing_io_tpu_torch.tools.perf_sweep")
    parser.add_argument("which", choices=("sampler", "vocoder"))
    parser.add_argument("set", nargs="?", default="base", choices=tuple(SETS),
                        help="the sampler's set of modes (the vocoder sweep runs every config)")
    parser.add_argument("--device", default=None)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--frames", type=int, default=2048)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    if args.which == "vocoder":
        sweep_vocoder(device=args.device, B=args.batch, T=args.frames, reps=args.reps)
        return 0
    sweep_sampler(SETS[args.set], device=args.device, B=args.batch, T=args.frames,
                  steps=args.steps, reps=args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
