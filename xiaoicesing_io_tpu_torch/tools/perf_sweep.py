"""Sampler sweep over the LYNXNet denoiser's kernel variants.

Counterpart of the JAX package's ``tools/perf_sweep.py sampler``: the shipped
``configs/acoustic.json`` acoustic model (LYNXNet 1024 x 6, k 31,
strong_cond) with random weights from a seed, B=4 sequences of T=2048
frames, 50 Euler steps of the rectified flow from T_start 0.4 with the aux
decoder's output as ``x_end``, then the normaliser's ``denorm``; one call per
mode, timed on the host clock around work that ends in a device synchronise.

    python -m xiaoicesing_io_tpu_torch.tools.perf_sweep sampler [base|v3|hybrid|all]
        [--device cuda|cpu] [--batch B] [--frames T] [--steps K] [--reps N]

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
purpose) and are not ported.  The JAX script's ``vocoder`` sweep needs the
time-folded vocoder, which is not ported yet.

The model's zero-initialised output projection and 1e-6 ConvNeXt layer
scales are randomised as ``chip_smoke.py`` does, so that the modes' mels
differ where their arithmetic does; the timing does not depend on it.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import acoustic_defaults
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

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def time(self, mode: str, reps: int = 3) -> Dict[str, float]:
        """Mean host ms of ``reps`` calls after one warm-up call, each ended
        by a device synchronise; ms per call and per step."""
        self.run(mode)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            self.run(mode)
        self._sync()
        ms = (time.perf_counter() - t0) * 1e3 / reps
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m xiaoicesing_io_tpu_torch.tools.perf_sweep")
    parser.add_argument("which", choices=("sampler", "vocoder"))
    parser.add_argument("set", nargs="?", default="base", choices=tuple(SETS))
    parser.add_argument("--device", default=None)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--frames", type=int, default=2048)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    if args.which == "vocoder":
        raise NotImplementedError("the vocoder sweep needs the time-folded vocoder "
                                  "(models/vocoders/nsf_fast.py), which is not ported yet")
    sweep_sampler(SETS[args.set], device=args.device, B=args.batch, T=args.frames,
                  steps=args.steps, reps=args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
