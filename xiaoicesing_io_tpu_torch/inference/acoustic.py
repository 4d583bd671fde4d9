"""Acoustic inference: ``.ds`` segments -> mel -> waveform.

Counterpart of the JAX package's ``DiffSingerAcousticInfer``:
``preprocess_input`` (tokens, ``mel2ph`` from the cumsum-rounded ``ph_dur``,
f0 resampled to the frame grid), per-segment seeds, 256-frame bucket padding,
the vocoder, and offset placement with zero fill or crossfade.

The segments are padded to 256-frame buckets exactly as the JAX runner pads
them: the depthwise convs of LYNXNet and of the ConvNeXt aux decoder reach
into the padded frames, so the last frames of a segment depend on the padding.

A LYNXNet denoiser with PReLU runs ``lynx_denoiser_apply``: in bf16 with the
conv-module kernel on the card, whatever its width (the kernel raises for a
width it does not take), and in f32 with the kernel's plain version on the
CPU, where it matches the f32 module that the JAX package's CPU runner uses.

Not ported yet (``NotImplementedError``): speaker mixes, variance embeddings,
key-shift (gender) and speed (velocity) inputs, and the DDPM cores.
"""

from __future__ import annotations

import json
import re
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.backbones.lynx_cuda import (
    lynx_cond_projections, lynx_denoiser_apply, lynx_kernel_weights,
)
from ..models.toplevel import VARIANCE_CHECKLIST, load_acoustic_state_dict
from ..ops.seq import length_regulator
from ..training.acoustic import build_acoustic
from ..utils import fresh_seed, generator_from_seed, resolve_device
from ..utils.curves import cross_fade, resample_align_curve
from ..utils.phonemes import PhonemeDictionary, locate_dictionary
from ..utils.text_encoder import TokenTextEncoder
from .base import BaseSVSInfer

BUCKET = 256  # frame bucket size for padding


def _bucket(n: int) -> int:
    return max(BUCKET, ((n + BUCKET - 1) // BUCKET) * BUCKET)


def find_checkpoint(work_dir, ckpt_steps: Optional[int] = None) -> Path:
    """The latest (or the given step's) ``model_ckpt_steps_*.ckpt`` in ``work_dir``."""
    ckpts = sorted(Path(work_dir).glob("model_ckpt_steps_*.ckpt"),
                   key=lambda p: int(re.search(r"(\d+)", p.stem).group(1)))
    if ckpt_steps is not None:
        ckpts = [p for p in ckpts if int(re.search(r"(\d+)", p.stem).group(1)) == int(ckpt_steps)]
    if not ckpts:
        raise FileNotFoundError(f"No model_ckpt_steps_*.ckpt found in {work_dir}")
    return ckpts[-1]


def _unsupported(cfg) -> List[str]:
    keys = [f"use_{v}_embed" for v in VARIANCE_CHECKLIST]
    keys += ["use_key_shift_embed", "use_speed_embed"]
    return [k for k in keys if cfg.get(k, False)]


class DiffSingerAcousticInfer(BaseSVSInfer):
    def __init__(self, cfg, load_vocoder: bool = True, ckpt_steps=None, device=None):
        super().__init__(cfg)
        self.device = resolve_device(device)
        unsupported = _unsupported(cfg)
        if unsupported:
            raise NotImplementedError(f"not ported yet: {', '.join(unsupported)}")
        phdict = PhonemeDictionary.load(
            locate_dictionary(cfg.get("dictionary"), cfg.get("work_dir"))
        )
        self.ph_encoder = TokenTextEncoder(phdict.phoneme_list)
        model, self.core, self.normalizer = build_acoustic(cfg, self.ph_encoder.vocab_size)
        # reference Lightning checkpoints hold more than tensors
        ckpt = torch.load(find_checkpoint(cfg["work_dir"], ckpt_steps), map_location="cpu",
                          weights_only=False)
        load_acoustic_state_dict(model, ckpt.get("state_dict", ckpt))
        self.model = model.to(self.device).eval()
        self.compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.kernel_weights = None
        if self.use_kernels:
            self.kernel_weights = lynx_kernel_weights(self.model.backbone, self.compute_dtype)
        self.vocoder = None
        if load_vocoder:
            from ..models.vocoders import get_vocoder_cls

            self.vocoder = get_vocoder_cls(cfg.get("vocoder", "NsfHifiGAN"))(cfg, device=device)

    @property
    def use_kernels(self) -> bool:
        """A LYNXNet denoiser with PReLU, the function the conv-module kernel
        computes, runs ``lynx_denoiser_apply``: the kernel in bf16 on the card,
        its plain version in f32 on the CPU.  Any other denoiser runs its f32
        module, as in the JAX runner."""
        bargs = self.cfg.get("backbone_args", {})
        return (self.cfg.get("backbone_type") == "lynxnet"
                and bargs.get("activation", "PReLU") == "PReLU")

    # -- preprocessing --------------------------------------------------------

    def preprocess_input(self, param: dict, idx: int = 0) -> Dict[str, np.ndarray]:
        batch: Dict[str, np.ndarray] = {}
        summary = OrderedDict()
        tokens = np.asarray([self.ph_encoder.encode(param["ph_seq"])], np.int64)
        batch["tokens"] = tokens

        ph_dur = np.array(param["ph_dur"].split(), np.float32)
        ph_acc = np.round(np.cumsum(ph_dur) / self.timestep + 0.5).astype(np.int64)
        durations = np.diff(ph_acc, prepend=0)[None]
        durations = durations * (tokens != 0)
        length = int(durations.sum())
        batch["mel2ph"] = length_regulator(torch.from_numpy(durations), out_len=length).numpy()

        summary["tokens"] = tokens.shape[1]
        summary["frames"] = length
        summary["seconds"] = "%.2f" % (length * self.timestep)

        batch["f0"] = resample_align_curve(
            np.array(param["f0_seq"].split(), np.float32),
            original_timestep=float(param["f0_timestep"]),
            target_timestep=self.timestep,
            align_length=length,
        )[None]
        print(f"[{idx}]\t" + ", ".join(f"{k}: {v}" for k, v in summary.items()))
        return batch

    # -- model forward --------------------------------------------------------

    @torch.no_grad()
    def synthesize(self, tokens, mel2ph, f0, noise=None,
                   generator: Optional[torch.Generator] = None,
                   timings: Optional[dict] = None, *, _f32_module: bool = False) -> torch.Tensor:
        """Tensors on the runner's device -> masked mel ``[B, T, M]`` (value
        domain).  ``noise`` is the sampler's start noise ``[B, 1, T, M]``;
        drawn from ``generator`` when None.  ``timings``, when given, receives
        host seconds of the condition + aux stage and of the sampler (both
        ended by a device synchronise).  ``_f32_module`` runs the f32
        ``LYNXNet`` module in place of the kernel path: the reference that
        ``chip_smoke.py`` holds the kernel path against."""
        cfg = self.cfg
        model = self.model
        sync = (lambda: torch.cuda.synchronize(self.device)) if self.device.type == "cuda" \
            else (lambda: None)
        t0 = _now()
        cond = model.condition(tokens, mel2ph, f0)
        mask = (mel2ph > 0)[:, :, None]
        shape = (cond.shape[0], 1, cond.shape[1], cfg["audio_num_mel_bins"])
        x_src = None
        if cfg.get("use_shallow_diffusion", False):
            x_src = (model.aux_out(cond) * mask).float()[:, None]
        if timings is not None:
            sync()
            timings["cond_aux"] = _now() - t0
            t0 = _now()

        if self.use_kernels and not _f32_module:
            backbone = model.backbone
            cd = self.compute_dtype
            cond_projs = lynx_cond_projections(backbone, cond, cd)

            def velocity_fn(x, t):
                return lynx_denoiser_apply(backbone, x, t, cond_projs=cond_projs,
                                           kernel_weights=self.kernel_weights,
                                           compute_dtype=cd).float()
        else:
            def velocity_fn(x, t):
                return model.denoise(x, t, cond).float()

        x = self.core.inference(
            velocity_fn, shape, x_end=x_src,
            t_start=cfg.get("T_start_infer", self.core.t_start),
            steps=cfg.get("sampling_steps", 20),
            algorithm=cfg.get("sampling_algorithm", "euler"),
            noise=noise, generator=generator, device=self.device,
        )
        mel = self.normalizer.denorm(x) * mask
        if timings is not None:
            sync()
            timings["sampler"] = _now() - t0
        return mel

    def forward_model(self, batch: Dict[str, np.ndarray], seed: int = 0,
                      noise: Optional[np.ndarray] = None, *,
                      _f32_module: bool = False) -> np.ndarray:
        """Pad to a frame bucket, synthesise, crop.  ``noise`` (``[1, 1,
        bucket, M]``) replaces the start noise drawn from ``seed``;
        ``_f32_module`` is :meth:`synthesize`'s."""
        length = batch["mel2ph"].shape[1]
        padded_len = _bucket(length)
        dev = self.device

        def pad(v):
            v = np.asarray(v)
            return np.pad(v, [(0, 0), (0, padded_len - length)] + [(0, 0)] * (v.ndim - 2))

        tokens = torch.as_tensor(np.asarray(batch["tokens"]), dtype=torch.long, device=dev)
        mel2ph = torch.as_tensor(pad(batch["mel2ph"]), dtype=torch.long, device=dev)
        f0 = torch.as_tensor(pad(batch["f0"]), dtype=torch.float32, device=dev)
        generator = None
        if noise is not None:
            noise = torch.tensor(np.asarray(noise, np.float32), device=dev)
        else:
            generator = generator_from_seed(seed, dev)
        mel = self.synthesize(tokens, mel2ph, f0, noise=noise, generator=generator,
                              _f32_module=_f32_module)
        return mel[:, :length].cpu().numpy()

    def run_vocoder(self, mel: np.ndarray, f0: np.ndarray,
                    seed: Optional[int] = None) -> np.ndarray:
        """Vocode one segment; ``seed`` drives the NSF source noise."""
        return self.vocoder.spec2wav(mel[0], f0[0],
                                     generator=generator_from_seed(seed, self.device, salt=1))

    # -- a whole .ds ----------------------------------------------------------

    def run_inference(self, params: List[dict], out_dir, title: str, num_runs: int = 1,
                      seed: int = -1, save_mel: bool = False) -> List[Path]:
        batches = [self.preprocess_input(p, idx=i) for i, p in enumerate(params)]
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        suffix = ".wav" if not save_mel else ".mel.npz"
        sr = self.cfg["audio_sample_rate"]
        paths = []
        for run in range(num_runs):
            run_seed = seed if seed >= 0 else fresh_seed()
            result = [] if save_mel else np.zeros(0)
            current_length = 0
            for i, (param, batch) in enumerate(zip(params, batches)):
                seg_seed = int(param.get("seed", run_seed + i))
                mel_pred = self.forward_model(batch, seed=seg_seed)
                if save_mel:
                    result.append({"offset": param.get("offset", 0.0), "mel": mel_pred[0],
                                   "f0": np.asarray(batch["f0"])[0]})
                    continue
                wav = self.run_vocoder(mel_pred, np.asarray(batch["f0"]), seed=seg_seed)
                silent = round(param.get("offset", 0) * sr) - current_length
                if silent >= 0:
                    result = np.append(result, np.zeros(silent))
                    result = np.append(result, wav)
                else:
                    result = cross_fade(result, wav, current_length + silent)
                current_length = current_length + silent + wav.shape[0]
            name = f"{title}-{run:03d}{suffix}" if num_runs > 1 else title + suffix
            path = out_dir / name
            if save_mel:
                np.savez(path, **{f"seg{i}_{k}": v for i, d in enumerate(result)
                                  for k, v in d.items()})
                print(f"| save mel: {path}")
            else:
                from ..utils.audio import save_wav

                save_wav(result, path, sr)
                print(f"| save audio: {path}")
            paths.append(path)
        return paths


def _now() -> float:
    import time

    return time.perf_counter()


def load_ds(path) -> List[dict]:
    with open(path, "r", encoding="utf-8") as f:
        params = json.load(f)
    return params if isinstance(params, list) else [params]
