"""NSF-HiFiGAN vocoder wrapper: load ``model.ckpt`` + ``config.json``, check the
mel parameters, ``spec2wav``.

Counterpart of the JAX package's ``NsfHifiGAN`` on the stock generator layout.
The checkpoint is a reference NSF-HiFiGAN ``model.ckpt`` (``{"generator":
state_dict}`` or a bare state dict); weight-norm factors are merged if present.
On the card the generator computes in bf16 with the resblock-stage kernel on
stages 0 and 1 of a ResBlock1 generator, whatever their width (the kernel
raises for a width it does not take); on the CPU in f32, with the kernel's
plain version on those stages.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ...utils import resolve_device
from . import register_vocoder
from .nsf_hifigan import Generator, NsfHifiganConfig


def merge_weight_norm(state_dict: dict) -> dict:
    """``weight_g`` / ``weight_v`` pairs -> ``weight`` (norm over all but dim 0)."""
    sd = {}
    for k, v in state_dict.items():
        if k.endswith("weight_g"):
            continue
        if k.endswith("weight_v"):
            base = k[: -len("weight_v")]
            g = state_dict[base + "weight_g"]
            dims = tuple(range(1, v.dim()))
            norm = torch.sqrt((v.float() ** 2).sum(dim=dims, keepdim=True))
            sd[base + "weight"] = g * v / torch.clamp(norm, min=1e-12)
        else:
            sd[k] = v
    return sd


@register_vocoder
class NsfHifiGAN:
    def __init__(self, cfg, model_path=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        model_path = Path(model_path or cfg["vocoder_ckpt"])
        if not model_path.exists():
            raise FileNotFoundError(
                f"NSF-HiFiGAN vocoder model is not found at '{model_path}'. "
                "Please follow instructions in docs/BestPractices.md#vocoders to get one."
            )
        with open(model_path.with_name("config.json")) as f:
            self.h = json.load(f)
        self.vcfg = NsfHifiganConfig.from_json(self.h)
        ckpt = torch.load(model_path, map_location="cpu", weights_only=True)
        sd = merge_weight_norm(ckpt.get("generator", ckpt))
        self.generator = Generator(self.vcfg)
        self.generator.load_state_dict(sd, strict=True)
        self.generator.to(self.device).eval()
        self._check_params()
        on_card = self.device.type == "cuda"
        self.dtype = torch.bfloat16 if on_card else torch.float32
        self.stages = self.generator.prepare_stages(self.dtype)

    def _check_params(self):
        pairs = [
            ("audio_sample_rate", "sampling_rate"), ("audio_num_mel_bins", "num_mels"),
            ("fft_size", "n_fft"), ("win_size", "win_size"), ("hop_size", "hop_size"),
            ("fmin", "fmin"), ("fmax", "fmax"),
        ]
        for ck, vk in pairs:
            if ck in self.cfg and vk in self.h and self.cfg[ck] != self.h[vk]:
                print(f"Mismatch parameters: cfg['{ck}']={self.cfg[ck]} != "
                      f"{self.h[vk]} (vocoder)")

    @torch.no_grad()
    def spec2wav_torch(self, mel: torch.Tensor, f0: torch.Tensor,
                       generator: Optional[torch.Generator] = None, *,
                       _f32_module: bool = False) -> torch.Tensor:
        """mel ``[B, T, M]`` (log10 or ln per ``mel_base``), f0 ``[B, T]`` on the
        vocoder's device -> wav ``[B, T*hop]`` f32.  ``_f32_module`` runs every
        stage's resblocks as f32 modules: the reference that ``chip_smoke.py``
        holds the bf16 kernel path against."""
        mel_base = self.cfg.get("mel_base", 10)
        if mel_base != "e":
            assert mel_base in (10, "10"), "mel_base must be 'e', '10' or 10."
            mel = 2.30259 * mel  # log10 -> ln
        if _f32_module:
            return self.generator(mel, f0, generator=generator, dtype=torch.float32, stages={})
        return self.generator(mel, f0, generator=generator, dtype=self.dtype,
                              stages=self.stages)

    def spec2wav(self, mel: np.ndarray, f0: np.ndarray,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """mel ``[T, M]`` or ``[B, T, M]``, f0 ``[T]`` or ``[B, T]`` -> wav.
        ``generator`` seeds the NSF source randomness; None gives a
        deterministic, noise-free source."""
        mel = torch.as_tensor(np.asarray(mel, np.float32))
        f0 = torch.as_tensor(np.asarray(f0, np.float32))
        squeeze = mel.dim() == 2
        if squeeze:
            mel, f0 = mel[None], f0[None]
        wav = self.spec2wav_torch(mel.to(self.device), f0.to(self.device), generator)
        wav = wav.cpu().numpy()
        return wav[0] if squeeze else wav
