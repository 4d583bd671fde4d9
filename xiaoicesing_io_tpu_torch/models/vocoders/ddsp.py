"""pc-ddsp vocoder: a TorchScript archive with a ``config.yaml`` beside it.

Counterpart of the JAX package's ``DDSP`` wrapper.  The reference ships
this vocoder only as a TorchScript archive, so there is no source to port:
the archive runs as it is, loaded with ``torch.jit.load`` onto the
wrapper's device (the card by default; the JAX package runs it on the CPU).
The config's sample rate, mel bins and hop size are checked against the
experiment's (a mismatch is printed), and a log10 mel (``mel_base`` other
than ``e``) is scaled to natural log before synthesis.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ...config import read_file
from ...utils import resolve_device
from . import register_vocoder


@register_vocoder
class DDSP:
    def __init__(self, cfg, model_path=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        model_path = Path(model_path or cfg["vocoder_ckpt"])
        if not model_path.exists():
            raise FileNotFoundError(f"DDSP model is not found at '{model_path}'")
        self.args = read_file(model_path.with_name("config.yaml"))
        data = self.args.get("data", self.args)
        for ck, vk in [("audio_sample_rate", "sampling_rate"),
                       ("audio_num_mel_bins", "n_mels"), ("hop_size", "block_size")]:
            if ck in cfg and vk in data and cfg[ck] != data[vk]:
                print(f"Mismatch parameters: cfg['{ck}']={cfg[ck]} != {data[vk]} (vocoder)")
        self.model = torch.jit.load(str(model_path), map_location=self.device)
        self.model.eval()

    @torch.no_grad()
    def spec2wav_torch(self, mel: torch.Tensor, f0: torch.Tensor,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mel ``[B, T, M]``, f0 ``[B, T]`` on the wrapper's device -> wav
        ``[B, T*hop]``.  ``generator`` is accepted for the vocoders' common
        signature and not used: the archive has no seedable randomness."""
        if self.cfg.get("mel_base", 10) != "e":
            mel = 2.30259 * mel  # log10 -> ln
        signal, _, (_, _) = self.model(mel, f0[..., None])
        return signal

    def spec2wav(self, mel: np.ndarray, f0: np.ndarray,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """mel ``[T, M]`` or ``[B, T, M]``, f0 ``[T]`` or ``[B, T]`` -> wav."""
        mel = torch.as_tensor(np.asarray(mel, np.float32))
        f0 = torch.as_tensor(np.asarray(f0, np.float32))
        squeeze = mel.dim() == 2
        if squeeze:
            mel, f0 = mel[None], f0[None]
        wav = self.spec2wav_torch(mel.to(self.device), f0.to(self.device), generator)
        wav = wav.float().cpu().numpy()
        return wav[0] if squeeze else wav
