"""Vocoder copy-synthesis evaluation.

Counterpart of the JAX package's ``inference/val_vocoder.py`` (the
reference's ``inference/val_nsf_hifigan.py``): extract the ground-truth
log-mel and f0 from wav files, vocode them back, write the reconstructions
and score each against its source by mel MAE and PESQ* (the built-in pitch
tracker stands in for torchcrepe).

On the card the (ground truth, reconstruction) pair is scored through the
batched device mel, one launch of the fused STFT -> log-mel kernel (K3) per
file; on the CPU the reconstruction's mel comes from the host path, as in the
JAX package off the TPU.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..dsp.pitch import get_pitch
from ..ops.mel import MelConfig, MelSpectrogram
from ..utils import resolve_device
from ..utils.audio import load_wav, save_wav


def _score_pair(extractor: MelSpectrogram, wav: np.ndarray, rec: np.ndarray, mel: np.ndarray,
                device: Optional[torch.device], plain: bool = False) -> float:
    """Mel MAE of ``rec`` against ``wav``, whose host mel is ``mel``.

    With a ``device``, both signals, cut to the shorter, go through
    :meth:`MelSpectrogram.device` as one ``[2, T]`` batch (K3 on a CUDA
    device, the plain version on the CPU or with ``plain``), and the first
    ``len(mel)`` frames are compared.  With ``device=None``, the
    reconstruction's mel comes from the host path and is compared with
    ``mel``."""
    if device is None:
        mel_rec = extractor.numpy(rec[: len(wav)])
        n = min(len(mel), len(mel_rec))
        return float(np.abs(mel[:n] - mel_rec[:n]).mean())
    m = min(len(wav), len(rec))
    y = torch.from_numpy(np.stack([wav[:m], rec[:m]]).astype(np.float32)).to(device)
    pair = extractor.device(y, plain=plain).cpu().numpy()
    n = len(mel)
    return float(np.abs(pair[0][:n] - pair[1][:n]).mean())


def copy_synthesis(wav_paths, cfg, out_dir, vocoder=None, device=None):
    """Copy-synthesise each wav; returns one dict per file: ``file``, ``out``,
    ``mel_mae``, ``pesq`` and ``seconds`` (host seconds per stage: ``load``,
    ``gt_mel``, ``pitch``, ``vocoder``, ``save``, ``score``, ``pesq``)."""
    from ..eval.metrics import pesq_approx

    device = resolve_device(device)
    if vocoder is None:
        from ..models.vocoders.wrapper import NsfHifiGAN

        vocoder = NsfHifiGAN(cfg, device=device)
    mel_extractor = MelSpectrogram(MelConfig.from_config(cfg))
    score_device = device if device.type == "cuda" else None
    sr = cfg["audio_sample_rate"]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for p in wav_paths:
        p = Path(p)
        seconds = {}
        t0 = time.perf_counter()

        def lap(name):
            nonlocal t0
            now = time.perf_counter()
            seconds[name] = now - t0
            t0 = now

        wav, _ = load_wav(p, sr=sr, mono=True)
        lap("load")
        mel = mel_extractor.numpy(wav)
        lap("gt_mel")
        f0, _ = get_pitch(
            wav, sr, mel.shape[0], hop_size=cfg["hop_size"],
            f0_min=cfg["f0_min"], f0_max=cfg["f0_max"], interp_uv=True,
        )
        lap("pitch")
        rec = vocoder.spec2wav(mel, f0)
        lap("vocoder")
        out_path = out_dir / f"{p.stem}_copysyn.wav"
        save_wav(rec, out_path, sr)
        lap("save")
        mae = _score_pair(mel_extractor, wav, rec, mel, score_device)
        lap("score")
        m = min(len(wav), len(rec))
        pesq = pesq_approx(wav[:m], rec[:m], sr)
        lap("pesq")
        results.append({
            "file": str(p), "out": str(out_path),
            "mel_mae": mae, "pesq": pesq, "seconds": seconds,
        })
        print(f"| {p.name}: mel MAE {mae:.4f} PESQ* {pesq:.2f} -> {out_path}")
    return results
