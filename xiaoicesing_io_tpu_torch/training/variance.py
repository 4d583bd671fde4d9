"""Variance model sampling under the validation condition.

Counterpart of the JAX package's ``training/variance.py:
sample_variance_inference`` (the losses and the train step are not ported
yet).  A collated batch (``data/dataset.VarianceDataset.collate``) is
sampled at its own shape: ground-truth ``mel2ph``, full retake, and the
encoder given ``ph_dur`` (it sums the word durations from them).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..inference.variance import BATCH_TYPES, head_denoiser
from ..models.diffusion.core import GaussianDiffusion


def batch_tensors(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch as tensors on ``device``: indices as int64,
    masks as bool, curves as f32."""
    return {k: torch.as_tensor(np.asarray(v), dtype=BATCH_TYPES.get(k, torch.float32),
                               device=device) for k, v in batch.items()}


@torch.no_grad()
def sample_variance_inference(
    cfg, model, core, normalizers, batch: Dict[str, np.ndarray], *,
    kernel_weights: Optional[Dict[str, list]] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Dict[str, np.ndarray]] = None,
    want_pitch: bool = True, want_variances: bool = False,
) -> Tuple[Optional[torch.Tensor], Dict[str, torch.Tensor]]:
    """Sampled pitch and variance curves of a collated batch.

    ``kernel_weights`` maps a head (``pitch``, ``variances``) to its
    prepared K4 weights (``inference/variance.head_kernel_weights``): such a
    head runs ``wavenet_denoiser_apply``, bf16 with the kernel on the card
    and f32 with its plain version on the CPU; any other head its f32
    module.  ``noise`` maps a head to its start noise ``[B, F, T, bins]``;
    a head without one draws it from ``generator`` (the pitch head first).  Returns ``(pitch [B, T] in MIDI
    or None, {name: curve [B, T]})``: the pitch is the base pitch plus the
    sampled delta, the curves denormalised.
    """
    dev = next(model.parameters()).device
    cd = torch.bfloat16 if dev.type == "cuda" else torch.float32
    kernel_weights = kernel_weights or {}
    noise = noise or {}
    b = batch_tensors(batch, dev)
    mel2ph = b["mel2ph"]
    spk_id = b["spk_ids"] if cfg.get("use_spk_id", False) else None
    encoder_out, _ = model.encode(b["tokens"], b["midi"], b["ph2word"], ph_dur=b["ph_dur"],
                                  spk_id=spk_id, infer=True)
    condition = model.frame_condition(encoder_out, mel2ph, spk_id=spk_id)

    def sample(head, backbone, cond, shape):
        denoise_fn = head_denoiser(backbone, cond, kernel_weights.get(head), cd)
        start = noise.get(head)
        if start is not None:
            start = torch.tensor(np.asarray(start, np.float32), device=dev)
        if isinstance(core, GaussianDiffusion):
            return core.inference(
                denoise_fn, shape, depth=cfg.get("K_step_infer", core.k_step),
                speedup=cfg.get("diff_speedup", 10),
                algorithm=cfg.get("diff_accelerator", "ddim"),
                solver_order=cfg.get("dpm_solver_order", 2),
                unipc_variant=cfg.get("unipc_variant", "bh2"),
                noise=start, generator=generator, device=dev)
        return core.inference(denoise_fn, shape, t_start=0.0,
                              steps=cfg.get("sampling_steps", 20),
                              algorithm=cfg.get("sampling_algorithm", "euler"),
                              noise=start, generator=generator, device=dev)

    B, T = mel2ph.shape
    pred_pitch = None
    if want_pitch and cfg.get("predict_pitch", False):
        pitch_cond = model.pitch_condition(
            condition, mel2ph, b["base_pitch"], note_midi=b["note_midi"],
            note_rest=b["note_rest"], note_dur=b["note_dur"], note_glide=b.get("note_glide"),
            mel2note=b["mel2note"])
        bins = cfg.get("pitch_prediction_args", {}).get("repeat_bins", 64)
        delta = sample("pitch", model.pitch_backbone, pitch_cond, (B, 1, T, bins))
        pred_pitch = normalizers["pitch"].denorm(delta) + b["base_pitch"]

    variances_out = {}
    names = model.variance_prediction_list
    if want_variances and names:
        var_cond = model.variance_condition(condition, b["pitch"], {})
        bins = cfg.get("variances_prediction_args", {}).get("total_repeat_bins", 48)
        x = sample("variances", model.variance_backbone, var_cond,
                   (B, len(names), T, bins // len(names)))
        out = normalizers["variances"].denorm(x)
        variances_out = dict(zip(names, [out] if len(names) == 1 else out))
    return pred_pitch, variances_out
