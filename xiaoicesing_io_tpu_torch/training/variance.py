"""Variance training and sampling (counterpart of the JAX package's
``training/variance.py``).

:func:`variance_losses`: ``lambda_dur_loss`` x the duration loss, and the
pitch and multi-variance heads' diffusion or rectified-flow losses, masked
by ``mel2ph > 0``, under random retake masks (:func:`random_retake_masks`:
a quarter of the rows whole, else one random span).  Without the melody
encoder the pitch target is the delta to the base pitch on retaken frames
only: the condition already holds the given pitch elsewhere.
:func:`sample_variance_inference` samples a collated batch
(``data/dataset.VarianceDataset.collate``) at its own shape under the
validation condition: ground-truth ``mel2ph``, full retake, and the encoder
given ``ph_dur`` (it sums the word durations from them).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..inference.variance import BATCH_TYPES, head_denoiser
from ..models.diffusion.core import GaussianDiffusion
from . import losses
from ..parallel.mesh import all_reduce_max
from .acoustic import diffusion_branch, make_train_step, rank_rows


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


def random_retake_masks(b: int, t: int, generator: Optional[torch.Generator] = None,
                        device=None, *, full: Optional[torch.Tensor] = None,
                        ends: Optional[torch.Tensor] = None,
                        shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``[b, t]`` retake masks: a row is retaken whole where its draw
    ``full`` (``[b, 1]`` in ``[0, 4)``) is 0, else on ``[lo, hi)`` of its two
    sorted draws ``ends`` (``[b, 2]`` in ``[0, t]``).  The draws come from
    ``generator`` unless given (for the global batch under ``shard``,
    :func:`~.acoustic.rank_rows`)."""
    if full is None:
        full = rank_rows(lambda n: torch.randint(0, 4, (n, 1), generator=generator,
                                                 device=device), b, shard)
    if ends is None:
        ends = rank_rows(lambda n: torch.randint(0, t + 1, (n, 2), generator=generator,
                                                 device=device), b, shard)
    ends = ends.sort(dim=1).values
    idx = torch.arange(t, device=ends.device)[None, :]
    return (full == 0) | ((idx >= ends[:, :1]) & (idx < ends[:, 1:]))


def variance_losses(model, core, normalizers, cfg, batch: Dict[str, torch.Tensor],
                    generator: Optional[torch.Generator] = None, *,
                    retakes: Optional[Dict[str, torch.Tensor]] = None,
                    t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                    var_t: Optional[torch.Tensor] = None,
                    var_noise: Optional[torch.Tensor] = None,
                    shard: Optional[Tuple[int, int]] = None) -> Dict[str, torch.Tensor]:
    """One forward pass -> ``{"dur_loss", "pitch_loss", "var_loss"}`` (as
    configured).  ``retakes`` (``pitch`` and each predicted curve, bool
    ``[B, T]``), the pitch head's ``t`` and ``noise`` and the variance
    head's ``var_t`` and ``var_noise`` are drawn from ``generator`` unless
    given (the masks first: pitch, then the curves in order).  Under
    ``shard=(rank, world)`` (a rank of a data-parallel group) the draws are
    the global batch's rows of this rank, and the word-duration term divides
    by the largest ``ph2word`` over every rank (one collective)."""
    retakes = dict(retakes or {})
    out: Dict[str, torch.Tensor] = {}
    tokens = batch["tokens"]
    b = tokens.shape[0]
    predict_pitch = cfg.get("predict_pitch", True)
    names = model.variance_prediction_list
    spk_id = batch.get("spk_ids") if cfg.get("use_spk_id", False) else None
    encoder_out, dur_pred = model.encode(tokens, batch.get("midi"), batch.get("ph2word"),
                                         ph_dur=batch["ph_dur"], spk_id=spk_id, infer=False)
    if dur_pred is not None:
        dur_args = cfg.get("dur_prediction_args", {})
        word_max = None if shard is None else all_reduce_max(batch["ph2word"].max())
        out["dur_loss"] = cfg.get("lambda_dur_loss", 1.0) * losses.duration_loss(
            dur_pred.float(), batch["ph_dur"], batch["ph2word"],
            offset=dur_args.get("log_offset", 1.0), loss_type=dur_args.get("loss_type", "mse"),
            lambda_pdur=dur_args.get("lambda_pdur_loss", 0.3),
            lambda_wdur=dur_args.get("lambda_wdur_loss", 1.0),
            lambda_sdur=dur_args.get("lambda_sdur_loss", 3.0), word_max=word_max)
    if not predict_pitch and not names:
        return out
    mel2ph = batch["mel2ph"]
    t_frames = mel2ph.shape[1]
    non_padding = (mel2ph > 0).float()
    condition = model.frame_condition(encoder_out, mel2ph, spk_id=spk_id)
    for name in (["pitch"] if predict_pitch else []) + list(names):
        if name not in retakes:
            retakes[name] = random_retake_masks(b, t_frames, generator, mel2ph.device,
                                                shard=shard)
    if predict_pitch:
        retake = retakes["pitch"]
        pitch_cond = model.pitch_condition(
            condition, mel2ph, batch["base_pitch"], pitch=batch["pitch"], pitch_retake=retake,
            note_midi=batch.get("note_midi"), note_rest=batch.get("note_rest"),
            note_dur=batch.get("note_dur"), note_glide=batch.get("note_glide"),
            mel2note=batch.get("mel2note"))
        delta = batch["pitch"] - batch["base_pitch"]
        if not cfg.get("use_melody_encoder", False):
            delta = delta * retake
        out["pitch_loss"] = cfg.get("lambda_pitch_loss", 1.0) * diffusion_branch(
            core, cfg, lambda x, tt: model.denoise_pitch(x, tt, pitch_cond),
            normalizers["pitch"].norm(delta), non_padding, generator, t=t, noise=noise,
            log_norm_default=True, shard=shard)
    if names:
        var_cond = model.variance_condition(condition, batch["pitch"],
                                            {v: batch[v] for v in names},
                                            variance_retake={v: retakes[v] for v in names})
        out["var_loss"] = cfg.get("lambda_var_loss", 1.0) * diffusion_branch(
            core, cfg, lambda x, tt: model.denoise_variance(x, tt, var_cond),
            normalizers["variances"].norm([batch[v] for v in names]), non_padding, generator,
            t=var_t, noise=var_noise, log_norm_default=True, shard=shard)
    return out


def make_variance_train_step(model, core, normalizers, cfg):
    return make_train_step(
        lambda batch, generator, **draws: variance_losses(
            model, core, normalizers, cfg, batch, generator, **draws), cfg)
