"""Acoustic training (counterpart of the JAX package's ``training/acoustic.py``).

:func:`build_acoustic` assembles the model and its diffusion core
(``GaussianDiffusion`` for ``diffusion_type: ddpm``, ``RectifiedFlow`` for
``reflow``).  :func:`acoustic_losses` is the aux decoder's L1 (scaled by
``lambda_aux_mel_loss``; its gradient into the condition scaled by
``aux_decoder_grad``) and the DDPM noise or rectified-flow velocity loss,
masked by ``mel2ph > 0``.  :func:`make_acoustic_train_step` differentiates
them with autograd, under ``torch.autocast`` in bf16 where the config's
``precision`` says bf16 (the parameters and optimizer stay f32).

A rank of a data-parallel group passes ``shard=(rank, world)``: its batch
is then one of ``world`` equal slices of the global batch, and each draw
(``t``, noise) is made for the whole global batch from the generator, which
every rank seeds alike, and sliced to this rank's rows
(:func:`rank_rows`).  A W-rank update so equals one process's update on the
ranks' batches concatenated in rank order.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..models.diffusion.core import GaussianDiffusion, RectifiedFlow, SpecNormalizer
from ..models.diffusion.schedule import DiffusionSchedule
from ..models.toplevel import VARIANCE_CHECKLIST, AcousticModel
from . import losses
from .train_state import TrainState


def build_acoustic(cfg, vocab_size: int):
    """-> (model, diffusion_core, normalizer); the model is on the CPU."""
    model = AcousticModel.from_config(cfg, vocab_size)
    normalizer = SpecNormalizer(
        spec_min=[cfg.get("spec_min", [-12.0])],
        spec_max=[cfg.get("spec_max", [0.0])],
        num_feats=1,
    )
    diffusion_type = cfg.get("diffusion_type", "ddpm")
    if diffusion_type == "ddpm":
        timesteps = cfg.get("timesteps", 1000)
        schedule = DiffusionSchedule.create(cfg.get("schedule_type", "linear"), timesteps)
        k_step = cfg.get("K_step", timesteps) if cfg.get("use_shallow_diffusion", False) \
            else timesteps
        core = GaussianDiffusion(schedule=schedule, timesteps=timesteps, k_step=k_step)
    elif diffusion_type == "reflow":
        t_start = cfg.get("T_start", 0.0) if cfg.get("use_shallow_diffusion", False) else 0.0
        core = RectifiedFlow(t_start=t_start, time_scale_factor=cfg.get("time_scale_factor", 1000))
    else:
        raise NotImplementedError(diffusion_type)
    return model, core, normalizer


def required_variances(cfg) -> Tuple[str, ...]:
    return tuple(v for v in VARIANCE_CHECKLIST if cfg.get(f"use_{v}_embed", False))


def sample_t(core, b: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Training's diffusion time: an integer step in ``[0, K_step)`` (DDPM)
    or uniform in ``[t_start, 1)`` (rectified flow)."""
    if isinstance(core, GaussianDiffusion):
        return torch.randint(0, core.k_step, (b,), generator=generator, device=device)
    return core.t_start + (1.0 - core.t_start) * torch.rand(b, generator=generator,
                                                            device=device)


def rank_rows(draw: Callable[[int], torch.Tensor], b: int,
              shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``draw(b)``; with ``shard=(rank, world)``, rows ``rank * b`` to
    ``(rank + 1) * b`` of ``draw(world * b)``, the global batch's draw."""
    if shard is None:
        return draw(b)
    r, w = shard
    return draw(w * b)[r * b:(r + 1) * b]


def diffusion_branch(core, cfg, denoise, gt_norm: torch.Tensor, non_padding: torch.Tensor,
                     generator: Optional[torch.Generator], t=None, noise=None,
                     log_norm_default: bool = False,
                     shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One diffusion loss: ``t`` and ``noise`` (drawn from ``generator``
    unless given, for the global batch under ``shard``), the noised input,
    ``denoise(x_t, t_in)`` and the DDPM noise loss or the rectified-flow
    velocity loss."""
    b, dev = gt_norm.shape[0], gt_norm.device
    if noise is None:
        noise = rank_rows(lambda n: torch.randn((n, *gt_norm.shape[1:]), generator=generator,
                                                device=dev), b, shard)
    if t is None:
        t = rank_rows(lambda n: sample_t(core, n, generator, dev), b, shard)
    loss_type = cfg.get("main_loss_type", "l2")
    if isinstance(core, GaussianDiffusion):
        x_t = core.q_sample(gt_norm, t.long(), noise)
        pred = denoise(x_t, t.float()).float()
        return losses.diffusion_loss(pred, noise, non_padding, loss_type=loss_type)
    t = t.float()
    x_t = noise + t.reshape(-1, 1, 1, 1) * (gt_norm - noise)
    pred = denoise(x_t, t * core.time_scale_factor).float()
    return losses.reflow_loss(pred, gt_norm - noise, t, non_padding, loss_type=loss_type,
                              log_norm=cfg.get("main_loss_log_norm", log_norm_default))


def acoustic_losses(model: AcousticModel, core, normalizer: SpecNormalizer, cfg,
                    batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                    *, t: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None,
                    shard: Optional[Tuple[int, int]] = None) -> Dict[str, torch.Tensor]:
    """One forward pass -> ``{"aux_mel_loss", "mel_loss"}`` (as configured).
    ``t`` and ``noise`` are drawn from ``generator`` unless given (for the
    global batch under ``shard``); dropout follows the model's mode."""
    use_shallow = cfg.get("use_shallow_diffusion", False)
    shallow = cfg.get("shallow_diffusion_args", {})
    variances = {v: batch[v] for v in required_variances(cfg)}
    cond = model.condition(batch["tokens"], batch["mel2ph"], batch["f0"],
                           key_shift=batch.get("key_shift"), speed=batch.get("speed"),
                           spk_embed_id=batch.get("spk_ids"), variances=variances)
    out: Dict[str, torch.Tensor] = {}
    non_padding = (batch["mel2ph"] > 0).float()
    norm_gt = normalizer.norm(batch["mel"])
    if use_shallow and shallow.get("train_aux_decoder", True):
        g = shallow.get("aux_decoder_grad", 0.1)
        aux_cond = cond * g + cond.detach() * (1 - g)
        aux_out = model.aux_out(aux_cond).float()
        out["aux_mel_loss"] = cfg.get("lambda_aux_mel_loss", 0.2) * losses.aux_mel_loss(
            aux_out * non_padding[:, :, None], norm_gt[:, 0] * non_padding[:, :, None])
    if not use_shallow or shallow.get("train_diffusion", True):
        out["mel_loss"] = diffusion_branch(
            core, cfg, lambda x, tt: model.denoise(x, tt, cond), norm_gt, non_padding,
            generator, t=t, noise=noise, shard=shard)
    return out


def mixed_precision(cfg, device: torch.device):
    """``torch.autocast`` to bf16 on ``device`` where ``precision`` names
    bf16 (``bf16-mixed``), else a no-op: the parameters stay f32."""
    bf16 = "bf16" in str(cfg.get("precision", "bf16-mixed"))
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16)


def make_train_step(losses_fn, cfg):
    """``train_step(state, batch, generator=None, **draws) -> (updated,
    metrics)``: the losses of one micro-batch (``losses_fn(batch,
    generator, **draws)``) under :func:`mixed_precision`, their sum's
    gradients, and the update once an update's micro-batches are in."""

    def train_step(state: TrainState, batch, generator=None, **draws):
        state.model.train()
        with mixed_precision(cfg, state.device):
            loss_dict = losses_fn(batch, generator, **draws)
        total = sum(loss_dict.values())
        updated = state.backward(total)
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["total_loss"] = total.detach()
        return updated, metrics

    return train_step


def make_acoustic_train_step(model, core, normalizer, cfg):
    return make_train_step(
        lambda batch, generator, **draws: acoustic_losses(
            model, core, normalizer, cfg, batch, generator, **draws), cfg)
