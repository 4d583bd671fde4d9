"""Acoustic model assembly (counterpart of the JAX ``training/acoustic.py:build_acoustic``).

Builds the model and its diffusion core: ``GaussianDiffusion`` for
``diffusion_type: ddpm`` and ``RectifiedFlow`` for ``reflow``.  The training
step itself is not ported yet.
"""

from __future__ import annotations

from ..models.diffusion.core import GaussianDiffusion, RectifiedFlow, SpecNormalizer
from ..models.diffusion.schedule import DiffusionSchedule
from ..models.toplevel import AcousticModel


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
