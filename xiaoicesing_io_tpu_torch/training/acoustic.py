"""Acoustic model assembly (counterpart of the JAX ``training/acoustic.py:build_acoustic``).

The training step itself is not ported yet.
"""

from __future__ import annotations

from ..models.diffusion.core import RectifiedFlow, SpecNormalizer
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
    if diffusion_type != "reflow":
        raise NotImplementedError(
            f"diffusion_type {diffusion_type!r} is not ported yet (ported: 'reflow')"
        )
    t_start = cfg.get("T_start", 0.0) if cfg.get("use_shallow_diffusion", False) else 0.0
    core = RectifiedFlow(t_start=t_start, time_scale_factor=cfg.get("time_scale_factor", 1000))
    return model, core, normalizer
