"""Spec normalisation, the DDPM core and the rectified-flow core.

Counterparts of the JAX package's ``models/diffusion/core.py``
(``SpecNormalizer``, ``GaussianDiffusion``, ``RectifiedFlow``).  The cores
hold only the schedule and the math; the denoiser is passed in as a
``denoise_fn(x, t)`` closure.  Model-domain layout: ``[B, F, T, M]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import samplers
from .schedule import DiffusionSchedule


class SpecNormalizer:
    """Value domain <-> [-1, 1] model domain, with repeat-bins support."""

    def __init__(self, spec_min: Sequence, spec_max: Sequence, num_feats: int = 1,
                 repeat_bins: Optional[int] = None,
                 clamps: Optional[List[Optional[Tuple[Optional[float], Optional[float]]]]] = None):
        self.num_feats = num_feats
        self.repeat_bins = repeat_bins
        self.clamps = clamps
        smin = np.asarray(spec_min, dtype=np.float32).reshape(num_feats, -1)
        smax = np.asarray(spec_max, dtype=np.float32).reshape(num_feats, -1)
        self.spec_min = smin[None, :, None, :]
        self.spec_max = smax[None, :, None, :]
        self._on_device = {}

    def _bounds(self, x: torch.Tensor):
        # copied once per device: a host-to-device copy waits for the card
        if x.device not in self._on_device:
            self._on_device[x.device] = (torch.as_tensor(self.spec_min, device=x.device),
                                         torch.as_tensor(self.spec_max, device=x.device))
        return self._on_device[x.device]

    def _clamp(self, xs):
        if self.clamps is None:
            return xs
        return [x if c is None else torch.clamp(x, c[0], c[1]) for x, c in zip(xs, self.clamps)]

    def norm(self, x) -> torch.Tensor:
        """Mel ``[B, T, M]`` or a list of curves ``[B, T]`` -> ``[B, F, T, M]``."""
        if self.repeat_bins is None:
            x = x[:, None, :, :]
        else:
            xs = self._clamp([x] if not isinstance(x, (list, tuple)) else list(x))
            x = torch.stack(xs, dim=1)[..., None].expand(-1, -1, -1, self.repeat_bins)
        mn, mx = self._bounds(x)
        return (x - mn) / (mx - mn) * 2.0 - 1.0

    def denorm(self, x: torch.Tensor):
        """``[B, F, T, M]`` -> mel ``[B, T, M]`` or curves."""
        mn, mx = self._bounds(x)
        x = (x + 1.0) / 2.0 * (mx - mn) + mn
        if self.repeat_bins is None:
            return x[:, 0]
        x = x.mean(dim=-1)
        xs = self._clamp([x[:, i] for i in range(self.num_feats)])
        return xs[0] if self.num_feats == 1 else xs


@dataclass(frozen=True)
class GaussianDiffusion:
    """DDPM core: forward noising and the sampling loops."""

    schedule: DiffusionSchedule
    timesteps: int = 1000
    k_step: int = 1000

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Forward-noise ``x_start`` at integer steps ``t`` ``[B]``."""
        shape = (-1,) + (1,) * (x_start.ndim - 1)

        def coef(a):
            # an asynchronous copy: a blocking one would wait for the card
            a = torch.as_tensor(a, dtype=torch.float32).to(x_start.device, non_blocking=True)
            return a[t].reshape(shape)

        return (coef(self.schedule.sqrt_alphas_cumprod) * x_start
                + coef(self.schedule.sqrt_one_minus_alphas_cumprod) * noise)

    def inference(self, denoise_fn: samplers.DenoiseFn, shape: Tuple[int, ...],
                  x_start: Optional[torch.Tensor] = None, depth: Optional[int] = None,
                  speedup: int = 1, algorithm: str = "ddim", solver_order: int = 2,
                  unipc_variant: str = "bh2", noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
        """Returns model-domain ``x`` ``[B, F, T, M]``.  With ``depth`` below
        ``timesteps`` the loop starts from ``q_sample(x_start, depth - 1)``
        (shallow diffusion).  ``noise`` (the start noise) is drawn from
        ``generator`` unless given; the ancestral sampler (``speedup`` 1)
        draws its per-step noise from ``generator`` too."""
        depth = self.k_step if depth is None else depth
        t_max = min(depth, self.k_step)
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        if t_max >= self.timesteps:
            x = noise
        elif t_max > 0:
            assert x_start is not None, "Missing shallow diffusion source."
            t = torch.full((shape[0],), t_max - 1, dtype=torch.long, device=noise.device)
            x = self.q_sample(x_start, t, noise)
        else:
            assert x_start is not None, "Missing shallow diffusion source."
            return x_start

        if speedup <= 1:
            return samplers.sample_ddpm(self.schedule, denoise_fn, x, t_max, generator=generator)
        if algorithm == "ddim":
            return samplers.sample_ddim(self.schedule, denoise_fn, x, t_max, speedup)
        if algorithm == "pndm":
            return samplers.sample_plms(self.schedule, denoise_fn, x, t_max, speedup)
        if algorithm == "dpm-solver":
            return samplers.sample_dpmpp(self.schedule, denoise_fn, x, t_max, t_max // speedup,
                                         order=solver_order)
        if algorithm == "unipc":
            return samplers.sample_unipc_bh2(self.schedule, denoise_fn, x, t_max,
                                             t_max // speedup, variant=unipc_variant)
        raise ValueError(f"Unsupported DDPM acceleration algorithm: {algorithm}")


@dataclass(frozen=True)
class RectifiedFlow:
    t_start: float = 0.0
    time_scale_factor: float = 1000.0

    def inference(self, velocity_fn: samplers.VelocityFn, shape: Tuple[int, ...],
                  x_end: Optional[torch.Tensor] = None, t_start: Optional[float] = None,
                  steps: int = 20, algorithm: str = "euler",
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
        """Returns model-domain ``x`` ``[B, F, T, M]``.  ``noise`` (the start
        noise) is drawn from ``generator`` unless given."""
        t0 = self.t_start if t_start is None else t_start
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        if t0 > 0:
            assert x_end is not None, "Missing shallow diffusion source."
            if t0 >= 1.0:
                return x_end
            x = t0 * x_end + (1 - t0) * noise
        else:
            t0 = 0.0
            x = noise
        return samplers.sample_reflow(velocity_fn, x, t0, steps,
                                      time_scale_factor=self.time_scale_factor,
                                      algorithm=algorithm)
