"""Spec normalisation and the rectified-flow core.

Counterparts of the JAX package's ``models/diffusion/core.py``
(``SpecNormalizer``, ``RectifiedFlow``).  The DDPM core is not ported yet.
Model-domain layout: ``[B, F, T, M]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import samplers


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

    def _bounds(self, x: torch.Tensor):
        return (torch.as_tensor(self.spec_min, device=x.device),
                torch.as_tensor(self.spec_max, device=x.device))

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
