"""Rectified-flow ODE samplers (Euler, RK2, RK4, RK5) as a plain loop.

Counterpart of the JAX package's ``samplers.py:sample_reflow``.  The time grid
is built in float64 numpy and then taken as float32, as there, so ``t`` does
not drift by an ulp per step.  ``velocity_fn(x, t_scaled)`` takes
``x: [B, F, T, M]`` and ``t_scaled = t * time_scale_factor`` as ``[B]``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

VelocityFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _bcast_t(t_val: torch.Tensor, batch: int) -> torch.Tensor:
    return torch.ones(batch, dtype=torch.float32, device=t_val.device) * t_val


def sample_reflow(velocity_fn: VelocityFn, x: torch.Tensor, t_start: float, steps: int,
                  time_scale_factor: float = 1000.0, algorithm: str = "euler") -> torch.Tensor:
    """Fixed-step integration from ``t_start`` to 1."""
    dt = (1.0 - t_start) / max(1, steps)
    t_grid = torch.tensor(t_start + dt * np.arange(steps), dtype=torch.float32,
                          device=x.device)
    b = x.shape[0]
    s = time_scale_factor

    def v(x, t):
        return velocity_fn(x, _bcast_t(t * s, b))

    def euler(x, t):
        return x + v(x, t) * dt

    def rk2(x, t):
        k1 = v(x, t)
        k2 = v(x + 0.5 * k1 * dt, t + 0.5 * dt)
        return x + k2 * dt

    def rk4(x, t):
        k1 = v(x, t)
        k2 = v(x + 0.5 * k1 * dt, t + 0.5 * dt)
        k3 = v(x + 0.5 * k2 * dt, t + 0.5 * dt)
        k4 = v(x + k3 * dt, t + dt)
        return x + (k1 + 2 * k2 + 2 * k3 + k4) * dt / 6

    def rk5(x, t):
        k1 = v(x, t)
        k2 = v(x + 0.25 * k1 * dt, t + 0.25 * dt)
        k3 = v(x + 0.125 * (k2 + k1) * dt, t + 0.25 * dt)
        k4 = v(x + 0.5 * (-k2 + 2 * k3) * dt, t + 0.5 * dt)
        k5 = v(x + 0.0625 * (3 * k1 + 9 * k4) * dt, t + 0.75 * dt)
        k6 = v(x + (-3 * k1 + 2 * k2 + 12 * k3 - 12 * k4 + 8 * k5) * dt / 7, t + dt)
        return x + (7 * k1 + 32 * k3 + 12 * k4 + 32 * k5 + 7 * k6) * dt / 90

    step_fn = {"euler": euler, "rk2": rk2, "rk4": rk4, "rk5": rk5}[algorithm]
    for i in range(steps):
        x = step_fn(x, t_grid[i])
    return x
