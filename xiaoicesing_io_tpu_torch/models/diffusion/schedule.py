"""DDPM noise schedules and derived coefficients (float64 numpy).

Counterpart of the JAX package's ``models/diffusion/schedule.py``, kept as
its own copy.  The reference quirk is kept too: the reference calls
``linear_beta_schedule`` without the configured ``max_beta``, so the linear
schedule is ``linspace(1e-4, 0.01, T)`` whatever the config says;
``build_acoustic`` calls :meth:`DiffusionSchedule.create` without it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def linear_beta_schedule(timesteps: int, max_beta: float = 0.01) -> np.ndarray:
    return np.linspace(1e-4, max_beta, timesteps)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


beta_schedule = {"linear": linear_beta_schedule, "cosine": cosine_beta_schedule}


@dataclass(frozen=True)
class DiffusionSchedule:
    """All q/p coefficients precomputed as float64 numpy, cast where used."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray = field(init=False)
    alphas_cumprod_prev: np.ndarray = field(init=False)
    sqrt_alphas_cumprod: np.ndarray = field(init=False)
    sqrt_one_minus_alphas_cumprod: np.ndarray = field(init=False)
    sqrt_recip_alphas_cumprod: np.ndarray = field(init=False)
    sqrt_recipm1_alphas_cumprod: np.ndarray = field(init=False)
    posterior_variance: np.ndarray = field(init=False)
    posterior_log_variance_clipped: np.ndarray = field(init=False)
    posterior_mean_coef1: np.ndarray = field(init=False)
    posterior_mean_coef2: np.ndarray = field(init=False)

    def __post_init__(self):
        betas = np.asarray(self.betas, dtype=np.float64)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        acp = np.append(1.0, ac[:-1])
        pv = betas * (1.0 - acp) / (1.0 - ac)
        derived = {
            "alphas_cumprod": ac,
            "alphas_cumprod_prev": acp,
            "sqrt_alphas_cumprod": np.sqrt(ac),
            "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - ac),
            "sqrt_recip_alphas_cumprod": np.sqrt(1.0 / ac),
            "sqrt_recipm1_alphas_cumprod": np.sqrt(1.0 / ac - 1.0),
            "posterior_variance": pv,
            "posterior_log_variance_clipped": np.log(np.maximum(pv, 1e-20)),
            "posterior_mean_coef1": betas * np.sqrt(acp) / (1.0 - ac),
            "posterior_mean_coef2": (1.0 - acp) * np.sqrt(alphas) / (1.0 - ac),
        }
        for name, value in derived.items():
            object.__setattr__(self, name, value)

    @property
    def timesteps(self) -> int:
        return len(self.betas)

    @staticmethod
    def create(schedule_type: str = "linear", timesteps: int = 1000, **kwargs) -> "DiffusionSchedule":
        return DiffusionSchedule(betas=beta_schedule[schedule_type](timesteps, **kwargs))
