"""Diffusion and flow samplers as plain Python loops.

Counterparts of the JAX package's ``samplers.py``, which runs each loop as
one ``lax.scan``.  Every step coefficient depends only on the time grid, so
it is computed in float64 numpy and taken as float32, as there; the loops
here walk the same arrays.

* DDPM ancestral (:func:`sample_ddpm`), DDIM (:func:`sample_ddim`),
  PNDM / PLMS (:func:`sample_plms`), DPM-Solver++ multistep
  (:func:`sample_dpmpp`, :func:`sample_dpmpp_2m`) and UniPC
  (:func:`sample_unipc_bh2`) over a discrete DDPM schedule:
  ``denoise_fn(x, t)`` returns the noise estimate, ``t`` the discrete step
  index as float ``[B]``.
* Rectified-flow Euler, RK2, RK4 and RK5 (:func:`sample_reflow`):
  ``velocity_fn(x, t_scaled)`` with ``t_scaled = t * time_scale_factor``.

``x`` is ``[B, F, T, M]`` float32 throughout.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .schedule import DiffusionSchedule

VelocityFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
DenoiseFn = VelocityFn


def _bcast_t(t_val, batch: int, device) -> torch.Tensor:
    return torch.ones(batch, dtype=torch.float32, device=device) * t_val


# ---------------------------------------------------------------------------
# DDPM ancestral
# ---------------------------------------------------------------------------

def sample_ddpm(schedule: DiffusionSchedule, denoise_fn: DenoiseFn, x: torch.Tensor, t_max: int,
                generator: Optional[torch.Generator] = None,
                step_noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Ancestral sampling from step ``t_max - 1`` down to 0.  The noise of
    step ``i`` (``i = 0`` at ``t_max - 1``) is ``step_noise[i]`` when given,
    else drawn from ``generator``; the last step (t = 0) adds none."""
    ts = np.arange(t_max - 1, -1, -1)
    coefs = np.stack([
        schedule.sqrt_recip_alphas_cumprod[ts],
        schedule.sqrt_recipm1_alphas_cumprod[ts],
        schedule.posterior_mean_coef1[ts],
        schedule.posterior_mean_coef2[ts],
        np.exp(0.5 * schedule.posterior_log_variance_clipped[ts]),
    ], axis=1).astype(np.float32).tolist()
    t_in = ts.astype(np.float32).tolist()
    b = x.shape[0]
    for i, (t, (recip, recipm1, mc1, mc2, std)) in enumerate(zip(t_in, coefs)):
        eps = denoise_fn(x, _bcast_t(t, b, x.device))
        x_recon = recip * x - recipm1 * eps
        x = mc1 * x_recon + mc2 * x
        if ts[i] != 0:
            noise = step_noise[i] if step_noise is not None else torch.randn(
                x.shape, generator=generator, device=x.device, dtype=x.dtype)
            x = x + std * noise
    return x


# ---------------------------------------------------------------------------
# DDIM
# ---------------------------------------------------------------------------

def _ddim_coefs(schedule: DiffusionSchedule, t_max: int, interval: int):
    ts = np.arange(0, t_max, interval)[::-1]  # reversed(range(0, t_max, interval))
    a_t = schedule.alphas_cumprod[ts]
    a_prev = schedule.alphas_cumprod[np.maximum(ts - interval, 0)]
    c_x = np.sqrt(a_prev) / np.sqrt(a_t)
    c_e = np.sqrt(a_prev) * (np.sqrt((1 - a_prev) / a_prev) - np.sqrt((1 - a_t) / a_t))
    return ts, c_x.astype(np.float32), c_e.astype(np.float32)


def sample_ddim(schedule: DiffusionSchedule, denoise_fn: DenoiseFn, x: torch.Tensor, t_max: int,
                interval: int) -> torch.Tensor:
    ts, c_x, c_e = _ddim_coefs(schedule, t_max, interval)
    b = x.shape[0]
    for t, cx, ce in zip(ts.astype(np.float32).tolist(), c_x.tolist(), c_e.tolist()):
        eps = denoise_fn(x, _bcast_t(t, b, x.device))
        x = cx * x + ce * eps
    return x


# ---------------------------------------------------------------------------
# PNDM / PLMS
# ---------------------------------------------------------------------------

def sample_plms(schedule: DiffusionSchedule, denoise_fn: DenoiseFn, x: torch.Tensor, t_max: int,
                interval: int) -> torch.Tensor:
    """PLMS: transfer through ``x_pred`` with an Adams-Bashforth noise
    estimate whose order ramps 1, 2, 3, 4 (the first step evaluates the
    denoiser twice)."""
    ts = np.arange(0, t_max, interval)[::-1]
    a_t = schedule.alphas_cumprod[ts]
    a_prev = schedule.alphas_cumprod[np.maximum(ts - interval, 0)]
    a_sq, ap_sq = np.sqrt(a_t), np.sqrt(a_prev)
    cx = 1.0 / (a_sq * (a_sq + ap_sq))
    ce = 1.0 / (a_sq * (np.sqrt((1 - a_prev) * a_t) + np.sqrt((1 - a_t) * a_prev)))
    d = a_prev - a_t
    coefs = np.stack([d * cx, d * ce], axis=1).astype(np.float32).tolist()
    t_prev0 = float(np.float32(max(ts[0] - interval, 0)))
    b = x.shape[0]

    def x_pred(x, noise, c):
        return x + c[0] * x - c[1] * noise

    hist = []  # newest first
    for t, c in zip(ts.astype(np.float32).tolist(), coefs):
        eps = denoise_fn(x, _bcast_t(t, b, x.device))
        if not hist:
            eps_prev = denoise_fn(x_pred(x, eps, c), _bcast_t(t_prev0, b, x.device))
            eps_prime = (eps + eps_prev) / 2
        elif len(hist) == 1:
            eps_prime = (3 * eps - hist[0]) / 2
        elif len(hist) == 2:
            eps_prime = (23 * eps - 16 * hist[0] + 5 * hist[1]) / 12
        else:
            eps_prime = (55 * eps - 59 * hist[0] + 37 * hist[1] - 9 * hist[2]) / 24
        x = x_pred(x, eps_prime, c)
        hist = [eps] + hist[:2]
    return x


# ---------------------------------------------------------------------------
# Continuous-time helpers for DPM-Solver++ / UniPC (discrete beta schedule)
# ---------------------------------------------------------------------------

def _marginals(schedule: DiffusionSchedule, t_max: int, t_cont: np.ndarray):
    """log_alpha, sigma and lambda at continuous times: piecewise-linear
    interpolation of 0.5 * log(alphas_cumprod) over the grid (i + 1) / N."""
    N = t_max
    grid = (np.arange(N) + 1.0) / N
    log_alpha_grid = 0.5 * np.log(schedule.alphas_cumprod[:N])
    log_alpha = np.interp(t_cont, grid, log_alpha_grid)
    sigma = np.sqrt(1.0 - np.exp(2.0 * log_alpha))
    lam = log_alpha - np.log(sigma)
    return log_alpha, sigma, lam


def _solver_time_grid(t_max: int, steps: int) -> np.ndarray:
    """time_uniform grid from T = 1 to t_0 = 1 / N, steps + 1 points."""
    return np.linspace(1.0, 1.0 / t_max, steps + 1)


def _model_t_input(t_cont: np.ndarray, t_max: int) -> np.ndarray:
    """Continuous time -> the denoiser's discrete-index input in [0, N - 1]."""
    return (t_cont - 1.0 / t_max) * t_max


def _f32(a) -> list:
    return np.asarray(a, np.float32).tolist()


# ---------------------------------------------------------------------------
# DPM-Solver++ (multistep, data prediction)
# ---------------------------------------------------------------------------

def sample_dpmpp(schedule: DiffusionSchedule, denoise_fn: DenoiseFn, x: torch.Tensor, t_max: int,
                 steps: int, order: int = 2, lower_order_final: bool = True) -> torch.Tensor:
    """DPM-Solver++ multistep, orders 1-3, time_uniform grid; the order ramps
    up over the first steps, and ``lower_order_final`` caps it over the last
    ones when ``steps < 10``."""
    assert 1 <= order <= 3, order
    ts = _solver_time_grid(t_max, steps)
    log_a, sigma, lam = _marginals(schedule, t_max, ts)
    alpha = np.exp(log_a)
    t_in = _model_t_input(ts, t_max)
    b = x.shape[0]

    # per-step coefficients of step i (ts[i - 1] -> ts[i]):
    #   x_new = c_x * x + c_m * m0 + c_a * (m0 - m1) + c_b * (m1 - m2)
    c_x = np.empty(steps)
    c_m = np.empty(steps)
    c_a = np.zeros(steps)
    c_b = np.zeros(steps)
    for i in range(1, steps + 1):
        h = lam[i] - lam[i - 1]
        phi_1 = np.expm1(-h)
        c_x[i - 1] = sigma[i] / sigma[i - 1]
        c_m[i - 1] = -alpha[i] * phi_1
        step_order = min(order, i)
        if lower_order_final and steps < 10:
            step_order = min(step_order, steps + 1 - i)
        if step_order >= 2:
            r0 = (lam[i - 1] - lam[i - 2]) / h
            if step_order == 2:
                c_a[i - 1] = -0.5 * alpha[i] * phi_1 / r0
            else:
                r1 = (lam[i - 2] - lam[i - 3]) / h
                phi_2 = phi_1 / h + 1.0
                phi_3 = phi_2 / h - 0.5
                w = r0 / (r0 + r1)
                c_a[i - 1] = alpha[i] * (phi_2 * (1.0 + w) - phi_3 / (r0 + r1)) / r0
                c_b[i - 1] = alpha[i] * (-phi_2 * w + phi_3 / (r0 + r1)) / r1

    eps0 = denoise_fn(x, _bcast_t(float(np.float32(t_in[0])), b, x.device))
    m0 = (x - float(sigma[0]) * eps0) / float(alpha[0])
    m_0 = m_1 = m_2 = m0
    rows = zip(_f32(c_x), _f32(c_m), _f32(c_a), _f32(c_b), _f32(t_in[1:]), _f32(sigma[1:]),
               _f32(alpha[1:]))
    for i, (cx, cm, ca, cb, tin, sig, alp) in enumerate(rows):
        x = cx * x + cm * m_0 + ca * (m_0 - m_1) + cb * (m_1 - m_2)
        if i + 1 < steps:
            eps = denoise_fn(x, _bcast_t(tin, b, x.device))
            m_new = (x - sig * eps) / alp
        else:
            m_new = m_0
        m_0, m_1, m_2 = m_new, m_0, m_1
    return x


def sample_dpmpp_2m(schedule: DiffusionSchedule, denoise_fn: DenoiseFn, x: torch.Tensor,
                    t_max: int, steps: int, lower_order_final: bool = True) -> torch.Tensor:
    """DPM-Solver++ multistep order 2 (the reference call site's default)."""
    return sample_dpmpp(schedule, denoise_fn, x, t_max, steps, order=2,
                        lower_order_final=lower_order_final)


# ---------------------------------------------------------------------------
# UniPC (multistep order 2, predictor-corrector, data prediction)
# ---------------------------------------------------------------------------

def sample_unipc_bh2(schedule: DiffusionSchedule, denoise_fn: DenoiseFn, x: torch.Tensor,
                     t_max: int, steps: int, variant: str = "bh2") -> torch.Tensor:
    """UniPC order 2, time_uniform, multistep, lower order at the last step;
    ``variant`` ``bh1`` takes B(h) = h, ``bh2`` B(h) = expm1(h).  The order-2
    corrector's 2 x 2 system is solved in closed form; the order-2 predictor
    takes rhos_p = [0.5] and the order-1 corrector rhos_c = [0.5], the
    simplifications of the vendored reference solver."""
    ts = _solver_time_grid(t_max, steps)
    log_a, sigma, lam = _marginals(schedule, t_max, ts)
    alpha = np.exp(log_a)
    t_in = _model_t_input(ts, t_max)
    b_sz = x.shape[0]

    rows = []
    for i in range(1, steps + 1):
        h = lam[i] - lam[i - 1]
        hh = -h
        h_phi_1 = np.expm1(hh)
        B_h = hh if variant == "bh1" else np.expm1(hh)
        b1 = (h_phi_1 / hh - 1.0) / B_h
        b2 = ((h_phi_1 / hh - 1.0) / hh - 0.5) * 2.0 / B_h
        step_order = min(2, steps + 1 - i)
        if i == 1 or step_order < 2:
            r0, use_d1 = 1.0, 0.0
        else:
            r0, use_d1 = (lam[i - 2] - lam[i - 1]) / h, 1.0
        denom = 1.0 - r0 if abs(1.0 - r0) > 1e-12 else 1e-12
        rho_c1 = (b1 - b2) / denom
        rho_c2 = (b2 - r0 * b1) / denom
        if use_d1 == 0.0:
            rho_c1, rho_c2 = 0.0, 0.5
        rows.append([
            sigma[i] / sigma[i - 1],        # c_x
            -alpha[i] * h_phi_1,            # c_m, on m_0
            -alpha[i] * B_h,                # c_B, on the residual terms
            0.5 * use_d1,                   # rho_p
            rho_c1 * use_d1,                # rhos_c[0], on D1_0
            rho_c2,                         # rhos_c[-1], on D1_t
            1.0 / r0 if use_d1 else 0.0,    # 1 / r0 for D1_0
            t_in[i],                        # the denoiser's t
            1.0 if i < steps else 0.0,      # use the corrector
        ])
    coefs = np.asarray(rows, dtype=np.float32).tolist()

    eps0 = denoise_fn(x, _bcast_t(float(np.float32(t_in[0])), b_sz, x.device))
    m0 = (x - float(sigma[0]) * eps0) / float(alpha[0])
    m_0 = m_1 = m0
    for c, sig, alp in zip(coefs, _f32(sigma[1:]), _f32(alpha[1:])):
        c_x, c_m, c_B, rho_p, rho_c0, rho_cT, inv_r0, tin, use_corr = c
        D1_0 = (m_1 - m_0) * inv_r0
        x_t_ = c_x * x + c_m * m_0
        x_pred = x_t_ + c_B * (rho_p * D1_0)
        if use_corr > 0.5:
            eps_t = denoise_fn(x_pred, _bcast_t(tin, b_sz, x.device))
            m_t = (x_pred - sig * eps_t) / alp
            x = x_t_ + c_B * (rho_c0 * D1_0 + rho_cT * (m_t - m_0))
            m_new = m_t
        else:
            x, m_new = x_pred, m_0
        m_0, m_1 = m_new, m_0
    return x


# ---------------------------------------------------------------------------
# Rectified flow ODE solvers
# ---------------------------------------------------------------------------

def sample_reflow(velocity_fn: VelocityFn, x: torch.Tensor, t_start: float, steps: int,
                  time_scale_factor: float = 1000.0, algorithm: str = "euler") -> torch.Tensor:
    """Fixed-step integration from ``t_start`` to 1."""
    dt = (1.0 - t_start) / max(1, steps)
    t_grid = torch.tensor(t_start + dt * np.arange(steps), dtype=torch.float32,
                          device=x.device)
    b = x.shape[0]
    s = time_scale_factor

    def v(x, t):
        return velocity_fn(x, _bcast_t(t * s, b, x.device))

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
