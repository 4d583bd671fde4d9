"""The port's training losses, learning-rate schedules and retake masks
against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and given to both sides.  Losses
agree within 1e-6 relative (f32 on both sides); schedules within 1e-5
relative over steps 0-200 (the JAX schedules compute in f32, the port's in
f64: ``0.97 ** 200`` alone differs by 6e-6 relative, since 0.97 rounds in
f32); retake masks built from the JAX draws are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

LOSS_TOL = 1e-6


def _close(got, ref, tol=LOSS_TOL):
    got, ref = float(got), float(ref)
    assert abs(got - ref) <= tol * max(1.0, abs(ref)), (got, ref)


def _masks(rng, b, t, per_bin=False):
    lengths = rng.integers(t // 2, t + 1, b)
    lengths[-1] = 0  # an all-padding row, as the trainer's added rows are
    m = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    return np.repeat(m[:, :, None], 5, axis=2) if per_bin else m


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
@pytest.mark.parametrize("per_bin", [False, True])
def test_diffusion_and_reflow_losses_match_jax(loss_type, per_bin):
    """Both losses: a plain mean over every element, padding zeroed but
    counted; reflow with and without the logit-normal weights."""
    from xiaoicesing_io_tpu.training import losses as J
    from xiaoicesing_io_tpu_torch.training import losses as P

    rng = np.random.default_rng(0)
    b, f, t, m = 4, 2, 17, 5
    pred, gt = (rng.standard_normal((b, f, t, m)).astype(np.float32) for _ in range(2))
    mask = _masks(rng, b, t, per_bin)
    tt = rng.uniform(0.0, 1.0, b).astype(np.float32)
    tt[0] = 0.0  # clamped to eps in the weights
    _close(P.diffusion_loss(torch.tensor(pred), torch.tensor(gt), torch.tensor(mask), loss_type),
           J.diffusion_loss(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask), loss_type))
    _close(P.diffusion_loss(torch.tensor(pred), torch.tensor(gt), None, loss_type),
           J.diffusion_loss(jnp.asarray(pred), jnp.asarray(gt), None, loss_type))
    for log_norm in (False, True):
        _close(P.reflow_loss(torch.tensor(pred), torch.tensor(gt), torch.tensor(tt),
                             torch.tensor(mask), loss_type, log_norm),
               J.reflow_loss(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(tt),
                             jnp.asarray(mask), loss_type, log_norm))
    np.testing.assert_allclose(
        P.reflow_logit_normal_weights(torch.tensor(tt)).numpy(),
        np.asarray(J.reflow_logit_normal_weights(jnp.asarray(tt))), rtol=LOSS_TOL)


def test_aux_mel_loss_matches_jax():
    from xiaoicesing_io_tpu.training import losses as J
    from xiaoicesing_io_tpu_torch.training import losses as P

    rng = np.random.default_rng(1)
    a, g = (rng.standard_normal((3, 19, 7)).astype(np.float32) for _ in range(2))
    for loss_type in ("l1", "l2"):
        _close(P.aux_mel_loss(torch.tensor(a), torch.tensor(g), loss_type),
               J.aux_mel_loss(jnp.asarray(a), jnp.asarray(g), loss_type))


@pytest.mark.parametrize("loss_type", ["mse", "huber"])
def test_duration_loss_matches_jax(loss_type):
    """Phone, word and sentence terms with padding tokens (ph2word 0), a
    padding row, predictions below zero (clamped for the word terms) and
    the word term's mean over ``[B, max(ph2word)]``."""
    from xiaoicesing_io_tpu.training import losses as J
    from xiaoicesing_io_tpu_torch.training import losses as P

    rng = np.random.default_rng(2)
    b, n = 4, 12
    ph2word = np.zeros((b, n), np.int64)
    gt = np.zeros((b, n), np.int64)
    for i, k in enumerate((12, 9, 5)):
        ph2word[i, :k] = np.cumsum(np.r_[1, rng.uniform(size=k - 1) < 0.5])
        gt[i, :k] = rng.integers(1, 40, k)
    pred = rng.uniform(-0.5, 30.0, (b, n)).astype(np.float32)
    for kw in ({}, {"offset": 0.5, "lambda_pdur": 0.1, "lambda_wdur": 2.0, "lambda_sdur": 0.5}):
        _close(P.duration_loss(torch.tensor(pred), torch.tensor(gt), torch.tensor(ph2word),
                               loss_type=loss_type, **kw),
               J.duration_loss(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(ph2word),
                               loss_type=loss_type, **kw))


SCHEDULERS = {
    "step": {"scheduler_cls": "torch.optim.lr_scheduler.StepLR", "step_size": 7, "gamma": 0.5},
    "exponential": {"scheduler_cls": "torch.optim.lr_scheduler.ExponentialLR", "gamma": 0.97},
    "multi_step": {"scheduler_cls": "torch.optim.lr_scheduler.MultiStepLR",
                   "milestones": [10, 50, 120], "gamma": 0.3},
    "linear": {"scheduler_cls": "torch.optim.lr_scheduler.LinearLR", "start_factor": 0.1,
               "end_factor": 1.0, "total_iters": 40},
    "constant_factor": {"scheduler_cls": "torch.optim.lr_scheduler.ConstantLR", "factor": 0.25,
                        "total_iters": 30},
    "cosine": {"scheduler_cls": "torch.optim.lr_scheduler.CosineAnnealingLR", "T_max": 150,
               "eta_min": 1e-6},
    "lambda": {"scheduler_cls": "torch.optim.lr_scheduler.LambdaLR"},
    "rsqrt": {"scheduler_cls": "utils.training_utils.RSQRTSchedule", "warmup_steps": 60,
              "hidden_size": 256},
    "warmup_cosine": {"scheduler_cls": "utils.training_utils.WarmupCosineSchedule",
                      "warmup_steps": 25, "t_total": 180, "eta_min": 1e-5},
    "sequential": {"scheduler_cls": "torch.optim.lr_scheduler.SequentialLR",
                   "schedulers": [{"cls": "torch.optim.lr_scheduler.LinearLR",
                                   "start_factor": 0.01, "total_iters": 20},
                                  {"cls": "torch.optim.lr_scheduler.StepLR", "step_size": 30,
                                   "gamma": 0.5},
                                  {"cls": "torch.optim.lr_scheduler.ExponentialLR",
                                   "gamma": 0.99}],
                   "milestones": [20, 100]},
    "chained": {"scheduler_cls": "torch.optim.lr_scheduler.ChainedScheduler",
                "schedulers": [{"cls": "torch.optim.lr_scheduler.ConstantLR", "factor": 0.5,
                                "total_iters": 15},
                               {"cls": "torch.optim.lr_scheduler.ExponentialLR",
                                "gamma": 0.98}]},
}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_schedule_matches_jax(name):
    """Every schedule and both composites, steps 0-200."""
    from xiaoicesing_io_tpu.training.schedules import build_lr_schedule as J
    from xiaoicesing_io_tpu_torch.training.schedules import build_lr_schedule as P

    opt = {"lr": 6e-4}
    j, p = J(opt, SCHEDULERS[name]), P(opt, SCHEDULERS[name])
    ref = np.asarray([float(j(jnp.asarray(s))) for s in range(201)])
    got = np.asarray([p(s) for s in range(201)])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12)


def test_schedule_errors():
    from xiaoicesing_io_tpu_torch.training.schedules import build_lr_schedule

    with pytest.raises(ValueError, match="schedulers"):
        build_lr_schedule({}, {"scheduler_cls": "SequentialLR"})
    with pytest.raises(ValueError, match="milestones"):
        build_lr_schedule({}, {"scheduler_cls": "SequentialLR", "milestones": [],
                               "schedulers": [{"cls": "StepLR"}, {"cls": "StepLR"}]})
    with pytest.raises(ValueError, match="nested"):
        build_lr_schedule({}, {"scheduler_cls": "ChainedScheduler",
                               "schedulers": [{"cls": "SequentialLR"}]})
    with pytest.raises(NotImplementedError):
        build_lr_schedule({}, {"scheduler_cls": "OneCycleLR"})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_retake_masks_from_jax_draws(seed):
    """The port's masks from the JAX draws (the whole-row flag, the two cut
    points) equal JAX's ``random_retake_masks``; drawn from a generator
    they are whole rows or one span."""
    from xiaoicesing_io_tpu.training.variance import random_retake_masks as J
    from xiaoicesing_io_tpu_torch.training.variance import random_retake_masks as P

    b, t = 16, 37
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    full = np.asarray(jax.random.randint(k1, (b, 1), 0, 4))
    ka, _ = jax.random.split(k2)
    ends = np.asarray(jax.random.randint(ka, (b, 2), 0, t + 1))
    got = P(b, t, full=torch.tensor(full), ends=torch.tensor(ends)).numpy()
    np.testing.assert_array_equal(got, np.asarray(J(key, b, t)))
    g = torch.Generator().manual_seed(seed)
    m = P(b, t, g).numpy()
    assert m.shape == (b, t) and m.dtype == np.bool_
    for row in m:
        on = np.flatnonzero(row)
        assert on.size == 0 or on.size == on[-1] - on[0] + 1  # one contiguous span
