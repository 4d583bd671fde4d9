"""Learning-rate schedules as pure functions of the optimizer step.

Counterpart of the JAX package's ``training/schedules.py``: torch's
``StepLR``, ``ExponentialLR``, ``MultiStepLR``, ``LinearLR``,
``ConstantLR``, ``CosineAnnealingLR`` and ``LambdaLR`` (constant), the
reference's ``RSQRTSchedule`` and ``WarmupCosineSchedule``, and the
``SequentialLR`` / ``ChainedScheduler`` composites of sub-schedulers given
by ``cls``.  A schedule maps step ``n`` to the learning rate of update
``n`` (0-based), so a resumed run needs no scheduler state.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def step_lr(base_lr: float, step_size: int, gamma: float) -> Schedule:
    return lambda step: base_lr * gamma ** (step // step_size)


def rsqrt(base_lr: float, warmup_steps: int = 10000, hidden_size: int = 256) -> Schedule:
    """lr * hidden^-0.5 * min(step * warmup^-1.5, step^-0.5)."""
    constant = base_lr * hidden_size ** -0.5

    def fn(step):
        step = max(step, 1)
        return constant * min(step * warmup_steps ** -1.5, step ** -0.5)

    return fn


def warmup_cosine(base_lr: float, warmup_steps: int, t_total: int,
                  eta_min: float = 0.0) -> Schedule:
    def fn(step):
        if step < warmup_steps:
            return base_lr * step / max(1, warmup_steps)
        progress = min(max((step - warmup_steps) / max(1, t_total - warmup_steps), 0.0), 1.0)
        return eta_min + (base_lr - eta_min) * 0.5 * (1 + math.cos(math.pi * progress))

    return fn


def exponential_lr(base_lr: float, gamma: float) -> Schedule:
    return lambda step: base_lr * gamma ** step


def constant_lr(base_lr: float) -> Schedule:
    return lambda step: base_lr


def multi_step_lr(base_lr: float, milestones: Sequence[int], gamma: float = 0.1) -> Schedule:
    """lr = base * gamma ^ (milestones passed)."""
    ms = tuple(int(m) for m in milestones)
    return lambda step: base_lr * gamma ** sum(step >= m for m in ms)


def linear_lr(base_lr: float, start_factor: float = 1.0 / 3, end_factor: float = 1.0,
              total_iters: int = 5) -> Schedule:
    def fn(step):
        p = min(max(step / max(1, total_iters), 0.0), 1.0)
        return base_lr * (start_factor + (end_factor - start_factor) * p)

    return fn


def constant_factor_lr(base_lr: float, factor: float = 1.0 / 3,
                       total_iters: int = 5) -> Schedule:
    return lambda step: base_lr * (factor if step < total_iters else 1.0)


def cosine_annealing_lr(base_lr: float, t_max: int, eta_min: float = 0.0) -> Schedule:
    return lambda step: eta_min + (base_lr - eta_min) * 0.5 * (
        1 + math.cos(math.pi * step / max(1, t_max)))


def sequential(schedules: Sequence[Schedule], milestones: Sequence[int]) -> Schedule:
    """SequentialLR: the schedule of the current milestone interval, on a
    step count that restarts at 0 when it becomes active."""
    starts = (0,) + tuple(int(m) for m in milestones)

    def fn(step):
        i = max((j for j, s in enumerate(starts) if step >= s), default=0)
        return schedules[i](step - starts[i])

    return fn


def chained(schedules: Sequence[Schedule], base_lr: float) -> Schedule:
    """ChainedScheduler: every schedule steps; their factors multiply."""

    def fn(step):
        lr = 1.0
        for s in schedules:
            lr *= s(step) / base_lr
        return base_lr * lr

    return fn


def build_lr_schedule(optimizer_args: dict, scheduler_args: dict) -> Schedule:
    """The schedule of the config's ``optimizer_args.lr`` and
    ``lr_scheduler_args`` (``scheduler_cls``; composites list their
    sub-schedulers under ``schedulers`` with a ``cls`` each)."""
    return _build(scheduler_args, optimizer_args.get("lr", 1e-4), cls_key="scheduler_cls")


def _build(args: dict, base_lr: float, *, cls_key: str = "cls") -> Schedule:
    cls = args.get(cls_key, "torch.optim.lr_scheduler.StepLR")
    name = cls.rsplit(".", 1)[-1]
    if name == "StepLR":
        return step_lr(base_lr, args.get("step_size", 50000), args.get("gamma", 0.5))
    if name == "ExponentialLR":
        return exponential_lr(base_lr, args.get("gamma", 0.999))
    if name == "MultiStepLR":
        return multi_step_lr(base_lr, args.get("milestones", ()), args.get("gamma", 0.1))
    if name == "LinearLR":
        return linear_lr(base_lr, args.get("start_factor", 1.0 / 3),
                         args.get("end_factor", 1.0), args.get("total_iters", 5))
    if name == "ConstantLR":
        return constant_factor_lr(base_lr, args.get("factor", 1.0 / 3),
                                  args.get("total_iters", 5))
    if name == "CosineAnnealingLR":
        return cosine_annealing_lr(base_lr, args.get("T_max", 160000), args.get("eta_min", 0.0))
    if name == "LambdaLR":
        return constant_lr(base_lr)
    if name == "RSQRTSchedule":
        return rsqrt(base_lr, args.get("warmup_steps", 10000), args.get("hidden_size", 256))
    if name == "WarmupCosineSchedule":
        return warmup_cosine(base_lr, args.get("warmup_steps", 10000),
                             args.get("t_total", 160000), args.get("eta_min", 0.0))
    if name in ("SequentialLR", "ChainedScheduler"):
        sub_args = args.get("schedulers", ())
        if not sub_args:
            raise ValueError(f"{name} requires a 'schedulers' list")
        if any(s.get("cls", "").rsplit(".", 1)[-1] in ("SequentialLR", "ChainedScheduler")
               for s in sub_args):
            raise ValueError("nested SequentialLR/ChainedScheduler is not supported")
        subs = [_build(s, base_lr) for s in sub_args]
        if name == "SequentialLR":
            milestones = args.get("milestones", ())
            if len(milestones) != len(subs) - 1:
                raise ValueError("SequentialLR needs len(schedulers)-1 milestones")
            return sequential(subs, milestones)
        return chained(subs, base_lr)
    raise NotImplementedError(f"scheduler {cls} not supported")
