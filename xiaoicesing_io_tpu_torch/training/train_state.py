"""The optimizer and the train state (counterpart of the JAX package's
``training/train_state.py``).

AdamW takes ``beta1``, ``beta2`` and ``weight_decay`` from
``optimizer_args`` with eps 1e-8, as optax's ``adamw``; its learning rate is
set from the schedule before each update, so that update ``n`` uses
``schedule(n)``, as optax's count does.  Gradients are clipped to
``clip_grad_norm`` with optax's ``clip_by_global_norm`` formula, ``g *
max_norm / max(norm, max_norm)`` (``torch.nn.utils.clip_grad_norm_`` divides
by ``norm + 1e-6`` instead).  With ``accumulate_grad_batches`` k > 1 an
update takes the mean of k micro-batch gradients, then the clip, as
``optax.MultiSteps`` does.  Frozen parameters (``requires_grad`` off) are
in neither the optimizer nor the global norm.

In a process group of more than one rank (``parallel/mesh.py``) each
update first averages the accumulated gradients over the ranks, one
collective an update, then clips the mean: the global batch's gradient,
as the JAX package's sharded step computes it.  Every rank holds every
gradient, a zero where its batch reached none, so that all ranks apply the
same update.
"""

from __future__ import annotations

from typing import List

import torch

from ..parallel.mesh import all_reduce_mean_, broadcast_
from .schedules import Schedule, build_lr_schedule


def build_optimizer(cfg, params: List[torch.nn.Parameter]) -> torch.optim.AdamW:
    opt_args = cfg.get("optimizer_args", {})
    return torch.optim.AdamW(params, lr=opt_args.get("lr", 1e-4),
                             betas=(opt_args.get("beta1", 0.9), opt_args.get("beta2", 0.98)),
                             eps=1e-8, weight_decay=opt_args.get("weight_decay", 0.0))


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / max(norm, max_norm)``;
    returns the global norm (on the gradients' device, no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float())
                                                 for g in grads]))
    scale = max_norm / norm.clamp(min=max_norm)
    torch._foreach_mul_(grads, scale.to(grads[0].dtype))
    return norm


class TrainState:
    """The model, its optimizer and the counts of one training run, on the
    model's device.  ``step`` counts updates, ``micro`` micro-batches."""

    def __init__(self, model: torch.nn.Module, cfg):
        self.model = model
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = build_optimizer(cfg, self.params)
        self.schedule: Schedule = build_lr_schedule(cfg.get("optimizer_args", {}),
                                                    cfg.get("lr_scheduler_args", {}))
        self.clip = cfg.get("clip_grad_norm", 1.0)
        self.accum = max(1, int(cfg.get("accumulate_grad_batches", 1) or 1))
        self.step = 0
        self.micro = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def backward(self, total: torch.Tensor) -> bool:
        """Accumulate ``total``'s gradients as one micro-batch of an update;
        at the last micro-batch of an update, apply it.  Returns whether an
        update happened."""
        (total / self.accum).backward()
        self.micro += 1
        if self.micro % self.accum:
            return False
        self.apply_gradients()
        return True

    def apply_gradients(self) -> None:
        """Average the accumulated gradients over the ranks, clip them, set
        the learning rate of update ``step`` and step the optimizer."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        for p, g in zip(self.params, grads):
            p.grad = g
        all_reduce_mean_(grads)
        if self.clip:
            clip_by_global_norm(grads, float(self.clip))
        lr = float(self.schedule(self.step))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1

    def broadcast_from(self, src: int = 0) -> None:
        """Make this rank's model and AdamW state rank ``src``'s (after a
        restore, so that every rank starts from the same state)."""
        tensors = list(self.model.parameters()) + list(self.model.buffers())
        for p in self.params:
            state = self.optimizer.state.get(p, {})
            tensors += [state[k] for k in sorted(state) if torch.is_tensor(state[k])]
        broadcast_(tensors, src)
