"""Training losses (counterpart of the JAX package's ``training/losses.py``).

* :func:`diffusion_loss`: l1 or l2 on the noise prediction, the padding
  zeroed, then a plain mean over every element, padding included;
* :func:`reflow_loss`: the same on the velocity, optionally weighted per
  row by the logit-normal density of ``t``;
* :func:`aux_mel_loss`: l1 on the normalised aux mel;
* :func:`duration_loss`: phone, word and sentence terms in the log domain
  (mse or huber), word durations summed by ``ph2word``.

Every denominator is a count of elements of the padded batch, a shape,
except the word term's, ``rows * max(ph2word)``; a rank of a data-parallel
group passes the maximum over every rank's batch (``word_max``), so that the
mean of the ranks' losses is the global batch's loss.
"""

from __future__ import annotations

from typing import Optional

import torch


def _elementwise(loss_type: str, pred, target):
    if loss_type == "l1":
        return (pred - target).abs()
    if loss_type == "l2":
        return (pred - target) ** 2
    raise NotImplementedError(loss_type)


def _huber(pred, target, delta: float = 1.0):
    d = pred - target
    return torch.where(d.abs() < delta, 0.5 * d * d, delta * (d.abs() - 0.5 * delta))


def _masked(pred, target, non_padding):
    if non_padding is None:
        return pred, target
    mask = non_padding[:, None, :, None] if non_padding.dim() == 2 else non_padding[:, None]
    mask = mask.to(pred.dtype)
    return pred * mask, target * mask


def diffusion_loss(x_recon: torch.Tensor, noise: torch.Tensor,
                   non_padding: Optional[torch.Tensor] = None,
                   loss_type: str = "l2") -> torch.Tensor:
    """x_recon, noise ``[B, F, T, M]``; non_padding ``[B, T]`` or ``[B, T, M]``."""
    x_recon, noise = _masked(x_recon, noise, non_padding)
    return _elementwise(loss_type, x_recon, noise).mean()


def reflow_logit_normal_weights(t: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    t = t.float().clamp(eps, 1 - eps)
    return 0.398942 / t / (1 - t) * torch.exp(-0.5 * torch.log(t / (1 - t)) ** 2) + eps


def reflow_loss(v_pred: torch.Tensor, v_gt: torch.Tensor, t: torch.Tensor,
                non_padding: Optional[torch.Tensor] = None, loss_type: str = "l2",
                log_norm: bool = True) -> torch.Tensor:
    v_pred, v_gt = _masked(v_pred, v_gt, non_padding)
    loss = _elementwise(loss_type, v_pred, v_gt)
    if log_norm:
        loss = reflow_logit_normal_weights(t)[:, None, None, None] * loss
    return loss.mean()


def aux_mel_loss(aux_out: torch.Tensor, norm_gt: torch.Tensor,
                 loss_type: str = "l1") -> torch.Tensor:
    return _elementwise(loss_type, aux_out, norm_gt).mean()


def duration_loss(dur_pred: torch.Tensor, dur_gt: torch.Tensor, ph2word: torch.Tensor,
                  offset: float = 1.0, loss_type: str = "mse", lambda_pdur: float = 0.3,
                  lambda_wdur: float = 1.0, lambda_sdur: float = 3.0,
                  word_max: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dur_pred, dur_gt ``[B, T_ph]``; ph2word 1-based (0: padding).  The
    word term is a plain mean over ``[B, max(ph2word)]``, as the reference
    takes it; ``word_max`` replaces ``max(ph2word)`` (a data-parallel rank
    passes the global batch's)."""
    base = {"mse": lambda p, g: (p - g) ** 2, "huber": _huber}[loss_type]

    def log(d):
        return torch.log(d + offset)

    dur_gt = dur_gt.to(dur_pred.dtype)
    pdur = lambda_pdur * base(log(dur_pred), log(dur_gt)).mean()
    dur_pred = dur_pred.clamp(min=0.0)
    b, n = ph2word.shape

    def words(d):
        return d.new_zeros(b, n + 1).scatter_add(1, ph2word.long(), d)[:, 1:]

    wdur_elems = base(log(words(dur_pred)), log(words(dur_gt)))
    wdur_denom = b * (ph2word.max() if word_max is None else word_max).clamp(min=1)
    wdur = lambda_wdur * wdur_elems.sum() / wdur_denom.to(wdur_elems.dtype)
    sdur = lambda_sdur * base(log(dur_pred.sum(1)), log(dur_gt.sum(1))).mean()
    return pdur + wdur + sdur
