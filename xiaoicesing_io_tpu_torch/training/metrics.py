"""Objective validation metrics, in numpy.

Counterpart of the JAX package's ``training/metrics.py``:

* :class:`RawCurveAccuracy`: the share of (masked) points with ``|pred -
  gt| <= tolerance``;
* :class:`RhythmCorrectness`: the share of words whose summed phoneme
  durations are within a relative tolerance of the target's;
* :class:`PhonemeDurationAccuracy`: the share of phonemes within a relative
  tolerance after the predicted durations are rhythm-regulated onto the
  target's word durations (the port's ``ops/seq.rhythm_regulator``).

Each keeps a (numerator, denominator) pair, so that states add across
workers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.seq import rhythm_regulator


@dataclass
class SumMetric:
    numer: float = 0.0
    denom: float = 0.0

    def compute(self) -> float:
        return self.numer / max(self.denom, 1e-9)

    def reset(self):
        self.numer = self.denom = 0.0


def _word_sum(x, ph2word, num_words):
    out = np.zeros((x.shape[0], num_words + 1), x.dtype)
    for b in range(x.shape[0]):
        np.add.at(out[b], ph2word[b], x[b])
    return out[:, 1:]


class RawCurveAccuracy(SumMetric):
    def __init__(self, tolerance: float):
        super().__init__()
        self.tolerance = tolerance

    def update(self, pred, target, mask=None):
        pred, target = np.asarray(pred), np.asarray(target)
        close = np.abs(pred - target) <= self.tolerance
        if mask is not None:
            mask = np.asarray(mask).astype(bool)
            close = close & mask
            self.denom += mask.sum()
        else:
            self.denom += pred.size
        self.numer += close.sum()


class RhythmCorrectness(SumMetric):
    def __init__(self, tolerance: float):
        super().__init__()
        assert 0.0 < tolerance < 1.0
        self.tolerance = tolerance

    def update(self, pdur_pred, pdur_target, ph2word, mask=None):
        pdur_pred = np.asarray(pdur_pred, np.float64)
        pdur_target = np.asarray(pdur_target, np.float64)
        ph2word = np.asarray(ph2word)
        num_words = int(ph2word.max())
        wdur_pred = _word_sum(pdur_pred, ph2word, num_words)
        wdur_target = _word_sum(pdur_target, ph2word, num_words)
        if mask is None:
            wmask = np.ones_like(wdur_pred, bool)
        else:
            wmask = _word_sum(np.asarray(mask, np.float64), ph2word, num_words) > 0
        correct = (np.abs(wdur_pred - wdur_target) <= wdur_target * self.tolerance) & wmask
        self.numer += correct.sum()
        self.denom += wmask.sum()


class PhonemeDurationAccuracy(SumMetric):
    def __init__(self, tolerance: float):
        super().__init__()
        self.tolerance = tolerance

    def update(self, pdur_pred, pdur_target, ph2word, mask=None):
        pdur_pred = np.asarray(pdur_pred, np.float64)
        pdur_target = np.asarray(pdur_target, np.float64)
        ph2word = np.asarray(ph2word)
        num_words = int(ph2word.max())
        wdur_target = _word_sum(pdur_target, ph2word, num_words)
        # the regulator in f32, as the JAX package runs it
        pdur_align = rhythm_regulator(
            torch.from_numpy(pdur_pred.astype(np.float32)), torch.from_numpy(ph2word),
            torch.from_numpy(wdur_target.astype(np.float32))).numpy()
        accurate = np.abs(pdur_align - pdur_target) <= pdur_target * self.tolerance
        if mask is not None:
            mask = np.asarray(mask).astype(bool)
            accurate = accurate & mask
            self.denom += mask.sum()
        else:
            self.denom += pdur_pred.size
        self.numer += accurate.sum()
