"""The port's ``ops/seq.py`` against the JAX package's on the CPU: duration
scaling (``alpha``, f32 products rounded half to even), clipped counts
(``max_dur``) and ``stretch_regulator``.  Integer outputs must be equal;
``stretch_regulator`` within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xiaoicesing_io_tpu.ops import seq as jseq
from xiaoicesing_io_tpu_torch.ops import seq as tseq

# odd durations: with alpha 0.5, 1.5 and 2.5 every product is an exact .5 tie
TIES = np.array([[1, 3, 5, 7, 9, 11, 13, 15, 0, 0, 0, 0]])


def _durations(seed: int) -> np.ndarray:
    """[4, 12] durations with zero-length tokens, padded rows and .5 ties."""
    rng = np.random.default_rng(seed)
    dur = rng.integers(0, 10, size=(3, 12))
    dur[1, 9:] = 0  # padded tokens
    dur[2, ::4] = 0  # zero-duration tokens inside the row
    return np.concatenate([dur, TIES]).astype(np.int64)


@pytest.mark.parametrize("alpha", [0.3, 0.5, 0.7, 1.5, 2.5])
def test_length_regulator_alpha(alpha):
    dur = _durations(0)
    ties = (dur.astype(np.float32) * np.float32(alpha)) % 1 == 0.5
    assert ties.any()  # the inputs hold products that round half to even
    out_len = int(np.round(dur.sum(1).max() * alpha)) + 4
    ref = np.asarray(jseq.length_regulator(jnp.asarray(dur, jnp.int32), out_len, alpha=alpha))
    got = tseq.length_regulator(torch.from_numpy(dur), out_len, alpha=alpha)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    # a shorter output cuts the last tokens off the same way
    ref = np.asarray(jseq.length_regulator(jnp.asarray(dur, jnp.int32), 17, alpha=alpha))
    np.testing.assert_array_equal(
        tseq.length_regulator(torch.from_numpy(dur), 17, alpha=alpha).numpy(), ref)


@pytest.mark.parametrize("offset", [-3, -1, 0, 2])
def test_mel2ph_to_dur_max_dur(offset):
    dur = _durations(2)
    t_txt, out_len = dur.shape[1], int(dur.sum(1).max()) + 5
    mel2ph = np.asarray(jseq.length_regulator(jnp.asarray(dur, jnp.int32), out_len))
    longest = int(dur.max())
    max_dur = longest + offset
    ref = np.asarray(jseq.mel2ph_to_dur(jnp.asarray(mel2ph), t_txt, max_dur=max_dur))
    got = tseq.mel2ph_to_dur(torch.from_numpy(mel2ph.astype(np.int64)), t_txt, max_dur=max_dur)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.max().item() == min(longest, max_dur)
    if offset >= 0:
        np.testing.assert_array_equal(got.numpy(), dur)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_stretch_regulator_random(seed):
    dur = _durations(seed)
    out_len = int(dur.sum(1).max()) + 6  # padding frames at every row's end
    mel2ph = np.asarray(jseq.length_regulator(jnp.asarray(dur, jnp.int32), out_len))
    ref = np.asarray(jseq.stretch_regulator(jnp.asarray(mel2ph), jnp.asarray(dur, jnp.int32)))
    got = tseq.stretch_regulator(torch.from_numpy(mel2ph.astype(np.int64)),
                                 torch.from_numpy(dur))
    assert got.dtype == torch.float32 and got.shape == mel2ph.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert (got.numpy()[mel2ph == 0] == 0).all()
    assert ((got.numpy() >= 0) & (got.numpy() < 1)).all()


def test_stretch_regulator_worked_example():
    # dur = [2, 4, 3] -> mel2ph = [1, 1, 2, 2, 2, 2, 3, 3, 3]
    mel2ph = np.array([[1, 1, 2, 2, 2, 2, 3, 3, 3]])
    dur = np.array([[2, 4, 3]])
    expect = np.array([[0, 1 / 2, 0, 1 / 4, 2 / 4, 3 / 4, 0, 1 / 3, 2 / 3]])
    ref = np.asarray(jseq.stretch_regulator(jnp.asarray(mel2ph), jnp.asarray(dur)))
    got = tseq.stretch_regulator(torch.from_numpy(mel2ph), torch.from_numpy(dur)).numpy()
    np.testing.assert_allclose(got, expect, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
