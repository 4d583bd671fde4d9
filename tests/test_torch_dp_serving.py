"""The port's serving over several devices against itself and the JAX
package, on the CPU, and the ``train`` command's multi-process flags.

``DataParallelSynthesizer(infer, devices=["cpu"] * n)`` pads each chunk to a
multiple of ``n`` rows and runs ``n`` slices, each through a runner of its
device (here the runner itself).  The tiny checkpoints, song segments and
JAX helpers are ``tests/test_torch_serving.py``'s.

* n = 1, 2, 3 give the same mels (each chunk's noise is drawn once, for its
  real rows; the rows of a slice run alone) and the same wavs, to f32
  rounding: 1e-5 plus 1e-6 of the value, the bar of a batched row against
  its segment alone;
* against JAX's ``DataParallelSynthesizer`` on a mesh of ``n`` CPU devices,
  with the start noise JAX draws over its padded rows fed to the port
  (which takes the real rows), within the module bar 2e-4; JAX's chunk plan
  (the cap ``max(n, 49152 // bucket)``) is the port's;
* the speaker-mix cases of the JAX package's ``tests/test_serving.py`` at
  n = 2;
* ``run_inference(data_parallel=True)`` writes the same song at n = 1 and 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serving import (  # noqa: F401 (fixtures)
    MELS, _one_torch_thread, _speaker_segment, _song, exps, runners,
)

ROW_ATOL, ROW_RTOL = 1e-5, 1e-6   # f32 rounding of batched against smaller products
JAX_TOL = 2e-4                    # the module bar: f32 on both sides


def _dp(pr, n):
    from xiaoicesing_io_tpu_torch.inference.serving import DataParallelSynthesizer

    return DataParallelSynthesizer(pr, devices=["cpu"] * n)


def _jax_noise(batches, seed, ddpm, n):
    """Every chunk's start noise as JAX's synthesizer on ``n`` devices draws
    it: over the chunk's rows padded to a multiple of ``n``."""
    from xiaoicesing_io_tpu_torch.inference.serving import plan_chunks

    out = {}
    lengths = [b["mel2ph"].shape[1] for b in batches]
    for bucket, chunk_no, idxs in plan_chunks(lengths, None, n):
        key = jax.random.fold_in(jax.random.PRNGKey(seed & 0xFFFFFFFF), bucket * 4099 + chunk_no)
        if ddpm:
            _, key = jax.random.split(key)
        rows = len(idxs) + (-len(idxs)) % n
        out[bucket, chunk_no] = np.asarray(
            jax.random.normal(key, (rows, 1, bucket, MELS), jnp.float32))
    return out


@pytest.mark.parametrize("name", ["lynx", "ddpm"])
def test_devices_give_the_same_mels_and_wavs(runners, name):
    """Six segments (buckets 256 and 512: chunks of 2 and 4 rows, padded to
    3 and 6 rows at n = 3) through 1, 2 and 3 devices."""
    from xiaoicesing_io_tpu_torch.inference.serving import plan_chunks

    _, pr = runners(name)
    segs = _song(6)
    batches = [pr.preprocess_input(p, idx=i) for i, p in enumerate(segs)]
    lengths = [b["mel2ph"].shape[1] for b in batches]
    assert [len(i) for _, _, i in plan_chunks(lengths, None, 3)] == [2, 4]
    ref_mels, ref_f0s = _dp(pr, 1).synthesize_mels(segs, seed=5, batches=batches)
    for n in (2, 3):
        dp = _dp(pr, n)
        assert dp.devices == [torch.device("cpu")] * n and list(dp.runners.values()) == [pr]
        mels, f0s = dp.synthesize_mels(segs, seed=5, batches=batches)
        for i, (m, rm) in enumerate(zip(mels, ref_mels)):
            assert m.shape == rm.shape == (lengths[i], MELS) and np.isfinite(m).all()
            np.testing.assert_allclose(m, rm, atol=ROW_ATOL, rtol=ROW_RTOL, err_msg=f"{n} {i}")
            np.testing.assert_array_equal(f0s[i], ref_f0s[i])
    if name == "lynx":
        wavs = [_dp(pr, n).vocode(ref_mels, ref_f0s, seed=2) for n in (1, 3)]
        for a, b in zip(*wavs):
            np.testing.assert_array_equal(a, b)  # the vocoder stays on the runner's device


@pytest.mark.parametrize("name,n", [("lynx", 2), ("lynx", 3), ("ddpm", 2)])
def test_devices_match_jax_mesh(runners, name, n):
    """The port on ``n`` devices against JAX's synthesizer on a mesh of
    ``n`` CPU devices, from JAX's noise."""
    from xiaoicesing_io_tpu.inference.serving import DataParallelSynthesizer as JDP
    from xiaoicesing_io_tpu.parallel.mesh import make_mesh

    jr, pr = runners(name)
    segs = _song(5)
    ref, _ = JDP(jr, mesh=make_mesh(jax.devices()[:n])).synthesize_mels(segs, seed=7)
    batches = [pr.preprocess_input(p, idx=i) for i, p in enumerate(segs)]
    noise = _jax_noise(batches, 7, name == "ddpm", n)
    mels, _ = _dp(pr, n).synthesize_mels(segs, seed=7, batches=batches, noise=noise)
    for i, (m, rm) in enumerate(zip(mels, ref)):
        assert m.shape == np.asarray(rm).shape
        np.testing.assert_allclose(m, np.asarray(rm), atol=JAX_TOL, rtol=0, err_msg=str(i))
    assert max(np.abs(np.asarray(rm)).max() for rm in ref) > 1.0


def test_spk_mix_cases_at_two_devices(runners):
    """``tests/test_serving.py``'s speaker-mix cases at n = 2: static mixes
    condition every frame; a two-speaker and a solo mix share a chunk; a
    static mix beside a dynamic one is repeated over time (an all-bob
    dynamic mix equals the static bob row)."""
    _, pr = runners("speakers")
    seg, dynamic_bob = _speaker_segment()
    static_a, static_b = {**seg, "spk_mix": {"alice": 1.0}}, {**seg, "spk_mix": {"bob": 1.0}}
    dp = _dp(pr, 2)
    (mel_a, mel_b), _ = dp.synthesize_mels([static_a, static_b], seed=11)
    assert np.abs(mel_a[1:] - mel_b[1:]).mean() > 1e-4
    duet = {**seg, "spk_mix": {"alice": 0.5, "bob": 0.5}}
    mels, _ = dp.synthesize_mels([duet, static_a], seed=4)
    assert all(np.isfinite(m).all() for m in mels)
    dynamic = {**seg, "spk_mix": dynamic_bob, "spk_mix_timestep": seg["f0_timestep"]}
    (got_a, got_b), _ = dp.synthesize_mels([static_a, dynamic], seed=11)
    np.testing.assert_allclose(got_a, mel_a, atol=ROW_ATOL, rtol=0)
    np.testing.assert_allclose(got_b, mel_b, atol=ROW_ATOL, rtol=0)
    one, _ = _dp(pr, 1).synthesize_mels([static_a, dynamic], seed=11)
    for a, b in zip((got_a, got_b), one):
        np.testing.assert_allclose(a, b, atol=ROW_ATOL, rtol=ROW_RTOL)


def test_run_inference_same_song_at_two_devices(runners, tmp_path):
    from scipy.io import wavfile

    _, pr = runners("lynx")
    segs = _song(4)
    songs = []
    for n in (1, 2):
        (path,) = pr.run_inference(segs, out_dir=tmp_path / str(n), title="song", seed=5,
                                   data_parallel=True, devices=["cpu"] * n)
        rate, wav = wavfile.read(path)
        assert rate == 44100
        songs.append(wav.astype(np.int32))
    assert songs[0].shape == songs[1].shape
    # int16 samples: f32 rounding of the mels moves a sample by at most one step
    assert np.abs(songs[0] - songs[1]).max() <= 1


def test_train_cli_parses_multi_process_flags(tmp_path):
    """``train --coordinator --num_processes --process_id``, as the JAX
    command takes them; more than one process without CUDA and without
    ``--device cpu`` raises before any group is formed."""
    import torch.distributed as dist

    from xiaoicesing_io_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["train", "--config", "c.yaml", "--exp_name", "e", "--coordinator", "10.0.0.1:29500",
         "--num_processes", "4", "--process_id", "3"])
    assert (args.coordinator, args.num_processes, args.process_id) == ("10.0.0.1:29500", 4, 3)
    args = cli.build_parser().parse_args(["train", "--exp_name", "e"])
    assert (args.coordinator, args.num_processes, args.process_id) == (None, None, None)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "--config", str(tmp_path / "c.yaml"), "--exp_name", "e",
                  "--coordinator", "localhost:1", "--num_processes", "2", "--process_id", "0"])
    assert not dist.is_initialized()
