"""The port's pitch extractors against the JAX package, on the CPU.

``E2E0`` at a reduced depth and width (2 encoder levels, 1 intermediate
layer, 1 block a level, 4 channels; the GRU and the 360 classes at their
full width) from a random flax parameter tree carried over by
``rmvpe_state_dict_from_jax``: the salience within 1e-5.  The carrier
inverts ``convert_rmvpe`` exactly.  ``RMVPE.get_pitch``: the JAX runner is
built as usual and its ``model`` and ``params`` are then replaced by the
small ones; the port loads the small checkpoint itself.  f0 within 1e-3 Hz
and uv equal.  ``HarvestPE`` (numpy on both sides) and the autocorrelation
tracker (the JAX package's native core against the port's numpy) on a tone
with vibrato: within 1e-3 Hz.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xiaoicesing_io_tpu.models import pe as jpe
from xiaoicesing_io_tpu.models.pe import rmvpe as jrmvpe
from xiaoicesing_io_tpu.utils.torch_ckpt import convert_rmvpe
from xiaoicesing_io_tpu_torch.models import pe
from xiaoicesing_io_tpu_torch.models.pe import rmvpe
from xiaoicesing_io_tpu_torch.utils.jax_weights import rmvpe_state_dict_from_jax

SR = 44100
SMALL = dict(n_blocks=1, en_de_layers=2, inter_layers=1, en_out_channels=4)
SALIENCE_TOL = 1e-5
F0_TOL = 1e-3  # Hz


@pytest.fixture(autouse=True)
def few_torch_threads():
    """Two torch threads for these tests: next to JAX's own pool in a busy
    test worker, a full-width OpenMP pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def small_params(seed: int, frames: int = 32) -> dict:
    """A random tree of the small JAX ``E2E0``'s parameters: kernels at
    1/sqrt(fan-in), BatchNorm statistics and affine terms about their
    identity."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jrmvpe.E2E0(**SMALL).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, frames, 128), jnp.float32))

    def fill(path, s):
        name = path[-1].key
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("mean", "bias", "b_ih", "b_hh"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def tone(seconds: float, f0: float = 220.0, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))) / SR
    y = sum(0.3 / k * np.sin(k * phase) for k in range(1, 6))
    return (y + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def full_depth_checkpoint(path) -> None:
    """A checkpoint with every name the JAX runner's constructor converts at
    full depth.  Its values are replaced right after construction, so each
    tensor is a broadcast zero (one stored element)."""
    sd = rmvpe.E2E0().state_dict()
    torch.save({k: torch.zeros(()).expand(v.shape) for k, v in sd.items()}, path)


def test_e2e0_matches_jax():
    params = small_params(0)
    mel = np.random.default_rng(1).standard_normal((1, 32, 128)).astype(np.float32)
    ref = np.asarray(jax.jit(jrmvpe.E2E0(**SMALL).apply)(params, jnp.asarray(mel)))
    model = rmvpe.E2E0.from_state_dict(rmvpe_state_dict_from_jax(params)).eval()
    assert len(model.unet.encoder.layers) == 2 and len(model.unet.intermediate.layers) == 1
    with torch.no_grad():
        got = model(torch.from_numpy(np.ascontiguousarray(mel.transpose(0, 2, 1)))).numpy()
    assert got.shape == ref.shape == (1, 32, 360)
    assert ref.std() > 0.05
    np.testing.assert_allclose(got, ref, rtol=0, atol=SALIENCE_TOL)


def test_e2e0_carrier_round_trip():
    """flax tree -> the carrier -> ``convert_rmvpe`` gives the tree back bit for
    bit, the transposed convs' flipped taps and the GRU's transposes among it;
    and a reference state dict comes back through both."""
    params = small_params(2)
    sd = rmvpe_state_dict_from_jax(params)
    back = convert_rmvpe({k: v.numpy() for k, v in sd.items()}, en_de_layers=2,
                         inter_layers=1, n_blocks=1)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert np.array_equal(a, b)
    torch.manual_seed(3)
    ref_sd = {k: v for k, v in rmvpe.E2E0(**{**SMALL, "n_gru": 1}).state_dict().items()
              if not k.endswith("num_batches_tracked") and not k.startswith("unet.tf.")}
    again = rmvpe_state_dict_from_jax(convert_rmvpe(
        {k: v.numpy() for k, v in ref_sd.items()}, en_de_layers=2, inter_layers=1, n_blocks=1))
    assert sorted(again) == sorted(ref_sd)
    for k, v in ref_sd.items():
        assert torch.equal(again[k], v), k


def test_rmvpe_runner_matches_jax(tmp_path):
    params = small_params(4)
    full_depth_checkpoint(tmp_path / "full.pt")
    jrunner = jrmvpe.RMVPE(tmp_path / "full.pt")
    jrunner.model, jrunner.params = jrmvpe.E2E0(**SMALL), params
    torch.save({"model": rmvpe_state_dict_from_jax(params)}, tmp_path / "small.pt")
    runner = rmvpe.RMVPE(tmp_path / "small.pt", device="cpu")

    wav = tone(0.6, seed=5)
    mel, n_frames = runner.mel_frames(wav, SR)
    assert mel.shape[0] % 32 == 0 and n_frames == 61
    ref_hidden = np.asarray(jrunner._apply(params, jnp.asarray(mel[None])))[0]
    np.testing.assert_allclose(runner.salience(mel), ref_hidden, rtol=0, atol=SALIENCE_TOL)

    length = 60
    for interp_uv in (True, False):
        kw = dict(hop_size=512, f0_min=65, f0_max=1100, interp_uv=interp_uv)
        f0, uv = runner.get_pitch(wav, SR, length, **kw)
        jf0, juv = jrunner.get_pitch(wav, SR, length, **kw)
        assert f0.shape == (length,) and f0.dtype == np.float32
        np.testing.assert_array_equal(uv, juv)
        np.testing.assert_allclose(f0, jf0, rtol=0, atol=F0_TOL)


def test_rmvpe_decoders_match_jax():
    rng = np.random.default_rng(6)
    hidden = rng.uniform(0, 0.05, (40, 360)).astype(np.float32)
    hidden[np.arange(30), np.linspace(80, 200, 30).astype(int)] = 0.9  # 10 unvoiced frames
    np.testing.assert_array_equal(rmvpe.to_local_average_f0(hidden),
                                  jrmvpe.to_local_average_f0(hidden))
    np.testing.assert_array_equal(rmvpe.to_viterbi_f0(hidden), jrmvpe.to_viterbi_f0(hidden))


@pytest.mark.parametrize("name", ["harvest", "parselmouth"])
def test_host_extractors_match_jax(name):
    cfg = {"pe": name}
    wav = tone(1.0, f0=247.0, seed=7)
    length = len(wav) // 512 + 1
    ours, theirs = pe.initialize_pe(cfg, device="cpu"), jpe.initialize_pe(cfg)
    assert type(ours).__name__ == type(theirs).__name__
    for interp_uv, speed in ((True, 1), (False, 1.2)):
        kw = dict(hop_size=512, f0_min=65, f0_max=1100, speed=speed, interp_uv=interp_uv)
        f0, uv = ours.get_pitch(wav, SR, length, **kw)
        jf0, juv = theirs.get_pitch(wav, SR, length, **kw)
        np.testing.assert_array_equal(uv, juv)
        np.testing.assert_allclose(f0, jf0, rtol=0, atol=F0_TOL)
        voiced = ~uv
        assert voiced.sum() > length // 2
        assert abs(np.median(f0[voiced]) - 247.0) < 10.0


def test_rmvpe_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rmvpe.RMVPE(tmp_path / "model.pt")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pe.initialize_pe({"pe": "rmvpe", "pe_ckpt": str(tmp_path / "model.pt")})
    with pytest.raises(ValueError, match="Unknown f0 extractor"):
        pe.initialize_pe({"pe": "crepe"}, device="cpu")


def test_rmvpe_worker_copy_loads_its_own_model(tmp_path):
    """A pickled runner (a ``spawn`` worker's copy) carries no model and loads
    its own on the runner's device at first use."""
    import pickle

    torch.save(rmvpe_state_dict_from_jax(small_params(8)), tmp_path / "small.pt")
    runner = rmvpe.RMVPE(tmp_path / "small.pt", device="cpu")
    mel = np.zeros((32, 128), np.float32)
    first = runner.salience(mel)
    copy = pickle.loads(pickle.dumps(runner))
    assert runner.model is not None and copy.model is None and copy.device == runner.device
    np.testing.assert_array_equal(copy.salience(mel), first)
