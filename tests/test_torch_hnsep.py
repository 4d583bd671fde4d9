"""The port's harmonic/noise separation against the JAX package, on the CPU.

``CascadedNet`` (mono at ``n_fft`` 256, stereo at 512; ``nout`` 16,
``nout_lstm`` 32) from one set of random weights written under the reference names:
the JAX side converts them with its ``convert_cascaded_net``, the port loads
them as they are; the complex mask within 1e-5 (stereo on the runner's own
input, so that the JAX net compiles once for it).  The carrier
``cascaded_net_state_dict_from_jax`` inverts ``convert_cascaded_net``
exactly.  ``VocalRemover.predict_harmonic`` of both packages from one
``model.pt`` + ``config.yaml``: within 1e-5 of the waveform's scale.  The
curves of ``dsp/features.py`` under ``world`` (the comb decomposition) from
the same waveform and f0: within 1e-4 (dB, or logit for tension).  The
``vr`` model cache: JAX keeps the first model whatever ``hnsep_ckpt`` names
next; the port loads each checkpoint it is given.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from xiaoicesing_io_tpu.dsp import features as jfeatures
from xiaoicesing_io_tpu.dsp.hnsep import DecomposedWaveform as JDecomposed
from xiaoicesing_io_tpu.models.hnsep_vr import CascadedNet as JCascadedNet
from xiaoicesing_io_tpu.models.hnsep_vr import VocalRemover as JVocalRemover
from xiaoicesing_io_tpu.utils.torch_ckpt import convert_cascaded_net
from xiaoicesing_io_tpu_torch.dsp import features
from xiaoicesing_io_tpu_torch.dsp.hnsep import DecomposedWaveform
from xiaoicesing_io_tpu_torch.models.hnsep_vr import CascadedNet, VocalRemover
from xiaoicesing_io_tpu_torch.utils.jax_weights import cascaded_net_state_dict_from_jax

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_pe import few_torch_threads  # noqa: E402,F401 (autouse)

SR = 44100
MASK_TOL = 1e-5       # the mask, of its scale (a bounded mask: |m| < 1)
HARMONIC_TOL = 1e-5   # the harmonic waveform, of the waveform's scale
CURVE_TOL = 1e-4      # dB (energy, breathiness, voicing), logit (tension)
# the runner's widths: hop n_fft / 2 keeps the frames (the LSTMs' steps) few
VR_WIDTHS = dict(n_fft=512, hop_length=256, n_out=16, n_out_lstm=32)


def random_net(seed: int, is_mono: bool, n_fft: int = 256, nout: int = 16,
               nout_lstm: int = 32) -> CascadedNet:
    """A port ``CascadedNet`` with torch's init and random BatchNorm statistics."""
    torch.manual_seed(seed)
    net = CascadedNet(n_fft, nout=nout, nout_lstm=nout_lstm, is_mono=is_mono).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return net


def write_vr(directory: Path, seed: int, **widths) -> Path:
    """``model.pt`` (the reference state dict, ``aux_out`` included) and its
    ``config.yaml``."""
    cfg = dict(VR_WIDTHS, is_mono=False, **widths)
    directory.mkdir(parents=True, exist_ok=True)
    net = random_net(seed, cfg["is_mono"], cfg["n_fft"], cfg["n_out"], cfg["n_out_lstm"])
    torch.save(net.state_dict(), directory / "model.pt")
    (directory / "config.yaml").write_text(yaml.safe_dump(cfg))
    return directory / "model.pt"


def tone(seconds: float, f0: float = 220.0, seed: int = 0) -> np.ndarray:
    """Harmonics of f0 with 5 Hz vibrato and -40 dB noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.01 * np.sin(2 * np.pi * 5 * t))) / SR
    y = sum(0.3 / k * np.sin(k * phase) for k in range(1, 6))
    return (y + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def test_cascaded_net_matches_jax_mono():
    net = random_net(0, True)
    x = np.random.default_rng(1).standard_normal((1, 2, 129, 64)).astype(np.float32)
    params = convert_cascaded_net({k: v.numpy() for k, v in net.state_dict().items()})
    ref = np.asarray(jax.jit(JCascadedNet(n_fft=256, nout=16, nout_lstm=32,
                                          is_mono=True).apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 2, 129, 64)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=MASK_TOL)


def test_cascaded_net_carrier_round_trip():
    """reference state dict -> ``convert_cascaded_net`` -> the carrier gives
    every tensor the JAX converter reads back, bit for bit; and the carrier's
    state dict converts back to the same tree."""
    sd = {k: v for k, v in random_net(2, False).state_dict().items()
          if not k.endswith("num_batches_tracked") and not k.startswith("aux_out.")}
    params = convert_cascaded_net({k: v.numpy() for k, v in sd.items()})
    back = cascaded_net_state_dict_from_jax(params)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.float32 and torch.equal(back[k], v), k
    again = convert_cascaded_net({k: v.numpy() for k, v in back.items()})
    assert jax.tree_util.tree_structure(again) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(params)):
        assert np.array_equal(a, b)


def test_vocal_remover_matches_jax(tmp_path):
    """The stereo mask on the runner's input, then the harmonic waveform."""
    path = write_vr(tmp_path / "vr", seed=3)
    wav = tone(0.3)
    jrunner = JVocalRemover(path)
    runner = VocalRemover(path, device="cpu")
    ri = runner.spectrogram(wav)[-1]
    assert ri.shape == (1, 4, 257, 64)
    ref_mask = np.asarray(jrunner._apply(jrunner.params, jnp.asarray(ri)))
    mask = runner.mask(ri)
    assert mask.shape == ref_mask.shape and np.abs(ref_mask).max() > 0.1
    np.testing.assert_allclose(mask, ref_mask, rtol=0, atol=MASK_TOL)
    ref = jrunner.predict_harmonic(wav)
    got = runner.predict_harmonic(wav)
    assert got.shape == ref.shape == wav.shape and got.dtype == np.float32
    scale = float(np.abs(wav).max())
    assert np.abs(got - ref).max() <= HARMONIC_TOL * scale
    assert np.abs(ref).max() > 1e-3 * scale  # the mask passes a real part


def test_vocal_remover_loads_reference_names(tmp_path):
    """``model.pt`` loads with every reference name, the unused training head
    ``aux_out`` among them; a missing tensor raises."""
    path = write_vr(tmp_path / "vr", seed=4)
    sd = torch.load(path)
    assert "aux_out.weight" in sd and "stg1_low_band_net.0.enc1.conv.0.weight" in sd
    assert "stg3_full_band_net.lstm_dec2.lstm.weight_ih_l0_reverse" in sd
    runner = VocalRemover(path, device="cpu")
    assert torch.equal(runner.model.aux_out.weight, sd["aux_out.weight"])
    del sd["out.weight"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="out.weight"):
        VocalRemover(path, device="cpu")


def test_curves_under_world_match_jax():
    wav = tone(1.0, f0=260.0, seed=5)
    hop, win = 512, 2048
    length = len(wav) // hop + 1
    t = np.arange(length) * hop / SR
    f0 = (260.0 * (1 + 0.01 * np.sin(2 * np.pi * 5 * t))).astype(np.float32)
    f0[:3] = 0  # an unvoiced start, interpolated inside the decomposition
    kw = dict(hop_size=hop, fft_size=win, win_size=win)
    jdw = JDecomposed(wav, SR, f0, algorithm="world", **kw)
    dw = DecomposedWaveform(wav, SR, f0, algorithm="world", **kw)
    got = {
        "energy": features.get_energy(wav, length, hop_size=hop, win_size=win),
        "breathiness": features.get_breathiness(dw, length=length),
        "voicing": features.get_voicing(dw, length=length),
        "tension": features.get_tension(dw, length=length),
    }
    ref = {
        "energy": jfeatures.get_energy(wav, length, hop_size=hop, win_size=win),
        "breathiness": jfeatures.get_breathiness(jdw, length=length),
        "voicing": jfeatures.get_voicing(jdw, length=length),
        "tension": jfeatures.get_tension(jdw, length=length),
    }
    for k in ref:
        assert got[k].dtype == np.float32 and got[k].shape == (length,), k
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=CURVE_TOL, err_msg=k)
    np.testing.assert_allclose(dw.noise_gain(length), jdw.noise_gain(length), rtol=1e-6)


def test_vr_model_cache_follows_the_checkpoint(tmp_path, monkeypatch):
    """JAX keeps one class-level vocal remover and ignores ``model_path`` after
    the first load (``dsp/hnsep.py:97-102``): a second checkpoint in the same
    process silently reuses the first.  The port keys its cache by (path,
    device), so each checkpoint gets its own model, and one path loads once."""
    first = write_vr(tmp_path / "a", seed=6)
    second = write_vr(tmp_path / "b", seed=7, hop_length=64)
    wav, f0 = tone(0.1), np.full(10, 220.0, np.float32)
    kw = dict(hop_size=512, fft_size=2048, win_size=2048, algorithm="vr")

    monkeypatch.setattr(JDecomposed, "_VR_MODEL", None)
    JDecomposed(wav, SR, f0, model_path=first, **kw)
    jax_second = JDecomposed(wav, SR, f0, model_path=second, **kw)
    assert jax_second._vr.hop_length == 256  # the first checkpoint's, not the second's

    a = DecomposedWaveform(wav, SR, f0, model_path=first, device="cpu", **kw)
    b = DecomposedWaveform(wav, SR, f0, model_path=second, device="cpu", **kw)
    assert (a._vr.hop_length, b._vr.hop_length) == (256, 64)
    assert DecomposedWaveform(wav, SR, f0, model_path=second, device="cpu", **kw)._vr is b._vr
    assert not torch.equal(a._vr.model.out.weight, b._vr.model.out.weight)


def test_vocal_remover_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    path = write_vr(tmp_path / "vr", seed=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VocalRemover(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecomposedWaveform(tone(0.1), SR, np.full(10, 220.0), hop_size=512, fft_size=2048,
                           win_size=2048, algorithm="vr", model_path=path)
