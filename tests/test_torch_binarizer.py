"""The port's binarizers and ``binarize`` command against the JAX package, on
the CPU.

Two raw sets in the layout of ``tests/test_binarizer.py`` and
``tests/test_variance_binarizer.py``, built here: two speakers, sung tones
with vibrato and -40 dB noise, ``transcriptions.csv`` (and, for the variance
set, ``.ds`` files that carry some items' f0 and curves).  Each set goes
through the JAX binarizer and the port's from the same ``random.seed``:

* acoustic: ``pe: parselmouth``, ``hnsep: world``, energy, breathiness,
  voicing and tension on, random pitch shifting and random time stretching
  on (the draws from ``random`` must come in the same order);
* variance: ``pe: harvest`` with ``hnsep: world``; ``pe: rmvpe`` with
  ``hnsep: vr`` and ``.ds``-sourced f0 and curves beside extracted ones is
  in ``tests/test_torch_binarizer_nets.py``, with ``num_workers``.

Checks: the same ``spk_map.json``, ``dictionary.txt`` and ``.meta`` (item
names, order, split, lengths), the same item keys; integer arrays
(``tokens``, ``mel2ph``, ``mel2note``, ...) and booleans equal; ``mel``
within 1e-5; f0 within 1e-3 Hz, the pitch within 1e-3 semitones; the
curves within ``CURVE_TOL`` (see there).  Each package reads the other's
``.data``.
"""

import json
import pickle
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from xiaoicesing_io_tpu.config import load_config as jax_load_config
from xiaoicesing_io_tpu.data.indexed_dataset import IndexedDataset as JIndexedDataset
from xiaoicesing_io_tpu.dsp.hnsep import DecomposedWaveform as JDecomposed
from xiaoicesing_io_tpu.preprocessing.acoustic_binarizer import (
    AcousticBinarizer as JAcousticBinarizer,
)
from xiaoicesing_io_tpu.preprocessing.base_binarizer import (
    BinarizationError as JBinarizationError,
)
from xiaoicesing_io_tpu.preprocessing.variance_binarizer import (
    VarianceBinarizer as JVarianceBinarizer,
)
from xiaoicesing_io_tpu.utils.audio import save_wav
from xiaoicesing_io_tpu_torch import cli
from xiaoicesing_io_tpu_torch.config import acoustic_defaults, variance_defaults
from xiaoicesing_io_tpu_torch.data.indexed_dataset import IndexedDataset
from xiaoicesing_io_tpu_torch.preprocessing.acoustic_binarizer import AcousticBinarizer
from xiaoicesing_io_tpu_torch.preprocessing.base_binarizer import BinarizationError
from xiaoicesing_io_tpu_torch.preprocessing.variance_binarizer import VarianceBinarizer

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_pe import few_torch_threads  # noqa: E402,F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
SR = 44100
MEL_TOL = 1e-5
F0_TOL = 1e-3      # Hz
PITCH_TOL = 1e-3   # semitones
# The curves come from the same code on both sides, but the comb masks of
# ``world`` sit at k * f0, and f0 differs by up to 1e-3 Hz between the port's
# numpy tracker and the JAX package's native one.  Measured on the acoustic
# set: tension 1.1e-4 (logit), voicing 5.7e-6 dB, breathiness 1.9e-6 dB,
# energy 0.  Under ``harvest`` + ``world`` every curve is equal; under
# ``rmvpe`` + ``vr`` the two nets' f32 masks move tension's logit by 2.0e-5.
# The bar: 1e-3 (dB, or logit for tension).
CURVE_TOL = 1e-3
CURVES = ("energy", "breathiness", "voicing", "tension")
SEED = 1234


def _tone(n: int, f0_hz: float, rng) -> np.ndarray:
    t = np.arange(n) / SR
    phase = 2 * np.pi * np.cumsum(f0_hz * (1 + 0.01 * np.sin(2 * np.pi * 5 * t))) / SR
    y = 0.35 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.05 * np.sin(3 * phase)
    return (y + 0.01 * rng.standard_normal(n)).astype(np.float32)


ACOUSTIC_ITEMS = {  # speaker -> [(name, f0, seconds, silence phone)]
    "alto": [("a1", 220.0, 1.0, "SP"), ("a2", 247.0, 0.9, "AP"), ("a3", 262.0, 0.8, "SP")],
    "tenor": [("t1", 196.0, 1.0, "AP"), ("t2", 175.0, 0.7, "SP")],
}


def make_acoustic_set(root: Path) -> Path:
    rng = np.random.default_rng(0)
    for spk, items in ACOUSTIC_ITEMS.items():
        (root / spk / "wavs").mkdir(parents=True)
        rows = ["name,ph_seq,ph_dur"]
        for name, f0, dur, sil in items:
            save_wav(_tone(int(SR * dur), f0, rng), root / spk / "wavs" / f"{name}.wav", SR)
            third = dur / 3
            rows.append(f"{name},{sil} a b,{third:.3f} {third:.3f} {third:.3f}")
        (root / spk / "transcriptions.csv").write_text("\n".join(rows) + "\n")
    (root / "dictionary.txt").write_text("x\ta b\n")
    return root


VARIANCE_ITEMS = {  # speaker -> [(name, f0, glides, with a .ds)]
    "alto": [("v1", 220.0, "none up", True), ("v2", 262.0, "down none", False)],
    "tenor": [("w1", 196.0, "none none", True), ("w2", 185.0, "none down", False)],
}
VARIANCE_SECONDS = 0.8  # one length: the JAX nets compile once


def make_variance_set(root: Path) -> Path:
    rng = np.random.default_rng(1)
    dur = VARIANCE_SECONDS
    third = dur / 3
    for spk, items in VARIANCE_ITEMS.items():
        (root / spk / "wavs").mkdir(parents=True)
        (root / spk / "ds").mkdir()
        rows = ["name,ph_seq,ph_dur,ph_num,note_seq,note_dur,note_glide"]
        for i, (name, f0, glides, with_ds) in enumerate(items):
            save_wav(_tone(int(SR * dur), f0, rng), root / spk / "wavs" / f"{name}.wav", SR)
            sil = "SP" if i % 2 == 0 else "AP"
            rows.append(f"{name},{sil} a b,{third:.3f} {third:.3f} {third:.3f},1 2,"
                        f"rest A3,{third:.3f} {2 * third:.3f},{glides}")
            if with_ds:  # f0, energy and breathiness from the .ds; voicing, tension extracted
                n = int(dur / 0.01)
                t = np.arange(n) * 0.01
                ds = {"f0_seq": " ".join(f"{f0 * (1 + 0.02 * np.sin(6 * x)):.1f}" for x in t),
                      "f0_timestep": "0.01",
                      "energy": " ".join(f"{-30 + 5 * np.sin(3 * x):.4f}" for x in t),
                      "energy_timestep": "0.01",
                      "breathiness": " ".join(f"{-60 + 4 * np.cos(2 * x):.4f}" for x in t),
                      "breathiness_timestep": "0.01"}
                (root / spk / "ds" / f"{name}.ds").write_text(json.dumps([ds]))
        (root / spk / "transcriptions.csv").write_text("\n".join(rows) + "\n")
    (root / "dictionary.txt").write_text("x\ta b\n")
    return root


def _common(cfg, root: Path, out: str, speakers) -> None:
    cfg.update(raw_data_dir=[str(root / s) for s in speakers], binary_data_dir=str(root / out),
               dictionary=str(root / "dictionary.txt"), speakers=list(speakers),
               num_spk=len(speakers), test_prefixes=["a2", "w1"])


def acoustic_cfg(port: bool, root: Path, out: str):
    cfg = acoustic_defaults() if port else jax_load_config(
        ROOT / "xiaoicesing_io_tpu/configs/acoustic.yaml")
    _common(cfg, root, out, ACOUSTIC_ITEMS)
    cfg.update(use_energy_embed=True, use_breathiness_embed=True, use_voicing_embed=True,
               use_tension_embed=True, use_key_shift_embed=True, use_speed_embed=True)
    cfg["augmentation_args"] = {
        "random_pitch_shifting": {"enabled": True, "range": [-5.0, 5.0], "scale": 1.0},
        "random_time_stretching": {"enabled": True, "range": [0.5, 2.0], "scale": 0.5},
    }
    return cfg


def variance_cfg(port: bool, root: Path, out: str, pe: str, hnsep: str, ckpts: dict):
    cfg = variance_defaults() if port else jax_load_config(
        ROOT / "xiaoicesing_io_tpu/configs/variance.yaml")
    _common(cfg, root, out, VARIANCE_ITEMS)
    cfg.update(predict_energy=True, predict_breathiness=True, predict_voicing=True,
               predict_tension=True, use_glide_embed=True, pe=pe, hnsep=hnsep,
               pe_ckpt=ckpts["pe_port" if port else "pe_jax"], hnsep_ckpt=ckpts["vr"])
    cfg["binarization_args"] = dict(cfg["binarization_args"], prefer_ds=pe == "rmvpe")
    return cfg


def run_jax(cls, cfg, small_rmvpe=None):
    random.seed(SEED)
    binarizer = cls(cfg)
    if small_rmvpe is not None:
        binarizer.pitch_extractor.model, binarizer.pitch_extractor.params = small_rmvpe
    binarizer.process()


def run_port(cls, cfg, **kw):
    random.seed(SEED)
    binarizer = cls(cfg, device="cpu", **kw)
    binarizer.process()
    return binarizer


def read_set(reader, directory: Path, prefix: str) -> list:
    ds = reader(directory, prefix)
    return [ds[i] for i in range(len(ds))]


def assert_same_sets(port_dir: Path, jax_dir: Path, f0_key: str) -> dict:
    """Every output file of the two binarizations agrees; -> the largest
    curve difference by name."""
    assert (json.loads((port_dir / "spk_map.json").read_text())
            == json.loads((jax_dir / "spk_map.json").read_text()))
    assert (port_dir / "dictionary.txt").read_bytes() == (jax_dir / "dictionary.txt").read_bytes()
    worst = {}
    for prefix in ("valid", "train"):
        with open(port_dir / f"{prefix}.meta", "rb") as f:
            meta = pickle.load(f)
        with open(jax_dir / f"{prefix}.meta", "rb") as f:
            assert meta == pickle.load(f), prefix
        ours = read_set(IndexedDataset, port_dir, prefix)
        theirs = read_set(JIndexedDataset, jax_dir, prefix)
        assert len(ours) == len(theirs) == len(meta["lengths"]) > 0
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert sorted(a) == sorted(b), (prefix, i)
            for k in b:
                x, y = np.asarray(a[k]), np.asarray(b[k])
                assert x.dtype == y.dtype and x.shape == y.shape, (prefix, i, k)
                if k == "mel":
                    np.testing.assert_allclose(x, y, rtol=0, atol=MEL_TOL)
                elif k == f0_key:
                    np.testing.assert_allclose(x, y, rtol=0,
                                               atol=F0_TOL if k == "f0" else PITCH_TOL)
                elif k in CURVES or k == "base_pitch":
                    worst[k] = max(worst.get(k, 0.0), float(np.abs(x - y).max()))
                    np.testing.assert_allclose(x, y, rtol=0, atol=CURVE_TOL, err_msg=k)
                elif np.issubdtype(y.dtype, np.floating):  # key_shift, speed, note_midi
                    np.testing.assert_allclose(x, y, rtol=1e-6, err_msg=k)
                else:
                    np.testing.assert_array_equal(x, y, err_msg=k)
    return worst


def assert_cross_read(port_dir: Path, jax_dir: Path) -> None:
    """The JAX reader reads the port's set and the port's reader the JAX set,
    to the same arrays as each package's own reader."""
    for prefix in ("valid", "train"):
        for own, other in (((IndexedDataset, JIndexedDataset), port_dir),
                           ((JIndexedDataset, IndexedDataset), jax_dir)):
            mine = read_set(own[0], other, prefix)
            cross = read_set(own[1], other, prefix)
            for a, b in zip(mine, cross):
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_acoustic_binarizer_matches_jax(tmp_path, capsys):
    root = make_acoustic_set(tmp_path)
    run_jax(JAcousticBinarizer, acoustic_cfg(False, root, "jax"))
    port = run_port(AcousticBinarizer, acoustic_cfg(True, root, "port"))
    worst = assert_same_sets(root / "port", root / "jax", "f0")
    assert set(worst) == set(CURVES)
    assert_cross_read(root / "port", root / "jax")
    train = read_set(IndexedDataset, root / "port", "train")
    shifted = [it for it in train if float(it["key_shift"]) != 0.0]
    stretched = [it for it in train if float(it["speed"]) != 1.0]
    assert len(train) > 4 and shifted and stretched  # both augmentations wrote items
    for it in train:
        n = it["mel"].shape[0]
        assert it["mel2ph"].shape == it["f0"].shape == (n,)
        assert all(it[c].shape == (n,) and np.isfinite(it[c]).all() for c in CURVES)
    assert {"load", "mel", "pitch", "separation", "curves", "augmentation", "write"} <= set(
        port.stage_seconds)
    assert "| train total duration (after augmentation)" in capsys.readouterr().out


def check_variance_binarizer(root: Path, pe: str, hnsep: str, ckpts: dict, small_rmvpe=None):
    """Both variance binarizers on ``make_variance_set(root)``: the same sets,
    read across packages.  The caller resets the JAX package's class-level
    vocal remover, which would keep another test's model."""
    run_jax(JVarianceBinarizer, variance_cfg(False, root, "jax", pe, hnsep, ckpts), small_rmvpe)
    run_port(VarianceBinarizer, variance_cfg(True, root, "port", pe, hnsep, ckpts))
    worst = assert_same_sets(root / "port", root / "jax", "pitch")
    assert set(worst) == set(CURVES) | {"base_pitch"}
    assert_cross_read(root / "port", root / "jax")
    glides = {int(g) for it in read_set(IndexedDataset, root / "port", "train")
              for g in it["note_glide"]}
    assert glides == {0, 1, 2}


def test_variance_binarizer_matches_jax(tmp_path, monkeypatch):
    """``pe: harvest``, ``hnsep: world``, every curve extracted."""
    monkeypatch.setattr(JDecomposed, "_VR_MODEL", None)
    check_variance_binarizer(make_variance_set(tmp_path), "harvest", "world",
                             {"pe_port": "", "pe_jax": "", "vr": ""})


def test_coverage_error_matches_jax(tmp_path):
    """A dictionary phone that no item sings stops both binarizers with the
    same message (``tests/test_binarizer.py::test_coverage_error``'s set)."""
    root = make_acoustic_set(tmp_path)
    (root / "dictionary.txt").write_text("x\ta b\ny\tc d\n")
    errors = []
    for port, (cls, err) in ((False, (JAcousticBinarizer, JBinarizationError)),
                             (True, (AcousticBinarizer, BinarizationError))):
        cfg = acoustic_cfg(port, root, f"cov{port}")
        cfg["augmentation_args"] = {}
        with pytest.raises(err) as exc:
            (cls(cfg, device="cpu") if port else cls(cfg)).process()
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and "(-) ['c', 'd']" in errors[1]


def _cli_config(tmp_path: Path, binarizer_cls: str) -> Path:
    root = make_acoustic_set(tmp_path / "raw")
    cfg = {"base_config": ["acoustic.json"], "binarizer_cls": binarizer_cls,
           "raw_data_dir": [str(root / s) for s in ACOUSTIC_ITEMS],
           "speakers": list(ACOUSTIC_ITEMS), "num_spk": 2, "test_prefixes": ["a2"],
           "binary_data_dir": str(tmp_path / "binary"),
           "dictionary": str(root / "dictionary.txt")}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_binarize_command_with_jax_blocked(tmp_path):
    """``cli binarize --device cpu`` on a config whose ``binarizer_cls`` names
    the JAX package's class, in a process where jax, flax and the JAX package
    cannot be imported: the port's binarizer writes the set."""
    cfg = _cli_config(tmp_path, "xiaoicesing_io_tpu.preprocessing.acoustic_binarizer."
                                "AcousticBinarizer")
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
for name in ("jax", "flax", "xiaoicesing_io_tpu"):
    sys.modules[name] = None
from xiaoicesing_io_tpu_torch import cli
cli.main(["binarize", "--config", {str(cfg)!r}, "--device", "cpu",
          "--hparams", "binarization_args.shuffle=false"])
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert ("| Binarizer: xiaoicesing_io_tpu_torch.preprocessing.acoustic_binarizer."
            "AcousticBinarizer") in out.stdout
    for name in ("train.data", "train.meta", "valid.data", "valid.meta", "spk_map.json",
                 "dictionary.txt"):
        assert (tmp_path / "binary" / name).exists(), name
    assert len(read_set(IndexedDataset, tmp_path / "binary", "train")) == 4


@pytest.mark.parametrize("name", [
    "xiaoicesing_io_tpu.preprocessing.variance_binarizer.VarianceBinarizer",
    "preprocessing.variance_binarizer.VarianceBinarizer",
    "xiaoicesing_io_tpu_torch.preprocessing.acoustic_binarizer.AcousticBinarizer",
    "AcousticBinarizer"])
def test_binarizer_class_by_name(name):
    cls = cli.binarizer_class(name)
    assert cls.__name__ == name.rsplit(".", 1)[-1]
    assert cls.__module__.startswith("xiaoicesing_io_tpu_torch.preprocessing.")


def test_unknown_binarizer_class_raises(tmp_path):
    cfg = _cli_config(tmp_path, "my_pkg.binarizers.MidiBinarizer")
    with pytest.raises(ValueError, match="Unknown binarizer_cls 'my_pkg.binarizers.MidiBinarizer'"):
        cli.main(["binarize", "--config", str(cfg), "--device", "cpu"])
    assert not (tmp_path / "binary").exists()
    assert "my_pkg" not in sys.modules


def test_binarizers_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    cfg = _cli_config(tmp_path, "preprocessing.acoustic_binarizer.AcousticBinarizer")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["binarize", "--config", str(cfg)])
    root = make_variance_set(tmp_path / "v")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VarianceBinarizer(variance_cfg(True, root, "out", "harvest", "world",
                                       {"pe_port": "", "pe_jax": "", "vr": ""}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AcousticBinarizer(acoustic_cfg(True, root, "out"))
