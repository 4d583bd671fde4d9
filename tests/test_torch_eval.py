"""The port's evaluation over binarized sets against the JAX package, on the CPU.

The binarized-set reader and writer (``data/indexed_dataset.py`` on the
numpy HDF5 codec ``data/hdf5.py``) against the JAX package's builder and
reader and against ``h5py`` itself, both ways; the collators; the
validation metrics; ``sample_variance_inference``; ``evaluate_acoustic``
and ``evaluate_variance``; the ``eval`` command; the DDSP vocoder wrapper.

The experiments are tiny (fs2 32 x 1, LYNXNet 64 x 2, WaveNet 64 x 4, a
narrow NSF-HiFiGAN) with random weights saved as reference-format
checkpoints, which the JAX package loads through its torch converter and
the port as they are.  The binarized sets are written by the JAX package's
``IndexedDatasetBuilder`` with a ``.meta`` pickle.  The start noise is the
array the JAX evaluation draws (``PRNGKey(seed + i)`` per acoustic item; a
``split`` chain from ``PRNGKey(0)`` per variance item), fed to the port
through ``noise=``.  The vocoder runs on both sides with its deterministic
source: the JAX side through its f32 stock generator (its wrapper's own
generator is bf16, which no f32 bar could hold), the port with no
generator.  Tolerances: mel metrics within 2e-4 (the module bar; f32 on
both sides); PESQ* within 1e-3 (as ``test_torch_val_vocoder.py`` holds the
scores the f32 vocoder moves); the waveform MCD within 1e-4 of its value
(the two vocoders' waveforms agree to ~2e-6, and the log-mel it re-extracts
from them magnifies that in near-silent bins to ~1e-3 dB of ~45 dB);
durations, counts and accuracies equal.
"""

import contextlib
import json
import pickle
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

ROOT = Path(__file__).resolve().parent.parent
DICT = ROOT / "dictionaries" / "opencpop-extension.txt"
CURVES = ("energy", "breathiness", "voicing", "tension")
TOL = 2e-4
PESQ_TOL = 1e-3
WAV_MCD_REL = 1e-4

# upsampling 8*8*2*2*2 = 512 = hop_size, at narrow widths
VOCODER = dict(num_mels=128, sampling_rate=44100, hop_size=512, n_fft=2048, win_size=2048,
               fmin=40, fmax=16000, upsample_rates=[8, 8, 2, 2, 2],
               upsample_kernel_sizes=[16, 16, 4, 4, 4], upsample_initial_channel=32,
               resblock="1", resblock_kernel_sizes=[3, 7, 11],
               resblock_dilation_sizes=[[1, 3, 5]] * 3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several worker processes share the cores: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vocab():
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    return TokenTextEncoder(PhonemeDictionary.load(DICT).phoneme_list).vocab_size


# ---------------------------------------------------------------------------
# items of binarized sets, as the binarizers write them
# ---------------------------------------------------------------------------

def _acoustic_items(n, seed=0, n_spk=1):
    """Acoustic items: int64 tokens and mel2ph, f32 mel and f0, the four
    curves, scalar key_shift / speed (Python floats) and spk_id (int)."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        T_ph = int(rng.integers(5, 14))
        mel2ph = np.repeat(np.arange(1, T_ph + 1), rng.integers(3, 13, T_ph)).astype(np.int64)
        T = len(mel2ph)
        t = np.arange(T)
        item = {"tokens": rng.integers(1, 60, T_ph).astype(np.int64), "mel2ph": mel2ph,
                "mel": (rng.standard_normal((T, 128)) - 5.0).astype(np.float32),
                "f0": (220.0 * 2 ** (0.2 * np.sin(t / 9.0))).astype(np.float32),
                "key_shift": float(rng.uniform(-3, 3)), "speed": float(rng.uniform(0.8, 1.2)),
                "spk_id": i % n_spk}
        for v in CURVES:
            item[v] = rng.uniform(-60, -10, T).astype(np.float32)
        items.append(item)
    return items


def _variance_items(n, seed=0, n_spk=1):
    """Variance items: phonemes grouped into words, notes covering the
    frames, bool ``note_rest`` and ``uv``, f32 curves."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        T_ph = int(rng.integers(6, 16))
        ph_dur = rng.integers(2, 12, T_ph).astype(np.int64)
        ph2word = np.cumsum(np.r_[1, rng.uniform(size=T_ph - 1) < 0.5]).astype(np.int64)
        mel2ph = np.repeat(np.arange(1, T_ph + 1), ph_dur).astype(np.int64)
        T = len(mel2ph)
        T_n = int(rng.integers(3, 7))
        cuts = np.sort(rng.choice(np.arange(1, T), T_n - 1, replace=False))
        note_dur = np.diff(np.r_[0, cuts, T]).astype(np.int64)
        note_midi = rng.uniform(55, 75, T_n).astype(np.float32)
        mel2note = np.repeat(np.arange(1, T_n + 1), note_dur).astype(np.int64)
        base = note_midi[mel2note - 1]
        item = {"tokens": rng.integers(1, 60, T_ph).astype(np.int64), "ph_dur": ph_dur,
                "midi": rng.integers(50, 80, T_ph).astype(np.int64), "ph2word": ph2word,
                "mel2ph": mel2ph, "note_midi": note_midi,
                "note_rest": rng.uniform(size=T_n) < 0.2, "note_dur": note_dur,
                "note_glide": rng.integers(0, 3, T_n).astype(np.int64), "mel2note": mel2note,
                "base_pitch": base.astype(np.float32),
                "pitch": (base + rng.uniform(-0.8, 0.8, T)).astype(np.float32),
                "uv": rng.uniform(size=T) < 0.15, "spk_id": i % n_spk}
        for v in CURVES:
            item[v] = rng.uniform(-60, -10, T).astype(np.float32)
        items.append(item)
    return items


def _write_set(builder, directory, prefix, items, names=None):
    """``items`` through ``builder`` (an ``IndexedDatasetBuilder`` class),
    and the ``.meta`` pickle the dataset classes read."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    b = builder(directory, prefix)
    for it in items:
        b.add_item(it)
    b.finalize()
    meta = {"lengths": [len(it["mel2ph"]) for it in items],
            "names": names or [f"item{i:02d}" for i in range(len(items))]}
    with open(directory / f"{prefix}.meta", "wb") as f:
        pickle.dump(meta, f)


def _assert_items_equal(got, ref):
    assert list(got) == sorted(ref)  # attributes come back in name order
    for k, v in ref.items():
        if isinstance(v, (int, float, bool)):
            assert type(got[k]) is type(v) and got[k] == v, k
        else:
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# the binarized-set reader and writer
# ---------------------------------------------------------------------------

def _mixed_items():
    items = _acoustic_items(3, seed=1) + _variance_items(3, seed=2)
    items[0].update(flag=True, empty=np.zeros((0, 4), np.float32), f16=np.ones(3, np.float16),
                    u8=np.arange(4, dtype=np.uint8), i16=-np.arange(5, dtype=np.int16),
                    u64=np.arange(2, dtype=np.uint64), zero_d=np.asarray(np.float32(2.5)))
    items[1]["skipped"] = None
    return items


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_indexed_dataset_round_trip(writer, tmp_path):
    """A set written by one package reads on the other, item for item:
    every attribute equal in value and dtype (bool ``uv`` / ``note_rest``,
    f16 to u64, an empty array), 0-d values as Python scalars, ``None``
    attributes skipped."""
    from xiaoicesing_io_tpu.data import indexed_dataset as J
    from xiaoicesing_io_tpu_torch.data import indexed_dataset as P

    items = _mixed_items()
    build, read = (J, P) if writer == "jax" else (P, J)
    _write_set(build.IndexedDatasetBuilder, tmp_path, "valid", items)
    ds = read.IndexedDataset(tmp_path, "valid", num_cache=2)
    assert len(ds) == len(items)
    for i, ref in enumerate(items):
        ref = {k: v for k, v in ref.items() if v is not None}
        if "zero_d" in ref:
            ref["zero_d"] = 2.5
        _assert_items_equal(ds[i], ref)
    assert ds[1] is ds[1]  # the cache hands back the same item
    with pytest.raises(IndexError):
        ds[len(items)]
    ds.close()


def test_builder_keeps_allowed_attributes_and_numbers(tmp_path):
    """``allowed_attr`` filters; explicit item numbers go with
    ``auto_increment=False`` only; a number is taken once."""
    from xiaoicesing_io_tpu.data.indexed_dataset import IndexedDataset as JDS
    from xiaoicesing_io_tpu_torch.data.indexed_dataset import (
        IndexedDataset, IndexedDatasetBuilder,
    )

    b = IndexedDatasetBuilder(tmp_path, "x", allowed_attr=["tokens", "spk_id"])
    assert b.add_item({"tokens": np.arange(3), "mel": np.zeros(2), "spk_id": 1}) == 0
    with pytest.raises(ValueError, match="mutually exclusive"):
        b.add_item({"tokens": np.arange(2)}, item_no=5)
    b.finalize()
    b = IndexedDatasetBuilder(tmp_path, "y", auto_increment=False)
    b.add_item({"a": np.arange(2)}, item_no=1)
    b.add_item({"a": np.arange(3)}, item_no=0)
    with pytest.raises(ValueError, match="already"):
        b.add_item({"a": np.arange(3)}, item_no=0)
    b.finalize()
    for cls in (IndexedDataset, JDS):
        assert sorted(cls(tmp_path, "x")[0]) == ["spk_id", "tokens"]
        y = cls(tmp_path, "y")
        assert [y[i]["a"].tolist() for i in range(2)] == [[0, 1, 2], [0, 1]]
    with pytest.raises(FileNotFoundError):
        IndexedDataset(tmp_path, "missing")


def _h5py_write(path, groups):
    with h5py.File(path, "w") as f:
        for name, datasets in groups.items():
            g = f.create_group(name)
            for k, v in datasets.items():
                g.create_dataset(k, data=v)


def _h5py_read(path):
    with h5py.File(path, "r") as f:
        return {name: {k: g[k][()] for k in g} for name, g in f.items()}


def _codec_read(path):
    from xiaoicesing_io_tpu_torch.data.hdf5 import H5Reader

    r = H5Reader(path)
    try:
        return {name: {k: r.read(a) for k, a in r.links(g).items()}
                for name, g in r.links(r.root).items()}
    finally:
        r.close()


def _codec_write(path, groups):
    from xiaoicesing_io_tpu_torch.data.hdf5 import H5Writer

    w = H5Writer(path)
    for name, datasets in groups.items():
        w.add_group(name, datasets)
    w.close()


def _assert_groups_equal(got, ref):
    assert list(got) == sorted(ref)
    for name, datasets in ref.items():
        assert list(got[name]) == sorted(datasets), name
        for k, v in datasets.items():
            g = np.asarray(got[name][k])
            assert g.dtype == v.dtype and g.shape == v.shape, (name, k, g.dtype, g.shape)
            np.testing.assert_array_equal(g, v, err_msg=f"{name}/{k}")


DTYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
          "float16", "float32", "float64", "bool"]


@st.composite
def _groups(draw, max_groups=40):
    n = draw(st.integers(0, max_groups))
    out = {}
    for i in range(n):
        datasets = {}
        for j in range(draw(st.integers(0, 4))):
            dtype = np.dtype(draw(st.sampled_from(DTYPES)))
            shape = tuple(draw(st.lists(st.integers(0, 5), max_size=3)))
            seed = draw(st.integers(0, 2 ** 16))
            raw = np.random.default_rng(seed).integers(0, 256, int(np.prod(shape, dtype=int))
                                                       * dtype.itemsize, dtype=np.uint8)
            v = raw.view(np.uint8).astype(bool) if dtype == np.bool_ else raw.view(dtype)
            if dtype.kind == "f":
                v = np.nan_to_num(v)
            datasets[f"d{j}"] = v.reshape(shape)
        out[str(draw(st.integers(0, 10 ** 6)) if i % 5 == 4 else i)] = datasets
    return out


@settings(max_examples=25, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(groups=_groups())
def test_hdf5_codec_against_h5py(groups, tmp_path_factory):
    """Dtypes, shapes (0-d, empty, up to rank 3) and group counts drawn by
    hypothesis: the codec's file read by h5py, h5py's file read by the
    codec, every value and dtype equal."""
    d = tmp_path_factory.mktemp("codec")
    _codec_write(d / "port.h5", groups)
    _assert_groups_equal(_h5py_read(d / "port.h5"), groups)
    _h5py_write(d / "h5py.h5", groups)
    _assert_groups_equal(_codec_read(d / "h5py.h5"), groups)


@pytest.mark.parametrize("count", [8, 9, 17, 257, 600])
def test_hdf5_codec_node_splits(count, tmp_path):
    """Item counts past one symbol table node (8 links; h5py splits into
    nodes of 4 and more), past one B-tree leaf (32 nodes) and into a second
    B-tree level, both ways."""
    groups = {str(i): {"x": np.full(i % 3 + 1, i, np.int64), "uv": np.array(i % 2 == 0)}
              for i in range(count)}
    _codec_write(tmp_path / "port.h5", groups)
    _assert_groups_equal(_h5py_read(tmp_path / "port.h5"), groups)
    _h5py_write(tmp_path / "h5py.h5", groups)
    _assert_groups_equal(_codec_read(tmp_path / "h5py.h5"), groups)


def test_hdf5_codec_follows_continuation(tmp_path):
    """An object header that h5py continues in a second chunk (a dataset with
    many attributes): the codec follows the continuation message."""
    with h5py.File(tmp_path / "a.h5", "w") as f:
        d = f.create_dataset("0/x", data=np.arange(7, dtype=np.float32))
        for i in range(40):
            d.attrs[f"attribute_{i}"] = np.arange(8) + i
    _assert_groups_equal(_codec_read(tmp_path / "a.h5"), {"0": {"x": np.arange(7, dtype=np.float32)}})


@pytest.mark.parametrize("case", ["chunked", "string", "latest", "big_endian", "not_hdf5"])
def test_hdf5_codec_rejects_outside_subset(case, tmp_path):
    from xiaoicesing_io_tpu_torch.data.hdf5 import UnsupportedHDF5

    path = tmp_path / "a.h5"
    if case == "not_hdf5":
        path.write_bytes(b"not an hdf5 file at all")
    else:
        kw = {"libver": "latest"} if case == "latest" else {}
        with h5py.File(path, "w", **kw) as f:
            data = {"chunked": np.arange(100.0), "string": "text", "latest": np.arange(3),
                    "big_endian": np.arange(3, dtype=">i4")}[case]
            f.create_dataset("0/x", data=data, **({"chunks": (10,)} if case == "chunked" else {}))
    with pytest.raises(UnsupportedHDF5):
        _codec_read(path)
    with pytest.raises(UnsupportedHDF5):
        _codec_write(tmp_path / "b.h5", {"0": {"x": np.arange(3, dtype=">i4")}})


# ---------------------------------------------------------------------------
# collators
# ---------------------------------------------------------------------------

def _acoustic_cfgs(**over):
    from xiaoicesing_io_tpu.config import load_config
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults

    out = []
    for cfg in (load_config(ROOT / "xiaoicesing_io_tpu/configs/acoustic.yaml"),
                acoustic_defaults()):
        cfg.update(over)
        out.append(cfg)
    return out


def _assert_batches_equal(got, ref):
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


COLLATE = {
    "plain": ({}, {}),
    "no_bucket": ({}, {"pad_to_bucket": False}),
    "padded": ({}, {"pad_frames_to": 700, "pad_tokens_to": 40, "pad_batch_to": 5}),
    "no_bucket_padded": ({}, {"pad_to_bucket": False, "pad_frames_to": 61,
                              "pad_tokens_to": 13, "pad_batch_to": 4}),
    "all_inputs": ({"use_spk_id": True, "use_key_shift_embed": True, "use_speed_embed": True,
                    **{f"use_{v}_embed": True for v in CURVES}}, {"pad_batch_to": 4}),
}


@pytest.mark.parametrize("case", list(COLLATE))
def test_acoustic_collate_matches_jax(case, tmp_path):
    from xiaoicesing_io_tpu.data.dataset import AcousticDataset as J
    from xiaoicesing_io_tpu.data.indexed_dataset import IndexedDatasetBuilder
    from xiaoicesing_io_tpu_torch.data.dataset import AcousticDataset as P

    over, kw = COLLATE[case]
    _write_set(IndexedDatasetBuilder, tmp_path, "train", _acoustic_items(3, n_spk=2))
    jcfg, pcfg = _acoustic_cfgs(**over)
    for preload in (False, True):
        jd, pd = J(tmp_path, "train", jcfg), P(tmp_path, "train", pcfg, preload=preload)
        assert len(pd) == len(jd) == 3 and pd.num_frames(1) == jd.num_frames(1)
        for idx in ([0], [2, 0, 1]):
            _assert_batches_equal(pd.collate(idx, **kw), jd.collate(idx, **kw))


VAR_COLLATE = {
    "plain": ({}, {}),
    "no_bucket": ({}, {"pad_to_bucket": False}),
    "padded": ({}, {"pad_frames_to": 400, "pad_tokens_to": 40, "pad_notes_to": 33,
                    "pad_batch_to": 5}),
    "glide_curves_spk": ({"use_glide_embed": True, "use_spk_id": True,
                          **{f"predict_{v}": True for v in CURVES}}, {"pad_batch_to": 4}),
    "no_dur_no_pitch": ({"predict_dur": False, "predict_pitch": False}, {}),
}


@pytest.mark.parametrize("case", list(VAR_COLLATE))
def test_variance_collate_matches_jax(case, tmp_path):
    from xiaoicesing_io_tpu.config import load_config
    from xiaoicesing_io_tpu.data.dataset import VarianceDataset as J
    from xiaoicesing_io_tpu.data.indexed_dataset import IndexedDatasetBuilder
    from xiaoicesing_io_tpu_torch.config import variance_defaults
    from xiaoicesing_io_tpu_torch.data.dataset import VarianceDataset as P

    over, kw = VAR_COLLATE[case]
    _write_set(IndexedDatasetBuilder, tmp_path, "valid", _variance_items(3, n_spk=2))
    jcfg = load_config(ROOT / "xiaoicesing_io_tpu/configs/variance.yaml")
    pcfg = variance_defaults()
    jcfg.update(over)
    pcfg.update(over)
    jd, pd = J(tmp_path, "valid", jcfg), P(tmp_path, "valid", pcfg)
    assert pd.attr_len("lengths", 2) == jd.attr_len("lengths", 2)
    for idx in ([1], [2, 0, 1]):
        got, ref = pd.collate(idx, **kw), jd.collate(idx, **kw)
        _assert_batches_equal(got, ref)
    if "note_midi" in ref:  # the pad values of the notes
        assert ref["note_rest"].dtype == bool and ref["uv"].dtype == bool


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["RawCurveAccuracy", "RhythmCorrectness",
                                    "PhonemeDurationAccuracy"])
def test_metrics_match_jax(metric, masked):
    from xiaoicesing_io_tpu.training import metrics as J
    from xiaoicesing_io_tpu_torch.training import metrics as P

    rng = np.random.default_rng(3)
    tol = {"RawCurveAccuracy": 0.5, "RhythmCorrectness": 0.1,
           "PhonemeDurationAccuracy": 0.2}[metric]
    jm, pm = getattr(J, metric)(tol), getattr(P, metric)(tol)
    for _ in range(3):
        if metric == "RawCurveAccuracy":
            target = rng.uniform(50, 70, (2, 40))
            args = (target + rng.normal(0, 0.5, target.shape), target)
            mask = rng.uniform(size=target.shape) < 0.8
        else:
            target = rng.integers(1, 15, (2, 12)).astype(np.float64)
            ph2word = np.sort(rng.integers(1, 6, (2, 12)), axis=1)
            ph2word[:, -2:] = 0
            args = (target * rng.uniform(0.7, 1.3, target.shape), target, ph2word)
            mask = ph2word > 0
        kw = {"mask": mask} if masked else {}
        jm.update(*args, **kw)
        pm.update(*args, **kw)
    assert (float(pm.numer), float(pm.denom)) == (float(jm.numer), float(jm.denom))
    assert pm.compute() == jm.compute() and 0.0 < pm.compute() < 1.0
    pm.reset()
    assert pm.compute() == 0.0


# ---------------------------------------------------------------------------
# experiments: random tiny models as reference checkpoints, sets, a vocoder
# ---------------------------------------------------------------------------

TINY = dict(hidden_size=32, enc_layers=1, num_heads=2)
LYNX = dict(backbone_type="lynxnet", sampling_steps=4,
            backbone_args={"num_channels": 64, "num_layers": 2, "kernel_size": 31,
                           "dropout_rate": 0.0, "strong_cond": True})
WAVENET = dict(backbone_type="wavenet", diffusion_type="ddpm", K_step=400, K_step_infer=400,
               diff_accelerator="ddim", diff_speedup=100,
               backbone_args={"num_channels": 64, "num_layers": 4, "dilation_cycle_length": 2})
SPEAKERS = {"alto": 0, "tenor": 1}
ACOUSTIC = {
    # LYNXNet + reflow with the encoder's optional inputs, WaveNet + DDPM alone and with speakers
    "lynx_reflow": dict(LYNX, use_key_shift_embed=True, use_speed_embed=True,
                        use_energy_embed=True, use_breathiness_embed=True),
    "wavenet_ddpm": dict(WAVENET),
    "wavenet_ddpm_2spk": dict(WAVENET, use_spk_id=True, num_spk=len(SPEAKERS)),
}


class JaxF32Vocoder:
    """The JAX package's stock NSF-HiFiGAN generator in f32 on a reference
    ``model.ckpt``, behind the wrapper's ``spec2wav`` (natural-log mels,
    the deterministic source)."""

    def __init__(self, cfg, model_path=None):
        from xiaoicesing_io_tpu.models.vocoders.nsf_hifigan import Generator, NsfHifiganConfig
        from xiaoicesing_io_tpu.utils.torch_ckpt import convert_nsf_hifigan

        model_path = Path(model_path or cfg["vocoder_ckpt"])
        if not model_path.exists():
            raise FileNotFoundError(model_path)
        vcfg = NsfHifiganConfig.from_json(json.loads(
            model_path.with_name("config.json").read_text()))
        sd = torch.load(model_path, map_location="cpu", weights_only=True)["generator"]
        self.params = convert_nsf_hifigan(sd, vcfg)
        self.apply = jax.jit(Generator(vcfg).apply)

    def spec2wav(self, mel, f0, key=None):
        wav = self.apply(self.params, jnp.asarray(mel, jnp.float32)[None],
                         jnp.asarray(f0, jnp.float32)[None])
        return np.asarray(wav)[0]


def _save_cfg(cfg, path):
    import yaml

    path.write_text(yaml.safe_dump(json.loads(json.dumps(dict(cfg)))))


def _make_acoustic_exp(name, root):
    """``root/checkpoints/exp`` (checkpoint, config.yaml, speaker map),
    ``root/binary`` (the valid set, by the JAX builder) and
    ``root/vocoder``; -> (JAX config, port config)."""
    from xiaoicesing_io_tpu.data.indexed_dataset import IndexedDatasetBuilder
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import (
        Generator, NsfHifiganConfig,
    )
    from xiaoicesing_io_tpu_torch.training.acoustic import build_acoustic

    work, binary, voc = root / "checkpoints" / "exp", root / "binary", root / "vocoder"
    for d in (work, voc):
        d.mkdir(parents=True)
    over = dict(TINY, **ACOUSTIC[name], work_dir=str(work), dictionary=str(DICT),
                binary_data_dir=str(binary), vocoder_ckpt=str(voc / "model.ckpt"))
    cfgs = _acoustic_cfgs(**over)
    for cfg in cfgs:
        cfg["shallow_diffusion_args"]["aux_decoder_args"].update(
            num_channels=32, num_layers=1, dropout_rate=0.0)
    torch.manual_seed(0)
    model, _, _ = build_acoustic(cfgs[1], _vocab())
    with torch.no_grad():
        # the zero-initialised output projection and 1e-6 ConvNeXt layer scales
        # would hide the denoiser and the aux blocks: randomise them
        model.backbone.output_projection.weight.normal_(0.0, 0.05)
        for block in model.aux_decoder.decoder.conv:
            block.gamma.normal_(0.0, 0.1)
    torch.save({"category": "acoustic",
                "state_dict": {f"model.{k}": v for k, v in model.state_dict().items()}},
               work / "model_ckpt_steps_100.ckpt")
    n_spk = over.get("num_spk", 1)
    items = _acoustic_items(3, seed=5, n_spk=n_spk)
    _write_set(IndexedDatasetBuilder, binary, "valid", items)
    if over.get("use_spk_id"):
        for d in (work, binary):
            (d / "spk_map.json").write_text(json.dumps(SPEAKERS))
    torch.manual_seed(1)
    torch.save({"generator": Generator(NsfHifiganConfig.from_json(VOCODER)).state_dict()},
               voc / "model.ckpt")
    (voc / "config.json").write_text(json.dumps(VOCODER))
    _save_cfg(cfgs[0], work / "config.yaml")
    return cfgs


@pytest.fixture(scope="module")
def acoustic_exps(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _make_acoustic_exp(name, tmp_path_factory.mktemp(name))
        return cache[name]
    return get


def _jax_acoustic_noise(pcfg, seed=0, pad_frames_to=0):
    """The start noise of each item as the JAX evaluation draws it: from
    ``PRNGKey(seed + i)`` over the runner's bucket of the collated length
    (DDPM: from the second key of its split)."""
    from xiaoicesing_io_tpu_torch.data.dataset import AcousticDataset

    ds = AcousticDataset(pcfg["binary_data_dir"], "valid", pcfg)
    out = []
    for i in range(len(ds)):
        T = ds.collate([i], pad_frames_to=pad_frames_to)["mel2ph"].shape[1]
        out.append(_jax_mel_noise(pcfg, seed + i, T))
    return out


def _jax_mel_noise(cfg, seed, T):
    from xiaoicesing_io_tpu_torch.inference.acoustic import _bucket

    key = jax.random.PRNGKey(seed & 0xFFFFFFFF)
    if cfg["diffusion_type"] == "ddpm":
        key = jax.random.split(key)[1]
    return np.asarray(jax.random.normal(key, (1, 1, _bucket(T), 128), jnp.float32))


@pytest.fixture(scope="module")
def jax_reports():
    """The JAX evaluation's reports, computed once per experiment and
    arguments (its vocoder through :class:`JaxF32Vocoder`)."""
    import xiaoicesing_io_tpu.models.vocoders.wrapper as jw
    from xiaoicesing_io_tpu.eval.copy_synthesis import evaluate_acoustic

    cache = {}

    def get(jcfg, **kw):
        key = (jcfg["work_dir"], jcfg["vocoder_ckpt"], tuple(sorted(kw.items())))
        if key not in cache:
            mp = pytest.MonkeyPatch()
            mp.setattr(jw, "NsfHifiGAN", JaxF32Vocoder)
            try:
                cache[key] = evaluate_acoustic(jcfg, "valid", **kw)
            finally:
                mp.undo()
        return cache[key]
    return get


@pytest.fixture
def deterministic_vocoders(monkeypatch):
    """The JAX runner's vocoder as its f32 stock generator, and the port's
    vocoder calls without a generator: both sources deterministic."""
    import xiaoicesing_io_tpu.models.vocoders.wrapper as jw
    import xiaoicesing_io_tpu_torch.inference.acoustic as pa

    monkeypatch.setattr(jw, "NsfHifiGAN", JaxF32Vocoder)
    monkeypatch.setattr(pa, "generator_from_seed", lambda *a, **k: None)


def _assert_close_report(got, ref, path="report"):
    """Two reports, key for key: floats within ``TOL``, PESQ* within
    ``PESQ_TOL``, the waveform MCD within ``WAV_MCD_REL`` of its value,
    everything else equal."""
    if isinstance(ref, dict):
        assert list(got) == list(ref), path
        for k in ref:
            _assert_close_report(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_close_report(g, r, f"{path}[{i}]")
    elif isinstance(ref, float) and not isinstance(got, int):
        tol = (PESQ_TOL if "pesq" in path else WAV_MCD_REL * abs(ref) if "wav_mcd" in path
               else TOL)
        assert np.isfinite(got) and abs(got - ref) <= tol, (path, got, ref)
    else:
        assert type(got) is type(ref) and got == ref, (path, got, ref)


@pytest.mark.parametrize("name", list(ACOUSTIC))
def test_evaluate_acoustic_matches_jax(name, acoustic_exps, jax_reports,
                                      deterministic_vocoders):
    """With ``with_pesq``: every per-item and mean metric, the aux decoder's
    and the waveform scores, the win counts and the per-speaker block."""
    from xiaoicesing_io_tpu_torch.eval.copy_synthesis import evaluate_acoustic as P

    jcfg, pcfg = acoustic_exps(name)
    ref = jax_reports(jcfg, with_pesq=True)
    got = P(pcfg, "valid", with_pesq=True, device="cpu", noise=_jax_acoustic_noise(pcfg))
    _assert_close_report(got, ref)
    assert got["step"] == 100 and len(got["items"]) == 3
    assert all(it["mel_mae"] > 0.1 and it["pesq"] is not None for it in got["items"])
    if name.endswith("2spk"):
        assert list(got["per_speaker"]) == ["alto", "tenor"]
        assert [v["n_items"] for v in got["per_speaker"].values()] == [2, 1]
    else:
        assert "per_speaker" not in got


def test_evaluate_acoustic_vocodes_own_frames(acoustic_exps, jax_reports,
                                              deterministic_vocoders):
    """``pad_frames_to`` that keeps the runner's bucket: the port's scores
    equal its own without it (it vocodes each item's own frames, rounded to
    the collator's bucket), while the JAX evaluation's waveform scores
    change (it vocodes the forced padding too)."""
    from xiaoicesing_io_tpu_torch.eval.copy_synthesis import evaluate_acoustic as P

    jcfg, pcfg = acoustic_exps("lynx_reflow")
    lengths = pickle.loads((Path(pcfg["binary_data_dir"]) / "valid.meta").read_bytes())["lengths"]
    # the padding changes the collated length of the short items, not the runner's bucket
    assert min(lengths) <= 128 and max(lengths) <= 256
    plain = P(pcfg, "valid", with_pesq=True, device="cpu", noise=_jax_acoustic_noise(pcfg))
    padded = P(pcfg, "valid", with_pesq=True, device="cpu", pad_frames_to=256,
               noise=_jax_acoustic_noise(pcfg, pad_frames_to=256))
    # equal but for the host's rounding (the scores' numpy reductions vary in the last bits)
    _assert_close_report(padded, plain)
    jplain = jax_reports(jcfg, with_pesq=True)
    jpadded = jax_reports(jcfg, with_pesq=True, pad_frames_to=256)
    short = lengths.index(min(lengths))
    assert jpadded["items"][short]["mel_mae"] == pytest.approx(jplain["items"][short]["mel_mae"],
                                                               abs=1e-6)
    assert abs(jpadded["items"][short]["pesq"] - jplain["items"][short]["pesq"]) > 10 * PESQ_TOL
    _assert_close_report(plain, jplain)


def test_evaluate_acoustic_vocoder_errors(acoustic_exps, jax_reports, deterministic_vocoders,
                                          tmp_path, capsys):
    """A missing vocoder checkpoint falls back to Griffin-Lim inversion, as
    in the JAX evaluation; any other error building the vocoder (here a
    corrupt checkpoint, then a missing ``config.json`` beside it) propagates,
    where the JAX evaluation falls back."""
    from xiaoicesing_io_tpu_torch.eval.copy_synthesis import evaluate_acoustic as P

    jcfg, pcfg = (dict(c, vocoder_ckpt=str(tmp_path / "missing" / "model.ckpt"))
                  for c in acoustic_exps("wavenet_ddpm"))
    ref = jax_reports(jcfg, with_pesq=True, limit=1)
    capsys.readouterr()
    got = P(pcfg, "valid", with_pesq=True, limit=1, device="cpu",
            noise=_jax_acoustic_noise(pcfg)[:1])
    assert "Griffin-Lim" in capsys.readouterr().out
    _assert_close_report(got, ref)

    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "model.ckpt").write_bytes(b"not a checkpoint")
    (tmp_path / "bad" / "config.json").write_text(json.dumps(VOCODER))
    pcfg["vocoder_ckpt"] = str(tmp_path / "bad" / "model.ckpt")
    with pytest.raises(Exception) as info:
        P(pcfg, "valid", with_pesq=True, limit=1, device="cpu")
    assert not isinstance(info.value, FileNotFoundError)
    assert "Griffin-Lim" not in capsys.readouterr().out
    (tmp_path / "bad" / "config.json").unlink()  # a file the vocoder reads beside its checkpoint
    with pytest.raises(FileNotFoundError, match="config.json"):
        P(pcfg, "valid", with_pesq=True, limit=1, device="cpu")
    assert "Griffin-Lim" not in capsys.readouterr().out


def test_checkpoint_step(tmp_path):
    from xiaoicesing_io_tpu_torch.eval.copy_synthesis import _checkpoint_step

    assert _checkpoint_step(tmp_path) == -1
    for step in (900, 12000, 2000):
        (tmp_path / f"model_ckpt_steps_{step}.ckpt").write_bytes(b"")
    assert _checkpoint_step(tmp_path) == 12000  # the one the runners load


# ---------------------------------------------------------------------------
# the variance model
# ---------------------------------------------------------------------------

VARIANCE = {
    "reflow": dict(predict_energy=True, predict_breathiness=True),
    "ddpm_melody_spk": dict(diffusion_type="ddpm", diff_speedup=250, use_melody_encoder=True,
                            use_glide_embed=True, glide_types=["up", "down"], use_spk_id=True,
                            num_spk=len(SPEAKERS), predict_energy=True),
}


def _random_state(model, seed=0):
    """Every tensor of ``model``'s state dict drawn with numpy: matrices at
    1 / sqrt(fan-in), norm scales around 1, biases around 0; the duration
    head's bias at 1.5, so that its durations are not clamped to 0."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if v.ndim >= 2:
            a = rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[1:]))
        elif k.endswith("weight"):
            a = 1.0 + 0.1 * rng.standard_normal(v.shape)
        else:
            a = 0.1 * rng.standard_normal(v.shape)
        sd[k] = torch.tensor(a, dtype=torch.float32)
    sd["fs2.dur_predictor.linear.bias"][:] = 1.5
    return sd


def _make_variance_exp(name, root, **extra):
    from xiaoicesing_io_tpu.config import load_config
    from xiaoicesing_io_tpu.data.indexed_dataset import IndexedDatasetBuilder
    from xiaoicesing_io_tpu_torch.config import variance_defaults
    from xiaoicesing_io_tpu_torch.models.toplevel import VarianceModel

    work, binary = root / "checkpoints" / "var_exp", root / "binary"
    work.mkdir(parents=True)
    over = dict(TINY, **VARIANCE[name], **extra, work_dir=str(work), dictionary=str(DICT),
                binary_data_dir=str(binary), sampling_steps=3)
    cfgs = []
    for cfg in (load_config(ROOT / "xiaoicesing_io_tpu/configs/variance.yaml"),
                variance_defaults()):
        cfg.update(over)
        cfg["dur_prediction_args"].update(hidden_size=32, num_layers=2)
        cfg["pitch_prediction_args"].update(repeat_bins=8)
        cfg["pitch_prediction_args"]["backbone_args"].update(
            num_layers=4, num_channels=64, dilation_cycle_length=2)
        cfg["variances_prediction_args"].update(total_repeat_bins=8)
        cfg["variances_prediction_args"]["backbone_args"].update(num_layers=2, num_channels=16)
        cfg["melody_encoder_args"].update(hidden_size=16, enc_layers=1)
        cfgs.append(cfg)
    model = VarianceModel.from_config(cfgs[1], _vocab())
    sd = _random_state(model, seed=len(name))
    torch.save({"category": "variance", "state_dict": {f"model.{k}": v for k, v in sd.items()}},
               work / "model_ckpt_steps_100.ckpt")
    n_spk = over.get("num_spk", 1)
    _write_set(IndexedDatasetBuilder, binary, "valid", _variance_items(3, seed=7, n_spk=n_spk))
    _save_cfg(cfgs[0], work / "config.yaml")
    return cfgs


@pytest.fixture(scope="module")
def variance_exps(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _make_variance_exp(name, tmp_path_factory.mktemp(name))
        return cache[name]
    return get


def _jax_pitch_noise(pcfg):
    """Each item's pitch start noise as the JAX evaluation draws it: item
    keys split in turn from ``PRNGKey(0)``, the pitch key split from the
    item's (DDPM: the second key of its split), at the collated length."""
    from xiaoicesing_io_tpu_torch.data.dataset import VarianceDataset

    ds = VarianceDataset(pcfg["binary_data_dir"], "valid", pcfg)
    key, out = jax.random.PRNGKey(0), []
    for i in range(len(ds)):
        key, k_item = jax.random.split(key)
        _, k = jax.random.split(k_item)
        if pcfg["diffusion_type"] == "ddpm":
            k = jax.random.split(k)[1]
        T = ds.collate([i])["mel2ph"].shape[1]
        shape = (1, 1, T, pcfg["pitch_prediction_args"]["repeat_bins"])
        out.append(np.asarray(jax.random.normal(k, shape, jnp.float32)))
    return out


def _port_variance_model(pcfg):
    from xiaoicesing_io_tpu_torch.inference.variance import load_variance_model

    return load_variance_model(pcfg, _vocab())


@pytest.mark.parametrize("name", list(VARIANCE))
def test_evaluate_variance_matches_jax(name, variance_exps):
    """Rhythm correctness (and its sweep), phoneme duration accuracy, word
    counts equal, the median word-sum error within the bar, and the pitch
    accuracy equal from the same noise."""
    from xiaoicesing_io_tpu.eval.copy_synthesis import evaluate_variance as J
    from xiaoicesing_io_tpu_torch.eval.copy_synthesis import evaluate_variance as P

    jcfg, pcfg = variance_exps(name)
    ref = J(jcfg, "valid")
    got = P(pcfg, "valid", device="cpu", noise=_jax_pitch_noise(pcfg))
    assert list(got) == list(ref)
    median = got.pop("median_wordsum_rel_err")
    assert median == pytest.approx(ref.pop("median_wordsum_rel_err"), abs=1e-5)
    assert got == ref
    assert 0.0 < got["pitch_acc"] < 1.0 and got["n_words"] > 10


def test_sample_variance_inference_matches_jax(variance_exps):
    """Both heads of one collated item (the pitch head on K4's plain
    version, the variance head on its f32 module) from the JAX noise."""
    from xiaoicesing_io_tpu.training.checkpoint import load_params_for_inference
    from xiaoicesing_io_tpu.training.variance import build_variance
    from xiaoicesing_io_tpu.training.variance import sample_variance_inference as J
    from xiaoicesing_io_tpu_torch.data.dataset import VarianceDataset
    from xiaoicesing_io_tpu_torch.inference.variance import (
        build_variance_cores, head_kernel_weights,
    )
    from xiaoicesing_io_tpu_torch.models.toplevel import build_variance_normalizers
    from xiaoicesing_io_tpu_torch.training.variance import sample_variance_inference as P

    jcfg, pcfg = variance_exps("reflow")
    b = VarianceDataset(pcfg["binary_data_dir"], "valid", pcfg).collate([1])
    jmodel, jcore, jnorm = build_variance(jcfg, _vocab())
    params = load_params_for_inference(jcfg["work_dir"], jcfg)
    key = jax.random.PRNGKey(3)
    ref_pitch, ref_var = J(jcfg, jmodel, jcore, jnorm, params, b, key, want_variances=True)
    _, T = b["mel2ph"].shape
    key, k_pitch = jax.random.split(key)
    _, k_var = jax.random.split(key)
    noise = {"pitch": jax.random.normal(k_pitch, (1, 1, T, 8)),
             "variances": jax.random.normal(k_var, (1, 2, T, 4))}
    model = _port_variance_model(pcfg)
    weights = head_kernel_weights(pcfg, {"pitch": model.pitch_backbone}, torch.float32)
    pitch, var = P(pcfg, model, build_variance_cores(pcfg), build_variance_normalizers(pcfg), b,
                   kernel_weights=weights, noise={k: np.asarray(v) for k, v in noise.items()},
                   want_variances=True)
    np.testing.assert_allclose(pitch.numpy(), np.asarray(ref_pitch), atol=TOL, rtol=0)
    assert list(var) == list(ref_var) == ["energy", "breathiness"]
    for k in var:
        np.testing.assert_allclose(var[k].numpy(), np.asarray(ref_var[k]), atol=TOL, rtol=0)
    module, _ = P(pcfg, model, build_variance_cores(pcfg), build_variance_normalizers(pcfg), b,
                  kernel_weights=None, noise=dict(noise))
    np.testing.assert_allclose(module.numpy(), pitch.numpy(), atol=TOL, rtol=0)


def test_encode_sums_word_durations(variance_exps):
    """``encode`` given ``ph_dur`` and no ``word_dur`` sums the word
    durations from ``ph_dur``, as the JAX model does."""
    from xiaoicesing_io_tpu.models.toplevel import VarianceModel as JModel
    from xiaoicesing_io_tpu.training.checkpoint import load_params_for_inference
    from xiaoicesing_io_tpu_torch.data.dataset import VarianceDataset

    jcfg, pcfg = variance_exps("reflow")
    b = VarianceDataset(pcfg["binary_data_dir"], "valid", pcfg).collate([0])
    model = _port_variance_model(pcfg)
    t = {k: torch.as_tensor(b[k], dtype=torch.long) for k in ("tokens", "midi", "ph2word",
                                                               "ph_dur")}
    word_dur = torch.zeros(1, int(b["ph2word"].max()) + 1, dtype=torch.long)
    word_dur.scatter_add_(1, t["ph2word"], t["ph_dur"])
    with torch.no_grad():
        enc, dur = model.encode(t["tokens"], t["midi"], t["ph2word"], ph_dur=t["ph_dur"])
        enc_w, dur_w = model.encode(t["tokens"], t["midi"], t["ph2word"], ph_dur=t["ph_dur"],
                                    word_dur=word_dur[:, 1:])
    torch.testing.assert_close(enc, enc_w, rtol=0, atol=0)
    params = load_params_for_inference(jcfg["work_dir"], jcfg)
    jenc, jdur = JModel.from_config(jcfg, _vocab()).apply(
        params, *(jnp.asarray(b[k]) for k in ("tokens", "midi", "ph2word")),
        ph_dur=jnp.asarray(b["ph_dur"]), infer=True, method=JModel.encode)
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=TOL, rtol=0)
    np.testing.assert_allclose(dur.numpy(), np.asarray(jdur), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# the eval command
# ---------------------------------------------------------------------------

def test_cli_eval_matches_jax(acoustic_exps, variance_exps, deterministic_vocoders,
                              monkeypatch, tmp_path):
    """``eval --exp exp --pesq --json`` (the LYNXNet experiment; the port's
    runner handed the JAX runner's noise for each seed) and ``eval --exp
    var_exp --json`` (a duration-only variance experiment, which draws no
    noise): the same printed lines and JSON reports as the JAX command."""
    from click.testing import CliRunner

    from xiaoicesing_io_tpu.cli.main import cli as jcli
    from xiaoicesing_io_tpu_torch import cli as pcli
    from xiaoicesing_io_tpu_torch.inference.acoustic import DiffSingerAcousticInfer

    forward = DiffSingerAcousticInfer.forward_model

    def forward_model(self, batch, seed=0, noise=None, _f32_module=False):
        return forward(self, batch, noise=_jax_mel_noise(self.cfg, seed, batch["mel2ph"].shape[1]),
                       _f32_module=_f32_module)

    monkeypatch.setattr(DiffSingerAcousticInfer, "forward_model", forward_model)
    jcfg, _ = acoustic_exps("lynx_reflow")
    root = Path(jcfg["work_dir"]).parent.parent
    dur_only = _make_variance_exp("reflow", root / "var", predict_pitch=False)
    (root / "checkpoints" / "var_exp").symlink_to(Path(dur_only[0]["work_dir"]))
    monkeypatch.chdir(root)
    for exp, args in (("exp", ["--pesq", "--limit", "1"]), ("var_exp", [])):
        ref = CliRunner().invoke(jcli, ["eval", "--exp", exp, "--json", "jax.json", *args])
        assert ref.exit_code == 0, ref.output
        out = tmp_path / f"{exp}.out"
        with open(out, "w") as f, contextlib.redirect_stdout(f):
            pcli.main(["eval", "--exp", exp, "--json", "port.json", "--device", "cpu", *args])
        got_lines = out.read_text().splitlines()
        ref_lines = [ln for ln in ref.output.splitlines() if ln.startswith("| ")]
        assert [ln.split(":")[0] for ln in got_lines] == [ln.split(":")[0] for ln in ref_lines]
        _assert_close_report(json.loads(Path("port.json").read_text()),
                             json.loads(Path("jax.json").read_text()))


# ---------------------------------------------------------------------------
# the DDSP vocoder
# ---------------------------------------------------------------------------

class ToyDDSP(torch.nn.Module):
    """A stand-in for a pc-ddsp TorchScript archive: mel ``[B, T, M]`` and
    f0 ``[B, T, 1]`` -> (signal ``[B, T * 4]``, harmonic, (noise, extra))."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(128, 4)

    def forward(self, mel, f0):
        frames = torch.tanh(self.proj(mel)) * torch.sin(f0 / 50.0)
        return frames.reshape(mel.shape[0], -1), frames, (frames, frames)


@pytest.mark.parametrize("mel_base", ["e", 10])
def test_ddsp_matches_jax(mel_base, tmp_path, capsys):
    import yaml

    from xiaoicesing_io_tpu.models.vocoders.wrapper import DDSP as JDDSP
    from xiaoicesing_io_tpu_torch.models.vocoders import get_vocoder_cls

    torch.manual_seed(0)
    torch.jit.script(ToyDDSP()).save(str(tmp_path / "model.pt"))
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(
        {"data": {"sampling_rate": 44100, "n_mels": 128, "block_size": 4}}))
    cls = get_vocoder_cls("DDSP")
    assert get_vocoder_cls("ddsp") is cls
    cfg = {"vocoder_ckpt": str(tmp_path / "model.pt"), "mel_base": mel_base,
           "audio_sample_rate": 44100, "audio_num_mel_bins": 128, "hop_size": 512}
    port, ref = cls(cfg, device="cpu"), JDDSP(cfg)
    assert capsys.readouterr().out.count("Mismatch parameters: cfg['hop_size']=512 != 4") == 2
    rng = np.random.default_rng(0)
    mel = (rng.standard_normal((2, 9, 128)) - 3.0).astype(np.float32)
    f0 = rng.uniform(100, 400, (2, 9)).astype(np.float32)
    got = port.spec2wav(mel, f0, generator=torch.Generator().manual_seed(1))
    assert got.shape == (2, 36)
    np.testing.assert_array_equal(got, ref.spec2wav(mel, f0))
    np.testing.assert_array_equal(port.spec2wav(mel[0], f0[0]), ref.spec2wav(mel[0], f0[0]))
    with pytest.raises(FileNotFoundError):
        cls(dict(cfg, vocoder_ckpt=str(tmp_path / "none.pt")), device="cpu")
