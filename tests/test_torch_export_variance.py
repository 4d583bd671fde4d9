"""The port's ``export variance`` and the ``export`` commands, on the CPU.

One reference checkpoint of a tiny random variance model (durations, the
pitch head with the melody encoder and glides, the four variance curves,
two speakers) is exported by both packages (JAX with ``fmt="onnx"``).  Both
write the same files, manifest and input surface, and the graphs without a
WaveNet agree at 2e-4 through both executors.  The WaveNet heads'
``pitch_step`` / ``variance_step`` are held against the JAX package's
modules at 2e-4, and the merged ``pitch.onnx`` / ``variance.onnx`` loops
against its sampler started from the executor's draw at 1e-4: the JAX
converter's ``ne`` -> ``Equal`` breaks the Mish in its own WaveNet graphs
(see ``tests/test_torch_export.py``).

The port's frozen options are held against its open graphs fed the frozen
values; the JAX package's ``export variance --freeze_spk`` raises, since
its speaker-mix lookup reads the acoustic model's ``fs2.spk_embed``.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from xiaoicesing_io_tpu.deployment.onnx_proto import parse_model as jax_parse
from xiaoicesing_io_tpu.deployment.onnx_run import run_graph as jax_run
from xiaoicesing_io_tpu_torch.deployment.onnx_proto import parse_model
from xiaoicesing_io_tpu_torch.deployment.onnx_run import run_graph

ROOT = Path(__file__).resolve().parent.parent
DICT = ROOT / "dictionaries" / "opencpop-extension.txt"
CURVES = ("energy", "breathiness", "voicing", "tension")
TOL = 2e-4
SPK = {"alice": 0, "bob": 1}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on shared cores; torch's
    intra-op threads would oversubscribe them.  Two threads a test."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny(cfg, work_dir):
    cfg.update(work_dir=str(work_dir), dictionary=str(DICT), hidden_size=32, enc_layers=1,
               num_heads=2, use_spk_id=True, num_spk=2, use_melody_encoder=True,
               use_glide_embed=True, **{f"predict_{v}": True for v in CURVES})
    cfg["dur_prediction_args"].update(hidden_size=32, num_layers=2)
    cfg["pitch_prediction_args"].update(repeat_bins=8)
    cfg["pitch_prediction_args"]["backbone_args"].update(num_layers=3, num_channels=16,
                                                         dilation_cycle_length=2)
    cfg["variances_prediction_args"].update(total_repeat_bins=8)
    cfg["variances_prediction_args"]["backbone_args"].update(num_layers=2, num_channels=16)
    cfg["melody_encoder_args"].update(hidden_size=16, enc_layers=1)
    return cfg


def _vocab():
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    return TokenTextEncoder(PhonemeDictionary.load(DICT).phoneme_list).vocab_size


def _random_state(model, seed=0):
    """Every tensor drawn with numpy; the duration head's bias at 1.5, so
    that its durations (exp(x) - 1) are not clamped to 0."""
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


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    from xiaoicesing_io_tpu.config import load_config
    from xiaoicesing_io_tpu.deployment.export import export_variance as jax_export
    from xiaoicesing_io_tpu_torch.config import variance_defaults
    from xiaoicesing_io_tpu_torch.deployment.export import export_variance
    from xiaoicesing_io_tpu_torch.models.toplevel import VarianceModel

    wd = tmp_path_factory.mktemp("variance")
    pcfg = _tiny(variance_defaults(), wd)
    jcfg = _tiny(load_config(ROOT / "xiaoicesing_io_tpu/configs/variance.yaml"), wd)
    sd = _random_state(VarianceModel.from_config(pcfg, _vocab()))
    torch.save({"category": "variance", "state_dict": {f"model.{k}": v for k, v in sd.items()}},
               wd / "model_ckpt_steps_100.ckpt")
    (wd / "spk_map.json").write_text(json.dumps(SPK))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        port = export_variance(pcfg, out_dir=str(wd / "port"))
    finally:
        torch.set_num_threads(n)
    ref = jax_export(jcfg, out_dir=str(wd / "jax"), fmt="onnx")
    manifest = yaml.safe_load((port / "dsconfig.yaml").read_text())
    return SimpleNamespace(wd=wd, port=port, jax=ref, pcfg=pcfg, jcfg=jcfg, manifest=manifest)


def _graphs(ex, name):
    return (parse_model((ex.port / f"{name}.onnx").read_bytes())[0],
            jax_parse((ex.jax / f"{name}.onnx").read_bytes())[0])


def _values(rng):
    """One value of every input the variance graphs take, by name."""
    T_ph, T_f, T_n, H = 64, 512, 32, 32
    return {
        "tokens": rng.integers(1, _vocab(), (1, T_ph)).astype(np.int32),
        "midi": rng.integers(40, 80, (1, T_ph)).astype(np.int32),
        "ph2word": np.sort(rng.integers(1, 33, (1, T_ph)), axis=1).astype(np.int32),
        "word_dur": rng.integers(1, 30, (1, T_ph)).astype(np.int32),
        "ph_spk_mix_embed": rng.standard_normal((1, 1, H)).astype(np.float32),
        "encoder_out": rng.standard_normal((1, T_ph, H)).astype(np.float32),
        "mel2ph": np.sort(rng.integers(0, T_ph + 1, (1, T_f)), axis=1).astype(np.int32),
        "spk_mix_embed": rng.standard_normal((1, 1, H)).astype(np.float32),
        "condition": rng.standard_normal((1, T_f, H)).astype(np.float32),
        "base_pitch": rng.uniform(55, 70, (1, T_f)).astype(np.float32),
        "pitch_expr": rng.uniform(0, 1, (1, T_f)).astype(np.float32),
        "note_midi": rng.uniform(55, 70, (1, T_n)).astype(np.float32),
        "note_rest": rng.uniform(size=(1, T_n)) < 0.2,
        "note_dur": rng.integers(1, 30, (1, T_n)).astype(np.int32),
        "note_glide": rng.integers(0, 3, (1, T_n)).astype(np.int32),
        "mel2note": np.sort(rng.integers(1, T_n + 1, (1, T_f)), axis=1).astype(np.int32),
        "pitch": rng.uniform(55, 70, (1, T_f)).astype(np.float32),
        "depth": np.asarray(1.0, np.float32),
        "steps": np.asarray(3, np.int64),
    }


def _feeds(graph, names, values):
    """Feeds for a standalone graph (inputs ``in0``... in the manifest's
    order) or a merged one (inputs by name)."""
    graph_names = [n for n, _, _ in graph.inputs]
    if graph_names[0] == "in0":
        return {f"in{i}": values[n] for i, n in enumerate(names)}
    return {n: values[n] for n in graph_names}


def test_files_and_manifest_match_jax(exported):
    names = sorted(p.name for p in exported.port.iterdir())
    assert names == sorted(p.name for p in exported.jax.iterdir())
    assert {"linguistic_dur.onnx", "frame_condition.onnx", "pitch_pre.onnx",
            "pitch_step.onnx", "pitch.onnx", "variance_pre.onnx", "variance_step.onnx",
            "variance.onnx", "alice.emb", "bob.emb"} <= set(names)
    assert exported.manifest == yaml.safe_load((exported.jax / "dsconfig.yaml").read_text())
    for name in ("alice.emb", "bob.emb"):
        np.testing.assert_allclose(
            np.frombuffer((exported.port / name).read_bytes(), np.float32),
            np.frombuffer((exported.jax / name).read_bytes(), np.float32), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["linguistic_dur", "frame_condition", "pitch_pre",
                                  "pitch_step", "pitch", "variance_pre", "variance_step",
                                  "variance"])
def test_input_surface_matches_jax(exported, name):
    pg, jg = _graphs(exported, name)
    assert pg.inputs == jg.inputs
    assert [(n, s) for n, _, s in pg.outputs] == [(n, s) for n, _, s in jg.outputs]


def _jax_model(ex):
    from xiaoicesing_io_tpu.models.toplevel import build_variance_normalizers
    from xiaoicesing_io_tpu.training.checkpoint import load_params_for_inference
    from xiaoicesing_io_tpu.training.variance import build_variance

    model, core, _ = build_variance(ex.jcfg, _vocab())
    return (model, core, build_variance_normalizers(ex.jcfg),
            load_params_for_inference(ex.wd, ex.jcfg))


def _jax_condition(ex, name, j):
    """The JAX package's module for a condition graph, on the values ``j``."""
    from xiaoicesing_io_tpu.models.toplevel import VarianceModel

    model, _, _, params = _jax_model(ex)
    if name == "linguistic_dur":
        return model.apply(params, j["tokens"], j["midi"], j["ph2word"], word_dur=j["word_dur"],
                           infer=True, ph_spk_mix_embed=j["ph_spk_mix_embed"],
                           method=VarianceModel.encode)
    if name == "frame_condition":
        return (model.apply(params, j["encoder_out"], j["mel2ph"],
                            spk_mix_embed=j["spk_mix_embed"],
                            method=VarianceModel.frame_condition),)
    if name == "pitch_pre":
        return (model.apply(params, j["condition"], j["mel2ph"], j["base_pitch"],
                            pitch_expr=j["pitch_expr"], note_midi=j["note_midi"],
                            note_rest=j["note_rest"], note_dur=j["note_dur"],
                            note_glide=j["note_glide"], mel2note=j["mel2note"],
                            method=VarianceModel.pitch_condition),)
    return (model.apply(params, j["condition"], j["pitch"], {},
                        method=VarianceModel.variance_condition),)


@pytest.mark.parametrize("name,key", [("linguistic_dur", "linguistic"),
                                      ("frame_condition", "frame_condition"),
                                      ("pitch_pre", "pitch_pre"),
                                      ("variance_pre", "variance_pre")])
def test_condition_graphs_match_jax(exported, name, key):
    """The port's graphs, through both executors, give the JAX package's
    modules; so do the JAX package's graphs, except ``pitch_pre``: its
    converter names values by the id of a jaxpr variable, and the two
    lookups of the retake table (``ones`` and ``zeros``) inline one cached
    sub-jaxpr, so they share one value and ``pitch_expr`` mixes nothing."""
    pg, jg = _graphs(exported, name)
    values = _values(np.random.default_rng(1))
    feeds = _feeds(pg, exported.manifest["graph_inputs"][key], values)
    ref = [np.asarray(r) for r in _jax_condition(
        exported, name, {k: jnp.asarray(v) for k, v in values.items()})]
    assert np.abs(ref[0]).max() > 0.5
    if name == "linguistic_dur":
        assert ref[1].shape == (1, 64) and ref[1].max() > 1.0  # durations
    for run in (run_graph, jax_run):
        out = run(pg, feeds)
        for i, r in enumerate(ref):
            np.testing.assert_allclose(out[f"out{i}"], r, atol=TOL, rtol=0, err_msg=str(i))
    jax_graph = jax_run(jg, feeds)
    np.testing.assert_array_equal(run_graph(jg, feeds)["out0"], jax_graph["out0"])
    if name == "pitch_pre":
        assert np.abs(jax_graph["out0"] - ref[0]).max() > 0.1
    else:
        np.testing.assert_allclose(jax_graph["out0"], ref[0], atol=TOL, rtol=0)


@pytest.mark.parametrize("head", ["pitch", "variance"])
def test_step_graphs_match_jax_modules(exported, head):
    from xiaoicesing_io_tpu.models.toplevel import VarianceModel

    pg, jg = _graphs(exported, f"{head}_step")
    shape = [s for n, _, s in pg.inputs][0]
    rng = np.random.default_rng(2)
    feeds = {"in0": rng.standard_normal(shape).astype(np.float32),
             "in1": np.asarray([370.0], np.float32),
             "in2": rng.standard_normal((1, 512, 32)).astype(np.float32)}
    model, _, _, params = _jax_model(exported)
    method = VarianceModel.denoise_pitch if head == "pitch" else VarianceModel.denoise_variance
    ref = np.asarray(model.apply(params, *[jnp.asarray(feeds[f"in{i}"]) for i in range(3)],
                                 method=method))
    assert np.abs(ref).max() > 0.5
    for run in (run_graph, jax_run):
        np.testing.assert_allclose(run(pg, feeds)["out0"], ref, atol=TOL, rtol=0)
    # the JAX package's own WaveNet graph: off by its Mish fault
    assert np.abs(jax_run(jg, feeds)["out0"] - ref).max() > 0.1


@pytest.mark.parametrize("head", ["pitch", "variance"])
def test_merged_predictors_match_jax_sampler(exported, head):
    """The merged loop's curves under one executor seed equal the JAX
    package's condition, sampler and normalizer started from the same
    draw."""
    from xiaoicesing_io_tpu.models.toplevel import VarianceModel

    pg, _ = _graphs(exported, head)
    values = _values(np.random.default_rng(3))
    feeds = _feeds(pg, None, values)
    model, core, normalizers, params = _jax_model(exported)
    j = {k: jnp.asarray(v) for k, v in values.items()}
    if head == "pitch":
        cond = model.apply(params, j["condition"], j["mel2ph"], j["base_pitch"],
                           pitch_expr=j["pitch_expr"], note_midi=j["note_midi"],
                           note_rest=j["note_rest"], note_dur=j["note_dur"],
                           note_glide=j["note_glide"], mel2note=j["mel2note"],
                           method=VarianceModel.pitch_condition)
        method, names = VarianceModel.denoise_pitch, ["pitd"]
    else:
        cond = model.apply(params, j["condition"], j["pitch"], {},
                           method=VarianceModel.variance_condition)
        method, names = VarianceModel.denoise_variance, list(CURVES)
    shape = tuple(next(s for n, _, s in pg.inputs if n == "condition")[:1]) + \
        tuple(_graphs(exported, f"{head}_step")[0].inputs[0][2][1:])
    noise = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    x = core.inference(lambda x, t: model.apply(params, x, t, cond, method=method),
                       jax.random.PRNGKey(0), shape, steps=3, algorithm="euler",
                       noise=jnp.asarray(noise))
    ref = normalizers["pitch" if head == "pitch" else "variances"].denorm(x)
    ref = [ref] if head == "pitch" else ref
    for run in (run_graph, jax_run):
        out = run(pg, feeds, rng=np.random.default_rng(4))
        assert list(out) == names
        for name, r in zip(names, ref):
            np.testing.assert_allclose(out[name], np.asarray(r), atol=1e-4, rtol=1e-4,
                                       err_msg=name)


def _cli(*argv):
    from xiaoicesing_io_tpu_torch import cli

    cli.main(list(argv))


def test_cli_exports_with_frozen_options(exported, tmp_path):
    """``cli export variance`` with every freeze option and ``--export_spk``:
    each frozen graph equals the open graph fed the frozen values, the
    manifest drops the frozen inputs, and the mix attachment is the mixed
    embedding."""
    root = exported.wd.parent
    exp = exported.wd.name
    (exported.wd / "config.json").write_text(json.dumps(dict(exported.pcfg)))
    out = tmp_path / "frozen"
    _cli("export", "variance", "--exp", exp, "--work_dir", str(root), "--out", str(out),
         "--freeze_expr", "0.8", "--freeze_glide", "--freeze_spk", "alice:0.3|bob:0.7",
         "--export_spk", "duet=alice:0.5|bob:0.5")
    manifest = yaml.safe_load((out / "dsconfig.yaml").read_text())
    assert manifest["frozen"] == ["expr", "glide", "spk_mix_embed"]
    assert manifest["graph_inputs"]["linguistic"] == ["tokens", "midi", "ph2word", "word_dur"]
    assert "pitch_expr" not in manifest["graph_inputs"]["pitch_pre"]
    assert "note_glide" not in manifest["graph_inputs"]["pitch_pre"]
    alice, bob = (np.frombuffer((exported.port / f"{n}.emb").read_bytes(), np.float32)
                  for n in ("alice", "bob"))
    np.testing.assert_allclose(np.frombuffer((out / "duet.emb").read_bytes(), np.float32),
                               0.5 * alice + 0.5 * bob, atol=1e-6)

    values = _values(np.random.default_rng(5))
    open_values = dict(values, ph_spk_mix_embed=(0.3 * alice + 0.7 * bob)[None, None],
                       spk_mix_embed=(0.3 * alice + 0.7 * bob)[None, None],
                       pitch_expr=np.full((1, 512), 0.8, np.float32),
                       note_glide=np.zeros((1, 32), np.int32))
    for name, key in (("linguistic_dur", "linguistic"), ("frame_condition", "frame_condition"),
                      ("pitch_pre", "pitch_pre")):
        frozen = parse_model((out / f"{name}.onnx").read_bytes())[0]
        opened = parse_model((exported.port / f"{name}.onnx").read_bytes())[0]
        got = run_graph(frozen, _feeds(frozen, manifest["graph_inputs"][key], values))
        ref = run_graph(opened, _feeds(opened, exported.manifest["graph_inputs"][key],
                                       open_values))
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=1e-5, err_msg=name)


def test_jax_variance_freeze_spk_fails(exported, tmp_path):
    """The reference fault the port does not copy: JAX's variance
    ``freeze_spk`` looks the table up under ``fs2``, where the variance model
    has none."""
    from xiaoicesing_io_tpu.deployment.export import export_variance as jax_export

    with pytest.raises(KeyError, match="spk_embed"):
        jax_export(exported.jcfg, out_dir=str(tmp_path / "jax"), fmt="onnx",
                   freeze_spk="alice")


def test_cli_exports_acoustic_and_vocoder(tmp_path):
    """``cli export acoustic`` and ``cli export nsf-hifigan`` write their
    artifacts; ``--format stablehlo`` is refused."""
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults
    from xiaoicesing_io_tpu_torch.deployment.export import export_acoustic
    from xiaoicesing_io_tpu_torch.models.toplevel import AcousticModel
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import (
        Generator, NsfHifiganConfig,
    )

    exp = tmp_path / "root" / "ac"
    exp.mkdir(parents=True)
    cfg = acoustic_defaults()
    cfg.update(work_dir=str(exp), dictionary=str(DICT), hidden_size=16, enc_layers=1,
               num_heads=2)
    cfg["backbone_args"] = {"num_channels": 64, "num_layers": 1, "kernel_size": 31,
                            "dropout_rate": 0.0, "strong_cond": True}
    cfg["shallow_diffusion_args"]["aux_decoder_args"].update(num_channels=16, num_layers=1)
    vocoder = dict(num_mels=128, sampling_rate=44100, hop_size=512, n_fft=2048, win_size=2048,
                   fmin=40, fmax=16000, upsample_rates=[8, 8, 2, 2, 2],
                   upsample_kernel_sizes=[16, 16, 4, 4, 4], upsample_initial_channel=64,
                   resblock="2", resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]])
    (tmp_path / "voc").mkdir()
    torch.save({"generator": Generator(NsfHifiganConfig.from_json(vocoder)).state_dict()},
               tmp_path / "voc" / "model.ckpt")
    (tmp_path / "voc" / "config.json").write_text(json.dumps(vocoder))
    cfg["vocoder_ckpt"] = str(tmp_path / "voc" / "model.ckpt")
    model = AcousticModel.from_config(cfg, _vocab())
    torch.save({"state_dict": {f"model.{k}": v for k, v in model.state_dict().items()}},
               exp / "model_ckpt_steps_7.ckpt")
    (exp / "config.json").write_text(json.dumps(dict(cfg)))

    _cli("export", "acoustic", "--exp", "ac", "--work_dir", str(tmp_path / "root"),
         "--out", str(tmp_path / "a"))
    assert {p.name for p in (tmp_path / "a").iterdir()} == {
        "fs2_aux.onnx", "diffusion_step.onnx", "acoustic.onnx", "dsconfig.yaml",
        "phonemes.txt", "dictionary.txt"}
    _cli("export", "nsf-hifigan", "--exp", "ac", "--work_dir", str(tmp_path / "root"),
         "--out", str(tmp_path / "v"))
    graph = parse_model((tmp_path / "v" / "nsf_hifigan.onnx").read_bytes())[0]
    assert [s for _, _, s in graph.outputs] == [[1, 256 * 512]]
    assert (tmp_path / "v" / "vocoder.yaml").exists()
    for fmt in ("stablehlo", "savedmodel"):
        with pytest.raises(SystemExit):
            _cli("export", "acoustic", "--exp", "ac", "--work_dir", str(tmp_path / "root"),
                 "--format", fmt)
        with pytest.raises(ValueError, match="JAX/TensorFlow"):
            export_acoustic(cfg, out_dir=str(tmp_path / "x"), fmt=fmt)
