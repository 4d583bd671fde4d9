"""The port's variance model and ``infer variance`` against the JAX package, on the CPU.

A tiny variance model (every head on: durations, pitch and the four
variance curves) gets random weights drawn with numpy under the reference
names; the JAX package's ``convert_variance`` makes its flax params, and
``variance_state_dict_from_jax`` carries those back into the port, which
loads them strictly.  Modules are compared in f32 at the module bar 2e-4;
durations, which are rounded frame counts, exactly.  The runner tests feed
the port the start noise the JAX runner draws (``normal(key)`` on reflow,
the second key of ``split(key)`` on DDPM; the variance head from
``fold_in(key, 1)``), since the two packages' generators differ by design.
The JAX runner takes its f32 flax path; the port's takes its kernel path in
f32, where the residual-block wrapper runs its plain version.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SAMPLES = sorted((ROOT / "samples").glob("*.ds"))
DICT = ROOT / "dictionaries" / "opencpop-extension.txt"
CURVES = ("energy", "breathiness", "voicing", "tension")
TOL = 2e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on shared cores; torch's
    intra-op threads then oversubscribe them and its convolutions slow down
    many-fold.  One thread per test, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(cfg, work_dir, **over):
    cfg.update(work_dir=str(work_dir), dictionary=str(DICT), hidden_size=32, enc_layers=1,
               num_heads=2, sampling_steps=3, **{f"predict_{v}": True for v in CURVES})
    cfg["dur_prediction_args"].update(hidden_size=32, num_layers=2)
    cfg["pitch_prediction_args"].update(repeat_bins=8)
    cfg["pitch_prediction_args"]["backbone_args"].update(num_layers=3, num_channels=16,
                                                         dilation_cycle_length=2)
    cfg["variances_prediction_args"].update(total_repeat_bins=8)
    cfg["variances_prediction_args"]["backbone_args"].update(num_layers=2, num_channels=16)
    cfg["melody_encoder_args"].update(hidden_size=16, enc_layers=1)
    cfg.update(over)
    return cfg


def _cfgs(work_dir, **over):
    from xiaoicesing_io_tpu.config import load_config
    from xiaoicesing_io_tpu_torch.config import variance_defaults

    return (_tiny(load_config(ROOT / "xiaoicesing_io_tpu/configs/variance.yaml"), work_dir, **over),
            _tiny(variance_defaults(), work_dir, **over))


def _vocab():
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    return TokenTextEncoder(PhonemeDictionary.load(DICT).phoneme_list).vocab_size


def _random_state(model, seed=0):
    """Every tensor of ``model``'s state dict drawn with numpy: matrices at
    1 / sqrt(fan-in), norm scales around 1, biases around 0; the duration
    head's bias at 1.5, so that its durations (exp(x) - 1) are not clamped
    to 0."""
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
    if "fs2.dur_predictor.linear.bias" in sd:
        sd["fs2.dur_predictor.linear.bias"][:] = 1.5
    return sd


def _pair(work_dir, seed=0, **over):
    """(JAX cfg, port cfg, JAX model, flax params, port model) with the same
    random weights; the port model loads them from the flax params."""
    from xiaoicesing_io_tpu.models.toplevel import VarianceModel as JModel
    from xiaoicesing_io_tpu.utils.torch_ckpt import convert_variance
    from xiaoicesing_io_tpu_torch.models.toplevel import (
        VarianceModel as PModel, load_variance_state_dict,
    )
    from xiaoicesing_io_tpu_torch.utils.jax_weights import variance_state_dict_from_jax

    jcfg, pcfg = _cfgs(work_dir, **over)
    vocab = _vocab()
    pm = PModel.from_config(pcfg, vocab)
    params = jax.tree_util.tree_map(np.asarray, convert_variance(_random_state(pm, seed), jcfg))
    load_variance_state_dict(pm, variance_state_dict_from_jax(params, pcfg))
    return jcfg, pcfg, JModel.from_config(jcfg, vocab), params, pm.eval()


def _write_exp(work_dir, pm, spk=None):
    sd = {f"model.{k}": v for k, v in pm.state_dict().items()}
    torch.save({"category": "variance", "state_dict": sd}, Path(work_dir) / "model_ckpt_steps_100.ckpt")
    if spk:
        (Path(work_dir) / "spk_map.json").write_text(json.dumps({n: i for i, n in enumerate(spk)}))


def _close(got, ref, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ph_dur,ph2word,word_dur", [
    ([[3, 5, 0, 7]], [[1, 1, 2, 2]], [[10, 9]]),
    # a word whose phonemes all round to 0, a phoneme scaled below 0.5, padding
    ([[0, 0, 4, 1, 9, 0]], [[1, 1, 2, 2, 3, 0]], [[6, 12, 2]]),
    ([[2, 2, 2], [1, 6, 3]], [[1, 2, 3], [1, 1, 2]], [[5, 0, 7], [4, 11, 0]]),
    ([[0.4, 2.6, 1.5, 3.5]], [[1, 1, 1, 2]], [[7, 3]]),
])
def test_rhythm_regulator_matches_jax(ph_dur, ph2word, word_dur):
    from xiaoicesing_io_tpu.ops.seq import rhythm_regulator as J
    from xiaoicesing_io_tpu_torch.ops.seq import rhythm_regulator as P

    ref = np.asarray(J(jnp.asarray(ph_dur), jnp.asarray(ph2word), jnp.asarray(word_dur)))
    got = P(torch.tensor(ph_dur), torch.tensor(ph2word), torch.tensor(word_dur)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mix", ["a", "a|b", "a:0.3|b", "a:0.25|b:0.25|c", "a:2|b:6",
                                 "bad mix", "a|a", "a:0.8|b:0.6|c"])
def test_spk_mix_parse_matches_jax(mix):
    from xiaoicesing_io_tpu.utils.spk_mix import parse_commandline_spk_mix as J
    from xiaoicesing_io_tpu_torch.utils.spk_mix import parse_commandline_spk_mix as P

    try:
        ref = J(mix)
    except AssertionError as e:
        with pytest.raises(AssertionError, match=str(e)[:20]):
            P(mix)
        return
    assert P(mix) == pytest.approx(ref)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Two weight sets: the melody encoder with glides and two speakers, and
    the plain base-pitch model."""
    wd = tmp_path_factory.mktemp("var_modules")
    return {
        "melody": _pair(wd, seed=1, use_melody_encoder=True, use_glide_embed=True,
                        use_spk_id=True, num_spk=2),
        "base": _pair(wd, seed=2),
    }


def _inputs(seed=0, T_ph=9, T_s=40, T_n=6, H=32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 60, (1, T_ph))
    tokens[0, -2:] = 0
    ph2word = np.array([[1, 1, 2, 3, 3, 3, 4, 0, 0]])[:, :T_ph]
    mel2ph = np.sort(rng.integers(1, T_ph - 1, (1, T_s)), axis=1)
    mel2ph[0, -3:] = 0
    note_midi = rng.uniform(55, 75, (1, T_n)).astype(np.float32)
    note_midi[0, -1] = -1.0
    return dict(
        tokens=tokens, midi=rng.integers(50, 80, (1, T_ph)), ph2word=ph2word,
        ph_dur=rng.integers(0, 9, (1, T_ph)), word_dur=rng.integers(4, 20, (1, 4)),
        mel2ph=mel2ph, base_pitch=rng.uniform(55, 75, (1, T_s)).astype(np.float32),
        pitch=rng.uniform(55, 75, (1, T_s)).astype(np.float32),
        expr=rng.uniform(0, 1, (1, T_s)).astype(np.float32),
        retake=rng.uniform(0, 1, (1, T_s)) > 0.4, note_midi=note_midi,
        note_rest=rng.uniform(0, 1, (1, T_n)) > 0.7, note_dur=rng.integers(2, 12, (1, T_n)),
        note_glide=rng.integers(0, 3, (1, T_n)), mel2note=np.sort(rng.integers(0, T_n, (1, T_s))),
        spk_mix=rng.standard_normal((1, 1, H)).astype(np.float32) * 0.3,
        cond=rng.standard_normal((1, T_s, H)).astype(np.float32),
        enc=rng.standard_normal((1, T_ph, H)).astype(np.float32),
        x_pitch=rng.standard_normal((1, 1, T_s, 8)).astype(np.float32),
        x_var=rng.standard_normal((1, 4, T_s, 2)).astype(np.float32),
        t=np.array([321.0], np.float32),
        curves={v: rng.uniform(-60, -5, (1, T_s)).astype(np.float32) for v in CURVES},
        curve_retake={v: rng.uniform(0, 1, (1, T_s)) > 0.5 for v in CURVES},
    )


def _j(a):
    return jnp.asarray(a)


def _p(a):
    return torch.as_tensor(np.asarray(a))


def _run_case(case, models):
    """(port output, JAX output) of one module case."""
    from xiaoicesing_io_tpu.models.fastspeech.variance import (
        DurationPredictor as JDur, FastSpeech2Variance as JFs2, MelodyEncoder as JMel,
    )
    from xiaoicesing_io_tpu.models.toplevel import VarianceModel as JM

    which = "melody" if case in ("melody_encoder", "pitch_condition_melody",
                                 "pitch_condition_melody_retake", "encode_spk",
                                 "frame_condition_spk") else "base"
    jcfg, pcfg, jm, params, pm = models[which]
    x = _inputs()
    p = params["params"]
    with torch.no_grad():
        if case == "dur_predictor":
            mod = JDur(n_layers=2, n_chans=32, kernel_size=3, offset=1.0)
            xs = np.random.default_rng(3).standard_normal((1, 9, 32)).astype(np.float32)
            mask = x["tokens"] == 0
            ref = mod.apply({"params": p["fs2"]["dur_predictor"]}, _j(xs), _j(mask), infer=False)
            got = pm.fs2.dur_predictor(_p(xs), _p(mask), infer=False)
            return got, ref
        if case in ("fs2_word_mode", "fs2_word_dur_from_ph_dur"):
            word_dur = None if case == "fs2_word_dur_from_ph_dur" else x["word_dur"]
            mod = JFs2(vocab_size=jm.fs2.vocab_size, hidden_size=32, enc_layers=1,
                       enc_ffn_kernel_size=3, use_rope=True, rel_pos=True,
                       dur_hidden_size=32, dur_num_layers=2)
            ref = mod.apply({"params": p["fs2"]}, _j(x["tokens"]), _j(x["midi"]),
                            _j(x["ph2word"]), ph_dur=_j(x["ph_dur"]),
                            word_dur=None if word_dur is None else _j(word_dur),
                            spk_embed=_j(x["spk_mix"]), infer=True)
            got = pm.fs2(_p(x["tokens"]), _p(x["midi"]), _p(x["ph2word"]),
                         ph_dur=_p(x["ph_dur"]), word_dur=None if word_dur is None
                         else _p(word_dur), spk_embed=_p(x["spk_mix"]), infer=True)
            return torch.cat([got[0].flatten(), got[1].flatten()]), \
                jnp.concatenate([ref[0].flatten(), ref[1].flatten()])
        if case == "melody_encoder":
            mod = JMel(hidden_size=16, out_size=32, enc_layers=1, enc_ffn_kernel_size=3,
                       use_rope=True, rel_pos=True, use_glide_embed=True, num_glide_types=2)
            ref = mod.apply({"params": p["melody_encoder"]}, _j(x["note_midi"]),
                            _j(x["note_rest"]), _j(x["note_dur"]), glide=_j(x["note_glide"]))
            got = pm.melody_encoder(_p(x["note_midi"]), _p(x["note_rest"]), _p(x["note_dur"]),
                                    glide=_p(x["note_glide"]))
            return got, ref
        if case in ("encode", "encode_spk"):
            spk = x["spk_mix"] if case == "encode_spk" else None
            ref = jm.apply(params, _j(x["tokens"]), _j(x["midi"]), _j(x["ph2word"]),
                           word_dur=_j(x["word_dur"]),
                           ph_spk_mix_embed=None if spk is None else _j(spk), infer=True,
                           method=JM.encode)
            got = pm.encode(_p(x["tokens"]), _p(x["midi"]), _p(x["ph2word"]),
                            word_dur=_p(x["word_dur"]),
                            ph_spk_mix_embed=None if spk is None else _p(spk), infer=True)
            return torch.cat([got[0].flatten(), got[1].flatten()]), \
                jnp.concatenate([ref[0].flatten(), ref[1].flatten()])
        if case in ("frame_condition", "frame_condition_spk"):
            spk = x["spk_mix"] if case == "frame_condition_spk" else None
            ref = jm.apply(params, _j(x["enc"]), _j(x["mel2ph"]),
                           spk_mix_embed=None if spk is None else _j(spk),
                           method=JM.frame_condition)
            got = pm.frame_condition(_p(x["enc"]), _p(x["mel2ph"]),
                                     spk_mix_embed=None if spk is None else _p(spk))
            return got, ref
        if case.startswith("pitch_condition"):
            kw = dict(note_midi=x["note_midi"], note_rest=x["note_rest"],
                      note_dur=x["note_dur"], note_glide=x["note_glide"], mel2note=x["mel2note"])
            if case.endswith("expr"):
                kw["pitch_expr"] = x["expr"]
            if case.endswith("retake"):
                kw.update(pitch=x["pitch"], pitch_retake=x["retake"], pitch_expr=x["expr"])
            ref = jm.apply(params, _j(x["cond"]), _j(x["mel2ph"]), _j(x["base_pitch"]),
                           **{k: _j(v) for k, v in kw.items()}, method=JM.pitch_condition)
            got = pm.pitch_condition(_p(x["cond"]), _p(x["mel2ph"]), _p(x["base_pitch"]),
                                     **{k: _p(v) for k, v in kw.items()})
            return got, ref
        if case.startswith("variance_condition"):
            retake = x["curve_retake"] if case.endswith("retake") else None
            ref = jm.apply(params, _j(x["cond"]), _j(x["pitch"]),
                           {k: _j(v) for k, v in x["curves"].items()},
                           variance_retake=None if retake is None
                           else {k: _j(v) for k, v in retake.items()},
                           method=JM.variance_condition)
            got = pm.variance_condition(_p(x["cond"]), _p(x["pitch"]),
                                        {k: _p(v) for k, v in x["curves"].items()},
                                        variance_retake=None if retake is None
                                        else {k: _p(v) for k, v in retake.items()})
            return got, ref
        if case in ("denoise_pitch", "denoise_variance"):
            xin = x["x_pitch"] if case == "denoise_pitch" else x["x_var"]
            ref = jm.apply(params, _j(xin), _j(x["t"]), _j(x["cond"]),
                           method=getattr(JM, case))
            got = getattr(pm, case)(_p(xin), _p(x["t"]), _p(x["cond"]))
            return got, ref
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "dur_predictor", "fs2_word_mode", "fs2_word_dur_from_ph_dur", "melody_encoder", "encode",
    "encode_spk", "frame_condition", "frame_condition_spk", "pitch_condition",
    "pitch_condition_expr", "pitch_condition_retake", "pitch_condition_melody",
    "pitch_condition_melody_retake", "variance_condition", "variance_condition_retake",
    "denoise_pitch", "denoise_variance",
])
def test_module_matches_jax(case, models):
    got, ref = _run_case(case, models)
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 0.1, "a near-zero output compares nothing"
    _close(got.numpy(), ref, case)


def test_fs2_phoneme_mode_matches_jax(tmp_path):
    """``predict_dur: false``: the phoneme-duration embedding, no duration head."""
    jcfg, pcfg, jm, params, pm = _pair(tmp_path, predict_dur=False)
    from xiaoicesing_io_tpu.models.toplevel import VarianceModel as JM

    x = _inputs()
    ref = jm.apply(params, _j(x["tokens"]), _j(x["midi"]), _j(x["ph2word"]),
                   ph_dur=_j(x["ph_dur"]), infer=True, method=JM.encode)
    with torch.no_grad():
        got = pm.encode(_p(x["tokens"]), _p(x["midi"]), _p(x["ph2word"]),
                        ph_dur=_p(x["ph_dur"]), infer=True)
    assert ref[1] is None and got[1] is None and "ph_dur_embed" in params["params"]["fs2"]
    _close(got[0].numpy(), ref[0], "encoder_out")


@pytest.mark.parametrize("head", ["pitch", "variances"])
def test_normalizers_match_jax(head, tmp_path):
    """Both normalizers, norm and denorm, with values beyond the clamps."""
    from xiaoicesing_io_tpu.models.toplevel import build_variance_normalizers as J
    from xiaoicesing_io_tpu_torch.models.toplevel import build_variance_normalizers as P

    jcfg, pcfg = _cfgs(tmp_path)
    jn, pn = J(jcfg)[head], P(pcfg)[head]
    rng = np.random.default_rng(4)
    n = 1 if head == "pitch" else 4
    lo, hi = (-20.0, 20.0) if head == "pitch" else (-120.0, 15.0)
    curves = [rng.uniform(lo, hi, (2, 30)).astype(np.float32) for _ in range(n)]
    ref = jn.norm(curves[0] if n == 1 else [_j(c) for c in curves])
    got = pn.norm(_p(curves[0]) if n == 1 else [_p(c) for c in curves])
    _close(got.numpy(), ref, "norm")
    x = rng.uniform(-1.6, 1.6, np.asarray(ref).shape).astype(np.float32)
    ref, got = jn.denorm(_j(x)), pn.denorm(_p(x))
    for r, g in zip([ref] if n == 1 else ref, [got] if n == 1 else got):
        _close(g.numpy(), r, "denorm")


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over", [
    dict(),
    dict(use_melody_encoder=True, use_glide_embed=True, use_spk_id=True, num_spk=3,
         diffusion_type="ddpm"),
    dict(predict_dur=False, predict_pitch=False),
], ids=["base", "melody_spk_ddpm", "curves_only"])
def test_variance_carrier_round_trip(over, tmp_path):
    """port state dict -> JAX convert_variance -> port carrier: identical."""
    from xiaoicesing_io_tpu.utils.torch_ckpt import convert_variance
    from xiaoicesing_io_tpu_torch.models.toplevel import VarianceModel
    from xiaoicesing_io_tpu_torch.utils.jax_weights import variance_state_dict_from_jax

    _, pcfg = _cfgs(tmp_path, **over)
    sd = _random_state(VarianceModel.from_config(pcfg, _vocab()))
    back = variance_state_dict_from_jax(convert_variance(sd, pcfg), pcfg)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy(), err_msg=k)


def test_reference_checkpoint_loads_strictly(tmp_path):
    """A checkpoint as the reference writes it: ``model.`` prefixes, the
    encoder's ``embed_tokens`` alias, ``in_proj_weight`` attention names and
    the diffusion cores' buffers (normalizer bounds, DDPM schedule) under
    ``pitch_predictor.`` and ``variance_predictor.``."""
    from xiaoicesing_io_tpu_torch.models.diffusion.schedule import DiffusionSchedule
    from xiaoicesing_io_tpu_torch.models.toplevel import (
        VarianceModel, load_variance_state_dict, reference_core_buffers,
    )

    _, pcfg = _cfgs(tmp_path, diffusion_type="ddpm", use_melody_encoder=True)
    src = VarianceModel.from_config(pcfg, _vocab())
    sd = _random_state(src)
    ref = {}
    for k, v in sd.items():
        ref["model." + k.replace(".self_attn.in_proj.weight", ".self_attn.in_proj_weight")] = v
    ref["model.fs2.encoder.embed_tokens.weight"] = sd["fs2.txt_embed.weight"]
    buffers = reference_core_buffers(DiffusionSchedule.create("linear", 1000))
    for core in ("pitch_predictor", "variance_predictor"):
        ref.update({f"model.{core}.{k}": v for k, v in buffers.items()})
        ref[f"model.{core}.spec_min"] = torch.zeros(1, 1, 1, 1)
        ref[f"model.{core}.spec_max"] = torch.ones(1, 1, 1, 1)
    assert any("pitch_predictor.denoise_fn." in k for k in ref)
    dst = VarianceModel.from_config(pcfg, _vocab())
    load_variance_state_dict(dst, ref)
    for k, v in dst.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_variance_state_dict(dst, dict(ref, **{"model.pitch_predictor.denoise_fn.extra.weight":
                                                   torch.zeros(1)}))


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

RUNNERS = {
    "reflow": dict(),
    "ddpm": dict(diffusion_type="ddpm", diff_speedup=250),  # 1000 steps, DDIM: 4
    "melody": dict(use_melody_encoder=True, use_glide_embed=True, use_spk_id=True, num_spk=2),
}


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """name -> (work dir, JAX cfg, port cfg): a tiny checkpoint per runner
    configuration; the runners are built per test, with their predictions."""
    out = {}
    for i, (name, over) in enumerate(RUNNERS.items()):
        wd = tmp_path_factory.mktemp(f"var_{name}")
        jcfg, pcfg, _, _, pm = _pair(wd, seed=10 + i, **over)
        _write_exp(wd, pm, spk=["a", "b"] if over.get("use_spk_id") else None)
        out[name] = (wd, jcfg, pcfg)
    return out


def _runner_pair(runners, name, predictions=()):
    from xiaoicesing_io_tpu.inference.variance import DiffSingerVarianceInfer as J
    from xiaoicesing_io_tpu_torch.inference.variance import DiffSingerVarianceInfer as P

    _, jcfg, pcfg = runners[name]
    return (J(jcfg, predictions=set(predictions)),
            P(pcfg, predictions=set(predictions), device="cpu"))


def _load(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _batches_equal(jb, pb):
    assert set(jb) == set(pb)
    for k in jb:
        if jb[k] is None:
            assert pb[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(pb[k]), np.asarray(jb[k]), err_msg=k)


@pytest.mark.parametrize("sample", [1, 4])
def test_preprocess_and_padding_match_jax(sample, runners, capsys):
    """Every segment of a sample ``.ds``, read with its durations and pitch,
    and without (the auto-completion of a bare score), with two speakers:
    the same arrays, and the same padded arrays."""
    jr, pr = _runner_pair(runners, "melody")
    for seg in _load(SAMPLES[sample]):
        bare = {k: v for k, v in seg.items() if k not in ("ph_dur", "f0_seq")}
        seg = dict(seg, spk_mix={"a": 0.3, "b": 0.7},
                   ph_spk_mix={"a": " ".join(["0.5"] * len(seg["ph_seq"].split())), "b": 0.5})
        for s, load in ((seg, True), (bare, False)):
            jb = jr.preprocess_input(s, load_dur=load, load_pitch=load)
            pb = pr.preprocess_input(s, load_dur=load, load_pitch=load)
            _batches_equal(jb, pb)
            jp, pp = jr._pad_batch(jb), pr._pad_batch(pb)
            assert jp[1:] == pp[1:]
            _batches_equal(jp[0], pp[0])
    assert "dynamic(a|b)" in capsys.readouterr().out


def _jax_noise(jr, batch, seed, ddpm):
    """The start noise of both heads as the JAX runner draws it."""
    padded = jr._pad_batch(batch)[0]
    T = padded["base_pitch"].shape[1]
    cfg = jr.cfg
    key = jax.random.PRNGKey(seed & 0xFFFFFFFF)
    keys = {"pitch": key, "variances": jax.random.fold_in(key, 1)}
    n = len(jr.model.variance_prediction_list)
    shapes = {"pitch": (1, 1, T, cfg["pitch_prediction_args"]["repeat_bins"]),
              "variances": (1, n, T, cfg["variances_prediction_args"]["total_repeat_bins"] // n)}
    return {h: np.asarray(jax.random.normal(jax.random.split(k)[1] if ddpm else k, shapes[h],
                                            jnp.float32)) for h, k in keys.items()}


SEGMENTS = {
    # (runner, predictions, keys dropped from the segment, extra keys, expected flags)
    "reflow_auto": ("reflow", (), ("ph_dur", "f0_seq"), {}, (True, True, True)),
    "ddpm_auto": ("ddpm", (), ("ph_dur", "f0_seq"), {}, (True, True, True)),
    "reflow_predict_pitch_curves": ("reflow", ("pitch", "energy", "tension"), (), {},
                                    (False, True, True)),
    "reflow_predict_curve_given_pitch": ("reflow", ("breathiness",), (), {},
                                         (False, False, True)),
    "melody_expr_spk": ("melody", ("dur", "pitch"), ("ph_dur",),
                        {"expr": 0.6, "spk_mix": {"a": 0.25, "b": 0.75},
                         "ph_spk_mix": {"a": 0.25, "b": 0.75}}, (True, True, False)),
    "ddpm_dur_only": ("ddpm", ("dur",), ("ph_dur",), {}, (True, False, False)),
}


@pytest.mark.parametrize("case", list(SEGMENTS))
def test_ds_segment_matches_jax(case, runners):
    """One ``.ds`` segment: the same flags, durations equal in frames, pitch
    and curves within the module bar."""
    name, predictions, drop, extra, flags = SEGMENTS[case]
    jr, pr = _runner_pair(runners, name, predictions)
    seg = {k: v for k, v in _load(SAMPLES[0])[1].items() if k not in drop}
    seg.update(extra)
    if name == "melody":  # every glide type in turn
        seg["note_glide"] = " ".join(("none", "up", "down")[i % 3]
                                     for i in range(len(seg["note_seq"].split())))
    assert jr.segment_flags(seg) == pr.segment_flags(seg) == flags
    kw = dict(load_dur=not flags[0] and (flags[1] or flags[2]),
              load_pitch=not flags[1] and flags[2])
    jb, pb = jr.preprocess_input(seg, **kw), pr.preprocess_input(seg, **kw)
    seed = 77
    jd, jp, jv = jr.forward_model(jb, flags, seed=seed)
    pd, pp, pv = pr.forward_model(pb, flags, seed=seed,
                                  noise=_jax_noise(jr, jb, seed, name == "ddpm"))
    if flags[0]:
        np.testing.assert_array_equal(pd, np.asarray(jd))
        assert pd.sum() > 0
    else:
        assert pd is None and jd is None
    if flags[1]:
        _close(pp, jp, "pitch")
        assert np.ptp(pp) > 1.0
    else:
        assert pp is None and jp is None
    assert set(pv) == set(jv) == (set(CURVES) if flags[2] else set())
    for k in pv:
        _close(pv[k], jv[k], k)


def test_run_inference_ds_matches_jax(runners, tmp_path):
    """Two bare segments through ``run_inference`` in auto-completion mode,
    the port fed the JAX runner's noise.  The written ``.ds`` holds the same
    segments and keys; every string but the predicted f0 and curves is
    equal, durations included.  f0 (written to 0.1 Hz) and the curves (to 4
    digits) agree to one unit of their last digit: the two f32 computations
    differ by up to ~1e-4 before rounding (the module bar), so a value near a
    rounding boundary may round either way."""
    jr, pr = _runner_pair(runners, "reflow")
    segs = [{k: v for k, v in s.items() if k not in ("ph_dur", "f0_seq")}
            for s in _load(SAMPLES[0])[:2]]
    seed = 5
    jr.run_inference(segs, tmp_path / "jax", "song", seed=seed)
    flags = [pr.segment_flags(s) for s in segs]
    noise = [_jax_noise(jr, jr.preprocess_input(s, load_dur=not f[0] and (f[1] or f[2]),
                                                load_pitch=not f[1] and f[2]),
                        seed + i, False) for i, (s, f) in enumerate(zip(segs, flags))]
    (path,) = pr.run_inference(segs, tmp_path / "port", "song", seed=seed, noise=noise)
    got, ref = _load(path), _load(tmp_path / "jax" / "song.ds")
    assert [list(g) for g in got] == [list(r) for r in ref]
    rounded = {"f0_seq": 0.1, **{v: 1e-4 for v in CURVES}}
    changed = 0
    for g, r in zip(got, ref):
        assert all(k in g for k in ("ph_dur", "f0_seq", *CURVES))
        for k in g:
            if k not in rounded:
                assert g[k] == r[k], k
                continue
            gv, rv = (np.array(x.split(), np.float64) for x in (g[k], r[k]))
            assert gv.shape == rv.shape, k
            np.testing.assert_allclose(gv, rv, rtol=0, atol=rounded[k] * 1.001, err_msg=k)
            changed += int((gv != rv).sum())
    values = sum(len(g[k].split()) for g in got for k in rounded)
    assert changed < 0.05 * values, (changed, values)


def test_cli_predict_dur_equals_jax(runners, tmp_path, monkeypatch):
    """``infer variance <ds> --exp E --predict dur --device cpu`` writes the
    ``.ds`` the JAX command writes from the same weights (the duration head
    samples nothing)."""
    from click.testing import CliRunner

    from xiaoicesing_io_tpu.cli.main import cli as jax_cli
    from xiaoicesing_io_tpu_torch import cli

    wd, jcfg, _ = runners["reflow"]
    root = tmp_path / "checkpoints"
    (root / "exp").mkdir(parents=True)
    for f in wd.iterdir():
        (root / "exp" / f.name).symlink_to(f)
    import yaml

    (root / "exp" / "config.yaml").write_text(yaml.safe_dump(json.loads(json.dumps(
        {k: v for k, v in dict(jcfg).items() if k not in ("work_dir", "infer")}))))
    ds = tmp_path / "song.ds"
    ds.write_text(json.dumps(_load(SAMPLES[0])[:2], ensure_ascii=False), encoding="utf8")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    res = CliRunner().invoke(jax_cli, ["infer", "variance", str(ds), "--exp", "exp",
                                       "--predict", "dur", "--out", "jax", "--seed", "3"])
    assert res.exit_code == 0, res.output
    cli.main(["infer", "variance", str(ds), "--exp", "exp", "--predict", "dur", "--out", "port",
              "--seed", "3", "--device", "cpu"])
    got, ref = (tmp_path / "port" / "song.ds").read_text(encoding="utf8"), \
        (tmp_path / "jax" / "song.ds").read_text(encoding="utf8")
    assert json.loads(got)[0]["ph_dur"] != _load(SAMPLES[0])[0]["ph_dur"]
    assert got == ref
