"""The acoustic runner's optional inputs against the JAX runner, on the CPU.

Speakers (``use_spk_id``: solo, static and dynamic mixes), the variance
curves (``use_{energy,breathiness,voicing,tension}_embed``), ``gender`` ->
``key_shift`` (static and dynamic) and ``velocity`` -> ``speed``.  A tiny
random acoustic model is saved as a reference-format checkpoint with a
speaker map; the JAX runner loads it through its own torch converter and
the port's runner through ``load_state_dict``.  Both runners preprocess the
same ``.ds`` segment into the same arrays, and the port, given the start
noise the JAX runner draws, gives its mel within the module bar 2e-4.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SAMPLE = sorted((ROOT / "samples").glob("00_*.ds"))[0]
DICT = ROOT / "dictionaries" / "opencpop-extension.txt"
CURVES = ("energy", "breathiness", "voicing", "tension")
SPEAKERS = {"alto": 0, "tenor": 1, "bass": 2}

TINY = dict(
    hidden_size=32, enc_layers=1, num_heads=2, sampling_steps=3,
    backbone_args={"num_channels": 128, "num_layers": 2, "kernel_size": 31,
                   "dropout_rate": 0.0, "strong_cond": True},
)
# every optional input, and each variance curve alone
CONFIGS = {
    "all": dict(use_spk_id=True, num_spk=3, use_key_shift_embed=True, use_speed_embed=True,
                **{f"use_{v}_embed": True for v in CURVES}),
    **{v: {f"use_{v}_embed": True} for v in CURVES},
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on shared cores; torch's
    intra-op threads then oversubscribe them and its convolutions slow down
    many-fold.  One thread per test, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(cfg, work_dir, over):
    cfg.update(work_dir=str(work_dir), dictionary=str(DICT), **TINY, **over)
    cfg["backbone_args"] = dict(TINY["backbone_args"])
    cfg["shallow_diffusion_args"]["aux_decoder_args"].update(num_channels=32, num_layers=1,
                                                            dropout_rate=0.0)
    return cfg


def _cfgs(work_dir, over):
    from xiaoicesing_io_tpu.config import load_config
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults

    return (_tiny(load_config(ROOT / "xiaoicesing_io_tpu/configs/acoustic.yaml"), work_dir, over),
            _tiny(acoustic_defaults(), work_dir, over))


@pytest.fixture(scope="module")
def exps(tmp_path_factory):
    """config name -> (JAX cfg, port cfg) of a random tiny checkpoint."""
    from xiaoicesing_io_tpu_torch.training.acoustic import build_acoustic
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    vocab = TokenTextEncoder(PhonemeDictionary.load(DICT).phoneme_list).vocab_size
    out = {}
    for i, (name, over) in enumerate(CONFIGS.items()):
        wd = tmp_path_factory.mktemp(f"acoustic_{name}")
        jcfg, pcfg = _cfgs(wd, over)
        torch.manual_seed(i)
        model, _, _ = build_acoustic(pcfg, vocab)
        with torch.no_grad():
            # zero-initialised output projection and 1e-6 ConvNeXt layer
            # scales would hide the denoiser and the aux blocks
            model.backbone.output_projection.weight.normal_(0.0, 0.05)
            for block in model.aux_decoder.decoder.conv:
                block.gamma.normal_(0.0, 0.5)
        sd = {f"model.{k}": v for k, v in model.state_dict().items()}
        torch.save({"category": "acoustic", "state_dict": sd}, wd / "model_ckpt_steps_100.ckpt")
        (wd / "spk_map.json").write_text(json.dumps(SPEAKERS))
        out[name] = (jcfg, pcfg)
    return out


def _curve(rng, n, lo, hi):
    return " ".join(f"{x:.3f}" for x in rng.uniform(lo, hi, n))


def _segment(case: str) -> dict:
    """The sample's first segment with every curve the configurations read
    (at their own timesteps), and the case's speaker, gender and velocity."""
    with open(SAMPLE, encoding="utf-8") as f:
        seg = json.load(f)[0]
    rng = np.random.default_rng(11)
    seconds = sum(float(d) for d in seg["ph_dur"].split())
    for v, (lo, hi) in zip(CURVES, ((-70, -20), (-90, -30), (-80, -15), (-4, 4))):
        seg[v] = _curve(rng, int(seconds / 0.01) + 2, lo, hi)
        seg[f"{v}_timestep"] = "0.01"
    if case == "spk_solo":
        seg["spk_mix"] = {"bass": 1.0}
    elif case == "spk_static":
        seg["spk_mix"] = {"alto": 0.2, "tenor": 0.5, "bass": 0.3}
    elif case == "spk_dynamic":
        seg["spk_mix"] = {"alto": _curve(rng, int(seconds / 0.05) + 2, 0.0, 1.0),
                          "bass": 0.4, "tenor": _curve(rng, int(seconds / 0.05) + 2, 0.0, 0.5)}
        seg["spk_mix_timestep"] = "0.05"
    elif case.startswith("gender_static"):
        seg["gender"] = 0.4 if case.endswith("up") else -0.7
    elif case == "gender_dynamic":
        seg["gender"] = _curve(rng, int(seconds / 0.02) + 2, -1.2, 1.2)
        seg["gender_timestep"] = "0.02"
    elif case == "velocity":
        seg["velocity"] = _curve(rng, int(seconds / 0.02) + 2, 0.3, 2.5)
        seg["velocity_timestep"] = "0.02"
    return seg


def _mels(exps, config, seg, seed=321):
    """(port mel, JAX mel, port batch, JAX batch) of one segment."""
    from xiaoicesing_io_tpu.inference.acoustic import DiffSingerAcousticInfer as JInfer
    from xiaoicesing_io_tpu_torch.inference.acoustic import (
        DiffSingerAcousticInfer as PInfer, _bucket,
    )

    jcfg, pcfg = exps[config]
    jr = JInfer(jcfg, load_vocoder=False)
    pr = PInfer(pcfg, load_vocoder=False, device="cpu")
    jb, pb = jr.preprocess_input(seg), pr.preprocess_input(seg)
    assert set(jb) == set(pb)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(pb[k]), np.asarray(jb[k]), err_msg=k)
    length = jb["mel2ph"].shape[1]
    ref = jr.forward_model(jb, seed=seed)
    # the JAX runner's start noise: jax.random.normal on the raw key, over the bucket
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1, 1, _bucket(length), 128),
                                         jnp.float32))
    return pr.forward_model(pb, noise=noise), ref, pb, jb


@pytest.mark.parametrize("config,case", [
    ("all", "spk_default_solo"), ("all", "spk_solo"), ("all", "spk_static"),
    ("all", "spk_dynamic"), ("all", "gender_static_up"), ("all", "gender_static_down"),
    ("all", "gender_dynamic"), ("all", "velocity"),
    *[(v, "curve") for v in CURVES],
])
def test_mel_matches_jax(exps, config, case, capsys):
    """One segment with the case's inputs: the same batch and the same mel."""
    got, ref, pb, _ = _mels(exps, config, _segment(case))
    extra = {config} if config in CURVES else {*CURVES, "spk_mix_id", "spk_mix_value",
                                               "key_shift", "speed"}
    assert set(pb) == {"tokens", "mel2ph", "f0", *extra}
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(ref).max() > 1.0  # random weights: not a near-zero mel
    # f32 on both sides, differing in summation order only: the module bar
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    out = capsys.readouterr().out
    if case == "spk_dynamic":
        assert "dynamic(alto|bass|tenor)" in out and pb["spk_mix_value"].shape[1] > 1
    if case == "velocity":
        speed = pb["speed"]
        assert speed.min() >= 0.5 and speed.max() <= 2.0 and "velocity: manual" in out
    if case == "gender_dynamic":
        assert pb["key_shift"].min() >= -5.0 and pb["key_shift"].max() <= 5.0


def test_inputs_move_the_mel(exps):
    """Each input reaches the mel: a change of speaker, gender or velocity
    changes it."""
    base, _, _, _ = _mels(exps, "all", _segment("spk_default_solo"))
    for case in ("spk_solo", "gender_static_up", "velocity"):
        got, _, _, _ = _mels(exps, "all", _segment(case))
        assert np.abs(got - base).max() > 1e-2, case


@pytest.mark.parametrize("mode,mix,length", [
    ("frame", None, 7), ("token", {"tenor": 1.0}, 5),
    ("frame", {"alto": 0.3, "bass": 0.9}, 7),
    ("token", {"alto": "0.1 0.2 0.3 0.0 1.0", "tenor": 0.5}, 5),
    ("frame", {"alto": "0 1 0.5", "bass": "1 0 0.5"}, 12),
    # the checks: an unknown speaker, negative or zero proportions, a token
    # curve of the wrong length
    ("frame", {"soprano": 1.0, "alto": 1.0}, 7), ("frame", {"alto": -0.5, "bass": 1.0}, 7),
    ("frame", {"alto": 0.0, "bass": 0.0}, 7), ("token", {"alto": "1 -1 1", "bass": 0.2}, 3),
    ("token", {"alto": "1 1", "bass": 0.2}, 3), ("frame", {"alto": "0 0", "bass": "0 0"}, 4),
])
def test_load_speaker_mix_matches_jax(mode, mix, length, tmp_path):
    """Ids and proportions, and the same refusals, as the JAX runner's."""
    from xiaoicesing_io_tpu.inference.base import BaseSVSInfer as J
    from xiaoicesing_io_tpu_torch.inference.base import BaseSVSInfer as P

    (tmp_path / "spk_map.json").write_text(json.dumps(SPEAKERS))
    cfg = {"hop_size": 512, "audio_sample_rate": 44100, "use_spk_id": True,
           "work_dir": str(tmp_path)}
    param = {} if mix is None else {("spk_mix" if mode == "frame" else "ph_spk_mix"): mix,
                                    "spk_mix_timestep": "0.1"}
    try:
        ref = J(cfg).load_speaker_mix(param, {}, mix_mode=mode, mix_length=length)
    except AssertionError as e:
        with pytest.raises(AssertionError) as got:
            P(cfg).load_speaker_mix(param, {}, mix_mode=mode, mix_length=length)
        assert str(got.value) == str(e)
        return
    summary = {}
    got = P(cfg).load_speaker_mix(param, summary, mix_mode=mode, mix_length=length)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert summary


@pytest.mark.parametrize("spk_map", [{}, {"a": 0, "b": 0}, ["a"]])
def test_bad_speaker_map_refused(spk_map, tmp_path):
    from xiaoicesing_io_tpu_torch.inference.base import BaseSVSInfer

    (tmp_path / "spk_map.json").write_text(json.dumps(spk_map))
    with pytest.raises(AssertionError, match="speaker map|Duplicate"):
        BaseSVSInfer({"hop_size": 512, "audio_sample_rate": 44100, "use_spk_id": True,
                      "work_dir": str(tmp_path)})


def test_acoustic_carrier_round_trip_with_inputs(exps):
    """The optional inputs' weights (``fs2.spk_embed``, ``fs2.variance_embeds.*``,
    ``fs2.key_shift_embed``, ``fs2.speed_embed``): port state dict -> JAX
    ``convert_acoustic`` -> port carrier, identical."""
    from xiaoicesing_io_tpu.utils.torch_ckpt import convert_acoustic
    from xiaoicesing_io_tpu_torch.training.acoustic import build_acoustic
    from xiaoicesing_io_tpu_torch.utils.jax_weights import acoustic_state_dict_from_jax
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    _, pcfg = exps["all"]
    vocab = TokenTextEncoder(PhonemeDictionary.load(DICT).phoneme_list).vocab_size
    sd = build_acoustic(pcfg, vocab)[0].state_dict()
    for name in ("fs2.spk_embed.weight", "fs2.key_shift_embed.weight", "fs2.speed_embed.weight",
                 *(f"fs2.variance_embeds.{v}.weight" for v in CURVES)):
        assert name in sd, name
    back = acoustic_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               convert_acoustic(sd, pcfg)), pcfg)
    want = {k: v for k, v in sd.items() if k != "fs2.encoder.embed_tokens.weight"}
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
