"""The port's ``export acoustic`` against the JAX package's, on the CPU.

One reference ``model_ckpt_steps_*.ckpt`` of a tiny random acoustic model
(speakers, key shift, speed and an energy curve embedded) is exported by
both packages (JAX with ``fmt="onnx"``): LYNXNet + rectified flow with its
inputs open and ``--export_spk``, and WaveNet + DDPM with gender, velocity
and a speaker mix frozen.  Both write the same files, manifest and input
surface.  The partial graphs ``fs2_aux`` and ``diffusion_step`` give the
same outputs at 2e-4 on one feed dict, and the merged, loop-bearing
``acoustic.onnx`` the same mel under the same executor noise (1e-4 for
reflow, 5e-4 for DDPM, the JAX package's own bars), through both
executors.

The JAX converter lowers ``ne`` to ``Equal`` without a ``Not``
(``deployment/onnx_export.py:515``), which turns the softplus of the
WaveNet's Mish into the identity: its WaveNet graphs are off by ~1 where
its modules are right.  So the WaveNet graphs are held against the JAX
package's modules and sampler, and a test pins the fault.
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
TOL = 2e-4
SPK = {"alice": 0, "bob": 1}
KINDS = {
    "reflow": dict(export_spk=["duet=alice:0.6|bob:0.4", "bob"]),
    "ddpm": dict(freeze_gender=0.5, freeze_velocity=1.2, freeze_spk="alice:0.3|bob:0.7"),
}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on shared cores; torch's
    intra-op threads would oversubscribe them.  Two threads a test."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny(cfg, work_dir, kind):
    cfg.update(work_dir=str(work_dir), dictionary=str(DICT), hidden_size=32, enc_layers=1,
               num_heads=2, use_spk_id=True, num_spk=2, use_key_shift_embed=True,
               use_speed_embed=True, use_energy_embed=True)
    if kind == "ddpm":
        cfg.update(diffusion_type="ddpm", backbone_type="wavenet")
        cfg["backbone_args"] = {"num_channels": 64, "num_layers": 2,
                                "dilation_cycle_length": 2}
    else:
        cfg["backbone_args"] = {"num_channels": 64, "num_layers": 2, "kernel_size": 31,
                                "dropout_rate": 0.0, "strong_cond": True}
    cfg["shallow_diffusion_args"]["aux_decoder_args"].update(num_channels=32, num_layers=1,
                                                            dropout_rate=0.0)
    return cfg


def _vocab():
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    return TokenTextEncoder(PhonemeDictionary.load(DICT).phoneme_list).vocab_size


def _random_state(model, seed=0):
    """Every tensor drawn with numpy: matrices at 1 / sqrt(fan-in), norm
    scales around 1, biases around 0 (no zero-initialised projection or
    1e-6 layer scale left to hide a block)."""
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
    return sd


@pytest.fixture(scope="module", params=sorted(KINDS))
def exported(request, tmp_path_factory):
    """Both packages' exports of one checkpoint."""
    from xiaoicesing_io_tpu.config import load_config
    from xiaoicesing_io_tpu.deployment.export import export_acoustic as jax_export
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults
    from xiaoicesing_io_tpu_torch.deployment.export import export_acoustic
    from xiaoicesing_io_tpu_torch.models.toplevel import AcousticModel

    kind = request.param
    wd = tmp_path_factory.mktemp(f"acoustic_{kind}")
    pcfg = _tiny(acoustic_defaults(), wd, kind)
    jcfg = _tiny(load_config(ROOT / "xiaoicesing_io_tpu/configs/acoustic.yaml"), wd, kind)
    sd = _random_state(AcousticModel.from_config(pcfg, _vocab()))
    torch.save({"category": "acoustic", "state_dict": {f"model.{k}": v for k, v in sd.items()}},
               wd / "model_ckpt_steps_100.ckpt")
    (wd / "spk_map.json").write_text(json.dumps(SPK))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        port = export_acoustic(pcfg, out_dir=str(wd / "port"), **KINDS[kind])
    finally:
        torch.set_num_threads(n)
    ref = jax_export(jcfg, out_dir=str(wd / "jax"), fmt="onnx", **KINDS[kind])
    return SimpleNamespace(kind=kind, wd=wd, port=port, jax=ref, pcfg=pcfg, jcfg=jcfg)


def _graphs(ex, name):
    return (parse_model((ex.port / f"{name}.onnx").read_bytes())[0],
            jax_parse((ex.jax / f"{name}.onnx").read_bytes())[0])


def _feeds(graph, rng, kind):
    """One feed dict for ``graph``'s inputs, by their names (the standalone
    graphs' inputs are ``in0``...: tokens, mel2ph, f0, curves)."""
    feeds = {}
    order = {"in0": "tokens", "in1": "mel2ph", "in2": "f0"}
    for name, _, shape in graph.inputs:
        what = order.get(name, name)
        if what == "tokens":
            a = rng.integers(1, _vocab(), shape).astype(np.int32)
        elif what == "mel2ph":
            a = np.sort(rng.integers(0, 65, shape), axis=1).astype(np.int32)
        elif what == "f0":
            a = rng.uniform(80, 900, shape).astype(np.float32)
        elif what == "depth":
            a = np.asarray(0.6, np.float32)
        elif what == "steps":
            a = np.asarray(3, np.int64)
        elif what == "speed":
            a = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        else:
            a = rng.standard_normal(shape).astype(np.float32)
        feeds[name] = a
    return feeds


def _run_both(pg, jg, feeds, seed=0):
    """-> (port graph in port executor, port graph in JAX executor, JAX
    graph in port executor, JAX graph in JAX executor)."""
    return [run(g, feeds, rng=np.random.default_rng(seed))
            for g, run in ((pg, run_graph), (pg, jax_run), (jg, run_graph), (jg, jax_run))]


def test_files_and_manifest_match_jax(exported):
    names = sorted(p.name for p in exported.port.iterdir())
    assert names == sorted(p.name for p in exported.jax.iterdir())
    assert {"fs2_aux.onnx", "diffusion_step.onnx", "acoustic.onnx", "dsconfig.yaml",
            "phonemes.txt", "dictionary.txt", "alice.emb", "bob.emb"} <= set(names)
    port = yaml.safe_load((exported.port / "dsconfig.yaml").read_text())
    ref = yaml.safe_load((exported.jax / "dsconfig.yaml").read_text())
    assert port == ref
    assert port["acoustic_merged"] == "acoustic.onnx"
    frozen = ["key_shift", "speed", "spk_mix_embed"] if exported.kind == "ddpm" else []
    assert port["frozen"] == frozen
    for name in ("phonemes.txt", "dictionary.txt"):
        assert (exported.port / name).read_bytes() == (exported.jax / name).read_bytes()


def test_attachments_match_jax(exported):
    embs = sorted(p.name for p in exported.port.glob("*.emb"))
    expected = ["alice.emb", "bob.emb"] + (["duet.emb"] if exported.kind == "reflow" else [])
    assert embs == expected
    for name in embs:
        got = np.frombuffer((exported.port / name).read_bytes(), np.float32)
        ref = np.frombuffer((exported.jax / name).read_bytes(), np.float32)
        assert got.shape == (32,)
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["fs2_aux", "diffusion_step", "acoustic"])
def test_input_surface_matches_jax(exported, name):
    pg, jg = _graphs(exported, name)
    assert pg.inputs == jg.inputs
    assert [(n, s) for n, _, s in pg.outputs] == [(n, s) for n, _, s in jg.outputs]
    merged = ["tokens", "mel2ph", "f0", "energy"]
    if exported.kind == "reflow":
        merged += ["key_shift", "speed", "spk_mix_embed"]
    if name == "acoustic":
        assert [n for n, _, _ in pg.inputs] == merged + ["depth", "steps"]
        assert any(n.op_type == "Loop" for n in pg.nodes)


def test_fs2_aux_matches_jax(exported):
    pg, jg = _graphs(exported, "fs2_aux")
    outs = _run_both(pg, jg, _feeds(pg, np.random.default_rng(1), exported.kind))
    ref = outs[-1]
    assert np.abs(ref["out0"]).max() > 1.0  # random weights: not a near-zero condition
    for out in outs[:-1]:
        for k in ref:
            np.testing.assert_allclose(out[k], ref[k], atol=TOL, rtol=0, err_msg=k)


def _jax_model(ex):
    from xiaoicesing_io_tpu.training.acoustic import build_acoustic
    from xiaoicesing_io_tpu.training.checkpoint import load_params_for_inference

    model, core, normalizer = build_acoustic(ex.jcfg, _vocab())
    return model, core, normalizer, load_params_for_inference(ex.wd, ex.jcfg)


def test_diffusion_step_matches_jax(exported):
    """Both executors give the JAX package's denoiser.  For LYNXNet the JAX
    graph agrees too; for WaveNet the JAX converter's ``ne`` -> ``Equal``
    flips the softplus in the Mish, and its graph departs from its module
    by far more than any bar."""
    from xiaoicesing_io_tpu.models.toplevel import AcousticModel

    pg, jg = _graphs(exported, "diffusion_step")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 1, 512, 128)).astype(np.float32)
    t = np.asarray([370.0 if exported.kind == "reflow" else 37.0], np.float32)
    c = rng.standard_normal((1, 512, 32)).astype(np.float32)
    model, _, _, params = _jax_model(exported)
    ref = np.asarray(model.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c),
                                 method=AcousticModel.denoise))
    assert np.abs(ref).max() > 0.5
    outs = _run_both(pg, jg, {"in0": x, "in1": t, "in2": c})
    for out in outs[:2]:
        np.testing.assert_allclose(out["out0"], ref, atol=TOL, rtol=0)
    for out in outs[2:]:
        if exported.kind == "reflow":
            np.testing.assert_allclose(out["out0"], ref, atol=TOL, rtol=0)
        else:
            assert np.abs(out["out0"] - ref).max() > 0.1


def _pipeline(ex, feeds, depth, steps, seed):
    """The JAX package's modules and sampler on ``feeds``, started from the
    executor's noise draw: the mel the merged graph must give."""
    from xiaoicesing_io_tpu.models.diffusion.core import GaussianDiffusion
    from xiaoicesing_io_tpu.models.toplevel import AcousticModel

    model, core, normalizer, params = _jax_model(ex)
    kw = {k: jnp.asarray(v) for k, v in feeds.items() if k not in ("depth", "steps")}
    shift_max = ex.jcfg["augmentation_args"]["random_pitch_shifting"]["range"][1]
    frozen = {"key_shift": KINDS["ddpm"]["freeze_gender"] * shift_max,
              "speed": KINDS["ddpm"]["freeze_velocity"]}
    for k, v in frozen.items():
        if k not in kw:
            kw[k] = jnp.full((1, 1), v, jnp.float32)
    if "spk_mix_embed" not in kw:
        table = np.asarray(params["params"]["fs2"]["spk_embed"]["embedding"])
        kw["spk_mix_embed"] = jnp.asarray(0.3 * table[0] + 0.7 * table[1])[None, None]
    variances = {"energy": kw.pop("energy")}
    c = model.apply(params, kw.pop("tokens"), kw.pop("mel2ph"), kw.pop("f0"),
                    variances=variances, **kw, method=AcousticModel.condition)
    aux = model.apply(params, c, method=AcousticModel.aux_out)
    shape = (1, 1, 512, 128)
    noise = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)

    def den(x, t):
        return model.apply(params, x, t, c, method=AcousticModel.denoise)

    if isinstance(core, GaussianDiffusion):
        depth_t = min(round(depth * core.timesteps), core.k_step)
        speedup = max(1, depth_t // steps)
        x = core.inference(den, jax.random.PRNGKey(0), shape, x_start=aux[:, None],
                           depth=depth_t // speedup * speedup, speedup=speedup,
                           algorithm="ddim", noise=jnp.asarray(noise))
    else:
        x = core.inference(den, jax.random.PRNGKey(0), shape, x_end=aux[:, None],
                           t_start=max(1.0 - depth, core.t_start), steps=steps,
                           algorithm="euler", noise=jnp.asarray(noise))
    return np.asarray(normalizer.denorm(x)), np.asarray(normalizer.denorm(aux[:, None]))


def test_merged_acoustic_matches_jax(exported):
    """The merged graph's mel under one executor seed equals the JAX
    package's sampler started from the same draw (and, for reflow, the JAX
    package's merged graph); at depth 0 it is the aux decoder's mel."""
    pg, jg = _graphs(exported, "acoustic")
    feeds = _feeds(pg, np.random.default_rng(4), exported.kind)
    feeds.update(depth=np.asarray(0.6, np.float32), steps=np.asarray(3, np.int64))
    ref, aux = _pipeline(exported, feeds, 0.6, 3, seed=5)
    atol = 1e-4 if exported.kind == "reflow" else 5e-4
    outs = _run_both(pg, jg, feeds, seed=5)
    for out in outs[:2] + (outs[2:] if exported.kind == "reflow" else []):
        np.testing.assert_allclose(out["mel"], ref, atol=atol, rtol=1e-4)
    assert np.abs(outs[0]["mel"] - aux).max() > 0.1  # the loop moved the start
    feeds["depth"] = np.asarray(0.0, np.float32)
    for run in (run_graph, jax_run):
        np.testing.assert_allclose(run(pg, feeds, rng=np.random.default_rng(0))["mel"], aux,
                                   atol=1e-4, rtol=1e-4)
