"""The JAX-checkpoint bridge against the JAX package, on the CPU.

Each JAX checkpoint here is made by the JAX package itself: tiny random
weights (numpy, carried into flax by its own converter), its
``build_optimizer`` (with ``wrap_optimizer_with_freezing`` where the case
freezes), two updates from seeded gradient trees, and its
``CheckpointManager.save`` (orbax).  Four runs: the plain chain, gradient
accumulation (``MultiSteps``), accumulation under freezing
(``multi_transform``), and a variance model with speakers.

* The reader: the port's ``read_checkpoint`` equals orbax's own restore leaf
  for leaf, bit for bit, ``None`` and empty states included.
* The port's copy of ``utils/torch_ckpt.py`` equals the JAX package's bit
  for bit; the bridge's self-check raises on a leaf it cannot account for.
* Resume: the converted AdamW state is the carriers of ``mu`` and ``nu``
  bit for bit, with ``step`` = ``count``; the inverse gives back the orbax
  tree bit for bit; two more updates on both sides from the same gradients
  agree within 1e-5 of each tensor's scale (the bar of
  ``test_torch_train_step.py``'s optimizer test).
* The runners: JAX's from the orbax work dir, the port's from the directory
  and from the converted file (without ``tensorstore``), the same mel
  within 2e-4 from the same noise.
* Finetuning and ``drop_spk`` from a directory against JAX's; the
  refusals; the loader's precedence; ``cli convert_ckpt``.
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
DICT = ROOT / "dictionaries" / "opencpop-extension.txt"
SAMPLES = sorted((ROOT / "samples").glob("*.ds"))
CURVES = ("energy", "breathiness", "voicing", "tension")
PARAM_TOL = 1e-5
MEL_TOL = 2e-4
STEP = 2

LYNX = {"backbone_type": "lynxnet", "diffusion_type": "reflow", "sampling_steps": 4,
        "backbone_args": {"num_channels": 64, "num_layers": 2, "kernel_size": 31,
                          "dropout_rate": 0.0, "strong_cond": True}}
WAVENET = {"backbone_type": "wavenet", "diffusion_type": "ddpm", "K_step": 300,
           "backbone_args": {"num_channels": 64, "num_layers": 4, "dilation_cycle_length": 2}}
FROZEN = ["fs2.encoder", "model.fs2.txt_embed"]
RUNS = {
    "plain": ("acoustic", {}),
    "accum": ("acoustic", {"accumulate_grad_batches": 2}),
    "frozen_accum": ("acoustic", {"accumulate_grad_batches": 2, "freezing_enabled": True,
                                  "frozen_params": FROZEN}),
    "variance": ("variance", {"use_spk_id": True, "num_spk": 3}),
}
SPEAKERS = {"a": 0, "b": 1, "c": 2}
# one jitted update for the runs and their resumes: a run compiles it once
APPLY = jax.jit(lambda s, g: s.apply_gradients(g))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several worker processes share the cores: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(category, work_dir, **over):
    """(JAX config, port config) at tiny widths, f32."""
    from xiaoicesing_io_tpu.config import load_config
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults, variance_defaults

    out = []
    if category == "acoustic":
        pairs = (load_config(ROOT / "xiaoicesing_io_tpu/configs/acoustic.yaml"),
                 acoustic_defaults())
    else:
        pairs = (load_config(ROOT / "xiaoicesing_io_tpu/configs/variance.yaml"),
                 variance_defaults())
    for cfg in pairs:
        cfg.update(work_dir=str(work_dir), dictionary=str(DICT), hidden_size=32, enc_layers=1,
                   num_heads=2, dropout=0.0, precision="fp32")
        if category == "acoustic":
            cfg.update({k: (dict(v) if isinstance(v, dict) else v) for k, v in LYNX.items()})
            cfg["shallow_diffusion_args"]["aux_decoder_args"].update(
                num_channels=32, num_layers=1, dropout_rate=0.0)
        else:
            cfg.update(sampling_steps=3, **{f"predict_{v}": True for v in CURVES})
            cfg["dur_prediction_args"].update(hidden_size=32, num_layers=2)
            cfg["pitch_prediction_args"].update(repeat_bins=8)
            cfg["pitch_prediction_args"]["backbone_args"].update(
                num_layers=3, num_channels=16, dilation_cycle_length=2)
            cfg["variances_prediction_args"].update(total_repeat_bins=8)
            cfg["variances_prediction_args"]["backbone_args"].update(num_layers=2,
                                                                     num_channels=16)
        for k, v in over.items():
            cfg[k] = dict(cfg.get(k, {}), **v) if isinstance(v, dict) else v
        out.append(cfg)
    return out


def _vocab():
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    return TokenTextEncoder(PhonemeDictionary.load(DICT).phoneme_list).vocab_size


def _port_model(category, pcfg):
    from xiaoicesing_io_tpu_torch.models.toplevel import AcousticModel, VarianceModel

    return (AcousticModel if category == "acoustic" else VarianceModel).from_config(
        pcfg, _vocab())


def _random_state(model, seed=0):
    """Every tensor of ``model``'s state dict drawn with numpy: matrices at
    1 / sqrt(fan-in), norm scales around 1, biases around 0; the duration
    head's bias at 1.5 (durations exp(x) - 1 well above 0)."""
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


def _jax_convert(category, sd, jcfg):
    from xiaoicesing_io_tpu.utils.torch_ckpt import convert_acoustic, convert_variance

    conv = convert_acoustic if category == "acoustic" else convert_variance
    return jax.tree_util.tree_map(np.asarray, conv(sd, jcfg))["params"]


def _carry(category, tree, pcfg):
    from xiaoicesing_io_tpu_torch.utils.jax_weights import (
        acoustic_state_dict_from_jax, variance_state_dict_from_jax,
    )

    fn = acoustic_state_dict_from_jax if category == "acoustic" else variance_state_dict_from_jax
    return fn(jax.tree_util.tree_map(np.asarray, tree), pcfg)


def _grad_trees(params, n, seed):
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.01 * (1 + i)).astype(np.float32), params)
        for i in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> a JAX training run saved by the JAX package at update 2: its
    work dir (with the port's ``config.yaml``), both configs, the JAX state
    after the save, its gradient trees (those of the two updates before the
    save, then of two more) and the accumulation."""
    from xiaoicesing_io_tpu.training.checkpoint import CheckpointManager
    from xiaoicesing_io_tpu.training.finetune import wrap_optimizer_with_freezing
    from xiaoicesing_io_tpu.training.train_state import TrainState, build_optimizer

    out = {}
    for i, (name, (category, over)) in enumerate(RUNS.items()):
        wd = tmp_path_factory.mktemp(f"jax_{name}")
        jcfg, pcfg = _cfgs(category, wd, **over)
        params = _jax_convert(category, _random_state(_port_model(category, pcfg), seed=i), jcfg)
        tx = build_optimizer(jcfg)
        if over.get("freezing_enabled"):
            tx = wrap_optimizer_with_freezing(tx, params, over["frozen_params"])
        state = TrainState.create(params, tx)
        accum = over.get("accumulate_grad_batches", 1)
        grads = _grad_trees(params, 4 * accum, seed=100 + i)
        for g in grads[:STEP * accum]:
            state = APPLY(state, g)
        CheckpointManager(wd, category).save(jax.device_get(state), STEP, extra_meta={"epoch": 1})
        pcfg.save(wd / "config.yaml")
        if over.get("use_spk_id"):
            (wd / "spk_map.json").write_text(json.dumps(SPEAKERS))
        out[name] = SimpleNamespace(wd=wd, category=category, jcfg=jcfg, pcfg=pcfg,
                                    state=state, grads=grads, accum=accum,
                                    ckpt=wd / f"model_ckpt_steps_{STEP}")
    return out


@pytest.fixture(scope="module")
def converted(runs, tmp_path_factory):
    """name -> the run's checkpoint converted to ``model_ckpt_steps_2.ckpt``
    in a directory of its own."""
    from xiaoicesing_io_tpu_torch.training.jax_bridge import convert_jax_checkpoint

    return {name: convert_jax_checkpoint(r.pcfg, r.ckpt, tmp_path_factory.mktemp(f"conv_{name}"))
            for name, r in runs.items()}


def _assert_tree_equal(got, ref, path="tree"):
    """The same nesting (dicts, lists), the same ``None`` and empty states,
    and arrays of the same dtype and shape, bit for bit."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), (path, sorted(got), sorted(ref))
        for k in ref:
            _assert_tree_equal(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)) and len(ref) and not isinstance(ref, np.ndarray):
        assert type(got) is type(ref) and len(got) == len(ref), (path, type(got), type(ref))
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_tree_equal(a, b, f"{path}.{i}")
    elif ref is None or isinstance(ref, (tuple, list)):
        assert got == ref and type(got) is type(ref), (path, got, ref)
    else:
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.dtype == ref.dtype and got.shape == ref.shape, \
            (path, got.dtype, ref.dtype, got.shape, ref.shape)
        assert np.ascontiguousarray(got).tobytes() == np.ascontiguousarray(ref).tobytes(), path


def _adam(opt_state):
    """Adam's ``{count, mu, nu}`` in any of the three layouts."""
    o = opt_state
    if "inner_states" in o:
        o = o["inner_states"]["trainable"]["inner_state"]
    if "inner_opt_state" in o:
        o = o["inner_opt_state"]
    return o[1][0]


# ---------------------------------------------------------------------------
# the reader and the converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(RUNS))
def test_reader_matches_orbax_restore(name, runs):
    import orbax.checkpoint as ocp

    from xiaoicesing_io_tpu_torch.utils.orbax_ckpt import read_checkpoint

    r = runs[name]
    ref = ocp.StandardCheckpointer().restore(r.ckpt.resolve())
    tree, meta = read_checkpoint(r.ckpt)
    _assert_tree_equal(tree, ref)
    assert meta == {"step": STEP, "category": r.category, "epoch": 1}
    params, _ = read_checkpoint(r.ckpt, subtree="params")
    _assert_tree_equal(params, ref["params"])


def test_reader_bf16_leaf(tmp_path):
    """A bf16 leaf reads as orbax writes it, bit for bit, as an
    ``ml_dtypes`` bfloat16 array."""
    import orbax.checkpoint as ocp

    from xiaoicesing_io_tpu_torch.utils.orbax_ckpt import read_checkpoint

    a = np.random.default_rng(0).standard_normal((3, 5)).astype(jnp.bfloat16)
    path = tmp_path / "model_ckpt_steps_7"
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path.resolve(), {"params": {"w": a, "b": np.arange(4, dtype=np.int32)}})
    ckptr.wait_until_finished()
    (path / "meta.json").write_text(json.dumps({"step": 7, "category": "acoustic"}))
    tree, _ = read_checkpoint(path)
    _assert_tree_equal(tree, ocp.StandardCheckpointer().restore(path.resolve()))
    assert tree["params"]["w"].dtype == a.dtype
    assert tree["params"]["w"].tobytes() == a.tobytes()


CONVERTERS = {
    "lynx_reflow": ("acoustic", {}),
    "wavenet_ddpm": ("acoustic", WAVENET),
    "variance": ("variance", {"use_spk_id": True, "num_spk": 2, "use_melody_encoder": True,
                              "use_glide_embed": True}),
}


@pytest.mark.parametrize("case", list(CONVERTERS))
def test_torch_ckpt_matches_jax(case, tmp_path):
    """The port's ``convert_acoustic`` / ``convert_variance`` equal the JAX
    package's on the same state dict (tensors, ``model.`` names)."""
    from xiaoicesing_io_tpu_torch.utils import torch_ckpt

    category, over = CONVERTERS[case]
    jcfg, pcfg = _cfgs(category, tmp_path, **over)
    sd = {f"model.{k}": v for k, v in _random_state(_port_model(category, pcfg)).items()}
    conv = torch_ckpt.convert_acoustic if category == "acoustic" else torch_ckpt.convert_variance
    _assert_tree_equal(conv(sd, pcfg)["params"], _jax_convert(category, sd, jcfg))
    np_sd = {k: v.numpy() for k, v in sd.items()}
    _assert_tree_equal(conv(np_sd, pcfg)["params"], _jax_convert(category, sd, jcfg))


@pytest.mark.parametrize("fault", ["extra_leaf", "missing_leaf", "f64_leaf"])
def test_self_check_raises(fault, runs):
    from xiaoicesing_io_tpu_torch.training.jax_bridge import model_state_dict_from_jax
    from xiaoicesing_io_tpu_torch.utils.orbax_ckpt import read_checkpoint

    r = runs["plain"]
    params, _ = read_checkpoint(r.ckpt, subtree="params")
    model_state_dict_from_jax(params, r.pcfg, "acoustic")  # the intact tree converts
    if fault == "extra_leaf":
        params["fs2"]["encoder"]["layers_0"]["ffn"]["ffn_3"] = {"kernel": np.ones((2, 2))}
        match = "ffn_3"
    elif fault == "missing_leaf":
        del params["backbone"]["output_projection"]["bias"]
        match = "output_projection.bias"
    else:  # a leaf that f32, the port's dtype, cannot hold
        leaf = params["fs2"]["dur_embed"]
        leaf["kernel"] = leaf["kernel"].astype(np.float64) + 1e-12
        match = "dur_embed.kernel"
    with pytest.raises((ValueError, RuntimeError), match=match):
        model_state_dict_from_jax(params, r.pcfg, "acoustic")


# ---------------------------------------------------------------------------
# the optimizer state and resume
# ---------------------------------------------------------------------------

def _train_state(r, path):
    from xiaoicesing_io_tpu_torch.training.checkpoint import load_checkpoint
    from xiaoicesing_io_tpu_torch.training.finetune import freeze_parameters
    from xiaoicesing_io_tpu_torch.training.train_state import TrainState

    model = _port_model(r.category, r.pcfg)
    if r.pcfg.get("freezing_enabled"):
        freeze_parameters(model, r.pcfg["frozen_params"])
    state = TrainState(model, r.pcfg)
    meta = load_checkpoint(path, state, expected_category=r.category)
    assert meta == {"step": STEP, "epoch": 1} and state.micro == STEP * r.accum
    return state


@pytest.mark.parametrize("name", ["plain", "accum", "frozen_accum"])
def test_adamw_state_is_optax_state(name, runs, converted):
    """exp_avg and exp_avg_sq are the carriers of mu and nu bit for bit, and
    step is Adam's count, for every trainable parameter; frozen ones have
    none."""
    from xiaoicesing_io_tpu_torch.utils.orbax_ckpt import read_checkpoint

    r = runs[name]
    tree, _ = read_checkpoint(r.ckpt)
    adam = _adam(tree["opt_state"])

    def carried(moment):  # frozen leaves (None) as zeros
        return _carry(r.category, jax.tree_util.tree_map(
            lambda m, p: np.zeros_like(p) if m is None else m, moment, tree["params"],
            is_leaf=lambda x: x is None), r.pcfg)

    mu, nu = carried(adam["mu"]), carried(adam["nu"])
    state = _train_state(r, converted[name])
    names = {id(p): n for n, p in state.model.named_parameters()}
    assert len(state.optimizer.state) == len(state.params)
    for p in state.params:
        s, n = state.optimizer.state[p], names[id(p)]
        assert torch.equal(s["exp_avg"], mu[n]) and torch.equal(s["exp_avg_sq"], nu[n]), n
        assert float(s["step"]) == int(adam["count"]) == STEP
    frozen = [n for n, p in state.model.named_parameters() if not p.requires_grad]
    assert bool(frozen) == (name == "frozen_accum")
    for p in state.model.parameters():
        if not p.requires_grad:
            assert p not in state.optimizer.state


@pytest.mark.parametrize("name", ["plain", "accum", "frozen_accum"])
def test_inverse_gives_back_the_orbax_tree(name, runs, converted):
    """The converted model and AdamW state, as the JAX tree again
    (``jax_tree_from_state``), are the checkpoint orbax restores, bit for
    bit; converting that tree gives the same AdamW state."""
    import orbax.checkpoint as ocp

    from xiaoicesing_io_tpu_torch.training.jax_bridge import (
        jax_tree_from_state, optimizer_state_from_jax,
    )

    r = runs[name]
    state = _train_state(r, converted[name])
    opt = state.optimizer.state_dict()
    tree = jax_tree_from_state(state.model, opt, r.pcfg)
    ref = ocp.StandardCheckpointer().restore(r.ckpt.resolve())
    inner = ref["opt_state"]
    inner = inner["inner_states"]["trainable"]["inner_state"] if "inner_states" in inner else inner
    if "acc_grads" in inner:  # MultiSteps' reset leaves -0.0 here and there: zeros by value
        leaves = [v for v in jax.tree_util.tree_leaves(inner["acc_grads"])]
        assert leaves and all(not np.any(v) for v in leaves)
        inner["acc_grads"] = jax.tree_util.tree_map(np.abs, inner["acc_grads"])
    _assert_tree_equal(tree, ref)
    again = optimizer_state_from_jax(tree["opt_state"], _train_state(r, converted[name]).model,
                                     r.pcfg, STEP)
    assert again["param_groups"] == opt["param_groups"]
    for i, s in opt["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(again["state"][i][k], s[k]), (i, k)


@pytest.mark.parametrize("name", ["plain", "accum", "frozen_accum"])
def test_resumed_updates_match_optax(name, runs, converted):
    """Two more updates (with accumulation, four micro-batches) from the
    same gradients: optax on the saved state, the port's ``TrainState`` on
    the converted file; each parameter within 1e-5 of its scale, frozen
    ones bitwise unchanged."""
    r = runs[name]
    jstate = r.state
    for g in r.grads[STEP * r.accum:]:
        jstate = APPLY(jstate, g)
    state = _train_state(r, converted[name])
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    updates = []
    for g in r.grads[STEP * r.accum:]:
        carried = _carry(r.category, g, r.pcfg)
        loss = sum((p * carried[k]).sum() for k, p in state.model.named_parameters()
                   if p.requires_grad)
        updates.append(state.backward(loss))
    assert sum(updates) == 2 and state.step == STEP + 2
    ref = _carry(r.category, jstate.params, r.pcfg)
    for k, p in state.model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p, before[k]) and torch.equal(ref[k], before[k]), k
            continue
        assert not torch.equal(p, before[k]), k
        err = float((p.detach() - ref[k]).abs().max())
        assert err <= PARAM_TOL * max(1.0, float(ref[k].abs().max())), (k, err)


# ---------------------------------------------------------------------------
# the runners
# ---------------------------------------------------------------------------

def _acoustic_mels(runs, converted, tmp_path, monkeypatch):
    from xiaoicesing_io_tpu.inference.acoustic import DiffSingerAcousticInfer as JInfer
    from xiaoicesing_io_tpu_torch.config import Config
    from xiaoicesing_io_tpu_torch.inference.acoustic import (
        DiffSingerAcousticInfer as PInfer, _bucket,
    )

    r = runs["plain"]
    seg = json.loads(SAMPLES[0].read_text(encoding="utf-8"))[0]
    jr = JInfer(r.jcfg, load_vocoder=False)
    jb = jr.preprocess_input(seg)
    seed = 1234
    ref = np.asarray(jr.forward_model(jb, seed=seed))
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1, 1, _bucket(
        jb["mel2ph"].shape[1]), r.pcfg["audio_num_mel_bins"]), jnp.float32))
    out = {"jax": ref}
    from_dir = PInfer(r.pcfg, load_vocoder=False, device="cpu")
    out["dir"] = from_dir.forward_model(from_dir.preprocess_input(seg), noise=noise)
    # the converted file alone, read without tensorstore
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    (tmp_path / converted["plain"].name).write_bytes(converted["plain"].read_bytes())
    from_file = PInfer(Config(r.pcfg, work_dir=str(tmp_path)), load_vocoder=False, device="cpu")
    out["file"] = from_file.forward_model(from_file.preprocess_input(seg), noise=noise)
    return out


def test_acoustic_runner_from_dir_and_file(runs, converted, tmp_path, monkeypatch):
    mels = _acoustic_mels(runs, converted, tmp_path, monkeypatch)
    ref = mels["jax"]
    assert np.abs(ref).max() > 1.0
    for how in ("dir", "file"):
        assert mels[how].shape == ref.shape and np.isfinite(mels[how]).all()
        np.testing.assert_allclose(mels[how], ref, atol=MEL_TOL, rtol=0, err_msg=how)
    np.testing.assert_array_equal(mels["dir"], mels["file"])


def _variance_noise(jr, batch, seed):
    """The reflow start noise of both heads as the JAX runner draws it."""
    padded = jr._pad_batch(batch)[0]
    T = padded["base_pitch"].shape[1]
    cfg = jr.cfg
    key = jax.random.PRNGKey(seed)
    n = len(jr.model.variance_prediction_list)
    shapes = {"pitch": (1, 1, T, cfg["pitch_prediction_args"]["repeat_bins"]),
              "variances": (1, n, T, cfg["variances_prediction_args"]["total_repeat_bins"] // n)}
    keys = {"pitch": key, "variances": jax.random.fold_in(key, 1)}
    return {h: np.asarray(jax.random.normal(k, shapes[h], jnp.float32)) for h, k in keys.items()}


def test_variance_runner_from_dir_and_file(runs, converted, tmp_path, monkeypatch):
    from xiaoicesing_io_tpu.inference.variance import DiffSingerVarianceInfer as JInfer
    from xiaoicesing_io_tpu_torch.config import Config
    from xiaoicesing_io_tpu_torch.inference.variance import DiffSingerVarianceInfer as PInfer

    r = runs["variance"]
    seg = {k: v for k, v in json.loads(SAMPLES[0].read_text(encoding="utf-8"))[1].items()
           if k not in ("ph_dur", "f0_seq")}
    seg.update(spk_mix={"a": 0.25, "c": 0.75}, ph_spk_mix={"a": 0.25, "c": 0.75})
    jr = JInfer(r.jcfg)
    flags = jr.segment_flags(seg)
    assert flags == (True, True, True)
    jb = jr.preprocess_input(seg)
    seed = 77
    jd, jp, jv = jr.forward_model(jb, flags, seed=seed)
    noise = _variance_noise(jr, jb, seed)
    outs = {}
    runners = {"dir": lambda: PInfer(r.pcfg, device="cpu")}
    for how in ("dir", "file"):
        if how == "file":
            monkeypatch.setitem(sys.modules, "tensorstore", None)
            (tmp_path / converted["variance"].name).write_bytes(converted["variance"].read_bytes())
            (tmp_path / "spk_map.json").write_text(json.dumps(SPEAKERS))
            runners["file"] = lambda: PInfer(Config(r.pcfg, work_dir=str(tmp_path)), device="cpu")
        pr = runners[how]()
        pd, pp, pv = pr.forward_model(pr.preprocess_input(seg), flags, seed=seed, noise=noise)
        np.testing.assert_array_equal(pd, np.asarray(jd))
        np.testing.assert_allclose(pp, np.asarray(jp), atol=MEL_TOL, rtol=0, err_msg="pitch")
        assert np.ptp(pp) > 1.0
        assert set(pv) == set(CURVES)
        for k in CURVES:
            np.testing.assert_allclose(pv[k], np.asarray(jv[k]), atol=MEL_TOL, rtol=0, err_msg=k)
        outs[how] = (pd, pp, pv)
    np.testing.assert_array_equal(outs["dir"][1], outs["file"][1])


def test_export_from_dir_and_file(runs, converted, tmp_path, monkeypatch):
    """``export acoustic`` from the JAX directory writes the graph it writes
    from the converted file."""
    from xiaoicesing_io_tpu_torch.config import Config
    from xiaoicesing_io_tpu_torch.deployment.export import export_acoustic

    r = runs["plain"]
    export_acoustic(r.pcfg, out_dir=str(tmp_path / "dir"))
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    (tmp_path / converted["plain"].name).write_bytes(converted["plain"].read_bytes())
    export_acoustic(Config(r.pcfg, work_dir=str(tmp_path)), out_dir=str(tmp_path / "file"))
    graphs = sorted(p.name for p in (tmp_path / "dir").glob("*.onnx"))
    assert "acoustic.onnx" in graphs
    for name in graphs:
        assert (tmp_path / "dir" / name).read_bytes() == (tmp_path / "file" / name).read_bytes()


# ---------------------------------------------------------------------------
# finetuning, drop_spk, the command
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strict", [False, True])
def test_finetune_from_dir_matches_jax(strict, runs, tmp_path):
    """A wider aux decoder than the pretrained one (its tensors shape-
    mismatched) with the encoder blacklisted: the port loads from the
    directory exactly the tensors JAX's ``load_finetune_params`` loads, or,
    with ``finetune_strict_shapes``, both raise."""
    from xiaoicesing_io_tpu.training.finetune import load_finetune_params as jload
    from xiaoicesing_io_tpu_torch.models.toplevel import load_acoustic_state_dict
    from xiaoicesing_io_tpu_torch.training.finetune import load_finetune_params

    r = runs["plain"]
    over = dict(finetune_enabled=True, finetune_ckpt_path=str(r.ckpt),
                finetune_ignored_params=["model.fs2.encoder"], finetune_strict_shapes=strict)
    jcfg, pcfg = _cfgs("acoustic", tmp_path, **over)
    for cfg in (jcfg, pcfg):
        cfg["shallow_diffusion_args"]["aux_decoder_args"]["num_channels"] = 48
    model = _port_model("acoustic", pcfg)
    init = _random_state(model, seed=9)
    load_acoustic_state_dict(model, init)
    jinit = _jax_convert("acoustic", init, jcfg)
    if strict:
        with pytest.raises(ValueError, match="Shape mismatch"):
            jload(jinit, jcfg, "acoustic")
        with pytest.raises(ValueError, match="Shape mismatch"):
            load_finetune_params(model, pcfg, "acoustic")
        return
    ref = _carry("acoustic", jload(jinit, jcfg, "acoustic"), pcfg)
    load_finetune_params(model, pcfg, "acoustic")
    got = model.state_dict()
    source = _carry("acoustic", r.state.params, r.pcfg)
    kinds = set()
    for k, v in got.items():
        assert torch.equal(v, ref[k]), k
        kinds.add("loaded" if torch.equal(v, source.get(k, torch.empty(0))) else "kept")
        if k.startswith("fs2.encoder.") or v.shape != source[k].shape:
            assert torch.equal(v, init[k]), k
    assert kinds == {"loaded", "kept"}


@pytest.mark.parametrize("fill", ["mean", "cyclic"])
def test_drop_spk_from_dir_matches_jax(fill, runs, converted, tmp_path):
    """``drop_spk`` on a JAX directory writes a reference ``.ckpt`` whose
    speaker table is JAX ``drop_spk``'s scrubbed table, and whose other
    tensors and optimizer state are the conversion's."""
    from xiaoicesing_io_tpu.deployment.drop_spk import drop_speakers as jdrop
    from xiaoicesing_io_tpu_torch.deployment.drop_spk import drop_speakers
    from xiaoicesing_io_tpu_torch.utils.orbax_ckpt import read_checkpoint

    r = runs["variance"]
    exp, root = r.wd.name, str(r.wd.parent)
    jdrop(exp, ["b"], fill, work_dir_root=root, out=str(tmp_path / "jax_out"))
    (jax_params, _) = read_checkpoint(tmp_path / "jax_out", subtree="params")
    path = drop_speakers(exp, ["b"], fill, work_dir_root=root, out=str(tmp_path / "p.ckpt"))
    got = torch.load(path, map_location="cpu", weights_only=False)
    ref = torch.load(converted["variance"], map_location="cpu", weights_only=False)
    scrubbed = got["state_dict"]["model.spk_embed.weight"]
    assert scrubbed.numpy().tobytes() == np.asarray(jax_params["spk_embed"]["embedding"]).tobytes()
    assert not torch.equal(scrubbed, ref["state_dict"]["model.spk_embed.weight"])
    for k, v in ref["state_dict"].items():
        if k != "model.spk_embed.weight":
            assert torch.equal(got["state_dict"][k], v), k
    assert got["optimizer_states"][0]["param_groups"] == ref["optimizer_states"][0]["param_groups"]
    assert got["global_step"] == STEP and got["category"] == "variance"


def test_cli_convert_ckpt(runs, converted, tmp_path, capsys):
    from xiaoicesing_io_tpu_torch import cli

    r = runs["accum"]
    args = ["convert_ckpt", "--exp", r.wd.name, "--work_dir", str(r.wd.parent)]
    cli.main(args + ["--out", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    path = tmp_path / f"model_ckpt_steps_{STEP}.ckpt"
    got = torch.load(path, map_location="cpu", weights_only=False)
    ref = torch.load(converted["accum"], map_location="cpu", weights_only=False)
    assert f"step {STEP}, category acoustic, {len(ref['state_dict'])} tensors" in line
    assert got.keys() == ref.keys() and got["epoch"] == 1
    for k, v in ref["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
    with pytest.raises(SystemExit, match="step 3"):
        cli.main(args + ["--ckpt_steps", "3", "--out", str(tmp_path)])
    assert not list(tmp_path.glob("*.partial"))


# ---------------------------------------------------------------------------
# refusals and precedence
# ---------------------------------------------------------------------------

def _opt_case(runs, name, edit):
    """The run's tree with ``edit(tree, meta, cfg)`` applied to copies."""
    from xiaoicesing_io_tpu_torch.config import Config
    from xiaoicesing_io_tpu_torch.utils.orbax_ckpt import read_checkpoint

    r = runs[name]
    tree, meta = read_checkpoint(r.ckpt)
    cfg = Config(r.pcfg)
    edit(tree, meta, cfg)
    return r, tree, meta, cfg


def _set(path, value):
    def edit(tree, meta, cfg):
        node = tree["opt_state"]
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
    return edit


REFUSALS = {
    "mini_step": ("accum", _set(["mini_step"], np.asarray(1, np.int32)), "mini_step"),
    "acc_grads": ("accum", lambda t, m, c: t["opt_state"]["acc_grads"]["fs2"]["dur_embed"].update(
        kernel=np.ones_like(t["opt_state"]["acc_grads"]["fs2"]["dur_embed"]["kernel"])),
        "acc_grads hold"),
    "counts": ("plain", lambda t, m, c: m.update(step=STEP + 1), "counts disagree"),
    "multisteps_without_accum": ("accum", lambda t, m, c: c.update(accumulate_grad_batches=1),
                                 "MultiSteps"),
    "accum_without_multisteps": ("plain", lambda t, m, c: c.update(accumulate_grad_batches=4),
                                 "accumulates 4"),
    "frozen_without_config": ("frozen_accum", lambda t, m, c: c.update(freezing_enabled=False),
                              "freezes none"),
    "config_freezes_others": ("frozen_accum",
                              lambda t, m, c: c.update(frozen_params=["fs2.encoder"]),
                              "frozen parameters differ"),
    "config_without_clip": ("plain", lambda t, m, c: c.update(clip_grad_norm=0), "chain"),
    "category": ("plain", lambda t, m, c: c.update(task_cls="training.VarianceTask"),
                 "category"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_conversion_refuses(case, runs, tmp_path):
    from xiaoicesing_io_tpu_torch.training.jax_bridge import convert_jax_tree

    name, edit, match = REFUSALS[case]
    _, tree, meta, cfg = _opt_case(runs, name, edit)
    with pytest.raises(ValueError, match=match):
        convert_jax_tree(cfg, tree, meta, tmp_path)
    assert not list(tmp_path.iterdir())


def test_loader_refuses_other_category(runs):
    from xiaoicesing_io_tpu_torch.training.checkpoint import load_model_state_dict

    r = runs["plain"]
    with pytest.raises(ValueError, match="category 'acoustic', expected 'variance'"):
        load_model_state_dict(r.wd, r.pcfg, "variance")
    sd = load_model_state_dict(r.wd, r.pcfg, "acoustic")
    ref = _carry("acoustic", r.state.params, r.pcfg)
    assert sd.keys() == ref.keys() and all(torch.equal(sd[k], ref[k]) for k in ref)


def test_without_tensorstore_names_convert_ckpt(runs, monkeypatch):
    from xiaoicesing_io_tpu_torch.inference.acoustic import DiffSingerAcousticInfer
    from xiaoicesing_io_tpu_torch.training.finetune import load_finetune_params
    from xiaoicesing_io_tpu_torch.config import Config

    r = runs["plain"]
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="convert_ckpt"):
        DiffSingerAcousticInfer(r.pcfg, load_vocoder=False, device="cpu")
    cfg = Config(r.pcfg, finetune_ckpt_path=str(r.ckpt))
    with pytest.raises(ImportError, match="convert_ckpt"):
        load_finetune_params(_port_model("acoustic", cfg), cfg, "acoustic")


def test_resume_refuses_a_newer_jax_dir(runs, converted, tmp_path):
    """The trainer's resume: a JAX directory newer than every ``.ckpt`` (or
    with none) raises and names ``convert_ckpt``; beside its converted file
    it resumes from that file."""
    import shutil

    from xiaoicesing_io_tpu_torch.training.checkpoint import CheckpointManager

    r = runs["plain"]
    wd = tmp_path / "exp"
    shutil.copytree(r.ckpt, wd / r.ckpt.name)
    state = _train_state(r, converted["plain"])
    manager = CheckpointManager(wd, "acoustic")
    with pytest.raises(RuntimeError, match="convert_ckpt"):
        manager.restore_latest(state)
    manager.save(state, STEP - 1)
    with pytest.raises(RuntimeError, match="newer than every"):
        manager.restore_latest(state)
    (wd / converted["plain"].name).write_bytes(converted["plain"].read_bytes())
    assert manager.restore_latest(state) == {"step": STEP, "epoch": 1}


def test_precedence_and_exact_step(tmp_path):
    """The highest step over ``.ckpt`` files and complete JAX directories,
    the ``.ckpt`` where both have it, and an exact ``ckpt_steps`` match
    (step 2000 must not load 12000).  The JAX package's
    ``load_params_for_inference`` takes any directory before any ``.ckpt``;
    the port's trainer writes ``.ckpt`` files, so here the newer file wins."""
    from xiaoicesing_io_tpu_torch.eval.copy_synthesis import _checkpoint_step
    from xiaoicesing_io_tpu_torch.training.checkpoint import find_model_checkpoint

    for step in (2000, 12000, 13000):
        d = tmp_path / f"model_ckpt_steps_{step}"
        d.mkdir()
        if step != 13000:  # 13000: an interrupted save, without meta.json
            (d / "meta.json").write_text(json.dumps({"step": step, "category": "acoustic"}))
    for step in (1000, 2000, 20000):
        (tmp_path / f"model_ckpt_steps_{step}.ckpt").write_bytes(b"")
    find = lambda s=None: find_model_checkpoint(tmp_path, s).name  # noqa: E731
    assert find() == "model_ckpt_steps_20000.ckpt"
    assert _checkpoint_step(tmp_path) == 20000
    assert find(12000) == "model_ckpt_steps_12000"
    assert find(2000) == "model_ckpt_steps_2000.ckpt"
    assert find(1000) == "model_ckpt_steps_1000.ckpt"
    assert find(20000) == "model_ckpt_steps_20000.ckpt"
    for step in (200, 13000):
        with pytest.raises(FileNotFoundError):
            find(step)
    (tmp_path / "model_ckpt_steps_20000.ckpt").unlink()
    assert find() == "model_ckpt_steps_12000"
    assert _checkpoint_step(tmp_path) == 12000
    (tmp_path / "model_ckpt_steps_12000.ckpt").write_bytes(b"")
    assert find() == "model_ckpt_steps_12000.ckpt"


def test_training_on_after_conversion_is_what_infer_loads(runs, converted, tmp_path,
                                                          monkeypatch):
    """``convert_ckpt`` into the work dir beside the JAX directory, then
    ``train`` on: the runner reads the trainer's newer save, not the older
    directory, also once retention has removed the converted file."""
    import shutil

    from xiaoicesing_io_tpu_torch.config import Config
    from xiaoicesing_io_tpu_torch.inference.acoustic import DiffSingerAcousticInfer
    from xiaoicesing_io_tpu_torch.training.checkpoint import CheckpointManager
    from xiaoicesing_io_tpu_torch.training.train_state import TrainState

    r = runs["plain"]
    wd = tmp_path / "exp"
    shutil.copytree(r.ckpt, wd / r.ckpt.name)
    shutil.copy(converted["plain"], wd)
    state = TrainState(_port_model("acoustic", r.pcfg), r.pcfg)
    manager = CheckpointManager(wd, "acoustic", num_ckpt_keep=1)
    assert manager.restore_latest(state) == {"step": STEP, "epoch": 1}
    carried = _carry("acoustic", r.grads[STEP], r.pcfg)
    assert state.backward(sum((p * carried[k]).sum()
                              for k, p in state.model.named_parameters()))
    manager.save(state, state.step)
    assert sorted(p.name for p in wd.iterdir()) == [r.ckpt.name,
                                                   f"model_ckpt_steps_{STEP + 1}.ckpt"]
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    runner = DiffSingerAcousticInfer(Config(r.pcfg, work_dir=str(wd)), load_vocoder=False,
                                     device="cpu")
    trained = state.model.state_dict()
    loaded = runner.model.state_dict()
    assert set(loaded) == set(trained)
    for k, v in trained.items():
        assert torch.equal(loaded[k], v), k
