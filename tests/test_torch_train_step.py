"""The port's train steps against the JAX package's, on the CPU.

Tiny models (fs2 32 x 1; LYNXNet 64 x 2 with reflow and shallow
diffusion, WaveNet 64 x 4 with DDPM and shallow diffusion; the variance
model's duration head, pitch head and energy + breathiness head, reflow
and DDPM) with random weights drawn with numpy, saved under the reference
names and carried into the JAX package by its converter; dropout 0 and
f32 (``precision: fp32``).  Batches are the port's collated items with an
added all-zero row, as the trainer feeds them.  The diffusion time, noise
and retake masks are the JAX step's own draws from its key, given to the
port.

* Losses within 1e-5 relative.
* Gradients: JAX's gradient tree carried by ``utils/jax_weights`` (checked
  to be linear: transposes and copies) against each port ``.grad``, within
  2e-4 of that tensor's largest JAX gradient.
* The optimizer (AdamW, the global-norm clip, the schedule; with
  ``accumulate_grad_batches: 2``; with ``frozen_params``): two updates from
  the same gradients on both sides, the parameters within 1e-5 of optax's;
  frozen tensors bitwise unchanged.
"""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
DICT = ROOT / "dictionaries" / "opencpop-extension.txt"
LOSS_TOL = 1e-5
GRAD_TOL = 2e-4
PARAM_TOL = 1e-5


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


def _write_set(directory, items):
    from xiaoicesing_io_tpu_torch.data.indexed_dataset import IndexedDatasetBuilder

    directory.mkdir(parents=True, exist_ok=True)
    b = IndexedDatasetBuilder(directory, "train")
    for it in items:
        b.add_item(it)
    b.finalize()
    with open(directory / "train.meta", "wb") as f:
        pickle.dump({"lengths": [len(it["mel2ph"]) for it in items]}, f)


def _acoustic_items(n, seed=0):
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        t_ph = int(rng.integers(5, 12))
        mel2ph = np.repeat(np.arange(1, t_ph + 1), rng.integers(3, 10, t_ph)).astype(np.int64)
        t = np.arange(len(mel2ph))
        items.append({"tokens": rng.integers(1, 60, t_ph).astype(np.int64), "mel2ph": mel2ph,
                      "mel": rng.uniform(-11.0, -1.0, (len(t), 128)).astype(np.float32),
                      "f0": (220.0 * 2 ** (0.2 * np.sin(t / 9.0))).astype(np.float32)})
    return items


def _variance_items(n, seed=0):
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        t_ph = int(rng.integers(6, 14))
        ph_dur = rng.integers(2, 10, t_ph).astype(np.int64)
        ph2word = np.cumsum(np.r_[1, rng.uniform(size=t_ph - 1) < 0.5]).astype(np.int64)
        mel2ph = np.repeat(np.arange(1, t_ph + 1), ph_dur).astype(np.int64)
        t = len(mel2ph)
        t_n = int(rng.integers(3, 6))
        cuts = np.sort(rng.choice(np.arange(1, t), t_n - 1, replace=False))
        note_dur = np.diff(np.r_[0, cuts, t]).astype(np.int64)
        note_midi = rng.uniform(55, 75, t_n).astype(np.float32)
        mel2note = np.repeat(np.arange(1, t_n + 1), note_dur).astype(np.int64)
        base = note_midi[mel2note - 1]
        items.append({
            "tokens": rng.integers(1, 60, t_ph).astype(np.int64), "ph_dur": ph_dur,
            "midi": rng.integers(50, 80, t_ph).astype(np.int64), "ph2word": ph2word,
            "mel2ph": mel2ph, "note_midi": note_midi, "note_rest": rng.uniform(size=t_n) < 0.2,
            "note_dur": note_dur, "mel2note": mel2note, "base_pitch": base.astype(np.float32),
            "pitch": (base + rng.uniform(-0.8, 0.8, t)).astype(np.float32),
            "uv": rng.uniform(size=t) < 0.15,
            "energy": rng.uniform(-60, -10, t).astype(np.float32),
            "breathiness": rng.uniform(-60, -10, t).astype(np.float32)})
    return items


ACOUSTIC = {
    "lynx_reflow_shallow": dict(backbone_type="lynxnet", diffusion_type="reflow",
                                backbone_args=dict(num_channels=64, num_layers=2, kernel_size=31,
                                                   strong_cond=True)),
    "wavenet_ddpm_shallow": dict(backbone_type="wavenet", diffusion_type="ddpm", K_step=300,
                                 backbone_args=dict(num_channels=64, num_layers=4,
                                                    dilation_cycle_length=2)),
}


def _acoustic_cfgs(case, **over):
    from xiaoicesing_io_tpu.config import load_config
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults

    out = []
    for cfg in (load_config(ROOT / "xiaoicesing_io_tpu/configs/acoustic.yaml"),
                acoustic_defaults()):
        cfg.update(hidden_size=32, enc_layers=1, num_heads=2, dropout=0.0, precision="fp32",
                   dictionary=str(DICT), **ACOUSTIC[case])
        cfg["shallow_diffusion_args"]["aux_decoder_args"].update(
            num_channels=32, num_layers=1, dropout_rate=0.0)
        cfg.update(over)
        out.append(cfg)
    return out


def _variance_cfgs(case, **over):
    from xiaoicesing_io_tpu.config import load_config
    from xiaoicesing_io_tpu_torch.config import variance_defaults

    out = []
    for cfg in (load_config(ROOT / "xiaoicesing_io_tpu/configs/variance.yaml"),
                variance_defaults()):
        cfg.update(hidden_size=32, enc_layers=1, num_heads=2, dropout=0.0, precision="fp32",
                   dictionary=str(DICT), predict_energy=True, predict_breathiness=True,
                   diffusion_type=case)
        cfg["dur_prediction_args"].update(hidden_size=32, num_layers=2, dropout=0.0)
        cfg["pitch_prediction_args"].update(repeat_bins=8)
        cfg["pitch_prediction_args"]["backbone_args"].update(num_layers=3, num_channels=16,
                                                             dilation_cycle_length=2)
        cfg["variances_prediction_args"].update(total_repeat_bins=8)
        cfg["variances_prediction_args"]["backbone_args"].update(num_layers=2, num_channels=16)
        cfg.update(over)
        out.append(cfg)
    return out


def _batch(category, cfg, tmp_path, seed=0):
    """Two items collated with one all-zero row added."""
    from xiaoicesing_io_tpu_torch.data.dataset import AcousticDataset, VarianceDataset

    items = (_acoustic_items if category == "acoustic" else _variance_items)(2, seed)
    _write_set(tmp_path / f"set{seed}", items)
    ds = (AcousticDataset if category == "acoustic" else VarianceDataset)(
        tmp_path / f"set{seed}", "train", cfg)
    return ds.collate([0, 1], pad_batch_to=3)


def _pair(category, jcfg, pcfg, seed=0):
    """(JAX model, core, normalizer(s), params, port model, core,
    normalizer(s)) with the same random weights."""
    from xiaoicesing_io_tpu.utils.torch_ckpt import convert_acoustic, convert_variance
    from xiaoicesing_io_tpu_torch.models.toplevel import (
        VarianceModel, build_variance_normalizers, load_acoustic_state_dict,
        load_variance_state_dict,
    )
    from xiaoicesing_io_tpu_torch.utils.jax_weights import (
        acoustic_state_dict_from_jax, variance_state_dict_from_jax,
    )

    vocab = _vocab()
    if category == "acoustic":
        from xiaoicesing_io_tpu.training.acoustic import build_acoustic as jbuild
        from xiaoicesing_io_tpu_torch.training.acoustic import build_acoustic as pbuild

        jm, jcore, jnorm = jbuild(jcfg, vocab)
        pm, pcore, pnorm = pbuild(pcfg, vocab)
        params = jax.tree_util.tree_map(np.asarray,
                                        convert_acoustic(_random_state(pm, seed), jcfg))
        load_acoustic_state_dict(pm, acoustic_state_dict_from_jax(params, pcfg))
    else:
        from xiaoicesing_io_tpu.training.variance import build_variance as jbuild
        from xiaoicesing_io_tpu_torch.inference.variance import build_variance_cores

        jm, jcore, jnorm = jbuild(jcfg, vocab)
        pm = VarianceModel.from_config(pcfg, vocab)
        pcore, pnorm = build_variance_cores(pcfg), build_variance_normalizers(pcfg)
        params = jax.tree_util.tree_map(np.asarray,
                                        convert_variance(_random_state(pm, seed), jcfg))
        load_variance_state_dict(pm, variance_state_dict_from_jax(params, pcfg))
    return jm, jcore, jnorm, params["params"], pm.eval(), pcore, pnorm


def _carry(category, tree, pcfg):
    from xiaoicesing_io_tpu_torch.utils.jax_weights import (
        acoustic_state_dict_from_jax, variance_state_dict_from_jax,
    )

    fn = acoustic_state_dict_from_jax if category == "acoustic" else variance_state_dict_from_jax
    return fn({"params": jax.tree_util.tree_map(np.asarray, tree)}, pcfg)


def _acoustic_draws(jcore, key, b, t, m):
    _, k_t, k_noise = jax.random.split(key, 3)
    return {"t": torch.tensor(np.asarray(jcore.sample_t(k_t, b))),
            "noise": torch.tensor(np.asarray(jax.random.normal(k_noise, (b, 1, t, m))))}


def _variance_draws(jm, jcore, pcfg, key, b, t):
    """The JAX step's retake masks, diffusion times and noises."""
    from xiaoicesing_io_tpu.training.variance import random_retake_masks

    _, k_retake, k_t, k_noise, k_vt, k_vnoise = jax.random.split(key, 6)
    retakes = {}
    for name in ["pitch"] + list(jm.variance_prediction_list):
        k_retake, kr = jax.random.split(k_retake)
        retakes[name] = torch.tensor(np.asarray(random_retake_masks(kr, b, t)))
    names = jm.variance_prediction_list
    bins = pcfg["variances_prediction_args"]["total_repeat_bins"] // len(names)
    pitch_bins = pcfg["pitch_prediction_args"]["repeat_bins"]
    return {"retakes": retakes,
            "t": torch.tensor(np.asarray(jcore.sample_t(k_t, b))),
            "noise": torch.tensor(np.asarray(jax.random.normal(k_noise, (b, 1, t, pitch_bins)))),
            "var_t": torch.tensor(np.asarray(jcore.sample_t(k_vt, b))),
            "var_noise": torch.tensor(np.asarray(
                jax.random.normal(k_vnoise, (b, len(names), t, bins))))}


def _losses_and_grads(category, case, tmp_path):
    """JAX's losses and gradient tree, and the port's losses and model with
    ``.grad`` set, from one batch and the JAX key's draws."""
    from xiaoicesing_io_tpu_torch.training.trainer import widen_batch
    from xiaoicesing_io_tpu_torch.training.variance import batch_tensors

    cfgs = _acoustic_cfgs(case) if category == "acoustic" else _variance_cfgs(case)
    jcfg, pcfg = cfgs
    jm, jcore, jnorm, params, pm, pcore, pnorm = _pair(category, jcfg, pcfg)
    batch = _batch(category, pcfg, tmp_path)
    key = jax.random.PRNGKey(3)
    b, t = batch["mel2ph"].shape
    if category == "acoustic":
        from xiaoicesing_io_tpu.training.acoustic import acoustic_losses as jlosses
        from xiaoicesing_io_tpu_torch.training.acoustic import acoustic_losses as plosses

        draws = _acoustic_draws(jcore, key, b, t, pcfg["audio_num_mel_bins"])
    else:
        from xiaoicesing_io_tpu.training.variance import variance_losses as jlosses
        from xiaoicesing_io_tpu_torch.training.variance import variance_losses as plosses

        draws = _variance_draws(jm, jcore, pcfg, key, b, t)

    def loss_fn(p):
        out = jlosses(jm, jcore, jnorm, jcfg, {"params": p},
                      {k: jnp.asarray(v) for k, v in batch.items()}, key, deterministic=True)
        return sum(out.values()), out

    (_, jout), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    pout = plosses(pm, pcore, pnorm, pcfg,
                   widen_batch({k: torch.as_tensor(v) for k, v in batch.items()}), **draws)
    sum(pout.values()).backward()
    return jcfg, pcfg, params, grads, jout, pout, pm, batch, draws


STEPS = [("acoustic", c) for c in ACOUSTIC] + [("variance", "reflow"), ("variance", "ddpm")]


@pytest.mark.parametrize("category,case", STEPS)
def test_losses_and_gradients_match_jax(category, case, tmp_path):
    jcfg, pcfg, params, grads, jout, pout, pm, _, _ = _losses_and_grads(category, case, tmp_path)
    expect = {"acoustic": {"aux_mel_loss", "mel_loss"},
              "variance": {"dur_loss", "pitch_loss", "var_loss"}}[category]
    assert set(jout) == set(pout) == expect
    for k in jout:
        ref, got = float(jout[k]), float(pout[k].detach())
        assert abs(got - ref) <= LOSS_TOL * abs(ref), (k, got, ref)
    # the carrier is linear (transposes, copies), so it carries gradients too
    carried = _carry(category, grads, pcfg)
    mix = _carry(category, jax.tree_util.tree_map(lambda p, g: p + 3.0 * g, params, grads), pcfg)
    base = _carry(category, params, pcfg)
    for k in carried:
        np.testing.assert_allclose(mix[k], base[k] + 3.0 * carried[k], rtol=1e-6, atol=1e-6)
    names = {k for k, p in pm.named_parameters()}
    assert set(carried) == names
    for k, p in pm.named_parameters():
        ref = carried[k].numpy()
        scale = float(np.abs(ref).max())
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= GRAD_TOL * max(scale, 1e-8), (k, err, scale)


@pytest.mark.parametrize("category,case", [("acoustic", "lynx_reflow_shallow"),
                                           ("variance", "reflow")])
def test_train_step_losses_match_jax(category, case, tmp_path):
    """The whole steps, JAX's jitted ``make_*_train_step`` from its key and
    the port's ``make_*_train_step`` given that key's draws: the reported
    losses agree, the port took one update."""
    from xiaoicesing_io_tpu_torch.training.trainer import widen_batch

    cfgs = _acoustic_cfgs(case) if category == "acoustic" else _variance_cfgs(case)
    jcfg, pcfg = cfgs
    jm, jcore, jnorm, params, pm, pcore, pnorm = _pair(category, jcfg, pcfg)
    batch = _batch(category, pcfg, tmp_path)
    key = jax.random.PRNGKey(5)
    b, t = batch["mel2ph"].shape
    if category == "acoustic":
        from xiaoicesing_io_tpu.training.acoustic import make_acoustic_train_step as jmake
        from xiaoicesing_io_tpu_torch.training.acoustic import make_acoustic_train_step as pmake

        draws = _acoustic_draws(jcore, key, b, t, pcfg["audio_num_mel_bins"])
    else:
        from xiaoicesing_io_tpu.training.variance import make_variance_train_step as jmake
        from xiaoicesing_io_tpu_torch.training.variance import make_variance_train_step as pmake

        draws = _variance_draws(jm, jcore, pcfg, key, b, t)
    from xiaoicesing_io_tpu.training.train_state import TrainState as JState, build_optimizer
    from xiaoicesing_io_tpu_torch.training.train_state import TrainState

    jstate = JState.create(params, build_optimizer(jcfg))
    _, jmetrics = jax.jit(jmake(jm, jcore, jnorm, jcfg))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    state = TrainState(pm, pcfg)
    updated, metrics = pmake(pm, pcore, pnorm, pcfg)(
        state, widen_batch({k: torch.as_tensor(v) for k, v in batch.items()}), **draws)
    assert updated and state.step == 1 and pm.training
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        ref = float(jmetrics[k])
        assert abs(float(metrics[k]) - ref) <= LOSS_TOL * abs(ref), (k, metrics[k], ref)


OPTIM = {
    "plain": {},
    "clipped_warmup": {"clip_grad_norm": 0.05,
                       "lr_scheduler_args": {"scheduler_cls": "torch.optim.lr_scheduler.LinearLR",
                                             "start_factor": 0.25, "total_iters": 4}},
    "accumulate_2": {"accumulate_grad_batches": 2, "clip_grad_norm": 0.05},
    "frozen": {"clip_grad_norm": 0.05, "freezing_enabled": True,
               "frozen_params": ["model.fs2.encoder", "fs2.txt_embed"]},
    "weight_decay": {"optimizer_args": {"lr": 0.001, "beta1": 0.8, "beta2": 0.95,
                                        "weight_decay": 0.01}},
}


@pytest.mark.parametrize("case", list(OPTIM))
def test_optimizer_updates_match_optax(case, tmp_path):
    """Two updates (with accumulation, four micro-batches) from the same
    gradients on both sides: optax's chain (clip, AdamW on the schedule;
    ``MultiSteps``; ``multi_transform`` freezing) against the port's
    ``TrainState``, which receives each micro-batch's gradients through
    ``backward`` of a loss whose gradient they are."""
    from xiaoicesing_io_tpu.training.finetune import wrap_optimizer_with_freezing
    from xiaoicesing_io_tpu.training.train_state import TrainState as JState, build_optimizer
    from xiaoicesing_io_tpu_torch.training.finetune import freeze_parameters
    from xiaoicesing_io_tpu_torch.training.train_state import TrainState

    over = OPTIM[case]
    jcfg, pcfg = _acoustic_cfgs("lynx_reflow_shallow")
    for cfg in (jcfg, pcfg):
        for k, v in over.items():
            cfg[k] = dict(cfg.get(k, {}), **v) if isinstance(v, dict) else v
    _, _, _, params, pm, _, _ = _pair("acoustic", jcfg, pcfg)
    rng = np.random.default_rng(7)
    accum = over.get("accumulate_grad_batches", 1)
    micro = [jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.01 * (1 + i)).astype(np.float32), params)
        for i in range(2 * accum)]
    tx = build_optimizer(jcfg)
    if over.get("frozen_params"):
        tx = wrap_optimizer_with_freezing(tx, params, over["frozen_params"])
        freeze_parameters(pm, over["frozen_params"])
    jstate = JState.create(params, tx)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    for g in micro:
        jstate = apply(jstate, g)
    before = {k: p.detach().clone() for k, p in pm.named_parameters()}
    state = TrainState(pm, pcfg)
    updates = []
    for g in micro:
        carried = _carry("acoustic", g, pcfg)
        loss = sum((p * carried[k]).sum() for k, p in pm.named_parameters() if p.requires_grad)
        updates.append(state.backward(loss))
    assert updates == [False] * (accum - 1) + [True] + [False] * (accum - 1) + [True]
    assert state.step == 2 and state.micro == 2 * accum
    ref = _carry("acoustic", jstate.params, pcfg)
    n_frozen = 0
    for k, p in pm.named_parameters():
        if not p.requires_grad:
            n_frozen += 1
            assert torch.equal(p, before[k]), k
            assert torch.equal(ref[k], before[k]), k
            continue
        assert not torch.equal(p, before[k]), k
        err = float((p.detach() - ref[k]).abs().max())
        assert err <= PARAM_TOL, (k, err)
    assert n_frozen == (0 if not over.get("frozen_params") else
                        sum(1 for k in before if k.startswith(("fs2.encoder", "fs2.txt_embed"))))
    if over.get("frozen_params"):
        assert n_frozen > 0
