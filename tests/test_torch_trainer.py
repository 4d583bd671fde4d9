"""The port's trainer against the JAX package's, on the CPU.

* The batch sampler forms the JAX sampler's batches (one replica) for
  three epochs under several frame and item budgets and seeds, with
  accumulation.
* ``fixed_batch_rows``, ``_collate_train`` and the compact feed's narrowing
  give JAX's arrays byte for byte; ``load_config`` with overrides and
  ``reset`` gives JAX's config.
* Tiny fits (fs2 32 x 1, LYNXNet 64 x 2 on reflow with shallow diffusion,
  a variance model with 16-wide WaveNet heads), ``device="cpu"``:
  checkpoints in the reference format with their retention, resume with the
  epoch, an incomplete save skipped; the checkpoint loaded by the port's
  runner and ``eval`` and by the JAX package's torch-checkpoint loader;
  SIGTERM; finetuning with the blacklist and shape tolerance; the ``train``
  command; the validation extras (their mel equals the runner's from the
  saved checkpoint with the same seed, their wavs are frames x hop long,
  their errors propagate); the prefetch's errors, the watchdogs, the
  profiler trace.
"""

import json
import os
import pickle
import signal
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
DICT = ROOT / "dictionaries" / "opencpop-extension.txt"
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


def _write_set(directory, prefix, items):
    from xiaoicesing_io_tpu_torch.data.indexed_dataset import IndexedDatasetBuilder

    directory.mkdir(parents=True, exist_ok=True)
    b = IndexedDatasetBuilder(directory, prefix)
    for it in items:
        b.add_item(it)
    b.finalize()
    with open(directory / f"{prefix}.meta", "wb") as f:
        pickle.dump({"lengths": [len(it["mel2ph"]) for it in items],
                     "names": [f"item{i}" for i in range(len(items))]}, f)


def _acoustic_items(n, seed=0, lo=3, hi=10):
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        t_ph = int(rng.integers(4, 10))
        mel2ph = np.repeat(np.arange(1, t_ph + 1), rng.integers(lo, hi, t_ph)).astype(np.int64)
        t = np.arange(len(mel2ph))
        items.append({"tokens": rng.integers(1, 60, t_ph).astype(np.int64), "mel2ph": mel2ph,
                      "mel": rng.uniform(-11.0, -1.0, (len(t), 128)).astype(np.float32),
                      "f0": (220.0 * 2 ** (0.2 * np.sin(t / 9.0))).astype(np.float32)})
    return items


def _variance_items(n, seed=0):
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        t_ph = int(rng.integers(6, 12))
        ph_dur = rng.integers(2, 9, t_ph).astype(np.int64)
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
            "energy": rng.uniform(-60, -10, t).astype(np.float32)})
    return items


@pytest.fixture(scope="module")
def binary(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_sets")
    _write_set(root / "acoustic", "train", _acoustic_items(10, seed=0))
    _write_set(root / "acoustic", "valid", _acoustic_items(2, seed=1))
    _write_set(root / "variance", "train", _variance_items(6, seed=2))
    _write_set(root / "variance", "valid", _variance_items(2, seed=3))
    torch.manual_seed(1)
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import Generator, NsfHifiganConfig

    (root / "vocoder").mkdir()
    torch.save({"generator": Generator(NsfHifiganConfig.from_json(VOCODER)).state_dict()},
               root / "vocoder" / "model.ckpt")
    (root / "vocoder" / "config.json").write_text(json.dumps(VOCODER))
    return root


def _acoustic_cfg(binary, work_dir, **over):
    from xiaoicesing_io_tpu_torch.config import Config, acoustic_defaults

    cfg = acoustic_defaults()
    cfg.update(binary_data_dir=str(binary / "acoustic"), dictionary=str(DICT),
               work_dir=str(work_dir), hidden_size=32, enc_layers=1, num_heads=2,
               precision="fp32", max_updates=4, log_interval=2, val_check_interval=2,
               max_batch_frames=300, max_batch_size=4, sampling_steps=2, num_valid_plots=1,
               vocoder_ckpt=None, backbone_args=Config(num_channels=64, num_layers=2,
                                                       kernel_size=31, strong_cond=True))
    cfg["shallow_diffusion_args"]["aux_decoder_args"].update(num_channels=32, num_layers=1)
    cfg.update(over)
    return cfg


def _variance_cfg(binary, work_dir, **over):
    from xiaoicesing_io_tpu_torch.config import variance_defaults

    cfg = variance_defaults()
    cfg.update(binary_data_dir=str(binary / "variance"), dictionary=str(DICT),
               work_dir=str(work_dir), hidden_size=32, enc_layers=1, num_heads=2,
               precision="fp32", max_updates=4, log_interval=2, val_check_interval=2,
               max_batch_frames=300, max_batch_size=4, sampling_steps=2, num_valid_plots=1,
               predict_energy=True)
    cfg["dur_prediction_args"].update(hidden_size=32, num_layers=1)
    cfg["pitch_prediction_args"].update(repeat_bins=8)
    cfg["pitch_prediction_args"]["backbone_args"].update(num_layers=2, num_channels=16)
    cfg["variances_prediction_args"].update(total_repeat_bins=8)
    cfg["variances_prediction_args"]["backbone_args"].update(num_layers=2, num_channels=16)
    cfg.update(over)
    return cfg


class Recorder:
    """A writer that keeps what it is given."""

    def __init__(self):
        self.scalars, self.figures, self.audio = [], [], []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def add_figure(self, tag, fig, step):
        import matplotlib.pyplot as plt

        plt.close(fig)
        self.figures.append((tag, step))

    def add_audio(self, tag, wav, step, sample_rate):
        self.audio.append((tag, np.asarray(wav).reshape(-1), step, sample_rate))

    def flush(self):
        pass


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

class Sizes:
    def __init__(self, sizes):
        self.sizes = np.asarray(sizes)

    def __len__(self):
        return len(self.sizes)

    def num_frames(self, i):
        return int(self.sizes[i])


SAMPLERS = {
    "frames": dict(max_batch_frames=3000, max_batch_size=64),
    "items": dict(max_batch_frames=100000, max_batch_size=5),
    "both_accum": dict(max_batch_frames=2500, max_batch_size=7,
                       required_batch_count_multiple=4),
    "seeded": dict(max_batch_frames=2000, max_batch_size=8, required_batch_count_multiple=3,
                   seed=3),
    "unsorted_grid": dict(max_batch_frames=4000, max_batch_size=16, sort_by_similar_size=False,
                          frame_count_grid=10, seed=11),
}


@pytest.mark.parametrize("case", list(SAMPLERS))
def test_sampler_batches_match_jax(case):
    """The port's one-card sampler against the JAX sampler's single replica."""
    from xiaoicesing_io_tpu.data.sampler import DistributedBatchSampler as J
    from xiaoicesing_io_tpu_torch.data.sampler import BatchSampler as P

    ds = Sizes(np.random.default_rng(0).integers(40, 900, 97))
    j, p = J(ds, **SAMPLERS[case]), P(ds, **SAMPLERS[case])
    for epoch in range(3):
        j.set_epoch(epoch)
        p.set_epoch(epoch)
        assert len(p) == len(j) > 0
        assert [list(b) for b in p] == [list(b) for b in j]
    with pytest.raises(RuntimeError):
        P(Sizes([]), 1000, 8).set_epoch(0)
    assert list(P(Sizes([]), 1000, 8, disallow_empty_batch=False)) == []


def test_fixed_batch_rows_match_jax():
    from xiaoicesing_io_tpu.training.trainer import fixed_batch_rows as J
    from xiaoicesing_io_tpu_torch.training.trainer import fixed_batch_rows as P

    for n_items in (1, 3, 9, 40):
        for t_pad in (128, 256, 1024, 2048):
            for frames, size in ((50000, 64), (6000, 5), (80000, 7), (1000, 64)):
                assert P(n_items, t_pad, frames, size) == J(n_items, t_pad, frames, size, 1)


def test_collate_train_and_narrowing_match_jax(binary):
    """The train batch (its zero rows included) and its narrowed wire
    arrays equal JAX's byte for byte; widening restores f32 and int64."""
    from xiaoicesing_io_tpu.training.trainer import Trainer as JTrainer, _narrow_batch
    from xiaoicesing_io_tpu_torch.data.dataset import AcousticDataset
    from xiaoicesing_io_tpu_torch.training.trainer import Trainer, narrow_batch, widen_batch

    cfg = _acoustic_cfg(binary, binary / "unused", max_batch_frames=1000, max_batch_size=16)
    ds = AcousticDataset(binary / "acoustic", "train", cfg)
    ns = SimpleNamespace(cfg=cfg, train_dataset=ds, collate=ds.collate, n_local=1)
    jplan, pplan = {}, {}
    for indices in ([0], [3, 1, 2], [4, 5, 6, 7, 8, 9]):
        ref = JTrainer._collate_train(ns, indices)
        got = Trainer._collate_train(ns, indices)
        assert got["tokens"].shape[0] % 8 == 0 and got["tokens"].shape[0] > len(indices)
        jn, pn = _narrow_batch(ref, jplan), narrow_batch(got, pplan)
        for a, b in ((got, ref), (pn, jn)):
            assert list(a) == list(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                assert a[k].tobytes() == b[k].tobytes(), k
        wide = widen_batch({k: torch.as_tensor(v) for k, v in pn.items()})
        assert wide["mel"].dtype == torch.float32 and wide["mel2ph"].dtype == torch.int64
        np.testing.assert_array_equal(wide["mel"].numpy(), jn["mel"].astype(np.float32))
    assert pplan == jplan and pplan["mel"] == np.float16 and pplan["mel2ph"] == np.int16
    big = {"mel": np.full((1, 2), 70000.0, np.float32), "mel2ph": np.full((1, 2), 40000)}
    assert narrow_batch(big, pplan)["mel"].dtype == np.float32 == pplan["mel"]
    assert narrow_batch(big, pplan)["mel2ph"].dtype == np.int64


def test_load_config_overrides_and_reset_match_jax(tmp_path):
    """The file chain, the saved work-dir config, ``reset`` and ``key=value``
    overrides in the JAX package's precedence; ``save`` writes the merged
    config."""
    import yaml

    from xiaoicesing_io_tpu.config import load_config as J, parse_overrides as JP
    from xiaoicesing_io_tpu_torch.config import load_config as P, parse_overrides as PP

    spec = "max_updates=7,optimizer_args.lr=0.01,frozen_params=[a.b, c],flag=True,x=null,s=word"
    assert PP(spec) == JP(spec)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump({"base_config": ["acoustic.yaml"], "max_updates": 3,
                                    "hidden_size": 64}))
    work = tmp_path / "ckpt" / "e"
    work.mkdir(parents=True)
    (work / "config.yaml").write_text(yaml.safe_dump({"hidden_size": 128, "val_check_interval": 9}))
    keys = ("max_updates", "hidden_size", "val_check_interval", "optimizer_args", "frozen_params",
            "flag", "x", "s", "work_dir", "exp_name", "diffusion_type")
    for reset in (False, True):
        kw = dict(exp_name="e", work_dir_root=tmp_path / "ckpt", overrides=spec, reset=reset)
        j, p = J(path, **kw), P(path, **kw)
        assert {k: p.get(k) for k in keys} == {k: j.get(k) for k in keys}
        assert p["hidden_size"] == (64 if reset else 128)
    saved = P(path, exp_name="e", work_dir_root=tmp_path / "ckpt", overrides="max_updates=11",
              save=True)
    assert yaml.safe_load((work / "config.yaml").read_text())["max_updates"] == 11 == \
        saved["max_updates"]
    with pytest.raises(FileNotFoundError):
        P(None, exp_name="e", work_dir_root=tmp_path / "ckpt", reset=True)


# ---------------------------------------------------------------------------
# fits
# ---------------------------------------------------------------------------

def _ckpt_steps(work):
    from xiaoicesing_io_tpu_torch.training.checkpoint import checkpoint_step, list_checkpoints

    return [checkpoint_step(p) for p in list_checkpoints(work)]


def test_acoustic_fit_checkpoints_resume_and_readers(binary, tmp_path, capsys):
    """Saves every update with ``num_ckpt_keep: 2`` and permanent ones from
    step 2 every 3rd; an incomplete save is skipped on resume and removed
    by the next save; a second trainer resumes at the saved step and epoch;
    the checkpoint reads in the port's runner and ``eval`` and in the JAX
    package's loader."""
    from xiaoicesing_io_tpu.training.checkpoint import load_params_for_inference
    from xiaoicesing_io_tpu_torch.eval.copy_synthesis import evaluate_acoustic
    from xiaoicesing_io_tpu_torch.inference.acoustic import DiffSingerAcousticInfer
    from xiaoicesing_io_tpu_torch.training.tasks import build_acoustic_trainer

    work = tmp_path / "exp"
    over = dict(max_updates=6, val_check_interval=1, num_ckpt_keep=2, permanent_ckpt_start=2,
                permanent_ckpt_interval=3, num_sanity_val_steps=0)
    trainer = build_acoustic_trainer(_acoustic_cfg(binary, work, **over), device="cpu",
                                     writer=None)
    assert len(trainer._make_sampler(0)) == 3  # steps 1-3 in epoch 0, 4-6 in epoch 1
    trainer.fit()
    assert _ckpt_steps(work) == [2, 4, 5, 6]  # permanent 2, 5; the newest two of the rest
    ckpt = torch.load(work / "model_ckpt_steps_6.ckpt", weights_only=False)
    assert sorted(ckpt) == ["category", "epoch", "global_step", "optimizer_states",
                            "state_dict"]
    assert ckpt["category"] == "acoustic" and ckpt["global_step"] == 6 and ckpt["epoch"] == 1
    assert all(k.startswith("model.") for k in ckpt["state_dict"])
    assert len(ckpt["optimizer_states"][0]["state"]) == len(list(trainer.state.params))
    # an interrupted save, resume, the next save cleans it
    (work / "model_ckpt_steps_99.ckpt.partial").write_bytes(b"cut short")
    capsys.readouterr()
    trainer2 = build_acoustic_trainer(_acoustic_cfg(binary, work, **dict(over, max_updates=8)),
                                      device="cpu", writer=None)
    trainer2.fit()
    assert "resumed from step 6 (epoch 1)" in capsys.readouterr().out
    assert _ckpt_steps(work) == [2, 5, 6, 7, 8]  # 8 is permanent too
    assert not list(work.glob("*.partial"))
    # resumed in epoch 1 (from its start, as the JAX trainer resumes), not 0
    assert torch.load(work / "model_ckpt_steps_8.ckpt", weights_only=False)["epoch"] == 1
    # readers of the reference format
    cfg = _acoustic_cfg(binary, work, **over)
    runner = DiffSingerAcousticInfer(cfg, load_vocoder=False, device="cpu")
    sd = trainer2.state.model.state_dict()
    for k, v in runner.model.state_dict().items():
        assert torch.equal(v, sd[k].cpu()), k
    report = evaluate_acoustic(cfg, "valid", device="cpu")
    assert report["step"] == 8 and np.isfinite(report["mean_mel_mae"])
    from xiaoicesing_io_tpu.config import load_config as jload

    jcfg = jload(ROOT / "xiaoicesing_io_tpu/configs/acoustic.yaml")
    jcfg.update({k: cfg[k] for k in ("hidden_size", "enc_layers", "num_heads", "backbone_args",
                                     "shallow_diffusion_args")})
    params = load_params_for_inference(work, jcfg)["params"]
    np.testing.assert_array_equal(np.asarray(params["fs2"]["txt_embed"]["embedding"]),
                                  sd["fs2.txt_embed.weight"].numpy())


def test_sigterm_checkpoints_and_exits(binary, tmp_path, capsys):
    from xiaoicesing_io_tpu_torch.training.tasks import build_acoustic_trainer

    work = tmp_path / "exp"
    trainer = build_acoustic_trainer(
        _acoustic_cfg(binary, work, max_updates=50, val_check_interval=100,
                      num_sanity_val_steps=0), device="cpu", writer=None)
    step_fn = trainer.train_step

    def step(state, batch, generator):
        out = step_fn(state, batch, generator)
        if state.step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer.train_step = step
    trainer.fit()
    assert "training preempted at step 3" in capsys.readouterr().out
    assert _ckpt_steps(work) == [3]
    assert signal.getsignal(signal.SIGTERM) is not None


def test_finetune_blacklist_and_shapes(binary, tmp_path, capsys):
    """Finetuning copies the source's tensors except blacklisted names; a
    shape mismatch raises unless ``finetune_strict_shapes`` is off; a
    category mismatch and a directory that is no complete JAX checkpoint
    raise."""
    from xiaoicesing_io_tpu_torch.training.acoustic import build_acoustic
    from xiaoicesing_io_tpu_torch.training.finetune import load_finetune_params

    cfg = _acoustic_cfg(binary, tmp_path / "w")
    torch.manual_seed(3)
    src, _, _ = build_acoustic(cfg, 70)  # another vocabulary: txt_embed differs in shape
    path = tmp_path / "src.ckpt"
    torch.save({"category": "acoustic",
                "state_dict": {f"model.{k}": v for k, v in src.state_dict().items()}}, path)
    torch.manual_seed(4)
    dst, _, _ = build_acoustic(cfg, 60)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    cfg.update(finetune_ckpt_path=str(path), finetune_ignored_params=["model.fs2.encoder"])
    with pytest.raises(ValueError, match="Shape mismatch"):
        load_finetune_params(dst, cfg, "acoustic")
    cfg["finetune_strict_shapes"] = False
    load_finetune_params(dst, cfg, "acoustic")
    assert "shape-mismatched" in capsys.readouterr().out
    for k, v in dst.state_dict().items():
        if k.startswith("fs2.encoder") or k == "fs2.txt_embed.weight":
            assert torch.equal(v, before[k]), k
        else:
            assert torch.equal(v, src.state_dict()[k]), k
    with pytest.raises(ValueError, match="category"):
        load_finetune_params(dst, cfg, "variance")
    cfg["finetune_ckpt_path"] = str(tmp_path)
    with pytest.raises(ValueError, match="directory"):
        load_finetune_params(dst, cfg, "acoustic")


def test_cli_train_end_to_end(binary, tmp_path):
    """``train --config --exp_name --work_dir --hparams --device cpu``: the
    merged config and checkpoints in the work dir; again with ``--reset``."""
    import yaml

    from xiaoicesing_io_tpu_torch.cli import main

    cfg = dict(_acoustic_cfg(binary, "unused"))
    cfg.pop("work_dir")
    cfg_path = tmp_path / "my.json"
    cfg_path.write_text(json.dumps({"base_config": ["acoustic.yaml"],
                                    **{k: v for k, v in cfg.items() if k != "infer"}}))
    args = ["train", "--config", str(cfg_path), "--exp_name", "e", "--work_dir",
            str(tmp_path / "ckpt"), "--device", "cpu",
            "--hparams", "max_updates=2,val_check_interval=2,num_sanity_val_steps=0"]
    main(args)
    work = tmp_path / "ckpt" / "e"
    saved = yaml.safe_load((work / "config.yaml").read_text())
    assert saved["max_updates"] == 2 and saved["work_dir"] == str(work)
    assert _ckpt_steps(work) == [2] and (work / "dictionary.txt").exists()
    main(args[:-1] + ["max_updates=3,val_check_interval=3,num_sanity_val_steps=0", "--reset"])
    assert _ckpt_steps(work) == [2, 3]


def test_acoustic_validation_extras(binary, tmp_path, capsys):
    """The extras sample through the runner's kernel path: their mel equals
    that of a runner loaded from the saved checkpoint on the same item and
    seed; each logged wav is finite and frames x hop long (the ground
    truth's at the first validation only).  Without a vocoder checkpoint
    there is no audio; a checkpoint that does not load raises."""
    from xiaoicesing_io_tpu_torch.eval.copy_synthesis import _batch_from_item
    from xiaoicesing_io_tpu_torch.inference.acoustic import DiffSingerAcousticInfer
    from xiaoicesing_io_tpu_torch.training.tasks import build_acoustic_trainer

    work = tmp_path / "exp"
    cfg = _acoustic_cfg(binary, work, vocoder_ckpt=str(binary / "vocoder" / "model.ckpt"),
                        num_sanity_val_steps=0)
    writer = Recorder()
    trainer = build_acoustic_trainer(cfg, device="cpu", writer=writer)
    mels = []
    forward = DiffSingerAcousticInfer.forward_model

    def recorded(self, batch, seed=0, noise=None, _f32_module=False):
        out = forward(self, batch, seed=seed, noise=noise, _f32_module=_f32_module)
        mels.append(out)
        return out

    DiffSingerAcousticInfer.forward_model = recorded
    try:
        trainer.fit()
    finally:
        DiffSingerAcousticInfer.forward_model = forward
    assert len(mels) == 2  # one plot at steps 2 and 4
    frames = int((trainer.valid_dataset[0]["mel2ph"] > 0).sum())
    assert [(t, s) for t, _, s, _ in writer.audio] == [
        ("validation/wav_diff_0", 2), ("validation/wav_gt_0", 2), ("validation/wav_diff_0", 4)]
    for _, wav, _, sr in writer.audio:
        assert wav.shape == (frames * 512,) and np.isfinite(wav).all() and sr == 44100
    runner = DiffSingerAcousticInfer(cfg, load_vocoder=False, device="cpu")
    b = trainer.valid_dataset.collate([0])
    np.testing.assert_array_equal(runner.forward_model(_batch_from_item(cfg, runner, b), seed=0),
                                  mels[-1])
    assert any(t == "validation/total_loss" for t, _, _ in writer.scalars)
    # no checkpoint: no audio, a line saying so; a corrupt one raises
    capsys.readouterr()
    cfg2 = _acoustic_cfg(binary, tmp_path / "e2", vocoder_ckpt=str(tmp_path / "none.ckpt"),
                         num_sanity_val_steps=0, max_updates=2)
    w2 = Recorder()
    build_acoustic_trainer(cfg2, device="cpu", writer=w2).fit()
    assert "no vocoder checkpoint" in capsys.readouterr().out and not w2.audio
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "model.ckpt").write_bytes(b"not a checkpoint")
    cfg3 = _acoustic_cfg(binary, tmp_path / "e3", vocoder_ckpt=str(tmp_path / "bad/model.ckpt"),
                         num_sanity_val_steps=0, max_updates=2)
    with pytest.raises(Exception):
        build_acoustic_trainer(cfg3, device="cpu", writer=Recorder()).fit()


def test_variance_fit_and_metrics(binary, tmp_path, capsys):
    """A tiny variance fit: duration, pitch and energy losses, a checkpoint
    the variance runner loads, and the validation metrics."""
    from xiaoicesing_io_tpu_torch.inference.variance import load_variance_model
    from xiaoicesing_io_tpu_torch.training.tasks import build_trainer_from_config

    work = tmp_path / "var"
    cfg = _variance_cfg(binary, work)
    trainer = build_trainer_from_config(cfg, device="cpu")
    trainer.writer = Recorder()
    trainer.fit()
    out = capsys.readouterr().out
    assert "dur_loss=" in out and "pitch_loss=" in out and "var_loss=" in out
    assert "| metrics @ step 4: rhythm_corr=" in out and "pitch_acc=" in out
    assert set(trainer.last_metrics) == {"rhythm_corr", "ph_dur_acc", "pitch_acc"}
    assert all(0.0 <= v <= 1.0 for v in trainer.last_metrics.values())
    assert _ckpt_steps(work) == [2, 4]
    model = load_variance_model(cfg, trainer.state.model.fs2.txt_embed.num_embeddings)
    sd = trainer.state.model.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())


def test_prefetch_propagates_collate_errors(binary, tmp_path):
    from xiaoicesing_io_tpu_torch.training.tasks import build_acoustic_trainer

    trainer = build_acoustic_trainer(_acoustic_cfg(binary, tmp_path / "e",
                                                   num_sanity_val_steps=0),
                                     device="cpu", writer=None)

    def broken(indices, **kw):
        raise RuntimeError("collate failed")

    trainer.collate = broken
    with pytest.raises(RuntimeError, match="collate failed"):
        trainer.fit()


def test_watchdogs_and_profiler(binary, tmp_path, monkeypatch, capsys):
    """The RSS watchdog checkpoints and re-execs at a log step; the stall
    watchdog re-execs without saving on a stale heartbeat; the profiler
    writes its trace."""
    from xiaoicesing_io_tpu_torch.training import trainer as T
    from xiaoicesing_io_tpu_torch.training.tasks import build_acoustic_trainer

    work = tmp_path / "e"
    trainer = build_acoustic_trainer(
        _acoustic_cfg(binary, work, max_updates=20, log_interval=2, val_check_interval=100,
                      num_sanity_val_steps=0, max_host_rss_mb=1, profile_trace_steps=2),
        device="cpu", writer=None)
    calls = []
    monkeypatch.setattr(trainer, "_exec_restart",
                        lambda step, save=True: calls.append((step, save)))
    trainer.fit()
    assert calls == [(4, True)] and _ckpt_steps(work) == [4]
    assert (work / "trace" / "trace.json").stat().st_size > 0
    assert "checkpointing and restarting" in capsys.readouterr().out

    stalled = SimpleNamespace(_heartbeat=0.0, restarts=[])

    def restart(step, save=True):
        stalled.restarts.append((step, save))
        raise SystemExit

    stalled._exec_restart = restart
    with pytest.raises(SystemExit):
        T._stall_guard_loop(stalled, stall_min=0.001, poll_s=0.0)
    assert stalled.restarts == [(-1, False)]
    assert T._host_rss_mb() > 0


def test_trainers_raise_without_cuda(binary, tmp_path, monkeypatch):
    """Without CUDA every trainer entry point raises unless asked for the CPU."""
    from xiaoicesing_io_tpu_torch.cli import main
    from xiaoicesing_io_tpu_torch.training.tasks import (
        build_acoustic_trainer, build_trainer_from_config, build_variance_trainer,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_acoustic_trainer(_acoustic_cfg(binary, tmp_path / "a"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_variance_trainer(_variance_cfg(binary, tmp_path / "v"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_trainer_from_config(_acoustic_cfg(binary, tmp_path / "c"))
    cfg_path = tmp_path / "c.json"
    cfg_path.write_text(json.dumps({k: v for k, v in _acoustic_cfg(binary, "x").items()
                                    if k not in ("work_dir", "infer")}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["train", "--config", str(cfg_path), "--exp_name", "e", "--work_dir",
              str(tmp_path / "ckpt")])
    assert not (tmp_path / "a").exists()
