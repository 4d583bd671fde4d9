"""The port's deployment tools and profiling helpers, on the CPU.

``modify_spk_embed`` against the JAX package's for every fill; ``drop_speakers``
and ``cli drop_spk`` on a port checkpoint with two speakers; the latency
benchmarks at tiny widths; ``Timer``, ``ThroughputMeter`` and the
``torch.profiler`` trace.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
DICT = ROOT / "dictionaries" / "opencpop-extension.txt"
SPEAKERS = {"alice": 0, "bob": 1}
TINY = dict(hidden_size=32, enc_layers=1, num_heads=2, sampling_steps=2, use_spk_id=True,
            num_spk=2, backbone_args={"num_channels": 64, "num_layers": 1, "kernel_size": 31,
                                      "dropout_rate": 0.0, "strong_cond": True})


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on shared cores; torch's
    intra-op threads then oversubscribe them.  One thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("retain", [False, True])
@pytest.mark.parametrize("fill", ["zeros", "random", "mean", "cyclic"])
def test_modify_spk_embed_matches_jax(fill, retain):
    """Every fill, dropping or retaining, with one seeded ``rng`` on each side."""
    from xiaoicesing_io_tpu.deployment.drop_spk import modify_spk_embed as jax_modify
    from xiaoicesing_io_tpu_torch.deployment.drop_spk import modify_spk_embed

    table = np.random.default_rng(0).standard_normal((6, 8)).astype(np.float32)
    ids = {1, 4, 9}  # 9 is no speaker of the table
    kw = dict(retain_ids=ids) if retain else dict(drop_ids=ids)
    got = modify_spk_embed(table, fill=fill, rng=np.random.default_rng(42), **kw)
    ref = jax_modify(table, fill=fill, rng=np.random.default_rng(42), **kw)
    assert got.dtype == table.dtype
    np.testing.assert_array_equal(got, ref)
    kept = sorted(ids & set(range(6))) if retain else sorted(set(range(6)) - ids)
    np.testing.assert_array_equal(got[kept], table[kept])
    assert not np.array_equal(got, table)


def test_modify_spk_embed_refuses():
    from xiaoicesing_io_tpu_torch.deployment.drop_spk import modify_spk_embed

    table = np.ones((3, 4), np.float32)
    with pytest.raises(ValueError, match="unknown fill"):
        modify_spk_embed(table, drop_ids={0}, fill="noise")
    with pytest.raises(ValueError, match="at least one retained"):
        modify_spk_embed(table, retain_ids=set(), fill="cyclic")
    with pytest.raises(ValueError, match="drop_ids or retain_ids"):
        modify_spk_embed(table)


def _port_cfg(work_dir):
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults

    cfg = acoustic_defaults()
    cfg.update(work_dir=str(work_dir), dictionary=str(DICT), **TINY)
    cfg["backbone_args"] = dict(TINY["backbone_args"])
    cfg["shallow_diffusion_args"]["aux_decoder_args"].update(num_channels=32, num_layers=1)
    return cfg


@pytest.fixture
def exp(tmp_path):
    """``<root>/exp``: a two-speaker port acoustic model saved by the
    trainer's ``CheckpointManager`` at steps 50 and 100, its config and
    speaker map."""
    from xiaoicesing_io_tpu_torch.training.acoustic import build_acoustic
    from xiaoicesing_io_tpu_torch.training.checkpoint import CheckpointManager
    from xiaoicesing_io_tpu_torch.training.train_state import TrainState
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    wd = tmp_path / "root" / "exp"
    cfg = _port_cfg(wd)
    vocab = TokenTextEncoder(PhonemeDictionary.load(DICT).phoneme_list).vocab_size
    torch.manual_seed(0)
    model, _, _ = build_acoustic(cfg, vocab)
    manager = CheckpointManager(wd, category="acoustic")
    manager.save(TrainState(model, cfg), step=50)
    with torch.no_grad():
        model.fs2.spk_embed.weight.normal_()
    manager.save(TrainState(model, cfg), step=100)
    (wd / "spk_map.json").write_text(json.dumps(SPEAKERS))
    (wd / "config.json").write_text(json.dumps(dict(cfg)))
    return wd, cfg


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def _assert_scrubbed(before, after, fill, drop=None, retain=None):
    """The table scrubbed as JAX's ``modify_spk_embed`` scrubs it; every
    other tensor and every other key byte-equal."""
    from xiaoicesing_io_tpu.deployment.drop_spk import modify_spk_embed

    key = "model.fs2.spk_embed.weight"
    assert set(after) == set(before)
    for k in before:
        if k != "state_dict":
            assert after[k] == before[k], k
    sd, sd0 = after["state_dict"], before["state_dict"]
    assert list(sd) == list(sd0)
    for k in sd0:
        if k != key:
            assert sd[k].dtype == sd0[k].dtype and torch.equal(sd[k], sd0[k]), k
    ref = modify_spk_embed(sd0[key].numpy(), drop_ids=drop, retain_ids=retain, fill=fill)
    if fill == "random":  # a fresh rng each side: the kept rows and the shape only
        kept = sorted(retain) if retain is not None else sorted(set(SPEAKERS.values()) - drop)
        np.testing.assert_array_equal(sd[key].numpy()[kept], ref[kept])
        assert not np.array_equal(sd[key].numpy(), sd0[key].numpy())
    else:
        np.testing.assert_array_equal(sd[key].numpy(), ref)


def test_drop_speakers_in_place(exp, capsys):
    """By name, in place: refused without ``overwrite``; with it the latest
    checkpoint is rewritten and loads in the runner."""
    from xiaoicesing_io_tpu_torch.deployment.drop_spk import drop_speakers
    from xiaoicesing_io_tpu_torch.inference.acoustic import DiffSingerAcousticInfer

    wd, cfg = exp
    latest, older = wd / "model_ckpt_steps_100.ckpt", wd / "model_ckpt_steps_50.ckpt"
    before, older_bytes = _load(latest), older.read_bytes()
    with pytest.raises(PermissionError, match="without --overwrite"):
        drop_speakers(wd.name, ["alice"], work_dir_root=str(wd.parent))
    assert _load(latest)["state_dict"]["model.fs2.spk_embed.weight"].abs().sum() > 0
    assert drop_speakers(wd.name, ["alice"], work_dir_root=str(wd.parent),
                         overwrite=True) == latest
    assert "scrubbed speakers [0]" in capsys.readouterr().out
    _assert_scrubbed(before, _load(latest), "zeros", drop={0})
    assert older.read_bytes() == older_bytes
    assert sorted(p.name for p in wd.iterdir()) == [
        "config.json", "model_ckpt_steps_100.ckpt", "model_ckpt_steps_50.ckpt", "spk_map.json"]
    runner = DiffSingerAcousticInfer(cfg, load_vocoder=False, device="cpu")
    np.testing.assert_array_equal(runner.model.fs2.spk_embed.weight.detach().numpy()[0], 0.0)


@pytest.mark.parametrize("fill", ["mean", "cyclic", "random"])
def test_drop_speakers_to_out(exp, tmp_path, fill):
    """By id into ``out``: the source stays as it was; an existing ``out``
    is replaced only with ``overwrite``."""
    from xiaoicesing_io_tpu_torch.deployment.drop_spk import drop_speakers

    wd, _ = exp
    src = wd / "model_ckpt_steps_100.ckpt"
    src_bytes, before = src.read_bytes(), _load(src)
    out = tmp_path / "scrubbed" / "model.ckpt"
    drop_speakers(wd.name, ["1"], fill=fill, work_dir_root=str(wd.parent), out=str(out))
    assert src.read_bytes() == src_bytes
    _assert_scrubbed(before, _load(out), fill, drop={1})
    with pytest.raises(FileExistsError, match="--overwrite"):
        drop_speakers(wd.name, ["1"], work_dir_root=str(wd.parent), out=str(out))
    drop_speakers(wd.name, ["1"], work_dir_root=str(wd.parent), out=str(out), overwrite=True)
    _assert_scrubbed(before, _load(out), "zeros", drop={1})


def test_drop_speakers_retain_and_cli(exp, tmp_path):
    """``--retain`` keeps the named speaker and scrubs the other, through
    the command line."""
    from xiaoicesing_io_tpu_torch import cli

    wd, _ = exp
    before = _load(wd / "model_ckpt_steps_100.ckpt")
    out = tmp_path / "kept.ckpt"
    cli.main(["drop_spk", wd.name, "--spk", "bob", "--retain", "--fill", "cyclic",
              "--work_dir", str(wd.parent), "--out", str(out)])
    _assert_scrubbed(before, _load(out), "cyclic", retain={1})
    table = _load(out)["state_dict"]["model.fs2.spk_embed.weight"]
    assert torch.equal(table[0], table[1])


def test_drop_speakers_top_level_table_and_none(tmp_path):
    """A variance checkpoint's own table (``model.spk_embed``) is scrubbed;
    a checkpoint without a speaker table raises."""
    from xiaoicesing_io_tpu_torch.deployment.drop_spk import drop_speakers

    wd = tmp_path / "var"
    wd.mkdir()
    table = torch.randn(3, 4)
    other = torch.randn(5)
    torch.save({"category": "variance", "global_step": 7,
                "state_dict": {"model.spk_embed.weight": table, "model.x": other}},
               wd / "model_ckpt_steps_7.ckpt")
    drop_speakers("var", ["2"], work_dir_root=str(tmp_path), overwrite=True)
    sd = _load(wd / "model_ckpt_steps_7.ckpt")["state_dict"]
    assert torch.equal(sd["model.spk_embed.weight"][:2], table[:2])
    assert torch.equal(sd["model.spk_embed.weight"][2], torch.zeros(4))
    assert torch.equal(sd["model.x"], other)
    torch.save({"state_dict": {"model.x": other}}, wd / "model_ckpt_steps_8.ckpt")
    with pytest.raises(KeyError, match="no speaker embedding table"):
        drop_speakers("var", ["0"], work_dir_root=str(tmp_path), overwrite=True)
    with pytest.raises(FileNotFoundError):
        drop_speakers("none", ["0"], work_dir_root=str(tmp_path), overwrite=True)


def _bench_cfg(**over):
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults

    cfg = acoustic_defaults()
    cfg.update(enc_layers=1, hidden_size=32, num_heads=2,
               backbone_args={"num_channels": 16, "num_layers": 1, "kernel_size": 31,
                              "strong_cond": True}, **over)
    cfg["shallow_diffusion_args"]["aux_decoder_args"].update(num_channels=16, num_layers=1)
    return cfg


@pytest.mark.parametrize("over", [
    {},  # rectified flow with the shallow aux decoder
    # a DDPM core without an aux decoder: DDIM from pure noise, no aux_out
    dict(diffusion_type="ddpm", use_shallow_diffusion=False, timesteps=8, diff_speedup=4),
])
def test_bench_acoustic(over, capsys):
    from xiaoicesing_io_tpu_torch.deployment.benchmarks import bench_acoustic

    dt = bench_acoustic(_bench_cfg(**over), tokens_n=4, frames=32, runs=2, steps=2,
                        device="cpu")
    assert dt > 0
    assert "| acoustic: 4 tokens / 32 frames / 2 steps: " in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench_acoustic(_bench_cfg(**over), runs=1)


def test_bench_vocoder(capsys):
    from xiaoicesing_io_tpu_torch.deployment.benchmarks import bench_vocoder

    dt = bench_vocoder(frames=8, runs=1, device="cpu")
    assert dt > 0
    assert "| vocoder: 8 frames: " in capsys.readouterr().out


def test_timer_and_throughput_meter(monkeypatch):
    from xiaoicesing_io_tpu_torch.utils import profiling

    clock = iter([10.0, 10.5, 20.0, 20.25])
    monkeypatch.setattr(profiling.time, "time", lambda: next(clock))
    monkeypatch.setattr(profiling.Timer, "timer_map", type(profiling.Timer.timer_map)(float))
    for _ in range(2):
        with profiling.Timer("step"):
            pass
    assert profiling.Timer.report() == {"step": 0.75}
    with profiling.Timer("off", enable=False):
        pass
    assert "off" not in profiling.Timer.report()

    ticks = iter([100.0, 102.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(ticks))
    meter = profiling.ThroughputMeter(sample_rate=44100, hop_size=512, num_chips=2)
    meter.start()
    meter.add_frames(44100)
    meter.add_frames(44100)
    assert meter.rate() == pytest.approx(88200 * 512 / 44100 / 2.0 / 2)


def test_torch_trace_writes_a_trace(tmp_path):
    from xiaoicesing_io_tpu_torch.utils.profiling import torch_trace

    with torch_trace(tmp_path / "trace") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]


def test_new_modules_import_with_jax_blocked():
    """The modules of this slice import with jax, flax and the JAX package
    unimportable, and the package walk that ``test_torch_slice.py`` scans
    finds them."""
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(ROOT)!r})
for name in ("jax", "flax", "xiaoicesing_io_tpu"):
    sys.modules[name] = None
import xiaoicesing_io_tpu_torch as pkg
names = {{m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}}
for name in ("inference.serving", "deployment", "deployment.drop_spk",
             "deployment.benchmarks", "utils.profiling"):
    assert pkg.__name__ + "." + name in names, name
    importlib.import_module(pkg.__name__ + "." + name)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=120)
    assert out.returncode == 0 and out.stdout.split()[-1] == "ok", out.stderr
