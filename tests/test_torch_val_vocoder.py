"""The port's copy-synthesis slice against the JAX package, on the CPU.

``load_wav``, the pitch tracker, the metrics, the pair scoring, the
``copy_synthesis`` runner and the ``val_vocoder`` / ``vocode`` commands.
Inputs come from seeded numpy.  The vocoder is a narrow random NSF-HiFiGAN
saved as a reference ``model.ckpt``: the port loads it as it is; the JAX side
runs the same weights through its f32 stock generator (the JAX wrapper's own
generator computes in bf16, which no f32 bar could hold), with the
deterministic source (``key=None`` / ``generator=None``).

Tolerances: host numpy code that both packages share within 1e-6 relative
(the pitch tracker at the bar of the JAX package's native-vs-numpy test:
f0 within 1e-3 Hz, ``uv`` identical); the f32 vocoder within 2e-4 (the
module bar), and the scores it moves within 1e-4 (mel MAE) and 1e-3 (PESQ*).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

ROOT = Path(__file__).resolve().parent.parent
SAMPLE = sorted((ROOT / "samples").glob("00_*.ds"))[0]
DICT = ROOT / "dictionaries" / "opencpop-extension.txt"

# upsampling 8*8*2*2*2 = 512 = hop_size, at narrow widths
VOCODER = dict(num_mels=128, sampling_rate=44100, hop_size=512, n_fft=2048, win_size=2048,
               fmin=40, fmax=16000, upsample_rates=[8, 8, 2, 2, 2],
               upsample_kernel_sizes=[16, 16, 4, 4, 4], upsample_initial_channel=32,
               resblock="1", resblock_kernel_sizes=[3, 7, 11],
               resblock_dilation_sizes=[[1, 3, 5]] * 3)

CFG = {"audio_sample_rate": 44100, "audio_num_mel_bins": 128, "fft_size": 2048,
       "win_size": 2048, "hop_size": 512, "fmin": 40, "fmax": 16000, "f0_min": 65,
       "f0_max": 1100, "mel_base": "e"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several worker processes share the cores: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tone(sr=44100, dur=1.0, f0=220.0, vibrato=0.02, silent_from=0.8, seed=0):
    """A vibrato tone with a second harmonic, light noise and a silent tail."""
    t = np.arange(int(sr * dur)) / sr
    f = f0 * (1 + vibrato * np.sin(2 * np.pi * 5.0 * t))
    phase = 2 * np.pi * np.cumsum(f) / sr
    x = (0.4 * np.sin(phase) + 0.15 * np.sin(2 * phase)
         + 0.002 * np.random.default_rng(seed).standard_normal(len(t)))
    x[int(silent_from * sr):] = 0.0
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def vocoder_dir(tmp_path_factory):
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import (
        Generator, NsfHifiganConfig,
    )

    d = tmp_path_factory.mktemp("vocoder")
    torch.manual_seed(1)
    torch.save({"generator": Generator(NsfHifiganConfig.from_json(VOCODER)).state_dict()},
               d / "model.ckpt")
    (d / "config.json").write_text(json.dumps(VOCODER))
    return d


class JaxF32Vocoder:
    """The JAX package's stock NSF-HiFiGAN generator in f32 on a reference
    ``model.ckpt``, behind the wrapper's ``spec2wav`` (natural-log mels)."""

    def __init__(self, cfg, model_path=None):
        from xiaoicesing_io_tpu.models.vocoders.nsf_hifigan import Generator, NsfHifiganConfig
        from xiaoicesing_io_tpu.utils.torch_ckpt import convert_nsf_hifigan

        model_path = Path(model_path or cfg["vocoder_ckpt"])
        vcfg = NsfHifiganConfig.from_json(json.loads(
            model_path.with_name("config.json").read_text()))
        sd = torch.load(model_path, map_location="cpu", weights_only=True)["generator"]
        self.params = convert_nsf_hifigan(sd, vcfg)
        self.generator = Generator(vcfg)

    def spec2wav(self, mel, f0, key=None):
        wav = self.generator.apply(self.params, jnp.asarray(mel, jnp.float32)[None],
                                   jnp.asarray(f0, jnp.float32)[None])
        return np.asarray(wav)[0]


# ---------------------------------------------------------------------------
# load_wav
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,file_sr", [
    ("int16", 44100), ("int16", 22050), ("int32", 44100), ("uint8", 16000),
    ("float32", 48000), ("stereo", 22050),
])
def test_load_wav_matches_jax(tmp_path, kind, file_sr):
    from xiaoicesing_io_tpu.utils.audio import load_wav as jload
    from xiaoicesing_io_tpu_torch.utils.audio import load_wav as pload

    x = _tone(sr=file_sr, dur=0.3, silent_from=1.0)
    data = {
        "int16": lambda: (x * 32767).astype(np.int16),
        "int32": lambda: (x * 2147483647).astype(np.int32),
        "uint8": lambda: (x * 127 + 128).astype(np.uint8),
        "float32": lambda: x,
        "stereo": lambda: (np.stack([x, 0.5 * x], 1) * 32767).astype(np.int16),
    }[kind]()
    path = tmp_path / "in.wav"
    wavfile.write(path, file_sr, data)
    for sr in (None, 44100):
        got, got_sr = pload(path, sr=sr)
        ref, ref_sr = jload(path, sr=sr)
        assert got_sr == ref_sr == (sr or file_sr)
        assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    got, _ = pload(path, sr=44100)
    assert abs(len(got) - round(len(x) * 44100 / file_sr)) <= 1


def test_save_wav_round_trip(tmp_path):
    from xiaoicesing_io_tpu.utils.audio import save_wav as jsave
    from xiaoicesing_io_tpu_torch.utils.audio import load_wav, save_wav

    x = _tone(dur=0.2)
    save_wav(x, tmp_path / "p.wav", 44100)
    jsave(x, tmp_path / "j.wav", 44100)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    y, sr = load_wav(tmp_path / "p.wav")
    assert sr == 44100 and np.abs(y - x).max() < 1e-4


# ---------------------------------------------------------------------------
# the pitch tracker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("interp_uv", [False, True])
def test_get_pitch_matches_jax(interp_uv):
    from xiaoicesing_io_tpu.dsp.pitch import get_pitch as jpitch
    from xiaoicesing_io_tpu_torch.dsp.pitch import get_pitch as ppitch

    wav = _tone()
    sr, hop = 44100, 512
    length = len(wav) // hop
    f0, uv = ppitch(wav, sr, length, hop_size=hop, interp_uv=interp_uv)
    f0_ref, uv_ref = jpitch(wav, sr, length, hop_size=hop, interp_uv=interp_uv)
    assert f0.shape == f0_ref.shape == (length,) and f0.dtype == np.float32
    np.testing.assert_array_equal(uv, uv_ref)
    np.testing.assert_allclose(f0, f0_ref, atol=1e-3, rtol=0)
    assert uv.any() and not uv.all()  # the tone is voiced, the tail is not
    voiced = ~uv
    cents = 1200 * np.abs(np.log2(f0[voiced][2:-2] / 220.0))
    assert cents.max() < 60  # +-2 % vibrato around 220 Hz is +-34 cents


def test_get_pitch_speed_matches_jax():
    from xiaoicesing_io_tpu.dsp.pitch import get_pitch as jpitch
    from xiaoicesing_io_tpu_torch.dsp.pitch import get_pitch as ppitch

    wav = _tone(f0=330.0, seed=1)
    kw = dict(hop_size=512, f0_min=80, f0_max=900, speed=1.2)
    f0, uv = ppitch(wav, 44100, 60, **kw)
    f0_ref, uv_ref = jpitch(wav, 44100, 60, **kw)
    np.testing.assert_array_equal(uv, uv_ref)
    np.testing.assert_allclose(f0, f0_ref, atol=1e-3, rtol=0)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _metric_inputs(name, rng):
    from xiaoicesing_io_tpu_torch.ops.mel import MelConfig

    mel_a = rng.standard_normal((40, 128)).astype(np.float32) - 4.0
    mel_b = mel_a[:37] + 0.1 * rng.standard_normal((37, 128)).astype(np.float32)
    wav = _tone(dur=0.5)
    deg = wav + 0.01 * rng.standard_normal(len(wav)).astype(np.float32)
    f0_a = rng.uniform(150, 300, 50)
    f0_a[:5] = 0.0
    f0_b = f0_a * 2 ** (rng.standard_normal(50) * 0.02)
    f0_b[3:8] = 0.0
    return {
        "mel_mae": ((mel_a, mel_b), {}),
        "mcd_mel": ((mel_a, mel_b), {}),
        "mcd_wave": ((wav, deg), {"is_mel": False}),
        "mcd_wave_small": ((wav[:8000], deg[:8000]),
                           {"is_mel": False, "n_mfcc": 10, "exclude_c0": False}),
        "f0_rmse_cents": ((f0_a, f0_b), {}),
        "f0_rmse_cents_unvoiced": ((np.zeros(10), f0_b[:10]), {}),
        "pesq_44k": ((wav, deg, 44100), {}),
        "pesq_16k": ((wav[:16000], deg[:16000], 16000), {}),
        "griffin_lim": ((mel_a[:12],), {"mel_cfg": MelConfig(), "n_iter": 4, "seed": 3}),
    }[name]


@pytest.mark.parametrize("name", [
    "mel_mae", "mcd_mel", "mcd_wave", "mcd_wave_small", "f0_rmse_cents",
    "f0_rmse_cents_unvoiced", "pesq_44k", "pesq_16k", "griffin_lim",
])
def test_metrics_match_jax(name):
    from xiaoicesing_io_tpu.eval import metrics as J
    from xiaoicesing_io_tpu.ops.mel import MelConfig as JMelConfig
    from xiaoicesing_io_tpu_torch.eval import metrics as P

    args, kw = _metric_inputs(name, np.random.default_rng(7))
    fn = {"mcd_mel": "mcd", "mcd_wave": "mcd", "mcd_wave_small": "mcd",
          "f0_rmse_cents_unvoiced": "f0_rmse_cents", "pesq_44k": "pesq_approx",
          "pesq_16k": "pesq_approx", "griffin_lim": "griffin_lim_from_logmel"}.get(name, name)
    got = getattr(P, fn)(*args, **kw)
    jkw = dict(kw, mel_cfg=JMelConfig()) if "mel_cfg" in kw else kw
    ref = getattr(J, fn)(*args, **jkw)
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# pair scoring and the runner
# ---------------------------------------------------------------------------

def test_score_pair_matches_jax():
    """The card branch through K3's plain version against the JAX package's
    TPU-branch lines reproduced with its ``.device()`` on the CPU; the CPU
    branch against its CPU-branch lines."""
    from xiaoicesing_io_tpu.ops.mel import MelConfig as JMC, MelSpectrogram as JMS
    from xiaoicesing_io_tpu_torch.inference.val_vocoder import _score_pair
    from xiaoicesing_io_tpu_torch.ops.mel import MelConfig, MelSpectrogram

    rng = np.random.default_rng(8)
    wav = _tone(dur=1.3, silent_from=1.1)
    rec = (np.concatenate([wav, np.zeros(700, np.float32)])
           + 0.02 * rng.standard_normal(len(wav) + 700).astype(np.float32))
    ext, jext = MelSpectrogram(MelConfig()), JMS(JMC())
    mel = ext.numpy(wav)

    got = _score_pair(ext, wav, rec, mel, torch.device("cpu"))
    m = min(len(wav), len(rec))
    pair = jext.device(np.stack([wav[:m], rec[:m]]))
    n = len(mel)
    ref = float(np.abs(pair[0][:n] - pair[1][:n]).mean())
    assert abs(got - ref) <= 1e-5
    assert got == _score_pair(ext, wav, rec, mel, torch.device("cpu"), plain=True)

    got = _score_pair(ext, wav, rec, mel, None)
    mel_rec = jext.numpy(rec[: len(wav)])
    n = min(len(mel), len(mel_rec))
    assert abs(got - float(np.abs(mel[:n] - mel_rec[:n]).mean())) <= 1e-6


def _write_inputs(d):
    """A 16-bit 44.1 kHz vibrato tone and a 22.05 kHz one (resampled on load)."""
    from xiaoicesing_io_tpu_torch.utils.audio import save_wav

    d.mkdir(exist_ok=True)
    save_wav(_tone(dur=0.6, silent_from=0.5), d / "a.wav", 44100)
    save_wav(_tone(sr=22050, dur=0.5, f0=300.0, silent_from=1.0, seed=2), d / "b.wav", 22050)
    return [d / "a.wav", d / "b.wav"]


def test_copy_synthesis_matches_jax(vocoder_dir, tmp_path):
    from xiaoicesing_io_tpu.inference.val_vocoder import copy_synthesis as jcopy
    from xiaoicesing_io_tpu_torch.inference.val_vocoder import copy_synthesis
    from xiaoicesing_io_tpu_torch.models.vocoders.wrapper import NsfHifiGAN
    from xiaoicesing_io_tpu_torch.ops.mel import num_frames

    cfg = dict(CFG, vocoder_ckpt=str(vocoder_dir / "model.ckpt"))
    paths = _write_inputs(tmp_path / "in")
    got = copy_synthesis(paths, cfg, tmp_path / "port", device="cpu",
                         vocoder=NsfHifiGAN(cfg, device="cpu"))
    ref = jcopy(paths, cfg, tmp_path / "jax", vocoder=JaxF32Vocoder(cfg))
    assert len(got) == len(ref) == 2
    for g, r, n in zip(got, ref, (int(0.6 * 44100), int(0.5 * 22050) * 2)):
        assert Path(g["out"]).name == Path(r["out"]).name
        assert set(g["seconds"]) == {"load", "gt_mel", "pitch", "vocoder", "save", "score",
                                     "pesq"}
        sr, wg = wavfile.read(g["out"])
        _, wr = wavfile.read(r["out"])
        assert sr == 44100 and wg.shape == wr.shape == (num_frames(n, 2048, 512) * 512,)
        assert np.abs(wr).max() > 100  # a signal, not silence
        np.testing.assert_allclose(wg / 32767, wr / 32767, atol=2e-4 + 1 / 32767, rtol=0)
        assert abs(g["mel_mae"] - r["mel_mae"]) <= 1e-4
        assert abs(g["pesq"] - r["pesq"]) <= 1e-3


def test_copy_synthesis_runs_the_card_branch_only_on_cuda(vocoder_dir, tmp_path, monkeypatch):
    """On the CPU the pair is scored by the host path; the device branch
    (K3 on the card) is chosen by the device alone."""
    from xiaoicesing_io_tpu_torch.inference import val_vocoder as V

    seen = []
    score = V._score_pair
    monkeypatch.setattr(V, "_score_pair",
                        lambda *a, **k: seen.append(a[4]) or score(*a, **k))
    cfg = dict(CFG, vocoder_ckpt=str(vocoder_dir / "model.ckpt"))
    V.copy_synthesis(_write_inputs(tmp_path / "in")[:1], cfg, tmp_path / "out", device="cpu")
    assert seen == [None]


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------

def _config_file(d, vocoder_dir):
    path = d / "voc.json"
    path.write_text(json.dumps({"base_config": ["acoustic.yaml"],
                                "vocoder_ckpt": str(vocoder_dir / "model.ckpt")}))
    return path


def test_val_vocoder_command_writes_wavs(vocoder_dir, tmp_path, capsys):
    from xiaoicesing_io_tpu_torch import cli
    from xiaoicesing_io_tpu_torch.ops.mel import num_frames

    paths = _write_inputs(tmp_path / "in")
    cli.main(["val_vocoder", *map(str, paths), "--config",
              str(_config_file(tmp_path, vocoder_dir)), "--out", str(tmp_path / "out"),
              "--device", "cpu"])
    for p, n in zip(paths, (int(0.6 * 44100), int(0.5 * 22050) * 2)):
        sr, wav = wavfile.read(tmp_path / "out" / f"{p.stem}_copysyn.wav")
        assert sr == 44100 and wav.shape == (num_frames(n, 2048, 512) * 512,)
    assert capsys.readouterr().out.count("PESQ*") == 2


def _short_ds(path):
    """The sample's first segment cut to its first six phonemes, twice; the
    second copy starts half a second in, so the two crossfade."""
    seg = json.loads(SAMPLE.read_text(encoding="utf-8"))[0]
    ph = seg["ph_seq"].split()[:6]
    dur = seg["ph_dur"].split()[:6]
    seg = dict(seg, ph_seq=" ".join(ph), ph_dur=" ".join(dur))
    second = dict(seg, offset=seg.get("offset", 0.0) + 0.5)
    path.write_text(json.dumps([seg, second]), encoding="utf-8")
    return path


@pytest.fixture(scope="module")
def mel_npz(tmp_path_factory, vocoder_dir):
    """``infer acoustic --mel`` of a two-segment ``.ds`` with a tiny random
    acoustic model (the port's command, on the CPU)."""
    from xiaoicesing_io_tpu_torch import cli
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults
    from xiaoicesing_io_tpu_torch.training.acoustic import build_acoustic
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    root = tmp_path_factory.mktemp("ckpts")
    exp = root / "exp"
    exp.mkdir()
    cfg = acoustic_defaults()
    cfg.update(work_dir=str(exp), dictionary=str(DICT), hidden_size=32, enc_layers=1,
               num_heads=2, sampling_steps=2, vocoder_ckpt=str(vocoder_dir / "model.ckpt"),
               backbone_args={"num_channels": 64, "num_layers": 1, "kernel_size": 31,
                              "dropout_rate": 0.0, "strong_cond": True})
    cfg["shallow_diffusion_args"]["aux_decoder_args"].update(num_channels=32, num_layers=1,
                                                            dropout_rate=0.0)
    (exp / "config.json").write_text(json.dumps(dict(cfg)))
    vocab = TokenTextEncoder(PhonemeDictionary.load(DICT).phoneme_list).vocab_size
    torch.manual_seed(0)
    model, _, _ = build_acoustic(cfg, vocab)
    sd = {f"model.{k}": v for k, v in model.state_dict().items()}
    torch.save({"category": "acoustic", "state_dict": sd}, exp / "model_ckpt_steps_1.ckpt")
    ds = _short_ds(root / "song.ds")
    cli.main(["infer", "acoustic", str(ds), "--exp", "exp", "--work_dir", str(root), "--mel",
              "--seed", "0", "--device", "cpu"])
    return root, root / "song.mel.npz"


def test_vocode_command_matches_jax(vocoder_dir, mel_npz, tmp_path, monkeypatch):
    """The port's ``vocode`` and the JAX package's, on the same ``.mel.npz``
    and the same f32 weights with the deterministic source: the same
    segment placement and crossfade."""
    import xiaoicesing_io_tpu.models.vocoders as jax_vocoders
    import xiaoicesing_io_tpu.utils as jax_utils
    import xiaoicesing_io_tpu_torch.utils as port_utils
    from xiaoicesing_io_tpu.cli.main import vocode as jvocode
    from xiaoicesing_io_tpu_torch import cli

    root, npz = mel_npz
    data = np.load(npz)
    assert sorted(data.files) == ["seg0_f0", "seg0_mel", "seg0_offset",
                                  "seg1_f0", "seg1_mel", "seg1_offset"]
    frames = [data[f"seg{i}_mel"].shape[0] for i in range(2)]
    monkeypatch.setattr(port_utils, "generator_from_seed", lambda *a, **k: None)
    monkeypatch.setattr(jax_utils, "key_from_seed", lambda *a, **k: None)
    monkeypatch.setattr(jax_vocoders, "get_vocoder_cls", lambda name: JaxF32Vocoder)
    config = _config_file(tmp_path, vocoder_dir)
    cli.main(["vocode", str(npz), "--config", str(config), "--out", str(tmp_path / "port"),
              "--seed", "3", "--device", "cpu"])
    jvocode.callback(mel_path=str(npz), exp=None, config=str(config), vocoder_cls=None,
                     vocoder_ckpt=None, out=str(tmp_path / "jax"), title=None, seed=3)
    sr, got = wavfile.read(tmp_path / "port" / "song.wav")
    _, ref = wavfile.read(tmp_path / "jax" / "song.wav")
    start = round(float(data["seg1_offset"]) * 44100) - round(float(data["seg0_offset"]) * 44100)
    assert 0 < start < frames[0] * 512  # the second segment overlaps the first
    assert sr == 44100 and got.shape == ref.shape
    assert got.shape == (round(float(data["seg1_offset"]) * 44100) + frames[1] * 512,)
    np.testing.assert_allclose(got / 32767, ref / 32767, atol=2e-4 + 1 / 32767, rtol=0)
    # the port's --exp resolves the experiment's config (its vocoder_ckpt)
    cli.main(["vocode", str(npz), "--exp", "ex", "--work_dir", str(root), "--title", "again",
              "--seed", "3", "--device", "cpu"])
    np.testing.assert_array_equal(wavfile.read(npz.parent / "again.wav")[1], got)


def test_entry_points_raise_without_cuda(vocoder_dir, mel_npz, tmp_path):
    """Without ``device=`` / ``--device`` the runner and both commands ask
    for CUDA and raise here."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from xiaoicesing_io_tpu_torch import cli
    from xiaoicesing_io_tpu_torch.inference.val_vocoder import copy_synthesis

    cfg = dict(CFG, vocoder_ckpt=str(vocoder_dir / "model.ckpt"))
    paths = _write_inputs(tmp_path / "in")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        copy_synthesis(paths, cfg, tmp_path / "out")
    config = str(_config_file(tmp_path, vocoder_dir))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["val_vocoder", str(paths[0]), "--config", config])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["vocode", str(mel_npz[1]), "--config", config, "--out", str(tmp_path)])
    assert not (tmp_path / "out").exists()
