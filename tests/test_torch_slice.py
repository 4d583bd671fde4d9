"""The port's `.ds` -> mel -> wav slice against the JAX package, on the CPU.

A tiny random acoustic model is saved once as a reference-format
``model_ckpt_steps_*.ckpt``; the JAX runner loads it through its own torch
converter and the port's runner through ``load_state_dict``.  The sampler's
start noise is the array the JAX runner draws from ``PRNGKey(seed)``, handed
to the port through ``noise=``.  The JAX runner takes its f32 flax path (its
kernels run only off the CPU); the port's runner takes its kernel path in
f32, where the conv-module wrapper runs its plain version on CPU tensors.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SAMPLE = sorted((ROOT / "samples").glob("00_*.ds"))[0]
DICT = ROOT / "dictionaries" / "opencpop-extension.txt"
PORT = ROOT / "xiaoicesing_io_tpu_torch"

TINY = dict(
    hidden_size=32, enc_layers=1, num_heads=2, sampling_steps=4,
    # LYNXNet with PReLU: the runner takes the conv-module kernel path
    backbone_args={"num_channels": 128, "num_layers": 2, "kernel_size": 31,
                   "dropout_rate": 0.0, "strong_cond": True},
)

# upsampling 8*8*2*2*2 = 512 = hop_size, at narrow widths
VOCODER = dict(num_mels=128, sampling_rate=44100, hop_size=512, n_fft=2048, win_size=2048,
               fmin=40, fmax=16000, upsample_rates=[8, 8, 2, 2, 2],
               upsample_kernel_sizes=[16, 16, 4, 4, 4], upsample_initial_channel=32,
               resblock="1", resblock_kernel_sizes=[3, 7, 11],
               resblock_dilation_sizes=[[1, 3, 5]] * 3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on shared cores; torch's
    intra-op threads then oversubscribe them and its convolutions slow down
    many-fold.  One thread per test, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(cfg, work_dir):
    cfg.update(work_dir=str(work_dir), dictionary=str(DICT), **TINY)
    cfg["backbone_args"] = dict(TINY["backbone_args"])
    cfg["shallow_diffusion_args"]["aux_decoder_args"].update(num_channels=32, num_layers=1,
                                                            dropout_rate=0.0)
    return cfg


def _port_cfg(work_dir):
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults

    return _tiny(acoustic_defaults(), work_dir)


def _jax_cfg(work_dir):
    from xiaoicesing_io_tpu.config import load_config

    return _tiny(load_config(ROOT / "xiaoicesing_io_tpu/configs/acoustic.yaml"), work_dir)


def _random_acoustic(cfg, seed=0):
    from xiaoicesing_io_tpu_torch.training.acoustic import build_acoustic
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    vocab = TokenTextEncoder(PhonemeDictionary.load(DICT).phoneme_list).vocab_size
    torch.manual_seed(seed)
    model, _, _ = build_acoustic(cfg, vocab)
    with torch.no_grad():
        # zero-initialised output projection and 1e-6 ConvNeXt layer scales
        # would hide the denoiser and the aux blocks: randomise them
        model.backbone.output_projection.weight.normal_(0.0, 0.05)
        for block in model.aux_decoder.decoder.conv:
            block.gamma.normal_(0.0, 0.5)
    return model.eval()


@pytest.fixture(scope="module")
def exp_dir(tmp_path_factory):
    """A work dir with a random tiny acoustic checkpoint and a random vocoder."""
    wd = tmp_path_factory.mktemp("port_exp")
    model = _random_acoustic(_port_cfg(wd))
    sd = {f"model.{k}": v for k, v in model.state_dict().items()}
    torch.save({"category": "acoustic", "state_dict": sd}, wd / "model_ckpt_steps_100.ckpt")

    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import (
        Generator, NsfHifiganConfig,
    )

    torch.manual_seed(1)
    gen = Generator(NsfHifiganConfig.from_json(VOCODER))
    voc = wd / "vocoder"
    voc.mkdir()
    torch.save({"generator": gen.state_dict()}, voc / "model.ckpt")
    (voc / "config.json").write_text(json.dumps(VOCODER))
    return wd


def _segment():
    with open(SAMPLE, encoding="utf-8") as f:
        return json.load(f)[0]


def test_bucket_padding_matches():
    from xiaoicesing_io_tpu.inference.acoustic import BUCKET as JB, _bucket as jb
    from xiaoicesing_io_tpu_torch.inference.acoustic import BUCKET as PB, _bucket as pb

    assert PB == JB == 256
    for n in (1, 255, 256, 257, 504, 512, 513, 2047, 2049):
        assert pb(n) == jb(n)


def test_ds_segment_mel_matches_jax(exp_dir):
    """One `.ds` segment: the same preprocessing, bucket padding and mel."""
    from xiaoicesing_io_tpu.inference.acoustic import DiffSingerAcousticInfer as JInfer
    from xiaoicesing_io_tpu_torch.inference.acoustic import (
        DiffSingerAcousticInfer as PInfer, _bucket,
    )

    seg = _segment()
    jr = JInfer(_jax_cfg(exp_dir), load_vocoder=False)
    pr = PInfer(_port_cfg(exp_dir), load_vocoder=False, device="cpu")
    assert pr.use_kernels  # lynx_denoiser_apply in f32, the kernel's plain version
    jb, pb = jr.preprocess_input(seg), pr.preprocess_input(seg)
    assert set(jb) == set(pb) == {"tokens", "mel2ph", "f0"}
    for k in jb:
        np.testing.assert_array_equal(np.asarray(pb[k]), np.asarray(jb[k]))

    seed = 1234
    length = jb["mel2ph"].shape[1]
    ref = jr.forward_model(jb, seed=seed)
    # the JAX runner's start noise: jax.random.normal on the raw key, over the bucket
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(seed & 0xFFFFFFFF),
                                         (1, 1, _bucket(length), 128), jnp.float32))
    got = pr.forward_model(pb, noise=noise)
    assert got.shape == ref.shape == (1, length, 128)
    assert np.isfinite(got).all()
    assert np.abs(ref).max() > 1.0  # random weights: not a near-zero mel
    # f32 on both sides, differing in summation order only: the module bar
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)


def test_run_inference_writes_wav(exp_dir, tmp_path):
    """Two segments (the second moved to overlap the first, so they
    crossfade) through the port's runner and a random vocoder."""
    from scipy.io import wavfile

    from xiaoicesing_io_tpu_torch.inference.acoustic import DiffSingerAcousticInfer

    with open(SAMPLE, encoding="utf-8") as f:
        segs = json.load(f)[:2]
    segs[1]["offset"] = segs[0]["offset"] + 4.0
    cfg = _port_cfg(exp_dir)
    cfg["vocoder_ckpt"] = str(exp_dir / "vocoder" / "model.ckpt")
    runner = DiffSingerAcousticInfer(cfg, device="cpu")
    lengths = []
    vocode = runner.run_vocoder

    def run_vocoder(mel, f0, seed=None):
        wav = vocode(mel, f0, seed=seed)
        assert np.isfinite(wav).all()
        lengths.append((mel.shape[1], wav.shape[0]))
        return wav

    runner.run_vocoder = run_vocoder
    (path,) = runner.run_inference(segs, out_dir=tmp_path, title="song", seed=7)
    assert [n for _, n in lengths] == [frames * 512 for frames, _ in lengths]
    sr, wav = wavfile.read(path)
    assert sr == 44100
    assert wav.shape == (round(segs[1]["offset"] * sr) + lengths[1][1],)
    # same seed, same take
    (again,) = runner.run_inference(segs, out_dir=tmp_path / "again", title="song", seed=7)
    np.testing.assert_array_equal(wavfile.read(again)[1], wav)


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)


def test_acoustic_carrier_round_trip(tmp_path):
    """port state_dict -> JAX convert_acoustic -> port carrier: identical."""
    from xiaoicesing_io_tpu.utils.torch_ckpt import convert_acoustic
    from xiaoicesing_io_tpu_torch.models.toplevel import _ALIASES
    from xiaoicesing_io_tpu_torch.utils.jax_weights import acoustic_state_dict_from_jax

    cfg = _port_cfg(tmp_path)
    sd = _random_acoustic(cfg).state_dict()
    params = jax.tree_util.tree_map(np.asarray, convert_acoustic(sd, cfg))
    back = acoustic_state_dict_from_jax(params, cfg)
    _assert_same({k: v for k, v in sd.items() if k not in _ALIASES}, back)


@pytest.mark.parametrize("mini_nsf", [False, True])
def test_nsf_hifigan_carrier_round_trip(mini_nsf):
    """port Generator state_dict -> JAX convert_nsf_hifigan -> port carrier."""
    from xiaoicesing_io_tpu.models.vocoders.nsf_hifigan import NsfHifiganConfig as JCfg
    from xiaoicesing_io_tpu.utils.torch_ckpt import convert_nsf_hifigan
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import (
        Generator, NsfHifiganConfig,
    )
    from xiaoicesing_io_tpu_torch.utils.jax_weights import nsf_hifigan_state_dict_from_jax

    vcfg = dict(VOCODER, mini_nsf=mini_nsf)
    pcfg = NsfHifiganConfig.from_json(vcfg)
    sd = Generator(pcfg).state_dict()
    params = convert_nsf_hifigan(sd, JCfg.from_json(vcfg))
    _assert_same(sd, nsf_hifigan_state_dict_from_jax(params, pcfg))


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_has_no_jax_imports():
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "xiaoicesing_io_tpu"}
    found = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.relative_to(ROOT)}: {n}" for n in names
                      if n.split(".")[0] in banned]
    assert not found, found


def test_port_imports_with_jax_blocked():
    """Every module of the port, and chip_smoke.py, imports with jax, flax,
    optax, orbax, tensorstore and the JAX package made unimportable: the
    JAX-checkpoint reader imports tensorstore inside its functions only."""
    code = f"""
import importlib, importlib.util, pkgutil, sys
sys.path.insert(0, {str(ROOT)!r})
for name in ("jax", "flax", "optax", "orbax", "tensorstore", "xiaoicesing_io_tpu"):
    sys.modules[name] = None
import xiaoicesing_io_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in ("ops.cuda.lynx_layer", "ops.cuda.lynx_hybrid", "tools.perf_sweep",
             "ops.cuda.hifigan_resblock", "models.vocoders.nsf_fast", "bench", "bench.__main__",
             "bench.cells", "bench.check", "bench.experiment", "bench.flops", "bench.inputs",
             "bench.reference", "bench.spread", "bench.trace", "inference.variance",
             "models.fastspeech.variance", "utils.spk_mix", "data", "data.hdf5",
             "data.indexed_dataset", "data.dataset", "training.metrics", "training.variance",
             "eval.copy_synthesis", "models.vocoders.ddsp", "preprocessing.acoustic_binarizer",
             "preprocessing.variance_binarizer", "preprocessing.augmentation",
             "preprocessing.align", "models.pe", "models.pe.rmvpe", "models.pe.harvest",
             "models.hnsep_vr", "dsp.hnsep", "dsp.features", "utils.multiprocess",
             "utils.orbax_ckpt", "utils.torch_ckpt", "training.jax_bridge"):
    assert pkg.__name__ + "." + name in names, name
spec = importlib.util.spec_from_file_location("chip_smoke", {str(ROOT / 'chip_smoke.py')!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 64


def test_entry_points_default_to_cuda(exp_dir):
    """Without ``device=`` an entry point asks for CUDA and raises here; it
    never runs on the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from xiaoicesing_io_tpu_torch import cli
    from xiaoicesing_io_tpu_torch.config import variance_defaults
    from xiaoicesing_io_tpu_torch.inference.acoustic import DiffSingerAcousticInfer
    from xiaoicesing_io_tpu_torch.inference.variance import DiffSingerVarianceInfer
    from xiaoicesing_io_tpu_torch.models.vocoders.wrapper import NsfHifiGAN

    cfg = _port_cfg(exp_dir)
    cfg["vocoder_ckpt"] = str(exp_dir / "vocoder" / "model.ckpt")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiffSingerAcousticInfer(cfg, load_vocoder=False)
    vcfg = variance_defaults()
    vcfg.update(work_dir=str(exp_dir), dictionary=str(DICT))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiffSingerVarianceInfer(vcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NsfHifiGAN(cfg)
    (exp_dir.parent / "root").mkdir(exist_ok=True)
    exp = exp_dir.parent / "root" / "exp"
    exp.mkdir(exist_ok=True)
    (exp / "config.json").write_text(json.dumps(dict(cfg)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["infer", "acoustic", str(SAMPLE), "--exp", "exp",
                  "--work_dir", str(exp_dir.parent / "root"), "--mel"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["infer", "variance", str(SAMPLE), "--exp", "exp",
                  "--work_dir", str(exp_dir.parent / "root"), "--predict", "dur"])
    from xiaoicesing_io_tpu_torch.eval.copy_synthesis import evaluate_acoustic, evaluate_variance
    from xiaoicesing_io_tpu_torch.models.vocoders.ddsp import DDSP

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_acoustic(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_variance(vcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["eval", "--exp", "exp", "--work_dir", str(exp_dir.parent / "root")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DDSP(cfg)


def test_shipped_defaults_match_yaml():
    """``configs/acoustic.json`` is the JAX package's base.yaml + acoustic.yaml,
    ``configs/variance.json`` its base.yaml + variance.yaml."""
    from xiaoicesing_io_tpu.config import load_config
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults, variance_defaults

    assert dict(acoustic_defaults()) == dict(
        load_config(ROOT / "xiaoicesing_io_tpu/configs/acoustic.yaml"))
    assert dict(variance_defaults()) == dict(
        load_config(ROOT / "xiaoicesing_io_tpu/configs/variance.yaml"))


@pytest.mark.parametrize("initial,stages", [(32, (0, 1)), (256, (0, 1)), (512, (0, 1))])
def test_vocoder_kernel_stages_follow_width(tmp_path, initial, stages):
    """The stock layout (``use_folded_vocoder: false``) sends stages 0 and 1
    through the resblock-stage kernel whatever their width (initial / 2,
    initial / 4), with their weights prepared once; on the CPU that path (the
    plain version, f32) gives the f32 module path's wav.  The folded layout,
    the default, is held in ``tests/test_torch_nsf_fast.py``."""
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import (
        Generator, NsfHifiganConfig,
    )
    from xiaoicesing_io_tpu_torch.models.vocoders.wrapper import NsfHifiGAN

    vcfg = dict(VOCODER, upsample_initial_channel=initial)
    torch.manual_seed(2)
    torch.save({"generator": Generator(NsfHifiganConfig.from_json(vcfg)).state_dict()},
               tmp_path / "model.ckpt")
    (tmp_path / "config.json").write_text(json.dumps(vcfg))
    voc = NsfHifiGAN({"vocoder_ckpt": str(tmp_path / "model.ckpt"), "use_folded_vocoder": False},
                     device="cpu")
    assert tuple(voc.stages) == stages
    for i, (weights, biases, specs) in voc.stages.items():
        width = initial >> (i + 1)
        assert len(weights) == len(biases) == 18
        assert [tuple(w.shape) for w in weights[:2]] == [(width, 3 * width)] * 2
        assert all(w.dtype == torch.float32 for w in weights)
    rng = np.random.default_rng(3)
    mel = torch.tensor(rng.standard_normal((1, 6, 128)) - 3.0, dtype=torch.float32)
    f0 = torch.tensor(rng.uniform(100, 400, (1, 6)), dtype=torch.float32)
    wav = voc.spec2wav_torch(mel, f0)
    ref = voc.spec2wav_torch(mel, f0, _f32_module=True)
    assert wav.shape == (1, 6 * 512) and np.abs(ref.numpy()).max() > 0
    # f32 on both sides, differing in summation order only
    np.testing.assert_allclose(wav.numpy(), ref.numpy(), atol=1e-5, rtol=0)
