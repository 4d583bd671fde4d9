"""The port's bucket-batched serving against the JAX package, on the CPU.

``DataParallelSynthesizer`` of the port and of the JAX package (on a mesh of
one CPU device) run the same ``.ds`` segments of tiny random checkpoints
(LYNXNet + rectified flow, WaveNet + DDPM, and a two-speaker LYNXNet).  Each
chunk's start noise is the array the JAX synthesizer draws from
``fold_in(PRNGKey(seed), bucket * 4099 + chunk)`` (for DDPM, the second key
of its split), handed to the port through ``noise=``.  The port's kernel path
runs its plain versions in f32 here, so its mels are held to JAX's at the
module bar 2e-4, and each batched row to the same segment run alone through
the port's ``forward_model`` at 1e-5 plus 1e-6 of the value (f32 rounding:
the batched products and convolutions sum in another order).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SONG = ROOT / "samples" / "02_一半一半.ds"
DICT = ROOT / "dictionaries" / "opencpop-extension.txt"
MELS = 128
SPEAKERS = {"alice": 0, "bob": 1}

LYNX = dict(hidden_size=32, enc_layers=1, num_heads=2, sampling_steps=3,
            backbone_args={"num_channels": 128, "num_layers": 2, "kernel_size": 31,
                           "dropout_rate": 0.0, "strong_cond": True})
DDPM = dict(hidden_size=32, enc_layers=1, num_heads=2, backbone_type="wavenet",
            diffusion_type="ddpm",
            backbone_args={"num_channels": 64, "num_layers": 4, "dilation_cycle_length": 2},
            K_step=400, K_step_infer=400, diff_accelerator="ddim", diff_speedup=20)
EXPS = {"lynx": LYNX, "ddpm": DDPM, "speakers": dict(LYNX, use_spk_id=True, num_spk=2)}

# upsampling 8*8*2*2*2 = 512 = hop_size, at narrow widths
VOCODER = dict(num_mels=MELS, sampling_rate=44100, hop_size=512, n_fft=2048, win_size=2048,
               fmin=40, fmax=16000, upsample_rates=[8, 8, 2, 2, 2],
               upsample_kernel_sizes=[16, 16, 4, 4, 4], upsample_initial_channel=32,
               resblock="1", resblock_kernel_sizes=[3, 7, 11],
               resblock_dilation_sizes=[[1, 3, 5]] * 3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on shared cores; torch's
    intra-op threads then oversubscribe them.  One thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(cfg, work_dir, over):
    cfg.update(work_dir=str(work_dir), dictionary=str(DICT), **over)
    cfg["backbone_args"] = dict(over["backbone_args"])
    cfg["shallow_diffusion_args"]["aux_decoder_args"].update(num_channels=32, num_layers=1,
                                                            dropout_rate=0.0)
    return cfg


def _port_cfg(name, work_dir):
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults

    cfg = _tiny(acoustic_defaults(), work_dir, EXPS[name])
    cfg["vocoder_ckpt"] = str(Path(work_dir) / "vocoder" / "model.ckpt")
    return cfg


def _jax_cfg(name, work_dir):
    from xiaoicesing_io_tpu.config import load_config

    return _tiny(load_config(ROOT / "xiaoicesing_io_tpu/configs/acoustic.yaml"), work_dir,
                 EXPS[name])


@pytest.fixture(scope="module")
def exps(tmp_path_factory):
    """name -> work dir of a random tiny reference-format checkpoint, a
    speaker map and a random narrow vocoder."""
    from xiaoicesing_io_tpu_torch.models.toplevel import reference_core_buffers
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import (
        Generator, NsfHifiganConfig,
    )
    from xiaoicesing_io_tpu_torch.training.acoustic import build_acoustic
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    vocab = TokenTextEncoder(PhonemeDictionary.load(DICT).phoneme_list).vocab_size
    out = {}
    for i, name in enumerate(EXPS):
        wd = tmp_path_factory.mktemp(f"serving_{name}")
        torch.manual_seed(i)
        model, core, _ = build_acoustic(_port_cfg(name, wd), vocab)
        with torch.no_grad():
            # zero-initialised output projection and 1e-6 ConvNeXt layer
            # scales would hide the denoiser and the aux blocks
            model.backbone.output_projection.weight.normal_(0.0, 0.05)
            for block in model.aux_decoder.decoder.conv:
                block.gamma.normal_(0.0, 0.5)
        sd = {f"model.{k}": v for k, v in model.state_dict().items()}
        if name == "ddpm":
            sd.update({f"model.diffusion.{k}": v
                       for k, v in reference_core_buffers(core.schedule).items()})
        torch.save({"category": "acoustic", "state_dict": sd}, wd / "model_ckpt_steps_100.ckpt")
        (wd / "spk_map.json").write_text(json.dumps(SPEAKERS))
        (wd / "vocoder").mkdir()
        torch.manual_seed(10 + i)
        gen = Generator(NsfHifiganConfig.from_json(VOCODER))
        torch.save({"generator": gen.state_dict()}, wd / "vocoder" / "model.ckpt")
        (wd / "vocoder" / "config.json").write_text(json.dumps(VOCODER))
        out[name] = wd
    return out


@pytest.fixture(scope="module")
def runners(exps):
    """name -> (JAX runner, port runner on the CPU), built once."""
    from xiaoicesing_io_tpu.inference.acoustic import DiffSingerAcousticInfer as JInfer
    from xiaoicesing_io_tpu_torch.inference.acoustic import DiffSingerAcousticInfer as PInfer

    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (JInfer(_jax_cfg(name, exps[name]), load_vocoder=False),
                           PInfer(_port_cfg(name, exps[name]), device="cpu"))
        return cache[name]
    return get


def _song(n=5, start=0):
    """Segments of the sample song: the first five fall in buckets 256 (2
    segments of 4 and 12 tokens) and 512 (3 of 36, 37 and 28 tokens)."""
    with open(SONG, encoding="utf-8") as f:
        return json.load(f)[start:start + n]


def _jax_dp(jr):
    from xiaoicesing_io_tpu.inference.serving import DataParallelSynthesizer
    from xiaoicesing_io_tpu.parallel.mesh import make_mesh

    return DataParallelSynthesizer(jr, mesh=make_mesh([jax.devices()[0]]))


def _jax_noise(pr, batches, seed, ddpm, max_group_size=None):
    """Every chunk's start noise as the JAX synthesizer draws it."""
    from xiaoicesing_io_tpu_torch.inference.serving import plan_chunks

    out = {}
    lengths = [b["mel2ph"].shape[1] for b in batches]
    for bucket, chunk_no, idxs in plan_chunks(lengths, max_group_size):
        key = jax.random.fold_in(jax.random.PRNGKey(seed & 0xFFFFFFFF), bucket * 4099 + chunk_no)
        if ddpm:
            _, key = jax.random.split(key)
        out[bucket, chunk_no] = np.asarray(
            jax.random.normal(key, (len(idxs), 1, bucket, MELS), jnp.float32))
    return out


def _against_jax(runners, name, segs, seed, max_group_size=None):
    """Both synthesizers on ``segs``; returns the port's synthesizer, its
    batches, noise, mels and f0s after holding them to JAX's."""
    from xiaoicesing_io_tpu_torch.inference.serving import DataParallelSynthesizer

    jr, pr = runners(name)
    ref_mels, ref_f0s = _jax_dp(jr).synthesize_mels(segs, seed=seed,
                                                    max_group_size=max_group_size)
    batches = [pr.preprocess_input(p, idx=i) for i, p in enumerate(segs)]
    noise = _jax_noise(pr, batches, seed, name == "ddpm", max_group_size)
    dp = DataParallelSynthesizer(pr)
    mels, f0s = dp.synthesize_mels(segs, seed=seed, max_group_size=max_group_size,
                                   batches=batches, noise=noise)
    assert len(mels) == len(f0s) == len(segs)
    for i, (m, f0, rm, rf0, b) in enumerate(zip(mels, f0s, ref_mels, ref_f0s, batches)):
        frames = b["mel2ph"].shape[1]
        assert m.shape == (frames, MELS) == np.asarray(rm).shape, i
        assert np.isfinite(m).all()
        np.testing.assert_array_equal(f0, np.asarray(rf0))
        # f32 on both sides, differing in summation order only: the module bar
        np.testing.assert_allclose(m, np.asarray(rm), atol=2e-4, rtol=0, err_msg=str(i))
    assert max(np.abs(np.asarray(rm)).max() for rm in ref_mels) > 1.0  # not near-zero mels
    return dp, batches, noise, mels, f0s


def _rows_alone(pr, batches, noise, mels, max_group_size=None):
    """Each batched row against its segment run alone through
    ``forward_model`` with the same noise row (same bucket, same padding)."""
    from xiaoicesing_io_tpu_torch.inference.serving import plan_chunks

    lengths = [b["mel2ph"].shape[1] for b in batches]
    for bucket, chunk_no, idxs in plan_chunks(lengths, max_group_size):
        for row, i in enumerate(idxs):
            alone = pr.forward_model(batches[i], noise=noise[bucket, chunk_no][row:row + 1])
            # f32 batched products sum in another order than single ones: a few
            # ulps at the mel's scale (|mel| up to ~16, where an ulp is 1e-6)
            np.testing.assert_allclose(mels[i], alone[0], atol=1e-5, rtol=1e-6, err_msg=str(i))


@pytest.mark.parametrize("name", ["lynx", "ddpm"])
def test_synthesize_mels_matches_jax_and_single_rows(runners, name):
    """Five segments in two buckets (2 and 3 rows, ragged token widths): the
    port's mels, f0s, order and lengths against JAX's, and each row against
    the segment alone."""
    from xiaoicesing_io_tpu_torch.inference.serving import plan_chunks

    segs = _song()
    dp, batches, noise, mels, _ = _against_jax(runners, name, segs, seed=7)
    assert [(b, c, i) for b, c, i in plan_chunks([b["mel2ph"].shape[1] for b in batches])] \
        == [(256, 0, [0, 4]), (512, 0, [1, 2, 3])]
    _rows_alone(dp.infer, batches, noise, mels)


def test_max_group_size_splits_chunks(runners):
    """Two segments of one bucket at ``max_group_size=1``: two chunks with
    their own noise (chunk numbers 0 and 1), as in JAX."""
    segs = _song(2, start=1)
    dp, batches, noise, mels, _ = _against_jax(runners, "lynx", segs, seed=9, max_group_size=1)
    assert sorted(noise) == [(512, 0), (512, 1)]
    assert not np.allclose(mels[0], mels[1])
    _rows_alone(dp.infer, batches, noise, mels, max_group_size=1)


def _speaker_segment():
    seg = dict(_song(1, start=1)[0])
    n_f0 = len(seg["f0_seq"].split())
    dynamic_bob = {"bob": " ".join(["1.0"] * n_f0), "alice": " ".join(["0.0"] * n_f0)}
    return seg, dynamic_bob


def test_static_spk_mix_conditions_all_frames(runners):
    """Static mixes ``[1, 1, N]`` are broadcast axes, not padded over time:
    two speakers on the same content and noise differ in every frame."""
    seg, _ = _speaker_segment()
    segs = [{**seg, "spk_mix": {"alice": 1.0}}, {**seg, "spk_mix": {"bob": 1.0}}]
    dp, batches, noise, (mel_a, mel_b), _ = _against_jax(runners, "speakers", segs, seed=11)
    assert np.abs(mel_a[1:] - mel_b[1:]).mean() > 1e-4
    _rows_alone(dp.infer, batches, noise, [mel_a, mel_b])


def test_ragged_spk_mix_cardinality(runners):
    """A two-speaker mix and a solo speaker in one chunk: the speaker axis is
    padded to the widest (id 0, weight 0)."""
    seg, _ = _speaker_segment()
    segs = [{**seg, "spk_mix": {"alice": 0.5, "bob": 0.5}}, {**seg, "spk_mix": {"alice": 1.0}}]
    dp, batches, noise, mels, _ = _against_jax(runners, "speakers", segs, seed=4)
    assert [b["spk_mix_id"].shape[2] for b in batches] == [2, 1]
    _rows_alone(dp.infer, batches, noise, mels)


def test_static_spk_mix_meets_dynamic(runners):
    """A static mix sharing a chunk with a dynamic one is repeated over time:
    row 0 does not depend on its neighbour's kind of mix, and an all-bob
    dynamic mix equals the static bob row under the same noise row."""
    seg, dynamic_bob = _speaker_segment()
    static_a, static_b = {**seg, "spk_mix": {"alice": 1.0}}, {**seg, "spk_mix": {"bob": 1.0}}
    dynamic = {**seg, "spk_mix": dynamic_bob, "spk_mix_timestep": seg["f0_timestep"]}
    _, _, _, (ref_a, ref_b), _ = _against_jax(runners, "speakers", [static_a, static_b], seed=11)
    dp, batches, noise, (got_a, got_b), _ = _against_jax(runners, "speakers",
                                                         [static_a, dynamic], seed=11)
    assert batches[1]["spk_mix_value"].shape[1] == batches[1]["mel2ph"].shape[1]
    np.testing.assert_allclose(got_a, ref_a, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_b, ref_b, atol=1e-5, rtol=0)
    _rows_alone(dp.infer, batches, noise, [got_a, got_b])


def test_chunk_streams_distinct_across_buckets(runners, monkeypatch):
    """Chunk 0 of every bucket draws its own stream under one seed: the salt
    ``bucket * 4099 + chunk`` is a multiple of 256 at chunk 0, so a seed that
    kept only its low byte would repeat one stream in every bucket."""
    from xiaoicesing_io_tpu_torch.inference.serving import DataParallelSynthesizer
    from xiaoicesing_io_tpu_torch.utils import generator_from_seed

    _, pr = runners("lynx")
    seen = []
    synthesize = pr.synthesize

    def record(*args, generator=None, **kwargs):
        seen.append((generator.initial_seed(), kwargs["mel2ph"].shape))
        return synthesize(*args, generator=generator, **kwargs)

    monkeypatch.setattr(pr, "synthesize", record)
    song = _song(6)  # buckets 256 and 512
    DataParallelSynthesizer(pr).synthesize_mels(song, seed=3)
    buckets = [shape[1] for _, shape in seen]
    assert len(set(buckets)) >= 2 and len({s for s, _ in seen}) == len(seen)
    draws = [torch.randn(64, generator=generator_from_seed(3, torch.device("cpu"),
                                                            salt=b * 4099)) for b in buckets]
    for i in range(len(draws)):
        for j in range(i):
            assert not torch.equal(draws[i], draws[j]), (buckets[i], buckets[j])


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 32 - 1, 2 ** 40 + 5, -3])
def test_generator_from_seed_small_salts_unchanged(seed):
    """On the card, salts below 256 (the runners' 0 and 1, the variance
    heads' small salts) seed the stream they always did: ``(seed << 8) |
    salt``.  On the CPU, whose generator keeps only its seed's low 32 bits,
    every bit of the seed and every salt moves the stream."""
    from xiaoicesing_io_tpu_torch.utils import generator_from_seed, seed_for

    cpu = torch.device("cpu")
    assert generator_from_seed(None, cpu) is None
    for salt in (0, 1, 2, 3, 17, 255):
        assert seed_for(seed, salt, "cuda") == ((seed & 0xFFFFFFFF) << 8) | salt
        g = generator_from_seed(seed, cpu, salt=salt)
        assert g.initial_seed() == seed_for(seed, salt, "cpu")
        # bits 24-31 of the seed reach the CPU stream
        for bit in (24, 31):
            other = generator_from_seed(seed ^ (1 << bit), cpu, salt=salt)
            assert not torch.equal(torch.randn(16, generator=generator_from_seed(seed, cpu, salt)),
                                   torch.randn(16, generator=other)), (salt, bit)
    # distinct salts draw distinct streams, small and large alike
    draws = [torch.randn(16, generator=generator_from_seed(seed, cpu, salt=salt))
             for salt in (0, 1, 2, 3, 17, 255, 256, 512, 256 * 4099, 512 * 4099,
                          512 * 4099 + 1)]
    for i in range(len(draws)):
        for j in range(i):
            assert not torch.equal(draws[i], draws[j]), (i, j)


def test_vocode_groups_match_jax(runners):
    """``vocode(seed=None)`` forms JAX's groups (lengths and members, in the
    same order); each wav equals the port's vocoder on that mel alone."""
    from types import SimpleNamespace

    from xiaoicesing_io_tpu.inference.serving import DataParallelSynthesizer as JDP
    from xiaoicesing_io_tpu_torch.inference.serving import DataParallelSynthesizer

    _, pr = runners("lynx")
    rng = np.random.default_rng(5)
    lengths = [7, 12, 7, 3, 12, 7]
    mels = [rng.standard_normal((n, MELS)).astype(np.float32) - 4.0 for n in lengths]
    f0s = [rng.uniform(120, 400, n).astype(np.float32) for n in lengths]

    def members(mel):
        return [next(i for i, m in enumerate(mels) if np.array_equal(m, row)) for row in mel]

    jcalls, pcalls = [], []

    def jax_spec2wav(mel, f0, key=None):
        jcalls.append((mel.shape[1], members(mel)))
        return np.zeros((mel.shape[0], mel.shape[1] * 512), np.float32)

    JDP(SimpleNamespace(vocoder=SimpleNamespace(spec2wav=jax_spec2wav)),
        mesh=object()).vocode(mels, f0s)
    spec2wav = pr.vocoder.spec2wav

    def port_spec2wav(mel, f0, generator=None):
        assert generator is None
        pcalls.append((mel.shape[1], members(mel)))
        return spec2wav(mel, f0, generator=generator)

    pr.vocoder.spec2wav = port_spec2wav
    try:
        wavs = DataParallelSynthesizer(pr).vocode(mels, f0s)
    finally:
        del pr.vocoder.spec2wav
    assert pcalls == jcalls == [(3, [3]), (7, [0, 2, 5]), (12, [1, 4])]
    for m, f0, w in zip(mels, f0s, wavs):
        assert w.shape == (m.shape[0] * 512,)
        np.testing.assert_allclose(w, pr.vocoder.spec2wav(m, f0), atol=1e-5, rtol=0)


def test_run_inference_data_parallel_places_dp_wavs(runners, tmp_path):
    """``run_inference(data_parallel=True)`` writes the dp wavs placed at
    their offsets (silence between, a crossfade where they overlap)."""
    from scipy.io import wavfile

    from xiaoicesing_io_tpu_torch.inference.serving import DataParallelSynthesizer
    from xiaoicesing_io_tpu_torch.utils.curves import cross_fade

    _, pr = runners("lynx")
    segs = _song(4)
    segs[1] = dict(segs[1], offset=segs[0]["offset"] + 1.0)  # overlaps segment 0
    (path,) = pr.run_inference(segs, out_dir=tmp_path, title="song", seed=5,
                               data_parallel=True)
    dp = DataParallelSynthesizer(pr)
    mels, f0s = dp.synthesize_mels(segs, seed=5)
    wavs = dp.vocode(mels, f0s, seed=5)
    sr = 44100
    song, current = np.zeros(0), 0
    for seg, mel, wav in zip(segs, mels, wavs):
        assert wav.shape == (mel.shape[0] * 512,) and np.isfinite(wav).all()
        silent = round(seg["offset"] * sr) - current
        if silent >= 0:
            song = np.append(np.append(song, np.zeros(silent)), wav)
        else:
            song = cross_fade(song, wav, current + silent)
        current += silent + wav.shape[0]
    rate, written = wavfile.read(path)
    assert rate == sr
    np.testing.assert_array_equal(written, (song * 32767).astype(np.int16))


def test_cli_dp(runners, exps, tmp_path):
    """``infer acoustic --dp --mel`` saves the dp mels; ``--dp`` a wav of
    the song's length."""
    from xiaoicesing_io_tpu_torch import cli
    from xiaoicesing_io_tpu_torch.inference.serving import DataParallelSynthesizer

    _, pr = runners("lynx")
    wd = exps["lynx"]
    (wd / "config.json").write_text(json.dumps(dict(_port_cfg("lynx", wd))))
    segs = _song(3)
    ds = tmp_path / "song.ds"
    ds.write_text(json.dumps(segs, ensure_ascii=False), encoding="utf-8")
    base = ["infer", "acoustic", str(ds), "--exp", wd.name, "--work_dir", str(wd.parent),
            "--seed", "3", "--dp", "--device", "cpu", "--out", str(tmp_path / "out")]
    cli.main(base + ["--mel"])
    data = np.load(tmp_path / "out" / "song.mel.npz")
    mels, _ = DataParallelSynthesizer(pr).synthesize_mels(segs, seed=3)
    for i, m in enumerate(mels):
        np.testing.assert_array_equal(data[f"seg{i}_mel"], m)
    cli.main(base)
    from scipy.io import wavfile

    rate, wav = wavfile.read(tmp_path / "out" / "song.wav")
    assert rate == 44100
    assert wav.shape == (round(segs[-1]["offset"] * 44100) + mels[-1].shape[0] * 512,)
