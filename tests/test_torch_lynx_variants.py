"""The port's LYNX kernel variants (K5, K7, K8) against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which repeats the
CUDA kernel's arithmetic; here it is held against the Pallas kernel run with
``interpret=True``, as the JAX package's own tests run it.  Inputs are made
from a numpy seed; activations are bf16 on both sides, as the JAX apply
passes them.  Bars: max error 2e-2 (absolute and relative, the bf16 bar of
``tests/test_lynx_pallas_apply.py``) and correlation > 0.999; the hybrid
schedule 5e-2, the bar at which JAX holds it against v1 (its ``inner`` is
stored in bf16, and the port's head rounds its product to bf16 once more).
``tests/test_torch_cuda.py`` holds the CUDA kernels against the plain
versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xiaoicesing_io_tpu_torch.ops.cuda import lynx_conv as K1
from xiaoicesing_io_tpu_torch.ops.cuda import lynx_hybrid as K8
from xiaoicesing_io_tpu_torch.ops.cuda import lynx_layer as K5

BAR = 2e-2
HYBRID_BAR = 5e-2
MIN_CORR = 0.999


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on shared cores; torch's
    intra-op threads then oversubscribe them.  One thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, bar):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=bar, rtol=bar)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > MIN_CORR


def _module_params(rng, dim, inner, k):
    """The conv module's parameters in JAX layouts, f32 numpy."""
    return [
        (1.0 + 0.1 * rng.standard_normal(dim)).astype(np.float32),
        (0.1 * rng.standard_normal(dim)).astype(np.float32),
        (0.05 * rng.standard_normal((dim, 2 * inner))).astype(np.float32),
        (0.05 * rng.standard_normal(2 * inner)).astype(np.float32),
        (0.2 * rng.standard_normal((k, 1, inner))).astype(np.float32),
        (0.05 * rng.standard_normal(inner)).astype(np.float32),
        np.full(inner, 0.25, np.float32),
        (0.05 * rng.standard_normal((inner, dim))).astype(np.float32),
        (0.05 * rng.standard_normal(dim)).astype(np.float32),
    ]


def _layer_inputs(rng, B, T, dim):
    """x and cond_proj rounded to bf16 (the apply's activations) and a
    bf16-valued step, as numpy f32 arrays."""
    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()

    return (bf16(rng.standard_normal((B, T, dim))), bf16(rng.standard_normal((B, T, dim))),
            bf16(rng.standard_normal((B, dim))))


def _port_layer(fn, x, cond, step, params, k):
    weights = K5.prepare_layer_weights(*[torch.from_numpy(p) for p in params])
    return fn(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(cond).to(torch.bfloat16),
              torch.from_numpy(step), weights, kernel_size=k)


def _jax_layer(fn, x, cond, step, params, k, tile):
    return fn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(cond, jnp.bfloat16), jnp.asarray(step),
              *[jnp.asarray(p) for p in params], kernel_size=k, tile=tile, interpret=True)


@pytest.mark.parametrize("B,T,dim,k,tile", [
    (2, 257, 128, 31, 128),   # a partial last tile, two sequences
    (1, 300, 128, 7, 128),    # a short kernel
])
def test_layer_plain_matches_pallas_v2(rng, B, T, dim, k, tile):
    """(a) K5's plain version against ``lynx_layer_fused``."""
    from xiaoicesing_io_tpu.ops.pallas.lynx_conv2 import lynx_layer_fused

    x, cond, step = _layer_inputs(rng, B, T, dim)
    params = _module_params(rng, dim, 2 * dim, k)
    ref = _jax_layer(lynx_layer_fused, x, cond, step, params, k, tile)
    got = _port_layer(K5.lynx_layer_fused, x, cond, step, params, k)
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, dim)
    _close(got.float().numpy(), ref, BAR)


@pytest.mark.parametrize("B,T,dim,k,tile", [
    (2, 257, 128, 31, 128),   # a partial final tile
    (1, 512, 128, 31, 128),   # exact tiling, a deeper pipeline
])
def test_layer_plain_matches_pallas_v3(rng, B, T, dim, k, tile):
    """(b) The same plain version (K7 computes K5's function) against
    ``lynx_layer_fused_v3``."""
    from xiaoicesing_io_tpu.ops.pallas.lynx_conv3 import lynx_layer_fused_v3

    x, cond, step = _layer_inputs(rng, B, T, dim)
    params = _module_params(rng, dim, 2 * dim, k)
    ref = _jax_layer(lynx_layer_fused_v3, x, cond, step, params, k, tile)
    got = _port_layer(K5.lynx_layer_fused_v3, x, cond, step, params, k)
    _close(got.float().numpy(), ref, BAR)
    # K5's and K7's wrappers share the plain version on the CPU
    again = _port_layer(K5.lynx_layer_fused, x, cond, step, params, k)
    np.testing.assert_array_equal(again.float().numpy(), got.float().numpy())


def test_layer_plain_in_f32_is_the_module(rng):
    """With f32 activations the plain version is the f32 layer:
    ``(x + cond) + ConvModule(x + cond + step)`` of the port's module."""
    from xiaoicesing_io_tpu_torch.models.backbones.lynxnet import LYNXConvModule

    B, T, dim, k = 2, 70, 64, 31
    torch.manual_seed(0)
    module = LYNXConvModule(dim, 2, k).eval()
    with torch.no_grad():
        module.net[5].weight.uniform_(0.1, 0.4)
    net = module.net
    weights = K1.prepare_weights(
        net[0].weight, net[0].bias, net[2].weight[:, :, 0].t(), net[2].bias,
        net[4].weight.permute(2, 1, 0), net[4].bias, net[5].weight,
        net[6].weight[:, :, 0].t(), net[6].bias, product_dtype=torch.float32)
    x, cond, step = (torch.from_numpy(a.astype(np.float32)) for a in
                     (rng.standard_normal((B, T, dim)), rng.standard_normal((B, T, dim)),
                      rng.standard_normal((B, dim))))
    with torch.no_grad():
        ref = module(x + cond + step[:, None]) + (x + cond)
        got = K5.lynx_layer_fused(x, cond, step, weights, kernel_size=k)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=0)


def test_hybrid_module_matches_pallas(rng):
    """(c) The port's hybrid module (PyTorch head + K8's plain version)
    against ``lynx_conv_module_hybrid``, at the shape of
    ``tests/test_lynx_pallas_apply.py:90``."""
    from xiaoicesing_io_tpu.ops.pallas.lynx_hybrid import lynx_conv_module_hybrid

    B, T, dim, inner, k = 2, 300, 128, 256, 31
    x = torch.from_numpy(rng.standard_normal((B, T, dim)).astype(np.float32)).to(torch.bfloat16)
    params = _module_params(rng, dim, inner, k)
    ref = lynx_conv_module_hybrid(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                  *[jnp.asarray(p) for p in params], kernel_size=k, tile=128,
                                  interpret=True)
    got = K8.lynx_conv_module_hybrid(
        x, K1.prepare_weights(*[torch.from_numpy(p) for p in params]), kernel_size=k)
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, dim)
    _close(got.float().numpy(), ref, HYBRID_BAR)


def test_conv_tail_plain_is_k1_tail(rng):
    """K8's plain tail on f32 ``inner`` is K1's plain module from the same
    head: the split moves no arithmetic but the rounding of ``inner``."""
    B, T, dim, inner, k = 2, 90, 64, 128, 7
    params = [torch.from_numpy(p) for p in _module_params(rng, dim, inner, k)]
    x = torch.from_numpy(rng.standard_normal((B, T, dim)).astype(np.float32))
    weights = K1.prepare_weights(*params, product_dtype=torch.float32)
    got = K8.lynx_conv_module_hybrid(x, weights, kernel_size=k)
    ref = K1.lynx_conv_module_plain(x, *params, kernel_size=k)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# (d), (e): the denoiser apply with fused_layer / module_impl
# ---------------------------------------------------------------------------

def _backbones(rng, strong_cond=True):
    """The JAX LYNXNet of ``tests/test_lynx_pallas_apply.py:58-69`` (2 layers,
    128 channels) with its output projection randomised, and the port's with
    the same weights carried by ``utils/jax_weights.py``."""
    from xiaoicesing_io_tpu.models.backbones import build_backbone as jbuild
    from xiaoicesing_io_tpu_torch.models.backbones import build_backbone as pbuild
    from xiaoicesing_io_tpu_torch.utils import jax_weights

    B, T, M, H, C = 2, 160, 16, 64, 128
    args = {"num_layers": 2, "num_channels": C, "kernel_size": 31, "strong_cond": strong_cond}
    spec = rng.standard_normal((B, 1, T, M)).astype(np.float32)
    step = np.array([3.0, 700.0], np.float32)
    cond = rng.standard_normal((B, T, H)).astype(np.float32)
    jm = jbuild(M, 1, "lynxnet", args, cond_dims=H)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(spec), jnp.asarray(step),
                     jnp.asarray(cond))
    params["params"]["output_projection"]["kernel"] = jnp.asarray(
        0.02 * rng.standard_normal((C, M)).astype(np.float32))
    pm = pbuild(M, 1, "lynxnet", args, cond_dims=H).eval()
    sd = jax_weights.lynxnet_state_dict(params["params"], "b", 2)
    pm.load_state_dict({key[2:]: v for key, v in sd.items()}, strict=True)
    return params, pm, spec, step, cond


def _port_apply(pm, spec, step, cond, **options):
    from xiaoicesing_io_tpu_torch.models.backbones.lynx_cuda import (
        lynx_cond_projections, lynx_denoiser_apply,
    )

    with torch.no_grad():
        projs = lynx_cond_projections(pm, torch.from_numpy(cond))
        return lynx_denoiser_apply(pm, torch.from_numpy(spec), torch.from_numpy(step),
                                   cond_projs=projs, **options).float().numpy()


@pytest.mark.parametrize("options,bar", [
    ({"fused_layer": True}, BAR),
    ({"fused_layer": "v3"}, BAR),
    ({"module_impl": "hybrid"}, HYBRID_BAR),
])
def test_denoiser_apply_variants_match_pallas(rng, options, bar):
    """(d) The port's bf16 apply against JAX's with the same option."""
    from xiaoicesing_io_tpu.models.backbones.lynx_pallas import (
        lynx_cond_projections as j_projs, lynx_denoiser_apply as j_apply,
    )

    params, pm, spec, step, cond = _backbones(rng)
    projs = j_projs(params, jnp.asarray(cond), num_layers=2)
    ref = np.asarray(j_apply(params, jnp.asarray(spec), jnp.asarray(step), num_layers=2,
                             strong_cond=True, kernel_size=31, tile=128, interpret=True,
                             cond_projs=projs, **options), np.float32)
    got = _port_apply(pm, spec, step, cond, **options)
    _close(got, ref, bar)


def test_fused_layer_needs_strong_cond(rng):
    """(e) Without strong_cond ``fused_layer`` has no effect: the layer runs
    v1, as in JAX (``lynx_pallas.py:95``)."""
    from xiaoicesing_io_tpu.models.backbones.lynx_pallas import lynx_denoiser_apply as j_apply

    params, pm, spec, step, cond = _backbones(rng, strong_cond=False)
    v1 = _port_apply(pm, spec, step, cond)
    for fused in (True, "v2", "v3"):
        np.testing.assert_array_equal(_port_apply(pm, spec, step, cond, fused_layer=fused), v1)
    ref = np.asarray(j_apply(params, jnp.asarray(spec), jnp.asarray(step), jnp.asarray(cond),
                             num_layers=2, strong_cond=False, kernel_size=31, tile=128,
                             interpret=True, fused_layer=True), np.float32)
    _close(v1, ref, BAR)


def test_denoiser_apply_refuses_unknown_options(rng):
    _, pm, spec, step, cond = _backbones(rng)
    with pytest.raises(ValueError, match="fused_layer"):
        _port_apply(pm, spec, step, cond, fused_layer="v4")
    with pytest.raises(ValueError, match="module_impl"):
        _port_apply(pm, spec, step, cond, module_impl="v2")


# ---------------------------------------------------------------------------
# (f): the sampler sweep
# ---------------------------------------------------------------------------

SWEEP_TINY = dict(
    hidden_size=32, enc_layers=1, num_heads=2,
    backbone_args={"num_channels": 128, "num_layers": 2, "kernel_size": 31,
                   "dropout_rate": 0.0, "strong_cond": True},
    shallow_diffusion_args={"aux_decoder_arch": "convnext",
                            "aux_decoder_args": {"num_channels": 32, "num_layers": 1,
                                                 "kernel_size": 7, "dropout_rate": 0.0}},
)


def _rel(got, ref):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    return err, torch.corrcoef(torch.stack([got.flatten(), ref.flatten()]))[0, 1].item()


def test_sweep_modes_agree(capsys):
    """Every mode of the sweep at tiny width and depth on the CPU: finite, of
    the right shape, within the bf16 bar of v1 (relative to the mel's
    scale), and one printed line each."""
    from xiaoicesing_io_tpu_torch.tools import perf_sweep

    sweep = perf_sweep.SamplerSweep.random(device="cpu", B=2, T=96, steps=4,
                                           overrides=SWEEP_TINY)
    ref = sweep.run("v1")
    assert ref.shape == (2, 96, 128) and torch.isfinite(ref).all()
    for mode in perf_sweep.MODES:
        got = sweep.run(mode)
        assert got.shape == ref.shape and torch.isfinite(got).all(), mode
        err, c = _rel(got, ref)
        assert err <= (HYBRID_BAR if mode == "hybrid" else BAR) and c > MIN_CORR, (mode, err, c)
    times = perf_sweep.sweep_sampler(perf_sweep.MODES, sweep=sweep, reps=1)
    assert set(times) == set(perf_sweep.MODES)
    assert all(t["ms"] > 0 and t["ms_per_step"] == t["ms"] / 4 for t in times.values())
    assert len([ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("sampler ")]) == len(perf_sweep.MODES)


def test_sweep_cli_sets_and_vocoder(capsys):
    """The CLI's sets, and the vocoder sweep at a tiny size on the CPU: one
    line per ``pallas_stages`` config and one for the stock layout.  Without
    a device both sweeps ask for CUDA."""
    from xiaoicesing_io_tpu_torch.tools import perf_sweep

    assert set(perf_sweep.SETS["all"]) == set(perf_sweep.MODES)
    assert perf_sweep.SETS["base"] == ("module", "v1", "v2")
    assert perf_sweep.VOCODER_CONFIGS == ((), (1,), (0,), (0, 1), (0, 1, 2))
    capsys.readouterr()
    assert perf_sweep.main(["vocoder", "--batch", "1", "--frames", "16", "--reps", "1",
                            "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("vocoder ")]
    assert [ln.split(":")[0] for ln in lines] == [
        f"vocoder stages={c}" for c in perf_sweep.VOCODER_CONFIGS] + ["vocoder stock"]
    assert all("ms per call" in ln and "audio-s/s" in ln for ln in lines)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            perf_sweep.main(["sampler", "v3", "--frames", "16", "--steps", "1"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            perf_sweep.main(["vocoder", "--frames", "16"])


def test_vocoder_sweep_configs_agree():
    """At a tiny size on the CPU (f32): every ``pallas_stages`` config gives
    the wav of ``()``, and the stock layout the same wav."""
    from xiaoicesing_io_tpu_torch.tools import perf_sweep

    sweep = perf_sweep.VocoderSweep.random(device="cpu", B=1, T=8)
    ref = sweep.run(())
    assert ref.shape == (1, 8 * 512) and ref.abs().max() > 1e-3
    for stages in perf_sweep.VOCODER_CONFIGS[1:] + (None,):
        np.testing.assert_allclose(sweep.run(stages).numpy(), ref.numpy(), atol=2e-5, rtol=0,
                                   err_msg=str(stages))


def test_sweep_v2_matches_jax_sampler():
    """The v2 mode against the JAX sweep's ``make_sample`` (fused_layer=True,
    Pallas in interpret mode) on the same weights, inputs and start noise."""
    from xiaoicesing_io_tpu.config import load_config
    from xiaoicesing_io_tpu.models.backbones.lynx_pallas import (
        lynx_cond_projections as j_projs, lynx_denoiser_apply as j_apply,
    )
    from xiaoicesing_io_tpu.models.toplevel import AcousticModel as JModel
    from xiaoicesing_io_tpu.training.acoustic import build_acoustic as jbuild
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults
    from xiaoicesing_io_tpu_torch.models.toplevel import load_acoustic_state_dict
    from xiaoicesing_io_tpu_torch.tools import perf_sweep
    from xiaoicesing_io_tpu_torch.training.acoustic import build_acoustic
    from xiaoicesing_io_tpu_torch.utils.jax_weights import acoustic_state_dict_from_jax
    from pathlib import Path

    B, T, steps, vocab = 2, 128, 3, perf_sweep.VOCAB
    root = Path(__file__).resolve().parent.parent
    jcfg = load_config(root / "xiaoicesing_io_tpu/configs/acoustic.yaml")
    pcfg = acoustic_defaults()
    for cfg in (jcfg, pcfg):
        cfg.update(SWEEP_TINY)
    M = pcfg["audio_num_mel_bins"]
    tokens, mel2ph, f0 = perf_sweep.sweep_inputs(B, T, vocab)
    noise = np.random.default_rng(1).standard_normal((B, 1, T, M)).astype(np.float32)

    jmodel, jcore, jnorm = jbuild(jcfg, vocab)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(mel2ph),
                         jnp.asarray(f0), jnp.zeros((B, 1, T, M)), jnp.zeros((B,)))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(2)
    p = params["params"]
    p["backbone"]["output_projection"]["kernel"] = (
        0.02 * rng.standard_normal(p["backbone"]["output_projection"]["kernel"].shape)
    ).astype(np.float32)
    for name, block in p["aux_decoder"].items():
        if name.startswith("conv_"):
            block["gamma"] = (0.1 * rng.standard_normal(block["gamma"].shape)).astype(np.float32)

    model, core, normalizer = build_acoustic(pcfg, vocab)
    load_acoustic_state_dict(model, acoustic_state_dict_from_jax(params, pcfg))
    sweep = perf_sweep.SamplerSweep(pcfg, model.eval(), core, normalizer, tokens, mel2ph, f0,
                                    noise, steps=steps, device="cpu")
    got = sweep.run("v2")

    jt, jm, jf = jnp.asarray(tokens), jnp.asarray(mel2ph), jnp.asarray(f0)
    cond = jmodel.apply(params, jt, jm, jf, method=JModel.condition)
    aux = jmodel.apply(params, cond, method=JModel.aux_out) * (jm > 0)[:, :, None]
    projs = j_projs(params, cond, num_layers=2)

    def velocity_fn(x, t):
        return j_apply(params, x, t, num_layers=2, strong_cond=True, kernel_size=31,
                       cond_projs=projs, tile=128, fused_layer=True,
                       interpret=True).astype(jnp.float32)

    x = jcore.inference(velocity_fn, jax.random.PRNGKey(1), (B, 1, T, M),
                        x_end=aux.astype(jnp.float32)[:, None], t_start=0.4, steps=steps,
                        algorithm="euler", noise=jnp.asarray(noise))
    ref = torch.from_numpy(np.array(jnorm.denorm(x), np.float32))
    assert got.shape == ref.shape == (B, T, M)
    err, c = _rel(got, ref)
    assert err <= BAR and c > MIN_CORR, (err, c)
