"""The port's aten -> ONNX converter and its ONNX layer, on the CPU.

Each graph the port's converter writes is parsed back and run through BOTH
numpy executors (the port's ``onnx_run`` and the JAX package's), and held
against torch eager f32 at 2e-5, the bar of the JAX package's own converter
tests (``tests/test_onnx_export.py``).  The vocoder graph is held against the
JAX package's f32 stock ``Generator`` carrying the same weights.  Each
side's graphs also run in the other side's executor.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from xiaoicesing_io_tpu.deployment.onnx_run import run_model_bytes as jax_run_bytes
from xiaoicesing_io_tpu_torch.deployment.onnx_export import export_onnx, trace_to_graph
from xiaoicesing_io_tpu_torch.deployment.onnx_proto import (
    FLOAT, Graph, Node, Tensor, build_model, parse_model,
)
from xiaoicesing_io_tpu_torch.deployment.onnx_run import run_graph, run_model_bytes

TOL = 2e-5


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on shared cores; torch's
    intra-op threads would oversubscribe them.  Two threads a test."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _roundtrip(fn, args, atol=TOL):
    """Export ``fn`` at ``args``; both executors must give torch eager's
    outputs.  Returns the model bytes."""
    data = export_onnx(fn, args, None)
    feeds = {f"in{i}": a for i, a in enumerate(args)}
    with torch.no_grad():
        ref = fn(*[torch.from_numpy(a) for a in args])
    ref = ref if isinstance(ref, tuple) else (ref,)
    for run in (run_model_bytes, jax_run_bytes):
        out = run(data, feeds)
        for i, r in enumerate(ref):
            assert out[f"out{i}"].dtype == r.numpy().dtype
            np.testing.assert_allclose(out[f"out{i}"], r.numpy(), atol=atol, rtol=1e-4)
    return data


def test_proto_roundtrip(rng):
    W = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))

    def f(x):
        return torch.tanh(x @ W)

    x = rng.standard_normal((2, 4)).astype(np.float32)
    data = _roundtrip(f, [x])
    graph, meta = parse_model(data)
    assert meta["opset"] == 17 and meta["ir_version"] == 8
    assert [n for n, _, _ in graph.inputs] == ["in0"]
    assert any(n.op_type == "MatMul" for n in graph.nodes)
    assert any(t.array.shape == (4, 8) for t in graph.initializers)


def test_scalar_initializers_stay_scalar():
    """A 0-d initializer is written as a scalar (no dims): a Gather with a
    scalar index drops its axis, as ONNX says, after the round trip."""
    g = Graph("g", [Node("Gather", ["x", "i"], ["y"], {"axis": 1}, name="gather")],
              [("x", FLOAT, [2, 3])], [("y", FLOAT, [2])],
              [Tensor("i", np.asarray(2, np.int64))])
    parsed, _ = parse_model(build_model(g))
    assert parsed.initializers[0].array.shape == ()
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(run_graph(parsed, {"x": x})["y"], x[:, 2])


def test_dense_gelu_layernorm(rng):
    W = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    ln = torch.nn.LayerNorm(32, eps=1e-5)
    with torch.no_grad():
        ln.weight.normal_()
        ln.bias.normal_()

    def f(x):
        h = F.gelu(x @ W + b)  # the exact form, as the port's modules use it
        return ln(h), F.gelu(h, approximate="tanh")

    data = _roundtrip(f, [rng.standard_normal((2, 5, 16)).astype(np.float32)])
    graph, _ = parse_model(data)
    assert {"Erf", "ReduceMean", "Tanh"} <= {n.op_type for n in graph.nodes}


@pytest.mark.parametrize("case", ["dilated", "depthwise", "depthwise_strided", "transposed",
                                  "strided", "transposed_vocoder"])
def test_conv_variants(rng, case):
    x = rng.standard_normal((2, 16, 9)).astype(np.float32)
    if case == "depthwise":
        m = torch.nn.Conv1d(16, 16, 3, padding=1, groups=16)
    elif case == "depthwise_strided":
        m = torch.nn.Conv1d(16, 16, 5, stride=2, padding=4, dilation=2, groups=16)
    elif case == "dilated":
        m = torch.nn.Conv1d(16, 24, 5, padding=4, dilation=2)
    elif case == "transposed":
        m = torch.nn.ConvTranspose1d(16, 8, 4, 2, padding=1)
    elif case == "strided":
        m = torch.nn.Conv1d(16, 8, 4, stride=2, padding=2)
    else:  # an NSF-HiFiGAN upsampler: k = 2 * rate, padding (k - rate) / 2
        m = torch.nn.ConvTranspose1d(16, 8, 16, 8, padding=4)
    data = _roundtrip(lambda x: m(x), [x])
    graph, _ = parse_model(data)
    assert [n.op_type for n in graph.nodes].count("Conv") == 1


def test_gather_scatter_softmax(rng):
    E = torch.from_numpy(rng.standard_normal((20, 8)).astype(np.float32))

    def f(tok, mel2ph, seg):
        emb = F.embedding(tok, E)
        pad = F.pad(emb, (0, 0, 1, 0))
        g = torch.gather(pad, 1, mel2ph.long()[:, :, None].expand(-1, -1, 8))
        att = torch.softmax(g @ g.transpose(1, 2) / 2.8, dim=-1)
        y = att @ g + torch.cumsum(g, dim=1)
        s = torch.zeros(1, 7).scatter_add(1, seg.long()[None], y[0, :, 0][None])
        return y, s, torch.fmod(y, 0.7), (mel2ph != 3) & (mel2ph > 1)

    tok = rng.integers(0, 20, (2, 5)).astype(np.int32)
    m2p = rng.integers(0, 6, (2, 9)).astype(np.int32)
    seg = rng.integers(0, 7, (9,)).astype(np.int32)
    data = _roundtrip(f, [tok, m2p, seg])
    graph, _ = parse_model(data)
    # int32 graph inputs, as the JAX package declares them; cast in-graph
    assert [et for _, et, _ in graph.inputs] == [6, 6, 6]
    assert {"Gather", "GatherElements", "ScatterElements", "CumSum", "Mod", "ReduceMax",
            "Not", "And"} <= {n.op_type for n in graph.nodes}


def test_unknown_aten_op_is_named(rng):
    x = rng.standard_normal((2, 8)).astype(np.float32)
    with pytest.raises(NotImplementedError, match="aten op .*sort"):
        trace_to_graph(lambda x: torch.sort(x, dim=-1)[0], [x])


@pytest.mark.parametrize("case", ["dropout", "randn"])
def test_random_ops_are_refused(rng, case):
    """A draw is never folded into a constant of the graph."""
    drop = torch.nn.Dropout(0.5).train()
    fn = (lambda x: drop(x)) if case == "dropout" else (lambda x: x + torch.randn(2, 8))
    with pytest.raises(NotImplementedError, match="random aten op"):
        trace_to_graph(fn, [rng.standard_normal((2, 8)).astype(np.float32)])


def test_executor_op_set_is_the_jax_executors():
    """The port's executor is a copy of the JAX package's: the same ops."""
    import inspect
    import re

    from xiaoicesing_io_tpu.deployment import onnx_run as jax_onnx_run
    from xiaoicesing_io_tpu_torch.deployment import onnx_run

    def ops(mod):
        return set(re.findall(r'op == "(\w+)"', inspect.getsource(mod.run_graph)))

    assert ops(onnx_run) == ops(jax_onnx_run)
    assert not {"Softmax", "LayerNormalization", "ConvTranspose", "Gelu"} & ops(onnx_run)


# ---------------------------------------------------------------------------
# the vocoder: the port's export against the JAX package's f32 Generator
# ---------------------------------------------------------------------------

VOCODER = dict(num_mels=16, sampling_rate=44100, hop_size=64, n_fft=256, win_size=256,
               fmin=40, fmax=16000, upsample_rates=[4, 4, 2, 2],
               upsample_kernel_sizes=[8, 8, 4, 4], upsample_initial_channel=64,
               resblock="1", resblock_kernel_sizes=[3, 7, 11],
               resblock_dilation_sizes=[[1, 3, 5]] * 3)


@pytest.fixture(scope="module")
def vocoder_export(tmp_path_factory):
    """A tiny random NSF-HiFiGAN checkpoint and its port export."""
    from xiaoicesing_io_tpu_torch.deployment.export import export_nsf_hifigan
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import (
        Generator, NsfHifiganConfig,
    )

    root = tmp_path_factory.mktemp("nsf")
    torch.manual_seed(1)
    gen = Generator(NsfHifiganConfig.from_json(VOCODER))
    torch.save({"generator": gen.state_dict()}, root / "model.ckpt")
    (root / "config.json").write_text(json.dumps(VOCODER))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = export_nsf_hifigan({"vocoder_ckpt": str(root / "model.ckpt")},
                                 out_dir=str(root / "artifacts"))
    finally:
        torch.set_num_threads(n)
    return root, out, gen.state_dict()


def test_vocoder_graph_matches_jax_generator(vocoder_export, rng):
    from xiaoicesing_io_tpu.models.vocoders.nsf_hifigan import (
        Generator as JGenerator, NsfHifiganConfig as JCfg,
    )
    from xiaoicesing_io_tpu.utils.torch_ckpt import convert_nsf_hifigan

    root, out, sd = vocoder_export
    data = (out / "nsf_hifigan.onnx").read_bytes()
    graph, _ = parse_model(data)
    T = 256
    assert [(n, s) for n, _, s in graph.inputs] == [("in0", [1, T, 16]), ("in1", [1, T])]
    assert [(n, s) for n, _, s in graph.outputs] == [("out0", [1, T * 64])]

    jcfg = JCfg.from_json(VOCODER)
    params = convert_nsf_hifigan({k: v.numpy() for k, v in sd.items()}, jcfg)
    gen = JGenerator(jcfg)  # the stock f32 generator
    mel = (rng.standard_normal((1, T, 16)) * 0.5 - 5).astype(np.float32)
    f0 = np.where(rng.uniform(size=(1, T)) < 0.2, 0.0,
                  rng.uniform(80, 900, (1, T))).astype(np.float32)
    ref = np.asarray(gen.apply(params, jnp.asarray(mel), jnp.asarray(f0)))
    assert ref.shape == (1, T * 64) and np.abs(ref).max() > 0.01
    for run in (run_model_bytes, jax_run_bytes):
        got = run(data, {"in0": mel, "in1": f0})["out0"]
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_vocoder_graph_is_all_f32(vocoder_export):
    """Inputs, outputs and every float initializer are f32 (the JAX
    package's own vocoder export fails on its bf16 generator)."""
    _, out, _ = vocoder_export
    graph, _ = parse_model((out / "nsf_hifigan.onnx").read_bytes())
    assert all(et == FLOAT for _, et, _ in graph.inputs + graph.outputs)
    kinds = {t.array.dtype for t in graph.initializers}
    assert np.dtype(np.float32) in kinds
    assert not {np.dtype(np.float16), np.dtype(np.float64)} & kinds
    casts = {n.attrs["to"] for n in graph.nodes if n.op_type == "Cast"}
    assert casts <= {FLOAT, 6, 7, 9}  # f32 and the integer / bool types


def test_vocoder_manifest_keys_match_jax(vocoder_export):
    import yaml

    root, out, _ = vocoder_export
    manifest = yaml.safe_load((out / "vocoder.yaml").read_text())
    assert manifest == {
        "name": "NSF-HiFiGAN", "model": "nsf_hifigan.onnx", "sample_rate": 44100,
        "hop_size": 64, "win_size": 256, "fft_size": 256, "num_mel_bins": 16,
        "mel_fmin": 40, "mel_fmax": 16000, "mel_base": "e", "mel_scale": "slaney",
    }


def test_jax_graphs_run_in_the_port_executor(rng):
    """The JAX package's converter output runs in the port's executor."""
    from xiaoicesing_io_tpu.deployment.onnx_export import export_onnx as jax_export

    W = rng.standard_normal((16, 32)).astype(np.float32)
    E = rng.standard_normal((20, 16)).astype(np.float32)

    def f(tok, x):
        h = jax.nn.gelu(jnp.take(E, tok, axis=0) @ W + x, approximate=False)
        return jax.nn.softmax(h, axis=-1), jnp.cumsum(h, axis=1)

    tok = rng.integers(0, 20, (2, 5)).astype(np.int32)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    data = jax_export(f, [tok, x], None)
    ref = f(jnp.asarray(tok), jnp.asarray(x))
    got = run_model_bytes(data, {"in0": tok, "in1": x})
    for i, r in enumerate(ref):
        np.testing.assert_allclose(got[f"out{i}"], np.asarray(r), atol=TOL, rtol=1e-4)
