"""Wire-format check of the port's ONNX artifacts with stock tooling.

The port's counterpart of ``tests/test_onnx_stock_tooling.py``: its merged,
loop-bearing ``acoustic.onnx`` and its ``nsf_hifigan.onnx`` are parsed by
Google's protobuf runtime through a protoc-compiled copy of the port's
``deployment/onnx_schema.proto`` (field numbers per the public ONNX IR
spec).  If the hand-rolled writer mis-encoded a field, stock tooling could
not load the models; here protobuf itself is the referee.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).parent.parent
PROTO = ROOT / "xiaoicesing_io_tpu_torch/deployment/onnx_schema.proto"
DICT = ROOT / "dictionaries" / "opencpop-extension.txt"

pytestmark = pytest.mark.skipif(
    shutil.which("protoc") is None, reason="protoc not available"
)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def onnx_pb2(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_onnx_pb2")
    subprocess.run(
        ["protoc", f"--proto_path={PROTO.parent}", f"--python_out={out}", PROTO.name],
        check=True,
    )
    sys.path.insert(0, str(out))
    try:
        import onnx_schema_pb2  # noqa: E402
    finally:
        sys.path.pop(0)
    return onnx_schema_pb2


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A tiny acoustic experiment and vocoder, exported by the port."""
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults
    from xiaoicesing_io_tpu_torch.deployment.export import (
        export_acoustic, export_nsf_hifigan,
    )
    from xiaoicesing_io_tpu_torch.models.toplevel import AcousticModel
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import (
        Generator, NsfHifiganConfig,
    )
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    root = tmp_path_factory.mktemp("port_stock")
    cfg = acoustic_defaults()
    cfg.update(work_dir=str(root), dictionary=str(DICT), hidden_size=16, enc_layers=1,
               num_heads=2)
    cfg["backbone_args"] = {"num_channels": 64, "num_layers": 1, "kernel_size": 31,
                            "dropout_rate": 0.0, "strong_cond": True}
    cfg["shallow_diffusion_args"]["aux_decoder_args"].update(num_channels=16, num_layers=1)
    vocab = TokenTextEncoder(PhonemeDictionary.load(DICT).phoneme_list).vocab_size
    torch.manual_seed(0)
    model = AcousticModel.from_config(cfg, vocab)
    torch.save({"state_dict": {f"model.{k}": v for k, v in model.state_dict().items()}},
               root / "model_ckpt_steps_1.ckpt")
    vocoder = dict(num_mels=128, sampling_rate=44100, hop_size=512, n_fft=2048, win_size=2048,
                   fmin=40, fmax=16000, upsample_rates=[8, 8, 2, 2, 2],
                   upsample_kernel_sizes=[16, 16, 4, 4, 4], upsample_initial_channel=64,
                   resblock="1", resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3, 5]])
    gen = Generator(NsfHifiganConfig.from_json(vocoder))
    torch.save({"generator": gen.state_dict()}, root / "model.ckpt")
    (root / "config.json").write_text(json.dumps(vocoder))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        acoustic = export_acoustic(cfg, out_dir=str(root / "acoustic"))
        voc = export_nsf_hifigan({"vocoder_ckpt": str(root / "model.ckpt")},
                                 out_dir=str(root / "vocoder"))
    finally:
        torch.set_num_threads(n)
    return acoustic, voc


def _check_initializers(graph_pb, graph):
    """Every initializer's dims and raw bytes are the writer's own."""
    by_name = {t.name: t.array for t in graph.initializers}
    assert len(graph_pb.initializer) == len(by_name)
    for t in graph_pb.initializer:
        a = by_name[t.name]
        assert tuple(t.dims) == a.shape
        assert t.raw_data == np.ascontiguousarray(a).tobytes()


def test_merged_acoustic_parses_with_google_protobuf(onnx_pb2, artifacts):
    from xiaoicesing_io_tpu_torch.deployment.onnx_proto import parse_model

    data = (artifacts[0] / "acoustic.onnx").read_bytes()
    m = onnx_pb2.ModelProto()
    m.ParseFromString(data)
    assert m.ir_version == 8
    assert m.opset_import[0].version == 17
    assert m.producer_name == "xiaoicesing_io_tpu_torch"
    g = m.graph
    names = [i.name for i in g.input]
    assert names == ["tokens", "mel2ph", "f0", "depth", "steps"]
    types = {i.name: i.type.tensor_type for i in g.input}
    assert types["tokens"].elem_type == 6  # INT32, as the JAX package declares it
    assert [d.dim_value for d in types["mel2ph"].shape.dim] == [1, 512]
    assert types["depth"].elem_type == 1 and not types["depth"].shape.dim  # f32 scalar
    assert types["steps"].elem_type == 7 and not types["steps"].shape.dim  # i64 scalar
    assert [o.name for o in g.output] == ["mel"]
    loops = [n for n in g.node if n.op_type == "Loop"]
    assert len(loops) == 1
    (battr,) = [a for a in loops[0].attribute if a.name == "body"]
    assert battr.type == 5  # AttributeProto.GRAPH
    body = battr.g
    assert body.input[0].type.tensor_type.elem_type == 7  # INT64
    assert body.input[1].type.tensor_type.elem_type == 9  # BOOL
    assert len(body.output) == 2
    assert any(n.op_type == "Conv" for n in body.node)
    graph, _ = parse_model(data)
    _check_initializers(g, graph)
    loop = next(n for n in graph.nodes if n.op_type == "Loop")
    _check_initializers(body, loop.attrs["body"])


def test_vocoder_parses_with_google_protobuf(onnx_pb2, artifacts):
    from xiaoicesing_io_tpu_torch.deployment.onnx_proto import parse_model

    data = (artifacts[1] / "nsf_hifigan.onnx").read_bytes()
    m = onnx_pb2.ModelProto()
    m.ParseFromString(data)
    g = m.graph
    assert [i.name for i in g.input] == ["in0", "in1"]
    assert [[d.dim_value for d in i.type.tensor_type.shape.dim] for i in g.input] == \
        [[1, 256, 128], [1, 256]]
    assert [[d.dim_value for d in o.type.tensor_type.shape.dim] for o in g.output] == \
        [[1, 256 * 512]]
    ops = {n.op_type for n in g.node}
    assert {"Conv", "CumSum", "Mod", "Sin", "Tanh"} <= ops
    convs = [n for n in g.node if n.op_type == "Conv"]
    for n in convs:
        attrs = {a.name: a for a in n.attribute}
        assert attrs["pads"].type == 7 and len(attrs["pads"].ints) == 2  # INTS
    graph, _ = parse_model(data)
    _check_initializers(g, graph)
