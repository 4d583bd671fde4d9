"""aten -> ONNX graph converter.

Counterpart of the JAX package's jaxpr converter
(``deployment/onnx_export.py``): it writes the same ``onnx_proto`` records
from a torch function, for the graphs the reference DiffSinger exports for
OpenUTAU with ``torch.onnx.export``
(``deployment/exporters/acoustic_exporter.py:160-390``).  The port does not
use ``torch.onnx``: its exporters need the ``onnx`` and ``onnxscript``
packages, which the port does not depend on.

Strategy:

* wrap ``fn`` in an ``nn.Module`` and trace it with ``torch.export.export``
  on f32 CPU tensors built from the numpy examples, then lower the program
  to core aten with ``run_decompositions()``; shapes are the examples'
  (static graphs, like the reference's fixed-axis exports);
* lifted parameters, buffers and constant tensors are known values;
* CONSTANT-FOLD: any node whose inputs are all known runs eagerly in torch
  and its result becomes a known value (an initializer once an emitted node
  reads it), as the JAX converter binds the primitive on host, so arange,
  shape arithmetic and weight transposes leave no op in the graph;
* each remaining aten op maps to ONNX ops of the numpy executor's set
  (``_LOWERINGS``), with its inputs cast to the dtype torch computes in, so
  a graph runs the same in a runtime that enforces ONNX's typing.  Softmax,
  layer norm and GELU are spelled in elementary ops, and a transposed conv
  is a zero interleave followed by a regular ``Conv``.  Any other aten op
  raises ``NotImplementedError`` naming it.

The converter runs on the CPU and launches no kernel: the exporters trace
the plain f32 modules.  Verified by the numpy executor (``onnx_run.py``).
"""

from __future__ import annotations

import contextlib
import math
import operator
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .onnx_proto import NP_TO_ONNX, Graph, Node, Tensor, build_model

aten = torch.ops.aten


@dataclass(frozen=True)
class _Value:
    """A value of the emitted graph: its name, numpy dtype and shape."""

    name: str
    dtype: np.dtype
    shape: tuple


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dt).numpy().dtype


def _meta(node):
    return node.meta["val"]


class _Module(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class _Converter:
    def __init__(self, prefix: str = ""):
        self.nodes: List[Node] = []
        self.initializers: Dict[str, Tensor] = {}
        self.counter = 0
        # namespace prefix so graphs built by separate converters can be
        # merged (or nested as Loop bodies) without name collisions
        self.prefix = prefix
        self.known: Dict[str, object] = {}    # fx node name -> torch value
        self.values: Dict[str, object] = {}   # fx node name -> _Value (or tuple)
        self.materialized: Dict[tuple, _Value] = {}  # (operand, dtype) -> initializer

    # -- naming and emission ----------------------------------------------------

    def fresh(self, hint: str = "t") -> str:
        self.counter += 1
        return f"{self.prefix}{hint}_{self.counter}"

    def const(self, value, dtype: Optional[np.dtype] = None) -> _Value:
        """An initializer holding ``value`` (a tensor, array or scalar)."""
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        a = np.asarray(value, dtype)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        name = self.fresh("c")
        self.initializers[name] = Tensor(name, np.ascontiguousarray(a).reshape(a.shape))
        return _Value(name, a.dtype, a.shape)

    def node(self, op: str, inputs: Sequence[_Value], dtype, shape, out: Optional[str] = None,
             **attrs) -> _Value:
        name = out or self.fresh("v")
        self.nodes.append(Node(op, [v.name for v in inputs], [name], attrs,
                               name=self.fresh(op)))
        return _Value(name, np.dtype(dtype), tuple(shape))

    def cast(self, v: _Value, dtype: np.dtype) -> _Value:
        dtype = np.dtype(dtype)
        if v.dtype == dtype:
            return v
        return self.node("Cast", [v], dtype, v.shape, to=NP_TO_ONNX[dtype])

    def shape_const(self, shape) -> _Value:
        return self.const(np.asarray(list(shape), np.int64))

    def reshape(self, v: _Value, shape, out: Optional[str] = None) -> _Value:
        if tuple(shape) == v.shape and out is None:
            return v
        return self.node("Reshape", [v, self.shape_const(shape)], v.dtype, shape, out=out)

    def value(self, arg, dtype: Optional[np.dtype] = None) -> _Value:
        """The graph value of an operand: an fx node (emitted or known) or a
        Python scalar, cast to ``dtype`` when given."""
        if isinstance(arg, torch.fx.Node):
            if arg.name in self.known:
                key = (arg.name, None if dtype is None else np.dtype(dtype).name)
                if key not in self.materialized:
                    k = self.known[arg.name]
                    if dtype is not None and isinstance(k, torch.Tensor):
                        k = k.to(getattr(torch, key[1]))
                    self.materialized[key] = self.const(k, dtype)
                return self.materialized[key]
            v = self.values[arg.name]
            return v if dtype is None else self.cast(v, dtype)
        # a Python scalar: one initializer per value and dtype
        key = ("scalar", repr(arg), None if dtype is None else np.dtype(dtype).name)
        if key not in self.materialized:
            self.materialized[key] = self.const(arg, dtype)
        return self.materialized[key]


# ---------------------------------------------------------------------------
# lowerings:  lower(cv, node, out_name) -> _Value | tuple of _Value
# ---------------------------------------------------------------------------

def _out(node):
    m = _meta(node)
    m = m[0] if isinstance(m, (tuple, list)) else m
    return _np_dtype(m.dtype), tuple(m.shape)


def _dim(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


def _operand_meta(arg):
    """A stand-in for ``torch.result_type``: a meta tensor of the operand's
    dtype and rank (a Python scalar stays a scalar)."""
    if isinstance(arg, torch.fx.Node):
        m = _meta(arg)
        return torch.empty((0,) * m.dim(), dtype=m.dtype, device="meta") if m.dim() \
            else torch.empty((), dtype=m.dtype, device="meta")
    return arg


def _compute_dtype(args) -> np.dtype:
    """The dtype torch computes an elementwise op in (its type promotion)."""
    ms = [_operand_meta(a) for a in args]
    dt = ms[0] if isinstance(ms[0], torch.Tensor) else torch.as_tensor(ms[0])
    dt = dt.dtype if len(ms) == 1 else torch.result_type(*ms[:2])
    for m in ms[2:]:
        dt = torch.promote_types(dt, m.dtype if isinstance(m, torch.Tensor)
                                 else torch.as_tensor(m).dtype)
    return _np_dtype(dt)


def _unary(op):
    def lower(cv, node, out):
        dt, shape = _out(node)
        return cv.node(op, [cv.value(node.args[0], dt)], dt, shape, out=out)
    return lower


def _binary(op):
    """Elementwise arithmetic: operands cast to the result dtype."""
    def lower(cv, node, out):
        dt, shape = _out(node)
        a, b = node.args[:2]
        alpha = node.kwargs.get("alpha", 1)
        vb = cv.value(b, dt)
        if alpha != 1:
            vb = cv.node("Mul", [vb, cv.const(alpha, dt)], dt, _meta_shape(b))
        return cv.node(op, [cv.value(a, dt), vb], dt, shape, out=out)
    return lower


def _meta_shape(arg):
    return tuple(_meta(arg).shape) if isinstance(arg, torch.fx.Node) else ()


def _compare(op, negate=False):
    def lower(cv, node, out):
        dt, shape = _out(node)
        ct = _compute_dtype(node.args[:2])
        ins = [cv.value(a, ct) for a in node.args[:2]]
        if not negate:
            return cv.node(op, ins, dt, shape, out=out)
        eq = cv.node(op, ins, dt, shape)
        return cv.node("Not", [eq], dt, shape, out=out)
    return lower


def _logical(op):
    def lower(cv, node, out):
        dt, shape = _out(node)
        if dt != np.bool_:
            raise NotImplementedError(f"ONNX export: {node.target} on {dt}")
        return cv.node(op, [cv.value(a, dt) for a in node.args[:2]], dt, shape, out=out)
    return lower


def _not(cv, node, out):
    dt, shape = _out(node)
    if dt != np.bool_:
        raise NotImplementedError(f"ONNX export: {node.target} on {dt}")
    return cv.node("Not", [cv.value(node.args[0], dt)], dt, shape, out=out)


def _where(cv, node, out):
    dt, shape = _out(node)
    c, a, b = node.args
    return cv.node("Where", [cv.value(c, np.bool_), cv.value(a, dt), cv.value(b, dt)],
                   dt, shape, out=out)


def _pow(cv, node, out):
    dt, shape = _out(node)
    a, b = node.args[:2]
    if not isinstance(b, torch.fx.Node) and b == 2:
        va = cv.value(a, dt)
        return cv.node("Mul", [va, va], dt, shape, out=out)
    return cv.node("Pow", [cv.value(a, dt), cv.value(b, dt)], dt, shape, out=out)


def _clamp(cv, node, out):
    dt, shape = _out(node)
    args = list(node.args) + [None] * 3
    lo = node.kwargs.get("min", args[1])
    hi = node.kwargs.get("max", args[2])
    if node.target == aten.clamp_max.default:
        lo, hi = None, args[1]
    v = cv.value(args[0], dt)
    if lo is not None:
        v = cv.node("Max", [v, cv.value(lo, dt)], dt, shape,
                    out=out if hi is None else None)
    if hi is not None:
        v = cv.node("Min", [v, cv.value(hi, dt)], dt, shape, out=out)
    return v


def _relu(cv, node, out):
    dt, shape = _out(node)
    return cv.node("Max", [cv.value(node.args[0], dt), cv.const(0, dt)], dt, shape, out=out)


def _rsqrt(cv, node, out):
    dt, shape = _out(node)
    s = cv.node("Sqrt", [cv.value(node.args[0], dt)], dt, shape)
    return cv.node("Reciprocal", [s], dt, shape, out=out)


def _log1p(cv, node, out):
    dt, shape = _out(node)
    t = cv.node("Add", [cv.value(node.args[0], dt), cv.const(1, dt)], dt, shape)
    return cv.node("Log", [t], dt, shape, out=out)


def _expm1(cv, node, out):
    dt, shape = _out(node)
    t = cv.node("Exp", [cv.value(node.args[0], dt)], dt, shape)
    return cv.node("Sub", [t, cv.const(1, dt)], dt, shape, out=out)


def _gelu(cv, node, out):
    """Exact GELU ``x/2 (1 + erf(x/sqrt 2))``; the tanh form when asked."""
    dt, shape = _out(node)
    x = cv.value(node.args[0], dt)
    approximate = node.kwargs.get("approximate", node.args[1] if len(node.args) > 1
                                  else "none")
    if approximate == "tanh":
        x3 = cv.node("Mul", [cv.node("Mul", [x, x], dt, shape), x], dt, shape)
        inner = cv.node("Add", [x, cv.node("Mul", [x3, cv.const(0.044715, dt)], dt, shape)],
                        dt, shape)
        inner = cv.node("Mul", [inner, cv.const(math.sqrt(2.0 / math.pi), dt)], dt, shape)
        g = cv.node("Tanh", [inner], dt, shape)
    else:
        g = cv.node("Erf", [cv.node("Mul", [x, cv.const(1.0 / math.sqrt(2.0), dt)],
                                    dt, shape)], dt, shape)
    g = cv.node("Add", [g, cv.const(1, dt)], dt, shape)
    half = cv.node("Mul", [x, cv.const(0.5, dt)], dt, shape)
    return cv.node("Mul", [half, g], dt, shape, out=out)


def _to_copy(cv, node, out):
    dt, shape = _out(node)
    v = cv.value(node.args[0])
    if v.dtype == dt:
        return cv.node("Identity", [v], dt, shape, out=out)
    return cv.node("Cast", [v], dt, shape, out=out, to=NP_TO_ONNX[dt])


def _identity(cv, node, out):
    return cv.value(node.args[0])


def _view(cv, node, out):
    dt, shape = _out(node)
    return cv.reshape(cv.value(node.args[0]), shape, out=out)


def _expand(cv, node, out):
    dt, shape = _out(node)
    v = cv.value(node.args[0])
    if v.shape == shape:
        return v
    return cv.node("Expand", [v, cv.shape_const(shape)], dt, shape, out=out)


def _permute(cv, node, out):
    dt, shape = _out(node)
    v = cv.value(node.args[0])
    rank = len(v.shape)
    if node.target == aten.t.default:
        perm = list(range(rank))[::-1]
    elif node.target == aten.transpose.int:
        perm = list(range(rank))
        a, b = _dim(node.args[1], rank), _dim(node.args[2], rank)
        perm[a], perm[b] = perm[b], perm[a]
    else:
        perm = [_dim(d, rank) for d in node.args[1]]
    return cv.node("Transpose", [v], dt, shape, out=out, perm=perm)


def _slice(cv, node, out):
    dt, shape = _out(node)
    v = cv.value(node.args[0])
    args = list(node.args) + [None] * 5
    rank = len(v.shape)
    dim = _dim(args[1] if args[1] is not None else 0, rank)
    size = v.shape[dim]
    start, end, step = args[2], args[3], args[4] or 1
    start = 0 if start is None else start
    end = size if end is None else end
    start = min(max(start + size if start < 0 else start, 0), size)
    end = min(max(end + size if end < 0 else end, 0), size)
    if start == 0 and end == size and step == 1:
        return v
    names = [cv.const(np.asarray([x], np.int64)) for x in (start, end, dim, step)]
    return cv.node("Slice", [v] + names, dt, shape, out=out)


def _select(cv, node, out):
    dt, shape = _out(node)
    v = cv.value(node.args[0])
    dim = _dim(node.args[1], len(v.shape))
    index = node.args[2]
    index = index + v.shape[dim] if index < 0 else index
    return cv.node("Gather", [v, cv.const(np.asarray(index, np.int64))], dt, shape, out=out,
                   axis=dim)


def _cat(cv, node, out):
    dt, shape = _out(node)
    dim = _dim(node.args[1] if len(node.args) > 1 else 0, len(shape))
    return cv.node("Concat", [cv.value(t, dt) for t in node.args[0]], dt, shape, out=out,
                   axis=dim)


def _split(cv, node, out):
    v = cv.value(node.args[0])
    sizes = list(node.args[1])
    dim = _dim(node.args[2] if len(node.args) > 2 else 0, len(v.shape))
    metas = _meta(node)
    names = [f"{out}_{i}" for i in range(len(sizes))]
    cv.nodes.append(Node("Split", [v.name, cv.const(np.asarray(sizes, np.int64)).name], names,
                         {"axis": dim}, name=cv.fresh("Split")))
    return tuple(_Value(n, _np_dtype(m.dtype), tuple(m.shape)) for n, m in zip(names, metas))


def _constant_pad(cv, node, out):
    """torch's pad list (last dim first) -> ONNX ``Pad``; negative pads crop
    with ``Slice`` first, as the JAX converter lowers them."""
    dt, shape = _out(node)
    v = cv.value(node.args[0])
    pad = list(node.args[1])
    value = node.args[2] if len(node.args) > 2 else 0
    rank = len(v.shape)
    lo, hi = [0] * rank, [0] * rank
    for i in range(len(pad) // 2):
        lo[rank - 1 - i], hi[rank - 1 - i] = pad[2 * i], pad[2 * i + 1]
    if any(p < 0 for p in lo + hi):
        starts = [max(0, -p) for p in lo]
        ends = [s + min(0, p) for s, p in zip(v.shape, hi)]
        crop = tuple(e - s for s, e in zip(starts, ends))
        names = [cv.const(np.asarray(a, np.int64)) for a in
                 (starts, ends, list(range(rank)))]
        v = cv.node("Slice", [v] + names, dt, crop)
        lo, hi = [max(0, p) for p in lo], [max(0, p) for p in hi]
    if not any(lo + hi):
        return cv.node("Identity", [v], dt, shape, out=out)
    return cv.node("Pad", [v, cv.const(np.asarray(lo + hi, np.int64)), cv.const(value, dt)],
                   dt, shape, out=out, mode="constant")


def _reduce(op, axes_as_input=True):
    def lower(cv, node, out):
        dt, shape = _out(node)
        v = cv.value(node.args[0], dt)
        rank = len(v.shape)
        dims = node.args[1] if len(node.args) > 1 else None
        dims = list(range(rank)) if dims is None or dims == [] else \
            [_dim(d, rank) for d in ([dims] if isinstance(dims, int) else dims)]
        keep = int(node.args[2] if len(node.args) > 2 else node.kwargs.get("keepdim", False))
        if axes_as_input:
            return cv.node(op, [v, cv.const(np.asarray(dims, np.int64))], dt, shape,
                           out=out, keepdims=keep)
        return cv.node(op, [v], dt, shape, out=out, axes=dims, keepdims=keep)
    return lower


def _matmul(cv, node, out):
    dt, shape = _out(node)
    if node.target == aten.addmm.default:
        bias, a, b = node.args[:3]
        beta = node.kwargs.get("beta", 1)
        alpha = node.kwargs.get("alpha", 1)
        if beta != 1 or alpha != 1:
            raise NotImplementedError("ONNX export: addmm with beta/alpha")
        mm = cv.node("MatMul", [cv.value(a, dt), cv.value(b, dt)], dt, shape)
        return cv.node("Add", [mm, cv.value(bias, dt)], dt, shape, out=out)
    a, b = node.args[:2]
    return cv.node("MatMul", [cv.value(a, dt), cv.value(b, dt)], dt, shape, out=out)


def _softmax(cv, node, out):
    """Max-subtracted ``Exp`` over ``ReduceSum``."""
    dt, shape = _out(node)
    x = cv.value(node.args[0], dt)
    dim = _dim(node.args[1], len(shape))
    axes = cv.const(np.asarray([dim], np.int64))
    red = tuple(1 if i == dim else s for i, s in enumerate(shape))
    mx = cv.node("ReduceMax", [x, axes], dt, red, keepdims=1)
    e = cv.node("Exp", [cv.node("Sub", [x, mx], dt, shape)], dt, shape)
    s = cv.node("ReduceSum", [e, axes], dt, red, keepdims=1)
    return cv.node("Div", [e, s], dt, shape, out=out)


def _layer_norm(cv, node, out):
    """``native_layer_norm`` output 0 as ``ReduceMean``/``Sub``/``Mul``/
    ``Sqrt``/``Div``; its mean and rstd outputs are not emitted."""
    dt, shape = _out(node)
    x = cv.value(node.args[0], dt)
    n = len(node.args[1])
    weight, bias, eps = node.args[2], node.args[3], node.args[4]
    axes = list(range(len(shape) - n, len(shape)))
    red = tuple(1 if i in axes else s for i, s in enumerate(shape))
    mean = cv.node("ReduceMean", [x], dt, red, axes=axes, keepdims=1)
    xc = cv.node("Sub", [x, mean], dt, shape)
    var = cv.node("ReduceMean", [cv.node("Mul", [xc, xc], dt, shape)], dt, red,
                  axes=axes, keepdims=1)
    std = cv.node("Sqrt", [cv.node("Add", [var, cv.const(eps, dt)], dt, red)], dt, red)
    y = cv.node("Div", [xc, std], dt, shape)
    if weight is not None:
        y = cv.node("Mul", [y, cv.value(weight, dt)], dt, shape)
    if bias is not None:
        y = cv.node("Add", [y, cv.value(bias, dt)], dt, shape)
    return (y, None, None)


def _conv(cv, node, out):
    """1-D ``convolution`` -> ``Conv`` (grouped, dilated, strided).  A
    transposed conv is the regular conv of the stride-interleaved input with
    the flipped, transposed kernel (its weight must be known)."""
    dt, shape = _out(node)
    x_arg, w_arg, b_arg, stride, padding, dilation, transposed, out_pad, groups = node.args
    if len(_meta(x_arg).shape) != 3:
        raise NotImplementedError("ONNX export: only 1-D convolutions")
    s, p, d, g = int(stride[0]), int(padding[0]), int(dilation[0]), int(groups)
    x = cv.value(x_arg, dt)
    ins = []
    if transposed:
        if w_arg.name not in cv.known:
            raise NotImplementedError("ONNX export: transposed conv with a traced weight")
        w = cv.known[w_arg.name]                              # [C_in, C_out/g, k]
        c_in, c_out_g, k = w.shape
        w = w.reshape(g, c_in // g, c_out_g, k).transpose(1, 2).reshape(g * c_out_g, c_in // g, k)
        ins_w = cv.const(torch.flip(w, dims=[2]).to(getattr(torch, dt.name)))
        n, c, t = x.shape
        if s > 1:
            # zero-interleave along time: [N,C,T] -> [N,C,T,s] -> [N,C,T*s]
            # -> drop the trailing s-1 zeros
            u = cv.reshape(x, (n, c, t, 1))
            z = cv.const(np.zeros((n, c, t, s - 1), dt))
            cat = cv.node("Concat", [u, z], dt, (n, c, t, s), axis=3)
            flat = cv.reshape(cat, (n, c, t * s))
            x = cv.node("Slice", [flat] + [cv.const(np.asarray([a], np.int64))
                                           for a in (0, t * s - (s - 1), 2)],
                        dt, (n, c, t * s - (s - 1)))
        lo = d * (k - 1) - p
        hi = d * (k - 1) - p + int(out_pad[0])
        if lo < 0 or hi < 0:
            raise NotImplementedError("ONNX export: transposed conv padding beyond the kernel")
        pads, s = [lo, hi], 1
        ins = [x, ins_w]
    else:
        pads = [p, p]
        ins = [x, cv.value(w_arg, dt)]
    if b_arg is not None:
        ins.append(cv.value(b_arg, dt))
    return cv.node("Conv", ins, dt, shape, out=out, dilations=[d], group=g, pads=pads,
                   strides=[s])


def _embedding(cv, node, out):
    dt, shape = _out(node)
    weight, idx = node.args[:2]
    return cv.node("Gather", [cv.value(weight), cv.value(idx)], dt, shape, out=out, axis=0)


def _gather(cv, node, out):
    dt, shape = _out(node)
    x, dim, idx = node.args[:3]
    return cv.node("GatherElements", [cv.value(x), cv.value(idx)], dt, shape, out=out,
                   axis=_dim(dim, len(shape)))


def _scatter_add(cv, node, out):
    dt, shape = _out(node)
    x, dim, idx, src = node.args[:4]
    if tuple(_meta(idx).shape) != tuple(_meta(src).shape):
        raise NotImplementedError("ONNX export: scatter_add with src larger than index")
    return cv.node("ScatterElements", [cv.value(x, dt), cv.value(idx), cv.value(src, dt)],
                   dt, shape, out=out, axis=_dim(dim, len(shape)), reduction="add")


def _cumsum(cv, node, out):
    dt, shape = _out(node)
    dim = _dim(node.args[1], len(shape))
    return cv.node("CumSum", [cv.value(node.args[0], dt), cv.const(np.asarray(dim, np.int64))],
                   dt, shape, out=out)


def _mod(fmod):
    def lower(cv, node, out):
        dt, shape = _out(node)
        return cv.node("Mod", [cv.value(a, dt) for a in node.args[:2]], dt, shape, out=out,
                       fmod=fmod)
    return lower


def _div(cv, node, out):
    dt, shape = _out(node)
    mode = node.kwargs.get("rounding_mode")
    if mode is None:
        return _binary("Div")(cv, node, out)
    if dt.kind != "f" or mode != "floor":
        raise NotImplementedError(f"ONNX export: div with rounding_mode={mode!r} on {dt}")
    q = cv.node("Div", [cv.value(a, dt) for a in node.args[:2]], dt, shape)
    return cv.node("Floor", [q], dt, shape, out=out)


_LOWERINGS = {
    aten.add.Tensor: _binary("Add"),
    aten.sub.Tensor: _binary("Sub"),
    aten.mul.Tensor: _binary("Mul"),
    aten.div.Tensor: _binary("Div"),
    aten.div.Tensor_mode: _div,
    aten.maximum.default: _binary("Max"),
    aten.minimum.default: _binary("Min"),
    aten.pow.Tensor_Scalar: _pow,
    aten.pow.Tensor_Tensor: _pow,
    aten.pow.Scalar: _pow,
    aten.neg.default: _unary("Neg"),
    aten.exp.default: _unary("Exp"),
    aten.log.default: _unary("Log"),
    aten.cos.default: _unary("Cos"),
    aten.sin.default: _unary("Sin"),
    aten.tanh.default: _unary("Tanh"),
    aten.sigmoid.default: _unary("Sigmoid"),
    aten.sqrt.default: _unary("Sqrt"),
    aten.reciprocal.default: _unary("Reciprocal"),
    aten.erf.default: _unary("Erf"),
    aten.sign.default: _unary("Sign"),
    aten.abs.default: _unary("Abs"),
    aten.floor.default: _unary("Floor"),
    aten.round.default: _unary("Round"),
    aten.rsqrt.default: _rsqrt,
    aten.log1p.default: _log1p,
    aten.expm1.default: _expm1,
    aten.relu.default: _relu,
    aten.gelu.default: _gelu,
    aten.clamp.default: _clamp,
    aten.clamp_min.default: _clamp,
    aten.clamp_max.default: _clamp,
    aten.lt.Scalar: _compare("Less"),
    aten.lt.Tensor: _compare("Less"),
    aten.le.Scalar: _compare("LessOrEqual"),
    aten.le.Tensor: _compare("LessOrEqual"),
    aten.gt.Scalar: _compare("Greater"),
    aten.gt.Tensor: _compare("Greater"),
    aten.ge.Scalar: _compare("GreaterOrEqual"),
    aten.ge.Tensor: _compare("GreaterOrEqual"),
    aten.eq.Scalar: _compare("Equal"),
    aten.eq.Tensor: _compare("Equal"),
    aten.ne.Scalar: _compare("Equal", negate=True),
    aten.ne.Tensor: _compare("Equal", negate=True),
    aten.bitwise_and.Tensor: _logical("And"),
    aten.logical_and.default: _logical("And"),
    aten.bitwise_or.Tensor: _logical("Or"),
    aten.logical_or.default: _logical("Or"),
    aten.bitwise_not.default: _not,
    aten.logical_not.default: _not,
    aten.where.self: _where,
    aten._to_copy.default: _to_copy,
    aten.clone.default: _identity,
    aten.alias.default: _identity,
    aten.detach.default: _identity,
    aten.lift_fresh_copy.default: _identity,
    aten.view.default: _view,
    aten._unsafe_view.default: _view,
    aten.reshape.default: _view,
    aten.unsqueeze.default: _view,
    aten.squeeze.dim: _view,
    aten.squeeze.dims: _view,
    aten.squeeze.default: _view,
    aten.expand.default: _expand,
    aten.permute.default: _permute,
    aten.t.default: _permute,
    aten.transpose.int: _permute,
    aten.slice.Tensor: _slice,
    aten.select.int: _select,
    aten.cat.default: _cat,
    aten.split_with_sizes.default: _split,
    aten.constant_pad_nd.default: _constant_pad,
    aten.sum.dim_IntList: _reduce("ReduceSum"),
    aten.mean.dim: _reduce("ReduceMean", axes_as_input=False),
    aten.amax.default: _reduce("ReduceMax"),
    aten.amin.default: _reduce("ReduceMin"),
    aten.addmm.default: _matmul,
    aten.mm.default: _matmul,
    aten.bmm.default: _matmul,
    aten._softmax.default: _softmax,
    aten.native_layer_norm.default: _layer_norm,
    aten.convolution.default: _conv,
    aten.embedding.default: _embedding,
    aten.gather.default: _gather,
    aten.scatter_add.default: _scatter_add,
    aten.cumsum.default: _cumsum,
    aten.fmod.Scalar: _mod(1),
    aten.fmod.Tensor: _mod(1),
    aten.remainder.Scalar: _mod(0),
    aten.remainder.Tensor: _mod(0),
}

# bookkeeping nodes that compute nothing
_DROP = {aten._assert_tensor_metadata.default, aten._assert_scalar.default,
         aten.sym_constrain_range_for_size.default}
# ops whose value depends on their operand's shape and dtype only
_SHAPE_ONLY = {aten.full_like.default, aten.zeros_like.default, aten.ones_like.default,
               aten.empty_like.default}


def _fold(cv: _Converter, node) -> bool:
    """Run ``node`` eagerly in torch when all its operands are known."""
    if node.target in _SHAPE_ONLY:
        m = _meta(node)
        fill = {aten.full_like.default: lambda: node.args[1],
                aten.ones_like.default: lambda: 1}.get(node.target, lambda: 0)()
        cv.known[node.name] = torch.full(tuple(m.shape), fill, dtype=m.dtype)
        return True
    refs = []
    torch.fx.map_arg((node.args, node.kwargs), refs.append)
    if any(r.name not in cv.known for r in refs):
        return False

    def load(a):
        return cv.known[a.name]

    args = torch.fx.map_arg(node.args, load)
    kwargs = torch.fx.map_arg(node.kwargs, load)
    if "device" in kwargs:
        kwargs = dict(kwargs, device=torch.device("cpu"))
    with torch.no_grad():
        cv.known[node.name] = node.target(*args, **kwargs)
    return True


def _convert_program(cv: _Converter, ep, user_inputs: Sequence[_Value]) -> List:
    """Walk the exported program's graph; returns the user outputs as
    (fx node or constant) entries."""
    sig = ep.graph_signature
    consts = dict(ep.state_dict)
    consts.update(ep.constants)
    kinds = {spec.arg.name: spec for spec in sig.input_specs}
    users = iter(user_inputs)
    outputs = []
    for node in ep.graph.nodes:
        if node.op == "placeholder":
            spec = kinds[node.name]
            if spec.kind.name == "USER_INPUT":
                cv.values[node.name] = next(users)
            else:
                cv.known[node.name] = consts[spec.target].detach()
            continue
        if node.op == "output":
            outputs = list(node.args[0])
            continue
        if node.op != "call_function":
            raise NotImplementedError(f"ONNX export: fx node {node.op}")
        if node.target is operator.getitem:
            src, i = node.args
            if src.name in cv.known:
                cv.known[node.name] = cv.known[src.name][i]
            else:
                v = cv.values[src.name][i]
                if v is None:
                    raise NotImplementedError(f"ONNX export: output {i} of {src.target}")
                cv.values[node.name] = v
            continue
        if node.target in _DROP:
            continue
        if torch.Tag.nondeterministic_seeded in getattr(node.target, "tags", ()):
            # folding would bake one draw into the graph
            raise NotImplementedError(f"ONNX export: random aten op '{node.target}' "
                                      "(trace the module in eval mode, without draws)")
        if _fold(cv, node):
            continue
        if node.target not in _LOWERINGS:
            raise NotImplementedError(f"ONNX export: aten op '{node.target}'")
        cv.values[node.name] = _LOWERINGS[node.target](cv, node, cv.fresh("v"))
    return [outputs[i] for i, spec in enumerate(sig.output_specs)
            if spec.kind.name == "USER_OUTPUT"]


# (function, example signature) -> its graph, inside ``reuse_traces()`` only
_TRACES: Optional[dict] = None


@contextlib.contextmanager
def reuse_traces():
    """Within the block, tracing a function again at the same example shapes
    and dtypes renames its first graph instead of tracing anew.  The
    exporters trace each function for its standalone graph and again for a
    merged one; outside the block every call traces (a function's weights
    may have changed between calls)."""
    global _TRACES
    saved, _TRACES = _TRACES, {}
    try:
        yield
    finally:
        _TRACES = saved


def _renamed(graph: Graph, prefix: str, input_names, output_names, graph_name) -> Graph:
    """``graph`` with its inputs and outputs renamed in order and every
    internal value, initializer and node name under ``prefix``; new records,
    the initializers' arrays shared."""
    names = {old: new for (old, _, _), new in zip(graph.inputs, input_names)}
    names.update({old: new for (old, _, _), new in zip(graph.outputs, output_names)})

    def rename(x):
        return names.get(x, prefix + x) if x else x

    return Graph(
        graph_name,
        [Node(n.op_type, [rename(x) for x in n.inputs], [rename(x) for x in n.outputs],
              dict(n.attrs), name=prefix + n.name) for n in graph.nodes],
        [(new, et, shape) for (_, et, shape), new in zip(graph.inputs, input_names)],
        [(new, et, shape) for (_, et, shape), new in zip(graph.outputs, output_names)],
        [Tensor(prefix + t.name, t.array) for t in graph.initializers],
    )


def trace_to_graph(
    fn,
    example_args: Sequence[np.ndarray],
    *,
    input_names: Optional[Sequence[str]] = None,
    output_names: Optional[Sequence[str]] = None,
    graph_name: str = "graph",
    prefix: str = "",
) -> Graph:
    """Trace ``fn(*example_args)`` into an ONNX :class:`Graph`.

    The examples are numpy arrays; the graph's inputs take their names,
    dtypes and shapes (f64 becomes f32).  Internal value names carry
    ``prefix`` so graphs from separate traces can be merged
    (``merge_graphs``) or embedded as Loop bodies (``onnx_loop.py``) without
    collisions; graph input/output names are the caller's verbatim.
    """
    arrays = [np.asarray(a) for a in example_args]
    arrays = [a.astype(np.float32) if a.dtype == np.float64 else a for a in arrays]
    tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    if input_names is None:
        input_names = [f"in{i}" for i in range(len(tensors))]
    if len(input_names) != len(tensors):
        raise ValueError(f"{len(tensors)} graph inputs but {len(input_names)} names")
    key = (fn, tuple((a.shape, a.dtype.str) for a in arrays))
    traced = None if _TRACES is None else _TRACES.get(key)
    if traced is not None:
        if output_names is None:
            output_names = [f"out{i}" for i in range(len(traced.outputs))]
        if len(output_names) != len(traced.outputs):
            raise ValueError(f"{len(traced.outputs)} graph outputs but "
                             f"{len(output_names)} names")
        return _renamed(traced, prefix, input_names, output_names, graph_name)
    ep = torch.export.export(_Module(fn), tensors).run_decompositions()

    cv = _Converter(prefix)
    graph_inputs = []
    values = []
    for name, a in zip(input_names, arrays):
        graph_inputs.append((name, NP_TO_ONNX[a.dtype], list(a.shape)))
        values.append(_Value(name, a.dtype, a.shape))
    outs = _convert_program(cv, ep, values)

    if output_names is None:
        output_names = [f"out{i}" for i in range(len(outs))]
    if len(output_names) != len(outs):
        raise ValueError(f"{len(outs)} graph outputs but {len(output_names)} names")
    graph_outputs = []
    for o, name in zip(outs, output_names):
        if isinstance(o, torch.fx.Node) and o.name in cv.values:
            src = cv.values[o.name]
        else:
            src = cv.value(o)
        cv.nodes.append(Node("Identity", [src.name], [name], {}, name=cv.fresh("Identity")))
        graph_outputs.append((name, NP_TO_ONNX[np.dtype(src.dtype)], list(src.shape)))

    graph = Graph(graph_name, cv.nodes, graph_inputs, graph_outputs,
                  list(cv.initializers.values()))
    if _TRACES is not None and not prefix:
        _TRACES[key] = graph
        graph = _renamed(graph, "", input_names, output_names, graph_name)
    return graph


def export_onnx(
    fn,
    example_args: Sequence[np.ndarray],
    path,
    *,
    input_names: Optional[Sequence[str]] = None,
    output_names: Optional[Sequence[str]] = None,
    graph_name: str = "graph",
    opset: int = 17,
    optimize: bool = True,
) -> bytes:
    """Trace ``fn(*example_args)`` and write an ONNX model to ``path``.

    Shapes are taken from the example args (static graphs, like the
    reference's fixed-axis exports with dynamic batch disabled).
    ``optimize`` runs the constant-fold / dead-value passes before writing
    (the reference runs onnxsim on every artifact, acoustic_exporter.py:336).
    Returns the serialized model bytes.
    """
    g = trace_to_graph(
        fn, example_args, input_names=input_names, output_names=output_names,
        graph_name=graph_name,
    )
    if optimize:
        from .graph_passes import simplify_graph

        g = simplify_graph(g)
    data = build_model(g, opset=opset)
    if path is not None:
        from pathlib import Path

        Path(path).write_bytes(data)
    return data
