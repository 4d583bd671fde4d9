"""Reference numpy executor for the ONNX op subset the exporter emits.

Copy of the JAX package's ``deployment/onnx_run.py``, with the same op set,
so that each package's executor runs the other's graphs.  The port does not
depend on onnxruntime, so exported ``.onnx`` artifacts are verified by
parsing them back (``onnx_proto.parse_model``) and executing the graph with
numpy, then comparing against the traced torch function.  The executor
implements standard ONNX semantics for the ops that ``onnx_export``'s
lowerings and ``onnx_loop`` emit; it is a validation tool, not a serving
runtime.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .onnx_proto import ONNX_TO_NP, Graph, parse_model


def _conv1d(x, w, pads, strides, dilations, group):
    """x [N,C,W], w [M, C/group, kW] -> [N, M, outW] (standard ONNX Conv)."""
    n, c, width = x.shape
    m, cg, kw = w.shape
    x = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[1])))
    span = (kw - 1) * dilations[0] + 1
    out_w = (x.shape[2] - span) // strides[0] + 1
    # im2col: [N, C, kw, out_w]
    idx = (np.arange(kw)[:, None] * dilations[0]
           + np.arange(out_w)[None, :] * strides[0])
    cpg = c // group
    mpg = m // group
    if cpg == 1 and mpg == 1 and group > 1:
        # depthwise: a sum of shifted rows over the taps, not one product a group
        out = np.zeros((n, m, out_w), np.float32)
        tap = np.empty_like(out)
        d, s = dilations[0], strides[0]
        for k in range(kw):
            np.multiply(x[:, :, k * d : k * d + (out_w - 1) * s + 1 : s],
                        w[None, :, 0, k, None], out=tap)
            out += tap
        return out
    out = np.empty((n, m, out_w), np.float32)
    cols = x[:, :, idx]  # im2col: [N, C, kw, out_w]
    for g in range(group):
        xg = cols[:, g * cpg : (g + 1) * cpg]          # [N, cpg, kw, out_w]
        wg = w[g * mpg : (g + 1) * mpg]                # [mpg, cpg, kw]
        out[:, g * mpg : (g + 1) * mpg] = np.einsum(
            "nckw,mck->nmw", xg, wg, optimize=True
        )
    return out


def run_graph(graph: Graph, feeds: Dict[str, np.ndarray],
              outer: Optional[Dict[str, np.ndarray]] = None,
              rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
    """Execute ``graph``.

    ``outer`` provides outer-scope values for subgraphs (ONNX Loop/If bodies
    may reference enclosing-graph names). ``rng`` seeds RandomNormal* ops so
    artifact verification is reproducible (stock runtimes draw fresh noise;
    parity tests replicate the executor's draws on the torch side).
    """
    env: Dict[str, np.ndarray] = dict(outer) if outer else {}
    if rng is None:
        rng = np.random.default_rng(0)
    for t in graph.initializers:
        env[t.name] = t.array
    for name, _, _ in graph.inputs:
        if name not in feeds:
            raise KeyError(f"missing graph input {name}")
        env[name] = np.asarray(feeds[name])

    for node in graph.nodes:
        i = [env[x] for x in node.inputs if x != ""]
        a = node.attrs
        op = node.op_type
        if op == "Add":
            r = i[0] + i[1]
        elif op == "Sub":
            r = i[0] - i[1]
        elif op == "Mul":
            r = i[0] * i[1]
        elif op == "Div":
            r = i[0] / i[1] if i[0].dtype.kind == "f" else i[0] // i[1]
        elif op == "Max":
            r = np.maximum(i[0], i[1])
        elif op == "Min":
            r = np.minimum(i[0], i[1])
        elif op == "Neg":
            r = -i[0]
        elif op == "Exp":
            r = np.exp(i[0])
        elif op == "Log":
            r = np.log(i[0])
        elif op == "Cos":
            r = np.cos(i[0])
        elif op == "Sin":
            r = np.sin(i[0])
        elif op == "Tanh":
            r = np.tanh(i[0])
        elif op == "Sigmoid":
            r = 1.0 / (1.0 + np.exp(-i[0]))
        elif op == "Sqrt":
            r = np.sqrt(i[0])
        elif op == "Reciprocal":
            r = 1.0 / i[0]
        elif op == "Erf":
            from scipy.special import erf

            r = erf(i[0]).astype(i[0].dtype)
        elif op == "Sign":
            r = np.sign(i[0])
        elif op == "Abs":
            r = np.abs(i[0])
        elif op == "Floor":
            r = np.floor(i[0])
        elif op == "Pow":
            r = np.power(i[0], i[1]).astype(i[0].dtype)
        elif op == "Less":
            r = i[0] < i[1]
        elif op == "LessOrEqual":
            r = i[0] <= i[1]
        elif op == "Greater":
            r = i[0] > i[1]
        elif op == "GreaterOrEqual":
            r = i[0] >= i[1]
        elif op == "Equal":
            r = i[0] == i[1]
        elif op == "And":
            r = i[0] & i[1]
        elif op == "Or":
            r = i[0] | i[1]
        elif op == "Not":
            r = ~i[0]
        elif op == "Where":
            r = np.where(i[0], i[1], i[2])
        elif op == "Identity":
            r = i[0]
        elif op == "Cast":
            r = i[0].astype(ONNX_TO_NP[a["to"]])
        elif op == "Reshape":
            r = i[0].reshape([int(d) for d in i[1]])
        elif op == "Transpose":
            r = np.transpose(i[0], a["perm"])
        elif op == "Expand":
            r = np.broadcast_to(i[0], [int(d) for d in i[1]]).copy()
        elif op == "Concat":
            r = np.concatenate(i, axis=int(a["axis"]))
        elif op == "Split":
            sizes = [int(s) for s in i[1]]
            r = np.split(i[0], np.cumsum(sizes)[:-1], axis=int(a["axis"]))
        elif op == "Slice":
            data, starts, ends, axes = i[0], i[1], i[2], i[3]
            steps = i[4] if len(i) > 4 else np.ones_like(starts)
            sl = [slice(None)] * data.ndim
            for s, e, ax, st in zip(starts, ends, axes, steps):
                sl[int(ax)] = slice(int(s), int(e), int(st))
            r = data[tuple(sl)]
        elif op == "Pad":
            pads = [int(x) for x in i[1]]
            nd = i[0].ndim
            value = i[2] if len(i) > 2 else np.zeros((), i[0].dtype)
            width = [(pads[d], pads[nd + d]) for d in range(nd)]
            r = np.pad(i[0], width, constant_values=np.asarray(value).item())
        elif op == "ReduceSum":
            r = i[0].sum(axis=tuple(int(x) for x in i[1]),
                         keepdims=bool(a.get("keepdims", 1)))
        elif op == "ReduceMean":
            ax = (tuple(int(x) for x in (i[1] if len(i) > 1 else a.get("axes", [])))
                  or None)
            r = i[0].mean(axis=ax, keepdims=bool(a.get("keepdims", 1)))
        elif op == "ReduceMax":
            r = i[0].max(axis=tuple(int(x) for x in i[1]),
                         keepdims=bool(a.get("keepdims", 1)))
        elif op == "ReduceMin":
            r = i[0].min(axis=tuple(int(x) for x in i[1]),
                         keepdims=bool(a.get("keepdims", 1)))
        elif op == "CumSum":
            r = np.cumsum(i[0], axis=int(i[1]))
        elif op == "Mod":
            r = np.fmod(i[0], i[1]) if a.get("fmod") else np.mod(i[0], i[1])
        elif op == "MatMul":
            r = np.matmul(i[0], i[1])
        elif op == "Gather":
            r = np.take(i[0], i[1].astype(np.int64), axis=int(a.get("axis", 0)))
        elif op == "GatherElements":
            data, idx = i[0], i[1].astype(np.int64)
            r = np.take_along_axis(data, idx, axis=int(a.get("axis", 0)))
        elif op == "ScatterElements":
            data, idx, upd = i[0].copy(), i[1].astype(np.int64), i[2]
            ax = int(a.get("axis", 0))
            if a.get("reduction") == "add":
                grid = list(np.ogrid[tuple(map(slice, idx.shape))])
                grid[ax] = idx
                np.add.at(data, tuple(grid), upd)
            else:
                np.put_along_axis(data, idx, upd, axis=ax)
            r = data
        elif op == "GatherND":
            data, idx = i[0], i[1].astype(np.int64)
            r = data[tuple(np.moveaxis(idx, -1, 0))]
        elif op == "ScatterND":
            data, idx, upd = i[0].copy(), i[1].astype(np.int64), i[2]
            coords = tuple(np.moveaxis(idx, -1, 0))
            if a.get("reduction") == "add":
                np.add.at(data, coords, upd)
            else:
                data[coords] = upd
            r = data
        elif op == "Round":
            # ONNX Round = round-half-to-even, which is numpy's np.round
            r = np.round(i[0])
        elif op == "Clip":
            lo = i[1] if len(i) > 1 else None
            hi = i[2] if len(i) > 2 else None
            r = np.clip(i[0], lo, hi)
        elif op == "RandomNormalLike":
            dt = ONNX_TO_NP[a["dtype"]] if "dtype" in a else i[0].dtype
            r = (a.get("mean", 0.0)
                 + a.get("scale", 1.0) * rng.standard_normal(i[0].shape)).astype(dt)
        elif op == "RandomNormal":
            dt = ONNX_TO_NP[a.get("dtype", 1)]
            shape = [int(d) for d in a["shape"]]
            r = (a.get("mean", 0.0)
                 + a.get("scale", 1.0) * rng.standard_normal(shape)).astype(dt)
        elif op == "Loop":
            trip = (int(np.asarray(i[0]).reshape(()).item())
                    if node.inputs[0] else np.iinfo(np.int64).max)
            cond = bool(np.asarray(i[1]).item()) if len(node.inputs) > 1 and node.inputs[1] else True
            body: Graph = a["body"]
            n_carried = len(node.inputs) - 2
            carried = list(i[2:2 + n_carried])
            n_scan = len(body.outputs) - 1 - n_carried
            scans = [[] for _ in range(n_scan)]
            it = 0
            while it < trip and cond:
                bfeeds = {body.inputs[0][0]: np.asarray(it, np.int64),
                          body.inputs[1][0]: np.asarray(cond)}
                for (bname, _, _), val in zip(body.inputs[2:], carried):
                    bfeeds[bname] = val
                bout = run_graph(body, bfeeds, outer=env, rng=rng)
                outs = [bout[bn] for bn, _, _ in body.outputs]
                cond = bool(np.asarray(outs[0]).item())
                carried = outs[1:1 + n_carried]
                for j in range(n_scan):
                    scans[j].append(outs[1 + n_carried + j])
                it += 1
            r = carried + [np.stack(s) for s in scans]
        elif op == "Conv":
            pads = [int(x) for x in a.get("pads", [0, 0])]
            r = _conv1d(
                i[0].astype(np.float32), i[1].astype(np.float32),
                pads, [int(x) for x in a.get("strides", [1])],
                [int(x) for x in a.get("dilations", [1])],
                int(a.get("group", 1)),
            )
            if len(i) > 2:  # bias
                r = r + i[2][None, :, None]
        else:
            raise NotImplementedError(f"executor: op {op}")
        if isinstance(r, list):
            for name, val in zip(node.outputs, r):
                env[name] = np.asarray(val)
        else:
            env[node.outputs[0]] = np.asarray(r)

    return {name: env[name] for name, _, _ in graph.outputs}


def run_model_bytes(data: bytes, feeds: Dict[str, np.ndarray]):
    graph, _ = parse_model(data)
    return run_graph(graph, feeds)


def _register_extra_ops():  # pragma: no cover - kept for clarity
    pass
