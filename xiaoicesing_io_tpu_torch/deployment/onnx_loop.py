"""Loop-bearing ONNX diffusion graphs and fs2+diffusion merging.

The reference ships ONE ``acoustic.onnx`` whose graph embeds the whole
sampling procedure — a scripted loop with runtime ``depth``/``steps`` inputs
(``deployment/modules/diffusion.py:18-161``, ``rectified_flow.py:37-69``)
merged with the fs2+aux graph through ``onnx.compose`` io_map
(``deployment/exporters/acoustic_exporter.py:363-390``).

Copy of the JAX package's ``deployment/onnx_loop.py``, built over the port's
torch models: the single-step denoiser is traced once through the
aten->ONNX converter (``onnx_export.trace_to_graph``) and embedded as
the body of an ONNX ``Loop`` node; the schedule coefficients, shallow-start
mixing, trip-count arithmetic and (de)normalization are emitted as explicit
ONNX ops on the ``depth``/``steps`` graph inputs, so the exported model is
driven exactly like the reference's (condition/x_start flow in, ``depth``
selects shallowness, ``steps`` the sampler step count).

Layout note: the reference's graphs carry [B, F, M, T]; ours carry
[B, F, T, M] (the layout both packages use for the model domain).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .onnx_export import trace_to_graph
from .onnx_proto import BOOL, FLOAT, INT64, Graph, Node, Tensor


class _GB:
    """Tiny graph builder: fresh names + node/initializer accumulation."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self.nodes: List[Node] = []
        self.initializers: List[Tensor] = []
        self.n = 0

    def fresh(self, hint: str = "t") -> str:
        self.n += 1
        return f"{self.prefix}{hint}_{self.n}"

    def node(self, op: str, inputs: Sequence[str], n_out: int = 1, **attrs):
        outs = [self.fresh(op.lower()) for _ in range(n_out)]
        self.nodes.append(Node(op, list(inputs), outs, attrs, name=self.fresh(op)))
        return outs[0] if n_out == 1 else outs

    def const(self, value, dtype=None) -> str:
        a = np.asarray(value, dtype)
        name = self.fresh("c")
        self.initializers.append(Tensor(name, a))
        return name

    def f32(self, value) -> str:
        return self.const(value, np.float32)

    def i64(self, value) -> str:
        return self.const(value, np.int64)


def _emit_post(
    g: _GB,
    x_final: str,
    shape: Tuple[int, int, int, int],
    k: np.ndarray,
    b: np.ndarray,
    post: str,
    clamps,
    out_names: Sequence[str],
) -> List[tuple]:
    """Denormalize the sampled tensor and emit graph outputs.

    ``post='mel'``: [B,1,T,M] -> denorm -> ``mel`` [B,T,M].
    ``post='curves'``: [B,F,T,R] -> denorm -> mean over repeat bins ->
    per-feature clamp -> F outputs [B,T] (SpecNormalizer.denorm parity,
    models/diffusion/core.py:78-88; ref ddpm.py:386-505).
    """
    B, F, T, M = shape
    den = g.node("Add", [g.node("Mul", [x_final, g.const(k)]), g.const(b)])
    outputs = []
    if post == "mel":
        mel = g.node("Reshape", [den, g.i64([B, T, M])])
        g.nodes.append(Node("Identity", [mel], [out_names[0]], {},
                            name=g.fresh("out")))
        return [(out_names[0], FLOAT, [B, T, M])]
    mean = g.node("ReduceMean", [den], axes=[3], keepdims=0)  # [B, F, T]
    for i, name in enumerate(out_names):
        feat = g.node("Slice", [mean, g.i64([i]), g.i64([i + 1]), g.i64([1])])
        curve = g.node("Reshape", [feat, g.i64([B, T])])
        c = clamps[i] if clamps else None
        if c is not None and (c[0] is not None or c[1] is not None):
            # both bounds always provided (optional-input gaps are avoided
            # so executors that filter empty names stay correct)
            lo = g.f32(c[0] if c[0] is not None else -3.4e38)
            hi = g.f32(c[1] if c[1] is not None else 3.4e38)
            curve = g.node("Clip", [curve, lo, hi])
        g.nodes.append(Node("Identity", [curve], [name], {},
                            name=g.fresh("out")))
        outputs.append((name, FLOAT, [B, T]))
    return outputs


def _trace_denoiser_body(
    denoise_fn,
    example_x: np.ndarray,
    example_cond: np.ndarray,
    cond_name: str,
    prefix: str,
) -> Tuple[Graph, str, str, str]:
    """Trace ``denoise_fn(x, t, cond)`` for use inside a Loop body.

    Returns (traced graph, x input name, t input name, output name). The
    cond input is named ``cond_name`` — the OUTER graph's condition value —
    so the body captures it by ONNX outer-scope reference and it does not
    appear as a loop-carried dependency.
    """
    B = example_x.shape[0]
    t_ex = np.zeros((B,), np.float32)
    x_name, t_name, v_name = f"{prefix}x_cur", f"{prefix}t_vec", f"{prefix}v_out"
    g = trace_to_graph(
        denoise_fn, (example_x, t_ex, example_cond),
        input_names=[x_name, t_name, cond_name],
        output_names=[v_name],
        graph_name=f"{prefix}denoiser",
        prefix=prefix,
    )
    return g, x_name, t_name, v_name


def build_reflow_graph(
    denoise_fn,
    shape: Tuple[int, int, int, int],  # (B, F, T, M)
    cond_shape: Tuple[int, int, int],  # (B, T, H)
    *,
    spec_min: np.ndarray,
    spec_max: np.ndarray,
    t_start_cfg: float,
    time_scale_factor: float,
    shallow: bool,
    graph_name: str = "diffusion",
    prefix: str = "diff.",
    post: str = "mel",
    clamps=None,
    out_names: Sequence[str] = ("mel",),
    cond_name: str = "condition",
    optimize: bool = True,
) -> Graph:
    """Rectified-flow sampler as ONE graph with an embedded Euler Loop.

    Inputs: ``condition`` [B,T,H], (``x_aux`` [B,T,M] normalized-domain aux
    mel, when ``shallow``), ``depth`` float scalar, ``steps`` int64 scalar.
    Output: ``mel`` [B,T,M] (denormalized).

    Math parity: ``samplers.sample_reflow`` (euler) /
    ref ``deployment/modules/rectified_flow.py:37-69``:
    t0 = max(1-depth, T_start); x = t0*x_end + (1-t0)*noise;
    dt = (1-t0)/steps; K times: x += v(x, t*scale)*dt.
    """
    B, F, T, M = shape
    g = _GB(prefix)
    k = (np.asarray(spec_max, np.float32) - np.asarray(spec_min, np.float32)) / 2.0
    b = (np.asarray(spec_max, np.float32) + np.asarray(spec_min, np.float32)) / 2.0

    inputs = [(cond_name, FLOAT, list(cond_shape))]
    if shallow:
        inputs.append(("x_aux", FLOAT, [B, T, M]))
    inputs += [("depth", FLOAT, []), ("steps", INT64, [])]

    one = g.f32(1.0)
    # t0 = max(1 - depth, T_start)  (clamped into [0, 1])
    t0 = g.node("Sub", [one, "depth"])
    t0 = g.node("Max", [t0, g.f32(float(t_start_cfg))]) if shallow else g.f32(0.0)
    t0 = g.node("Min", [t0, one])

    steps_f = g.node("Cast", [g.node("Max", ["steps", g.i64(1)])], to=FLOAT)
    dt = g.node("Div", [g.node("Sub", [one, t0]), steps_f])

    if shallow:
        # x_end: [B,T,M] normalized aux -> [B,F,T,M]
        x_end = g.node("Reshape", ["x_aux", g.i64([B, F, T, M])])
        noise = g.node("RandomNormalLike", [x_end])
        mix = g.node(
            "Add",
            [g.node("Mul", [t0, x_end]),
             g.node("Mul", [g.node("Sub", [one, t0]), noise])],
        )
        # t0 >= 1 -> x_end exactly; t0 <= 0 -> pure noise
        x0 = g.node("Where", [g.node("GreaterOrEqual", [t0, one]), x_end,
                              g.node("Where", [g.node("LessOrEqual", [t0, g.f32(0.0)]),
                                               noise, mix])])
    else:
        x0 = g.node("RandomNormal", [], shape=[B, F, T, M], dtype=FLOAT)

    # ---- Loop body: x <- x + v(x, (t0 + i*dt) * scale) * dt ----
    bp = f"{prefix}body."
    ex_x = np.zeros((B, F, T, M), np.float32)
    ex_c = np.zeros(cond_shape, np.float32)
    body_g, x_name, t_name, v_name = _trace_denoiser_body(
        denoise_fn, ex_x, ex_c, cond_name, bp)

    bb = _GB(bp + "w.")
    iter_name, cond_in = bp + "iter", bp + "cond_in"
    i_f = bb.node("Cast", [iter_name], to=FLOAT)
    t_scalar = bb.node("Add", [t0, bb.node("Mul", [i_f, dt])])
    t_tr = bb.node("Mul", [t_scalar, bb.f32(float(time_scale_factor))])
    bb.nodes.append(Node("Expand", [t_tr, bb.i64([B])], [t_name], {},
                         name=bb.fresh("Expand")))
    body_nodes = bb.nodes + body_g.nodes
    x_out, cond_out = bp + "x_next", bp + "cond_out"
    body_nodes.append(Node("Add", [x_name, bb.fresh("vdt_pre")], [x_out], {},
                           name=bp + "euler"))
    # patch: the Add's second input is v*dt — emit the Mul with that name
    vdt = body_nodes[-1].inputs[1]
    body_nodes.insert(-1, Node("Mul", [v_name, dt], [vdt], {}, name=bp + "vdt"))
    body_nodes.append(Node("Identity", [cond_in], [cond_out], {},
                           name=bp + "keep"))
    body = Graph(
        bp + "euler_body", body_nodes,
        [(iter_name, INT64, []), (cond_in, BOOL, []), (x_name, FLOAT, [B, F, T, M])],
        [(cond_out, BOOL, []), (x_out, FLOAT, [B, F, T, M])],
        bb.initializers + body_g.initializers,
    )

    cond_true = g.const(np.asarray(True))
    x_final = g.node("Loop", ["steps", cond_true, x0], body=body)

    outputs = _emit_post(g, x_final, shape, k, b, post, clamps, out_names)
    graph = Graph(graph_name, g.nodes, inputs, outputs, g.initializers)
    if optimize:
        from .graph_passes import simplify_graph

        graph = simplify_graph(graph)
    return graph


def build_ddpm_graph(
    denoise_fn,
    shape: Tuple[int, int, int, int],
    cond_shape: Tuple[int, int, int],
    *,
    spec_min: np.ndarray,
    spec_max: np.ndarray,
    alphas_cumprod: np.ndarray,
    timesteps: int,
    k_step: int,
    shallow: bool,
    graph_name: str = "diffusion",
    prefix: str = "diff.",
    post: str = "mel",
    clamps=None,
    out_names: Sequence[str] = ("mel",),
    cond_name: str = "condition",
    optimize: bool = True,
) -> Graph:
    """DDPM/DDIM sampler as ONE graph with an embedded Loop.

    Inputs: ``condition`` [B,T,H], (``x_aux`` when ``shallow``), ``depth``
    float scalar in [0,1], ``steps`` int64. Output ``mel`` [B,T,M].

    Math parity: ``samplers.sample_ddim`` / ref
    ``deployment/modules/diffusion.py:55-66,107-161``:
    depth_t = min(round(depth*timesteps), k_step); speedup = max(1,
    depth_t//steps); depth_t rounded down to a multiple of speedup; loop
    t = depth_t-speedup, ..., 0 with
    x <- sqrt(a_prev/a_t)*x + sqrt(a_prev)*(sqrt((1-a_prev)/a_prev) -
    sqrt((1-a_t)/a_t))*eps(x, t).
    """
    B, F, T, M = shape
    g = _GB(prefix)
    ac = np.asarray(alphas_cumprod, np.float32)
    k = (np.asarray(spec_max, np.float32) - np.asarray(spec_min, np.float32)) / 2.0
    b = (np.asarray(spec_max, np.float32) + np.asarray(spec_min, np.float32)) / 2.0

    inputs = [(cond_name, FLOAT, list(cond_shape))]
    if shallow:
        inputs.append(("x_aux", FLOAT, [B, T, M]))
    inputs += [("depth", FLOAT, []), ("steps", INT64, [])]

    # depth_t = min(round(depth * timesteps), k_step)
    depth_t = g.node("Cast", [g.node("Round", [g.node("Mul", ["depth", g.f32(float(timesteps))])])], to=INT64)
    depth_t = g.node("Min", [depth_t, g.i64(int(k_step))])
    # speedup = max(1, depth_t // steps); n = depth_t // speedup;
    # depth_t' = n * speedup
    speedup = g.node("Max", [g.node("Div", [depth_t, g.node("Max", ["steps", g.i64(1)])]), g.i64(1)])
    n_iters = g.node("Div", [depth_t, speedup])
    depth_t = g.node("Mul", [n_iters, speedup])

    if shallow:
        x_end = g.node("Reshape", ["x_aux", g.i64([B, F, T, M])])
        noise = g.node("RandomNormalLike", [x_end])
        # q_sample at t = depth_t - 1 (schedule gathers, clamped at 0)
        idx = g.node("Max", [g.node("Sub", [depth_t, g.i64(1)]), g.i64(0)])
        sac = g.node("Gather", [g.const(np.sqrt(ac)), idx])
        s1m = g.node("Gather", [g.const(np.sqrt(1.0 - ac).astype(np.float32)), idx])
        q = g.node("Add", [g.node("Mul", [sac, x_end]), g.node("Mul", [s1m, noise])])
        deep = g.node("GreaterOrEqual", [depth_t, g.i64(int(timesteps))])
        x0 = g.node("Where", [deep, noise,
                              g.node("Where", [g.node("Greater", [depth_t, g.i64(0)]),
                                               q, x_end])])
    else:
        x0 = g.node("RandomNormal", [], shape=[B, F, T, M], dtype=FLOAT)

    # ---- Loop body: DDIM update at t = (n-1-i)*speedup ----
    bp = f"{prefix}body."
    ex_x = np.zeros((B, F, T, M), np.float32)
    ex_c = np.zeros(cond_shape, np.float32)
    body_g, x_name, t_name, v_name = _trace_denoiser_body(
        denoise_fn, ex_x, ex_c, cond_name, bp)

    bb = _GB(bp + "w.")
    iter_name, cond_in = bp + "iter", bp + "cond_in"
    n_m1 = bb.node("Sub", [n_iters, bb.i64(1)])
    t_int = bb.node("Mul", [bb.node("Sub", [n_m1, iter_name]), speedup])
    t_prev = bb.node("Max", [bb.node("Sub", [t_int, speedup]), bb.i64(0)])
    ac_name = bb.const(ac)
    a_t = bb.node("Gather", [ac_name, t_int])
    a_prev = bb.node("Gather", [ac_name, t_prev])
    one = bb.f32(1.0)
    c_x = bb.node("Div", [bb.node("Sqrt", [a_prev]), bb.node("Sqrt", [a_t])])
    term = bb.node(
        "Sub",
        [bb.node("Sqrt", [bb.node("Div", [bb.node("Sub", [one, a_prev]), a_prev])]),
         bb.node("Sqrt", [bb.node("Div", [bb.node("Sub", [one, a_t]), a_t])])],
    )
    c_e = bb.node("Mul", [bb.node("Sqrt", [a_prev]), term])
    t_f = bb.node("Cast", [t_int], to=FLOAT)
    bb.nodes.append(Node("Expand", [t_f, bb.i64([B])], [t_name], {},
                         name=bb.fresh("Expand")))
    body_nodes = bb.nodes + body_g.nodes
    x_out, cond_out = bp + "x_next", bp + "cond_out"
    body_nodes.append(Node(
        "Add",
        [bp + "cx_x", bp + "ce_eps"], [x_out], {}, name=bp + "ddim"))
    body_nodes.insert(-1, Node("Mul", [c_x, x_name], [bp + "cx_x"], {},
                               name=bp + "cxx"))
    body_nodes.insert(-1, Node("Mul", [c_e, v_name], [bp + "ce_eps"], {},
                               name=bp + "cee"))
    body_nodes.append(Node("Identity", [cond_in], [cond_out], {},
                           name=bp + "keep"))
    body = Graph(
        bp + "ddim_body", body_nodes,
        [(iter_name, INT64, []), (cond_in, BOOL, []), (x_name, FLOAT, [B, F, T, M])],
        [(cond_out, BOOL, []), (x_out, FLOAT, [B, F, T, M])],
        bb.initializers + body_g.initializers,
    )

    cond_true = g.const(np.asarray(True))
    x_final = g.node("Loop", [n_iters, cond_true, x0], body=body)

    outputs = _emit_post(g, x_final, shape, k, b, post, clamps, out_names)
    graph = Graph(graph_name, g.nodes, inputs, outputs, g.initializers)
    if optimize:
        from .graph_passes import simplify_graph

        graph = simplify_graph(graph)
    return graph


def merge_graphs(
    first: Graph,
    second: Graph,
    io_map: Sequence[Tuple[str, str]],
    graph_name: str,
    extra_outputs: Optional[Sequence[str]] = None,
) -> Graph:
    """Compose two graphs like ``onnx.compose.merge_models``.

    Every (out_name, in_name) pair in ``io_map`` wires an output of
    ``first`` to an input of ``second`` (an Identity bridge keeps both
    names valid). Remaining inputs/outputs of both graphs stay on the
    merged boundary. The caller guarantees disjoint internal namespaces
    (both builders here prefix internal names).
    """
    mapped_in = {dst for _, dst in io_map}
    # identical names already unify (e.g. fs2's `condition` output feeding
    # the diffusion graph's `condition` input) — no bridge needed
    bridges = [Node("Identity", [src], [dst], {}, name=f"merge_{i}")
               for i, (src, dst) in enumerate(io_map) if src != dst]
    inputs = list(first.inputs) + [
        io for io in second.inputs if io[0] not in mapped_in
    ]
    keep_first_outs = [o for o in first.outputs
                       if extra_outputs and o[0] in extra_outputs]
    outputs = keep_first_outs + list(second.outputs)
    # outputs of `first` that feed io_map bridges only are internal now;
    # their Identity-to-output nodes are harmless and kept
    return Graph(
        graph_name,
        list(first.nodes) + bridges + list(second.nodes),
        inputs,
        outputs,
        list(first.initializers) + list(second.initializers),
    )
