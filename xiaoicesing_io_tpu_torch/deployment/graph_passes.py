"""Graph-level optimization passes for exported ONNX artifacts.

Copy of the JAX package's ``deployment/graph_passes.py``.  The reference
DiffSinger post-processes every exported graph: onnxsim (constant folding +
dead-value elimination, run twice, ``deployment/exporters/
acoustic_exporter.py:333-361``) and a custom pass that extracts the per-layer
conditioner 1x1-conv projections out of the denoiser so they compute ONCE
instead of once per diffusion timestep (``graph_extract_conditioner_
projections``, ``utils/onnx_helper.py:154``).

This module implements the equivalents over the port's own
``onnx_proto.Graph`` IR:

* ``hoist_loop_invariants`` — generalizes the reference's conditioner
  extraction: ANY node in a ``Loop`` body whose value cannot change across
  iterations (no data path from the iteration counter, the carried state, or
  a random op) is moved into the outer graph before the ``Loop`` node; the
  body keeps referencing it by ONNX outer-scope capture.  For our exported
  samplers this hoists exactly the per-layer conditioner projections (they
  depend only on ``condition``), so a consumer no longer recomputes them K
  times.
* ``fold_constants`` — evaluates nodes whose inputs are all constants with
  the in-repo numpy executor and replaces them with initializers (onnxsim's
  core), recursing into ``Loop``/``If``/``Scan`` bodies with outer-scope
  constants visible (onnxsim also folds inside subgraphs).
* ``eliminate_dead`` — drops nodes and initializers unreachable from the
  graph outputs, recursing into subgraph bodies
  (ref ``utils/onnx_helper.py:316`` dead-value elimination).

``simplify_graph`` chains all three and is applied by default to every
artifact ``export --format onnx`` writes.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np

from .onnx_proto import Graph, Node, Tensor

# ops whose value is not a pure function of their inputs (never hoist/fold)
NONDETERMINISTIC_OPS = {
    "RandomNormal", "RandomNormalLike", "RandomUniform", "RandomUniformLike",
    "Multinomial", "Dropout",
}
CONTROL_OPS = {"Loop", "If", "Scan"}


def _subgraph_attrs(node: Node):
    return [(k, v) for k, v in node.attrs.items() if isinstance(v, Graph)]


def _outer_refs(body: Graph) -> Set[str]:
    """Names a subgraph reads from its enclosing scope(s)."""
    defined = {t.name for t in body.initializers} | {i[0] for i in body.inputs}
    refs: Set[str] = set()
    for n in body.nodes:
        for x in n.inputs:
            if x and x not in defined:
                refs.add(x)
        for _, sub in _subgraph_attrs(n):
            refs |= {r for r in _outer_refs(sub) if r not in defined}
        defined.update(n.outputs)
    return refs


def hoist_loop_invariants(graph: Graph) -> Tuple[Graph, int]:
    """Move loop-invariant Loop-body nodes into the outer graph.

    A body node is invariant when no input (transitively) depends on the
    body's own inputs (iteration counter, loop condition, carried state) and
    it is deterministic.  Moved nodes are inserted directly before their
    ``Loop`` node; every outer value they reference is already defined there
    (the body could only have referenced it by outer-scope capture, which
    requires it to precede the Loop).  Initializers the moved nodes use are
    lifted to the outer graph; body nodes that still reference them resolve
    through outer scope (ONNX subgraph name resolution).
    """
    new_nodes: List[Node] = []
    new_inits = list(graph.initializers)
    n_hoisted = 0
    for node in graph.nodes:
        if node.op_type != "Loop":
            new_nodes.append(node)
            continue
        body = node.attrs.get("body")
        if not isinstance(body, Graph):
            new_nodes.append(node)
            continue
        varying = {i[0] for i in body.inputs}
        keep: List[Node] = []
        hoist: List[Node] = []
        for bn in body.nodes:
            if (
                bn.op_type in NONDETERMINISTIC_OPS
                or bn.op_type in CONTROL_OPS
                or any(x in varying for x in bn.inputs if x)
            ):
                keep.append(bn)
                varying.update(bn.outputs)
            else:
                hoist.append(bn)
        if not hoist:
            new_nodes.append(node)
            continue
        moved_names = set()
        for bn in hoist:
            moved_names.update(x for x in bn.inputs if x)
        moved_inits = [t for t in body.initializers if t.name in moved_names]
        moved_init_names = {t.name for t in moved_inits}
        remaining = [t for t in body.initializers
                     if t.name not in moved_init_names]
        new_inits.extend(moved_inits)
        new_nodes.extend(hoist)  # topological order preserved from the body
        node.attrs["body"] = Graph(
            body.name, keep, body.inputs, body.outputs, remaining
        )
        new_nodes.append(node)
        n_hoisted += len(hoist)
    return Graph(graph.name, new_nodes, graph.inputs, graph.outputs,
                 new_inits), n_hoisted


def fold_constants(graph: Graph, outer_const: Dict[str, np.ndarray] = None
                   ) -> Tuple[Graph, int]:
    """Replace nodes whose inputs are all constants with initializers.

    Evaluation reuses the in-repo numpy executor one node at a time; ops it
    cannot execute are simply kept.  Nodes producing graph outputs are kept
    (an output backed directly by an initializer confuses some runtimes).

    Recurses into ``Loop``/``If``/``Scan`` bodies (onnxsim folds everywhere,
    the reference's ``deployment/exporters/acoustic_exporter.py:333-361``):
    body nodes fold against the body's own initializers PLUS the enclosing
    scope's constants (``outer_const`` — ONNX outer-scope capture), with the
    subgraph's formal inputs and redefined node outputs shadowing outer
    names.  The control node itself is never folded (its body runs per
    iteration), but constant subcomputation inside the body — e.g. anything
    depending only on the carried state's SHAPE — collapses to body
    initializers."""
    from .onnx_run import run_graph

    const: Dict[str, np.ndarray] = dict(outer_const or {})
    const.update({t.name: t.array for t in graph.initializers})
    for name, *_ in graph.inputs:  # formal inputs shadow outer names
        const.pop(name, None)
    out_names = {o[0] for o in graph.outputs}
    new_nodes: List[Node] = []
    new_inits = list(graph.initializers)
    n_folded = 0
    for node in graph.nodes:
        # fold inside subgraph bodies first, against the constants visible
        # at this point of the enclosing scope
        for k, sub in _subgraph_attrs(node):
            folded_sub, n_sub = fold_constants(sub, const)
            node.attrs[k] = folded_sub
            n_folded += n_sub
        if (
            node.op_type in NONDETERMINISTIC_OPS
            or node.op_type in CONTROL_OPS
            or any(o in out_names for o in node.outputs)
            or any(x and x not in const for x in node.inputs)
        ):
            for o in node.outputs:  # redefinition shadows any outer constant
                const.pop(o, None)
            new_nodes.append(node)
            continue
        feed_names = {x for x in node.inputs if x}
        mini = Graph(
            "fold", [node], [], [(o, 1, []) for o in node.outputs],
            [Tensor(x, const[x]) for x in feed_names],
        )
        try:
            res = run_graph(mini, {})
        except Exception:  # op the executor can't fold: keep the node
            for o in node.outputs:
                const.pop(o, None)
            new_nodes.append(node)
            continue
        for o in node.outputs:
            const[o] = res[o]
            new_inits.append(Tensor(o, np.asarray(res[o])))
        n_folded += 1
    return Graph(graph.name, new_nodes, graph.inputs, graph.outputs,
                 new_inits), n_folded


def eliminate_dead(graph: Graph) -> Tuple[Graph, int]:
    """Drop nodes and initializers not reachable from the graph outputs.

    Recurses into subgraph bodies: a kept ``Loop`` keeps every outer value
    its body captures, and the body itself is DCE'd against its own outputs
    plus those captures.
    """
    removed = 0

    def dce(g: Graph, extra_live: Set[str]) -> Graph:
        nonlocal removed
        needed = {o[0] for o in g.outputs} | extra_live
        kept: List[Node] = []
        for node in reversed(g.nodes):
            if not any(o in needed for o in node.outputs):
                removed += 1
                continue
            for k, sub in _subgraph_attrs(node):
                refs = _outer_refs(sub)
                needed |= refs
                node.attrs[k] = dce(sub, refs)
            kept.append(node)
            needed.update(x for x in node.inputs if x)
        kept.reverse()
        inits = [t for t in g.initializers if t.name in needed]
        removed += len(g.initializers) - len(inits)
        return Graph(g.name, kept, g.inputs, g.outputs, inits)

    return dce(graph, set()), removed


def simplify_graph(graph: Graph, verbose: bool = False) -> Graph:
    """hoist-loop-invariants -> fold-constants -> dead-value elimination."""
    graph, n_h = hoist_loop_invariants(graph)
    graph, n_f = fold_constants(graph)
    graph, n_d = eliminate_dead(graph)
    if verbose and (n_h or n_f or n_d):
        print(f"| graph simplify [{graph.name}]: hoisted {n_h} loop-invariant "
              f"node(s), folded {n_f}, removed {n_d} dead value(s)")
    return graph
