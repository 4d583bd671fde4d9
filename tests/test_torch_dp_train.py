"""The port's data-parallel training in ``gloo`` groups of spawned CPU
processes (``tests/torch_dp_workers.py``), against the JAX package's
sharded step and against the port's one process.

Every rank holds the same weights (``tests/test_torch_train_step.py``'s
tiny models, random weights drawn with numpy, dropout 0, f32) and its own
rows of a global batch: items collated to the shapes every rank agrees on
(``Trainer._global_shape_targets``), zero rows included.

* One acoustic update at 2 and 3 ranks and one variance update at 2 ranks
  whose ``ph2word`` maxima differ, each rank given its rows of the JAX
  step's draws: against JAX's gradient of the concatenated batch on a mesh
  of that many CPU devices (``parallel/mesh.make_train_step``), each
  gradient (averaged over the ranks, before the clip) within 2e-4 of its
  largest JAX value; the ranks' two updates against optax's two updates
  from the same (the ranks') gradients within 1e-5 (the bars of
  ``tests/test_torch_train_step.py``; from independently computed gradients
  AdamW's division by ``sqrt(v) + 1e-8`` magnifies their f32 differences
  where a gradient is near 1e-8); against
  the port's one-process step on the concatenated batch from the same draws,
  both updates' gradients and the parameters within 1e-5 of each tensor's
  scale; every result equal bit for bit across the ranks.
* The same with the ranks' own draws: the shared seeded generator draws for
  the global batch and each rank keeps its rows, so the ranks' updates
  equal one process's from that seed (1e-5 of scale).  With each rank's own
  ``ph2word`` maximum in the word-duration term (the per-rank denominator)
  the variance update misses that bar.
* ``Trainer.fit`` in 2 processes to 6 updates: parameters bit for bit equal
  across the ranks, rank 0's checkpoints at steps 3 and 6, validation at the
  same steps with the same losses; one rank over its ``max_host_rss_mb``
  stops both ranks at the same step, rank 0's checkpoint at that step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_workers as W
from test_torch_parallel import _write_set
from test_torch_train_step import (  # noqa: F401 (_one_torch_thread: autouse)
    GRAD_TOL, PARAM_TOL, _acoustic_cfgs, _acoustic_draws, _acoustic_items, _carry,
    _one_torch_thread, _pair, _variance_cfgs, _variance_draws, _variance_items,
)

ONE_PROCESS_TOL = 1e-5   # of each tensor's largest value: f32 summation order only
ROWS = 4                 # a rank's rows: its items and zero rows


def _rank_batches(category, pcfg, tmp_path, ranks_items):
    """Each rank's batch of its items, collated to the targets of the
    global batch, and their concatenation in rank order."""
    from types import SimpleNamespace

    from xiaoicesing_io_tpu_torch.data.dataset import AcousticDataset, VarianceDataset
    from xiaoicesing_io_tpu_torch.training.trainer import Trainer

    items = [it for r in ranks_items for it in r]
    _write_set(tmp_path / "set", items)
    ds = (AcousticDataset if category == "acoustic" else VarianceDataset)(
        tmp_path / "set", "train", pcfg)
    cuts = np.cumsum([0] + [len(r) for r in ranks_items])
    indices = [list(range(a, b)) for a, b in zip(cuts, cuts[1:])]
    sampler = SimpleNamespace(batches_at_step=lambda step: indices)
    ns = SimpleNamespace(cfg=dict(pcfg, max_batch_size=ROWS), train_dataset=ds,
                         collate=ds.collate, world=len(indices))
    targets = Trainer._global_shape_targets(ns, sampler, 0)
    batches = [Trainer._collate_train(ns, idx, targets) for idx in indices]
    assert all(b["mel2ph"].shape == batches[0]["mel2ph"].shape for b in batches)
    assert batches[0]["mel2ph"].shape[0] == ROWS
    return batches, {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


def _setup(category, world, tmp_path):
    """The JAX and port models with one set of weights, the ranks' batches
    (variance: rank 0's items have fewer words than rank 1's)."""
    if category == "acoustic":
        jcfg, pcfg = _acoustic_cfgs("lynx_reflow_shallow")
        items = [_acoustic_items(2, seed=10 + r) for r in range(world)]
    else:
        jcfg, pcfg = _variance_cfgs("reflow")
        pool = _variance_items(12, seed=7)
        pool.sort(key=lambda it: int(it["ph2word"].max()))
        items = [pool[:2], pool[-2:]]
        assert max(int(it["ph2word"].max()) for it in items[0]) < \
            max(int(it["ph2word"].max()) for it in items[1])
    jm, jcore, jnorm, params, pm, _, _ = _pair(category, jcfg, pcfg)
    batches, whole = _rank_batches(category, pcfg, tmp_path, items)
    return jcfg, pcfg, (jm, jcore, jnorm, params), pm.state_dict(), batches, whole


def _jax_draws(category, jax_side, pcfg, whole, key):
    """The draws of JAX's step from ``key`` for the global batch."""
    jm, jcore = jax_side[:2]
    b, t = whole["mel2ph"].shape
    if category == "acoustic":
        return _acoustic_draws(jcore, key, b, t, pcfg["audio_num_mel_bins"])
    return _variance_draws(jm, jcore, pcfg, key, b, t)


def _jax_grads(category, jcfg, jax_side, whole, world, key):
    """JAX's gradient of the global batch's loss from ``key``, on a mesh of
    ``world`` devices."""
    from xiaoicesing_io_tpu.parallel.mesh import make_mesh, make_train_step

    jm, jcore, jnorm, params = jax_side
    if category == "acoustic":
        from xiaoicesing_io_tpu.training.acoustic import acoustic_losses as jlosses
    else:
        from xiaoicesing_io_tpu.training.variance import variance_losses as jlosses
    mesh = make_mesh(jax.devices()[:world])
    batch = {k: jnp.asarray(v) for k, v in whole.items()}

    def grads(p, b, key):
        def loss(q):
            return sum(jlosses(jm, jcore, jnorm, jcfg, {"params": q}, b, key,
                               deterministic=True).values())
        return jax.grad(loss)(p), {}

    g, _ = make_train_step(grads, mesh, donate=False)(params, batch, key)
    return g


def _optax_updates(category, jcfg, params, sd, grads):
    """optax's parameters after one update from each of ``grads`` (the
    port's gradients by name, carried into JAX's tree by the JAX package's
    converter, which is linear)."""
    from xiaoicesing_io_tpu.training.train_state import TrainState as JState, build_optimizer
    from xiaoicesing_io_tpu.utils.torch_ckpt import convert_acoustic, convert_variance

    convert = convert_acoustic if category == "acoustic" else convert_variance
    state = JState.create(params, build_optimizer(jcfg))
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    for g in grads:
        tree = convert({k: g.get(k, torch.zeros_like(v)) for k, v in sd.items()}, jcfg)
        state = apply(state, jax.tree_util.tree_map(jnp.asarray, tree["params"]))
    return state.params


def _rows(draws, rank):
    """A rank's rows of one update's draws."""
    sl = slice(rank * ROWS, (rank + 1) * ROWS)
    return {k: ({n: m[sl] for n, m in v.items()} if isinstance(v, dict) else v[sl])
            for k, v in draws.items()}


def _worst(got, ref):
    """The largest error of a tensor over its reference's largest value."""
    return max(float((got[k] - ref[k]).abs().max()) / max(float(ref[k].abs().max()), 1e-30)
               for k in ref)


def _same_on_every_rank(results):
    for r in results[1:]:
        for mine, first in zip(r["grads"] + [r["params"]],
                               results[0]["grads"] + [results[0]["params"]]):
            for k, v in first.items():
                assert torch.equal(mine[k], v), k


def _run(tmp_path, spec, world):
    tmp_path.mkdir(parents=True, exist_ok=True)
    torch.save(spec, tmp_path / "spec.pt")
    return W.run_ranks(W.step_rank, world, tmp_path / "ranks", str(tmp_path / "spec.pt"))


@pytest.mark.parametrize("category,world", [("acoustic", 2), ("acoustic", 3), ("variance", 2)])
def test_dp_update_matches_jax_and_one_process(category, world, tmp_path):
    jcfg, pcfg, jax_side, sd, batches, whole = _setup(category, world, tmp_path)
    keys = [jax.random.PRNGKey(3), jax.random.PRNGKey(4)]
    jgrads = _carry(category, _jax_grads(category, jcfg, jax_side, whole, world, keys[0]), pcfg)
    draws = [_jax_draws(category, jax_side, pcfg, whole, k) for k in keys]
    spec = dict(category=category, cfg=pcfg, state_dict=sd, batches=batches, seed=0,
                draws=[[_rows(d, r) for d in draws] for r in range(world)])
    results = _run(tmp_path, spec, world)
    _same_on_every_rank(results)
    got = results[0]
    assert set(got["grads"][0]) == set(jgrads)
    for k, ref in jgrads.items():
        scale = float(ref.abs().max())
        err = float((got["grads"][0][k] - ref).abs().max())
        assert err <= GRAD_TOL * max(scale, 1e-8), (k, err, scale)
    optax = _carry(category, _optax_updates(category, jcfg, jax_side[3], sd, got["grads"]),
                   pcfg)
    for k, ref in optax.items():
        assert float((got["params"][k] - ref).abs().max()) <= PARAM_TOL, k
    one = W.two_updates(category, pcfg, sd, whole, draws=draws)
    for g, ref in zip(got["grads"], one["grads"]):
        assert _worst(g, ref) <= ONE_PROCESS_TOL
    assert _worst(got["params"], one["params"]) <= ONE_PROCESS_TOL
    assert any(not torch.equal(got["params"][k], v) for k, v in sd.items() if k in got["params"])


@pytest.mark.parametrize("category", ["acoustic", "variance"])
def test_dp_update_own_draws_matches_one_process(category, tmp_path):
    """The ranks draw for the global batch from the shared seed and keep
    their rows; the variance update with the per-rank word denominator
    misses the bar."""
    _, pcfg, _, sd, batches, whole = _setup(category, 2, tmp_path)
    spec = dict(category=category, cfg=pcfg, state_dict=sd, batches=batches, seed=9,
                draws=None)
    results = _run(tmp_path / "global", spec, 2)
    _same_on_every_rank(results)
    one = W.two_updates(category, pcfg, sd, whole, seed=9)
    for g, ref in zip(results[0]["grads"], one["grads"]):
        assert _worst(g, ref) <= ONE_PROCESS_TOL
    assert _worst(results[0]["params"], one["params"]) <= ONE_PROCESS_TOL
    if category == "variance":
        per_rank = _run(tmp_path / "per_rank", dict(spec, per_rank_denominator=True), 2)
        worst = _worst(per_rank[0]["grads"][0], one["grads"][0])
        assert worst > 100 * ONE_PROCESS_TOL, worst


def _fit_cfgs(tmp_path, world, per_rank=None):
    from xiaoicesing_io_tpu_torch.config import Config, acoustic_defaults

    items = _acoustic_items(12, seed=5)
    _write_set(tmp_path / "binary", items)
    _write_set(tmp_path / "binary", _acoustic_items(2, seed=6), prefix="valid")
    cfg = acoustic_defaults()
    cfg.update(binary_data_dir=str(tmp_path / "binary"), dictionary=str(W.DICT),
               work_dir=str(tmp_path / "work"), hidden_size=32, enc_layers=1, num_heads=2,
               dropout=0.0, precision="fp32", max_updates=6, log_interval=2,
               val_check_interval=3, max_batch_frames=120, max_batch_size=4,
               sampling_steps=2, num_valid_plots=1, vocoder_ckpt=None,
               backbone_args=Config(num_channels=32, num_layers=2, kernel_size=31,
                                    strong_cond=True))
    cfg["shallow_diffusion_args"]["aux_decoder_args"].update(num_channels=32, num_layers=1)
    cfgs = []
    for r in range(world):
        c = Config(cfg)
        c.update((per_rank or {}).get(r, {}))
        cfgs.append(c)
    torch.save(cfgs, tmp_path / "cfgs.pt")
    return cfgs


def _ckpt_steps(work):
    from xiaoicesing_io_tpu_torch.training.checkpoint import checkpoint_step, list_checkpoints

    return [checkpoint_step(p) for p in list_checkpoints(work)]


def test_two_process_fit(tmp_path):
    cfgs = _fit_cfgs(tmp_path, 2)
    results = W.run_ranks(W.fit_rank, 2, tmp_path / "ranks", str(tmp_path / "cfgs.pt"))
    for r, res in enumerate(results):
        assert res["step"] == 6 and [s for s, _, _ in res["steps"]] == list(range(1, 7))
        assert all(shard == (r, 2) for _, _, shard in res["steps"])
        assert res["writer"] is False or r == 0
        assert res["compact_feed"] is False
    # each step's batch has one shape on both ranks
    assert [s[1] for s in results[0]["steps"]] == [s[1] for s in results[1]["steps"]]
    for k, v in results[0]["params"].items():
        assert torch.equal(results[1]["params"][k], v), k
    assert [(a, s) for a, s, _ in results[0]["validations"]] == [(0, True), (3, False),
                                                                 (6, False)]
    assert results[0]["validations"] == results[1]["validations"]
    assert _ckpt_steps(cfgs[0]["work_dir"]) == [3, 6]
    ckpt = torch.load(sorted((tmp_path / "work").glob("*_6.ckpt"))[0], weights_only=False)
    for k, v in results[0]["params"].items():
        assert torch.equal(ckpt["state_dict"][f"model.{k}"], v), k


def test_rss_over_on_one_rank_stops_both(tmp_path):
    cfgs = _fit_cfgs(tmp_path, 2, {0: {"max_host_rss_mb": 0}, 1: {"max_host_rss_mb": 1}})
    for c in cfgs:
        c.update(log_interval=1, val_check_interval=100, num_sanity_val_steps=0)
    torch.save(cfgs, tmp_path / "cfgs.pt")
    results = W.run_ranks(W.fit_rank, 2, tmp_path / "ranks", str(tmp_path / "cfgs.pt"))
    assert [res["step"] for res in results] == [2, 2]
    assert all(res["validations"] == [] for res in results)
    assert _ckpt_steps(cfgs[0]["work_dir"]) == [2]
    for k, v in results[0]["params"].items():
        assert torch.equal(results[1]["params"][k], v), k
