"""Ranks of a ``gloo`` process group for the port's data-parallel tests.

Not a test module: ``tests/test_torch_dp_train.py`` imports it, and each
spawned rank imports it again (without JAX, which the ranks never need).
Every rank joins its group through ``parallel/mesh.init_distributed`` with a
``file://`` rendezvous in the test's directory (no port, so parallel test
workers cannot collide) and runs one torch thread.
"""

import multiprocessing as mp
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
DICT = ROOT / "dictionaries" / "opencpop-extension.txt"


def run_ranks(fn, world: int, tmp: Path, *args, timeout: float = 240.0) -> list:
    """``fn(rank, world, tmp, *args)`` in ``world`` spawned processes of one
    group; returns their results in rank order.  A rank's exception (its
    traceback) fails the call."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(tmp), args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    errors = [(tmp / f"error_{r}.txt").read_text() for r in range(world)
              if (tmp / f"error_{r}.txt").exists()]
    assert not errors, "\n".join(errors)
    assert not alive, f"{len(alive)} rank(s) did not finish in {timeout} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(tmp / f"result_{r}.pt", weights_only=False) for r in range(world)]


def _entry(fn, rank: int, world: int, tmp: str, args) -> None:
    import torch.distributed as dist

    from xiaoicesing_io_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    try:
        init_distributed(num_processes=world, process_id=rank, device="cpu",
                         init_method=f"file://{tmp}/rendezvous")
        out = fn(rank, world, Path(tmp), *args)
        torch.save(out, Path(tmp) / f"result_{rank}.pt")
    except BaseException:
        (Path(tmp) / f"error_{rank}.txt").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# two updates of a train step
# ---------------------------------------------------------------------------

def vocab_size() -> int:
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    return TokenTextEncoder(PhonemeDictionary.load(DICT).phoneme_list).vocab_size


def build_model(category: str, cfg, state_dict):
    """(model, core, normalizer(s)) of ``category`` holding ``state_dict``."""
    if category == "acoustic":
        from xiaoicesing_io_tpu_torch.training.acoustic import build_acoustic

        model, core, norm = build_acoustic(cfg, vocab_size())
    else:
        from xiaoicesing_io_tpu_torch.inference.variance import build_variance_cores
        from xiaoicesing_io_tpu_torch.models.toplevel import (
            VarianceModel, build_variance_normalizers,
        )

        model = VarianceModel.from_config(cfg, vocab_size())
        core, norm = build_variance_cores(cfg), build_variance_normalizers(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model, core, norm


def two_updates(category: str, cfg, state_dict, batch, draws=None, seed: int = 0,
                shard=None) -> dict:
    """Two updates of the port's train step on ``batch`` (numpy), with the
    given ``draws`` (one dict a step) or drawn from a generator seeded with
    ``seed`` (``shard``: this rank's rows of the global batch).  Returns
    each update's gradients as the clip received them (after the reduction
    over the ranks) and the parameters after both."""
    from xiaoicesing_io_tpu_torch.training import train_state as ts
    from xiaoicesing_io_tpu_torch.training.acoustic import make_acoustic_train_step
    from xiaoicesing_io_tpu_torch.training.trainer import widen_batch
    from xiaoicesing_io_tpu_torch.training.variance import make_variance_train_step

    model, core, norm = build_model(category, cfg, state_dict)
    make = make_acoustic_train_step if category == "acoustic" else make_variance_train_step
    step = make(model, core, norm, cfg)
    state = ts.TrainState(model, cfg)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    seen = []
    clip = ts.clip_by_global_norm

    def recorded(grads, max_norm):
        seen.append({n: g.detach().clone() for n, g in zip(names, grads)})
        return clip(grads, max_norm)

    ts.clip_by_global_norm = recorded
    try:
        tensors = widen_batch({k: torch.as_tensor(v) for k, v in batch.items()})
        generator = torch.Generator().manual_seed(seed)
        for i in range(2):
            kw = dict(draws[i]) if draws is not None else {}
            if shard is not None:
                kw["shard"] = shard
            updated, _ = step(state, tensors, generator, **kw)
            assert updated
    finally:
        ts.clip_by_global_norm = clip
    return {"grads": seen,
            "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


def step_rank(rank: int, world: int, tmp: Path, spec_path: str) -> dict:
    """One rank's two updates from the spec the test saved: its batch, and
    either its rows of the JAX step's draws or the shared seed."""
    spec = torch.load(spec_path, weights_only=False)
    if spec.get("per_rank_denominator"):
        from xiaoicesing_io_tpu_torch.training import variance

        variance.all_reduce_max = lambda t: t  # the rank's own ph2word maximum
    draws = spec["draws"][rank] if spec.get("draws") is not None else None
    return two_updates(spec["category"], spec["cfg"], spec["state_dict"],
                       spec["batches"][rank], draws=draws, seed=spec["seed"],
                       shard=(rank, world))


# ---------------------------------------------------------------------------
# Trainer.fit
# ---------------------------------------------------------------------------

def fit_rank(rank: int, world: int, tmp: Path, cfgs_path: str) -> dict:
    """``Trainer.fit`` of this rank's config (the list the test saved, one
    config a rank); returns its parameters, its last step, the steps it
    updated at and its validations' losses."""
    from xiaoicesing_io_tpu_torch.training.tasks import build_trainer_from_config

    cfg = torch.load(cfgs_path, weights_only=False)[rank]
    trainer = build_trainer_from_config(cfg, device="cpu")
    validations, steps = [], []
    validate, step = trainer.validate, trainer.train_step

    def recorded_validate(at, sanity=False):
        out = validate(at, sanity=sanity)
        validations.append((at, sanity, out))
        return out

    def recorded_step(state, batch, generator, **kw):
        updated, metrics = step(state, batch, generator, **kw)
        steps.append((state.step, tuple(batch["mel2ph"].shape), kw.get("shard")))
        return updated, metrics

    trainer.validate, trainer.train_step = recorded_validate, recorded_step
    trainer.fit()
    return {"params": {n: p.detach().clone() for n, p in trainer.state.model.named_parameters()},
            "step": trainer.state.step, "steps": steps, "validations": validations,
            "writer": trainer.writer is not None, "compact_feed": trainer.compact_feed}
