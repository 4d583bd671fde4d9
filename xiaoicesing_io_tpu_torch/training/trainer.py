"""The trainer (counterpart of the JAX package's
``training/trainer.py:Trainer``), on one card or on one card a process of a
``torch.distributed`` group (``parallel/mesh.py``).

* ``fit``: resume from the latest checkpoint with its epoch, a sanity
  validation, per-epoch frame-budget batches (:mod:`..data.sampler`),
  ``max_updates`` updates, a log line every ``log_interval`` (losses, lr,
  it/s, audio-s/s over real frames), validation and a checkpoint every
  ``val_check_interval``.
* Train batches have a row count fixed by their padded length
  (:func:`fixed_batch_rows`); the added rows are all zero and enter the
  losses' plain means, as in the JAX package.
* ``compact_feed`` (default on): a batch crosses to the card as f16 / i16
  where its values fit (:func:`narrow_batch`, on the host) and is widened
  there (:func:`widen_batch`), so the model trains on f16-rounded inputs,
  exactly like the JAX trainer.
* Batches are collated, narrowed and copied on a small thread pool ahead
  of the step; a collate error propagates.
* Per-epoch batches from :class:`~..data.sampler.BatchSampler`, the JAX
  sampler, at this process's rank.
* SIGTERM / SIGINT: checkpoint at the next update, then return.
* ``profile_trace_steps``: a ``torch.profiler`` trace of the first N
  updates into ``<work_dir>/trace``.
* ``max_host_rss_mb`` and ``stall_restart_minutes``: checkpoint (the RSS
  watchdog) and re-exec the process through this package's CLI.

With W > 1 ranks (the JAX trainer's multi-process parts, each at its
counterpart):

* each rank trains on its sampler batch, padded to the shapes that every
  rank computes alike from ``batches_at_step`` (:meth:`Trainer.
  _global_shape_targets`), with the same row count; the global batch is one
  sampler batch a card, the ranks' batches concatenated in rank order;
* the draws (``t``, noise, retake masks) are the global batch's, from one
  generator seeded alike on every rank, each rank keeping its rows
  (``shard=(rank, W)`` of the train step); dropout is seeded from ``(seed,
  rank)``; the gradients are averaged over the ranks before the clip
  (``TrainState.apply_gradients``), so a W-rank update equals one process's
  update on the concatenated batch;
* after a restore every rank takes rank 0's parameters and AdamW state;
* ``compact_feed`` is off: its f16 narrowing plan depends on values, so
  ranks could narrow a field differently;
* the losses are logged by rank 0 as means over the ranks, reduced at log
  steps only; the RSS and signal stop flags are combined at log steps, so
  every rank stops at the same step;
* validation runs the whole valid set on every rank, with no collective;
  its extras, the stall watchdog and the re-exec run only in a process of
  its own (a rank cannot restart alone: it checkpoints and returns, for the
  launcher to start every rank again);
* rank 0 writes the checkpoints, the logs and the profiler trace, and the
  ranks meet at a barrier after each save.
"""

from __future__ import annotations

import math
import os
import signal
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.sampler import BatchSampler
from ..parallel.mesh import all_reduce_mean_, any_flag, barrier, broadcast_, rank, world_size
from ..utils import seed_for
from .checkpoint import CheckpointManager
from .train_state import TrainState

_DEFAULT_WRITER = object()


def _host_rss_mb() -> int:
    """This process's resident set size in MB (0 where unknown)."""
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmRSS"):
                    return int(ln.split()[1]) // 1024
    except OSError:
        pass
    return 0


def _host_mem_total_mb() -> int:
    try:
        with open("/proc/meminfo") as f:
            for ln in f:
                if ln.startswith("MemTotal"):
                    return int(ln.split()[1]) // 1024
    except OSError:
        pass
    return 0


def narrow_batch(batch: Dict[str, np.ndarray], plan: Dict[str, np.dtype]) -> Dict[str, np.ndarray]:
    """f32 -> f16 and i32 / i64 -> i16 where the values fit.  The choice is
    pinned per field in ``plan`` at first sight and only ever widened back
    (a later batch that does not fit)."""
    out = {}
    for k, v in batch.items():
        tgt = plan.get(k)
        if tgt is None:
            if v.dtype == np.float32:
                tgt = np.float16 if (not v.size or float(np.abs(v).max()) < 60000.0) \
                    else np.float32
            elif v.dtype in (np.int32, np.int64) and v.size and \
                    int(v.max()) < 32000 and int(v.min()) > -32000:
                tgt = np.int16
            else:
                tgt = v.dtype
            plan[k] = tgt
        elif tgt == np.float16 and v.size and float(np.abs(v).max()) >= 60000.0:
            tgt = plan[k] = np.float32
        elif tgt == np.int16 and v.size and not (int(v.max()) < 32000 and int(v.min()) > -32000):
            tgt = plan[k] = v.dtype
        out[k] = v.astype(tgt) if v.dtype != tgt else v
    return out


def widen_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The card's side of :func:`narrow_batch`: f16 -> f32, and every
    integer field to int64 (the models' index type)."""
    wide = {torch.float16: torch.float32, torch.int16: torch.int64, torch.int32: torch.int64}
    return {k: v.to(wide[v.dtype]) if v.dtype in wide else v for k, v in batch.items()}


def fixed_batch_rows(n_items: int, t_pad: int, max_batch_frames: int, max_batch_size: int,
                     n_local: int = 1) -> int:
    """Rows of a train batch of padded length ``t_pad``: ``max_batch_frames
    // t_pad``, capped by ``max_batch_size`` rounded down to the quantum
    ``lcm(8, n_local)``, never below ``n_items``, rounded up to the
    quantum (only ``n_local`` where the cap is below one quantum)."""
    mult = math.lcm(8, n_local)
    if max_batch_size < mult:
        mult = n_local
    rows = max(n_items, max_batch_frames // max(t_pad, 1))
    rows = min(rows, max(max_batch_size // mult * mult, mult))
    rows = max(rows, n_items)
    return -(-rows // mult) * mult


def _stall_guard_loop(trainer, stall_min: float, poll_s: float = 15.0) -> None:
    """The stall watchdog's thread: re-exec when no step has completed for
    ``stall_min`` minutes."""
    while True:
        time.sleep(poll_s)
        stale = time.time() - trainer._heartbeat
        if stale > stall_min * 60:
            print(f"| stall watchdog: no step completed for {stale / 60:.1f} min "
                  f"(> {stall_min:g}) - re-exec and resume from the last checkpoint", flush=True)
            trainer._exec_restart(-1, save=False)


def default_writer(work_dir: Path):
    """A ``tensorboardX.SummaryWriter`` under ``<work_dir>/lightning_logs/
    lastest``, or None (with a line saying so) where tensorboardX is absent."""
    import importlib.util

    if importlib.util.find_spec("tensorboardX") is None:
        print("| tensorboardX is not installed: no TensorBoard logs, figures or audio")
        return None
    from tensorboardX import SummaryWriter

    log_dir = work_dir / "lightning_logs" / "lastest"
    log_dir.mkdir(parents=True, exist_ok=True)
    return SummaryWriter(str(log_dir))


class Trainer:
    def __init__(self, cfg, state: TrainState, train_step: Callable, val_losses_fn: Callable,
                 train_dataset, valid_dataset, category: str,
                 on_validation_extras: Optional[Callable] = None, writer=_DEFAULT_WRITER):
        """``train_step(state, batch, generator) -> (updated, metrics)`` and
        ``val_losses_fn(batch, generator) -> {name: loss}`` take batches of
        tensors on the state's device; ``on_validation_extras(trainer,
        step)`` runs after each validation but the sanity one."""
        self.cfg = cfg
        self.state = state
        self.device = state.device
        self.category = category
        self.train_dataset = train_dataset
        self.valid_dataset = valid_dataset
        self.collate = train_dataset.collate
        self.on_validation_extras = on_validation_extras
        self.train_step = train_step
        self.val_losses_fn = val_losses_fn
        self.world = world_size()
        self.rank = rank()
        self.compact_feed = bool(cfg.get("compact_feed", True)) and self.world == 1
        self._narrow_plan: Dict[str, np.dtype] = {}
        self._feed_stats = {"collate_s": 0.0, "dispatch_s": 0.0, "starve_s": 0.0}
        work_dir = Path(cfg["work_dir"])
        self.ckpt = CheckpointManager(
            work_dir, category=category, num_ckpt_keep=cfg.get("num_ckpt_keep", 5),
            permanent_ckpt_start=cfg.get("permanent_ckpt_start", 0),
            permanent_ckpt_interval=cfg.get("permanent_ckpt_interval", -1))
        if self.rank != 0:
            writer = None
        self.writer = default_writer(work_dir) if writer is _DEFAULT_WRITER else writer
        self.accum = state.accum
        self.max_updates = cfg.get("max_updates", 160000)
        self.log_interval = cfg.get("log_interval", 100)
        self.val_check_interval = cfg.get("val_check_interval", 2000)
        self._heartbeat = time.time()
        # one mark a completed update (a CUDA event on the card), for update times
        self.update_marks: list = []
        # the last validation extras' metrics (the variance task's accuracies)
        self.last_metrics: Dict[str, float] = {}

    # -- batches ---------------------------------------------------------------

    def _global_shape_targets(self, sampler: BatchSampler, step_idx: int):
        """The shapes of train step ``step_idx`` that every rank pads to:
        the most items, frames, tokens and notes over every rank's batch of
        that step, from the sampler and the set's ``.meta`` lengths, with no
        communication.  None at one rank."""
        if self.world == 1:
            return None
        ds = self.train_dataset
        all_b = sampler.batches_at_step(step_idx)
        items = [i for b in all_b for i in b]
        targets = {"items": max((len(b) for b in all_b), default=0),
                   "frames": max((ds.num_frames(i) for i in items), default=0)}
        meta = getattr(ds, "metadata", {})
        if "tokens" in meta:
            targets["tokens"] = max(ds.attr_len("tokens", i) for i in items)
        if "note_midi" in meta:
            targets["notes"] = max(ds.attr_len("note_midi", i) for i in items)
        return targets

    def _collate_train(self, indices, shape_targets=None):
        """A train batch whose row count is a function of its padded length
        (:func:`fixed_batch_rows`), padded to ``shape_targets`` where given
        (more than one rank); ``fixed_shape_batches: false`` collates the
        sampler's items alone at one rank."""
        if not self.cfg.get("fixed_shape_batches", True) and shape_targets is None:
            return self.collate(indices)
        from ..data.dataset import FRAME_BUCKET, _round_up

        ds = self.train_dataset
        frames = max(ds.num_frames(i) for i in indices)
        n_items = len(indices)
        extra = {}
        if shape_targets is not None:
            frames = max(frames, shape_targets["frames"])
            n_items = max(n_items, shape_targets["items"])
            if "tokens" in shape_targets:
                extra["pad_tokens_to"] = shape_targets["tokens"]
            if "notes" in shape_targets:
                extra["pad_notes_to"] = shape_targets["notes"]
            extra["pad_frames_to"] = frames
        t_pad = _round_up(int(frames), FRAME_BUCKET)
        rows = fixed_batch_rows(n_items, t_pad, int(self.cfg.get("max_batch_frames", 50000)),
                                int(self.cfg.get("max_batch_size", 64)))
        return self.collate(indices, pad_batch_to=rows, **extra)

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        on_card = self.device.type == "cuda"
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.pin_memory() if on_card else t).to(self.device, non_blocking=on_card)
        return out

    def _prefetch(self, sampler, depth: Optional[int] = None):
        """Yield ``(batch on the device, real frames)`` for the sampler's
        batches, in order, collated, narrowed and copied on
        ``dataloader_num_threads`` threads up to ``dataloader_prefetch_factor``
        batches ahead."""
        if depth is None:
            depth = max(1, int(self.cfg.get("dataloader_prefetch_factor", 2)))
        workers = max(1, int(self.cfg.get("dataloader_num_threads", 2)))
        stats = self._feed_stats

        def produce(indices, shape_targets):
            t0 = time.perf_counter()
            batch = self._collate_train(indices, shape_targets)
            real_frames = int((batch["mel2ph"] > 0).sum()) if "mel2ph" in batch else 0
            t1 = time.perf_counter()
            if self.compact_feed:
                batch = narrow_batch(batch, self._narrow_plan)
            dev = self._to_device(batch)
            stats["collate_s"] += t1 - t0
            stats["dispatch_s"] += time.perf_counter() - t1
            return dev, real_frames

        def take(future):
            t0 = time.perf_counter()
            item = future.result()
            stats["starve_s"] += time.perf_counter() - t0
            return item

        window = max(depth, workers)
        ex = ThreadPoolExecutor(max_workers=workers)
        pending: deque = deque()
        try:
            for step_idx, indices in enumerate(sampler):
                pending.append(ex.submit(produce, indices,
                                         self._global_shape_targets(sampler, step_idx)))
                if len(pending) >= window:
                    yield take(pending.popleft())
            while pending:
                yield take(pending.popleft())
        finally:
            for f in pending:
                f.cancel()
            ex.shutdown(wait=False)

    def _make_sampler(self, epoch: int) -> BatchSampler:
        s = BatchSampler(
            self.train_dataset, max_batch_frames=self.cfg.get("max_batch_frames", 50000),
            max_batch_size=self.cfg.get("max_batch_size", 64),
            num_replicas=self.world, rank=self.rank,
            required_batch_count_multiple=self.cfg.get("accumulate_grad_batches", 1),
            frame_count_grid=self.cfg.get("sampler_frame_count_grid", 6),
            shuffle_sample=True, sort_by_similar_size=self.cfg.get("sort_by_len", True),
            seed=self.cfg.get("seed", 0))
        s.set_epoch(epoch)
        return s

    def _mark_update(self) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.update_marks.append(ev)
        else:
            self.update_marks.append(time.perf_counter())

    def update_ms(self) -> list:
        """Milliseconds between consecutive completed updates of this
        process (the card's own timeline on CUDA)."""
        m = self.update_marks
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]

    # -- loops -----------------------------------------------------------------

    def _say(self, msg: str) -> None:
        """Print on rank 0 only."""
        if self.rank == 0:
            print(msg)

    def _save(self, step: int, epoch: int) -> None:
        """Rank 0 writes the checkpoint; every rank waits for it."""
        if self.rank == 0:
            self.ckpt.save(self.state, step, epoch=epoch)
        barrier()

    def _restore(self):
        """The latest checkpoint's ``(step, epoch)``; with more than one
        rank, rank 0's state, step and epoch on every rank."""
        meta = self.ckpt.restore_latest(self.state)
        step, epoch = meta["step"], meta["epoch"]
        if self.world > 1:
            self.state.broadcast_from(0)
            counts = torch.tensor([step, epoch], dtype=torch.int64, device=self.device)
            broadcast_([counts], 0)
            step, epoch = (int(v) for v in counts.tolist())
            self.state.step, self.state.micro = step, step * self.state.accum
            # dropout: each rank its own stream; the draws' generator is shared
            torch.manual_seed(seed_for(int(self.cfg.get("seed", 0)), self.rank, self.device.type))
        return step, epoch

    def fit(self) -> None:
        step, epoch = self._restore()
        if step > 0:
            self._say(f"| resumed from step {step} (epoch {epoch})")
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(self.cfg.get("seed", 0)))
        shard = {"shard": (self.rank, self.world)} if self.world > 1 else {}
        stop_requested = {"flag": False}

        def request_stop(signum, frame):
            if stop_requested["flag"]:  # a second signal: let it kill us
                raise KeyboardInterrupt
            print(f"| received signal {signum}: checkpointing at the next update, then exiting")
            stop_requested["flag"] = True

        prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, request_stop)
            except ValueError:  # not the main thread
                pass
        if step == 0 and self.cfg.get("num_sanity_val_steps", 1) > 0:
            self._say("| running sanity validation")
            self.validate(0, sanity=True)
        t_log = time.time()
        frames_since_log = 0
        last_validated = -1
        rss_limit = self.cfg.get("max_host_rss_mb", None)
        if rss_limit is None:
            rss_limit = int(_host_mem_total_mb() * 0.7)
        rss_limit = int(rss_limit or 0)
        stall_min = float(self.cfg.get("stall_restart_minutes", 0) or 0)
        self._heartbeat = time.time()
        if stall_min > 0 and self.world == 1:
            threading.Thread(target=_stall_guard_loop, args=(self, stall_min), daemon=True,
                             name="stall-watchdog").start()
        updates_this_process = 0
        restart_requested = False
        trace_steps = int(self.cfg.get("profile_trace_steps", 0) or 0)
        prof = None
        if trace_steps > 0 and self.rank == 0:
            prof = self._start_trace(trace_steps)
        trace_stop_at = step + trace_steps if prof is not None else -1
        while step < self.max_updates:
            for batch, real_frames in self._prefetch(self._make_sampler(epoch)):
                if step >= self.max_updates:
                    break
                frames_since_log += real_frames
                batch = widen_batch(batch)
                updated, metrics = self.train_step(self.state, batch, generator, **shard)
                self._heartbeat = time.time()
                if not updated:
                    continue  # mid-accumulation
                step = self.state.step
                self._mark_update()
                if step == trace_stop_at:
                    self._stop_trace(prof)
                    prof, trace_stop_at = None, -1
                log_step = step % self.log_interval == 0
                if log_step:
                    self._log(step, metrics, time.time() - t_log, frames_since_log)
                    t_log, frames_since_log = time.time(), 0
                updates_this_process += 1
                if step % self.val_check_interval == 0:
                    self.validate(step)
                    last_validated = step
                    self._save(step, epoch)
                # the stop decisions: with more than one rank, combined at log
                # steps, so that every rank breaks at the same step
                rss_over = (rss_limit and step < self.max_updates and log_step
                            and updates_this_process >= 2 * self.log_interval
                            and _host_rss_mb() > rss_limit)
                stop = stop_requested["flag"]
                if self.world > 1:
                    if not log_step:
                        continue
                    rss_over, stop = any_flag([rss_over, stop], self.device)
                    stop_requested["flag"] = stop
                if rss_over:
                    print(f"| host RSS {_host_rss_mb()} MB (limit {rss_limit} MB"
                          f"{', over on a rank' if self.world > 1 else ''}): "
                          "checkpointing and restarting")
                    restart_requested = True
                    break
                if stop:
                    break
            if stop_requested["flag"] or restart_requested:
                break
            epoch += 1
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        if prof is not None:  # ended inside the capture window
            self._stop_trace(prof)
        if stop_requested["flag"] or restart_requested:
            if last_validated != step:
                self._save(step, epoch)
            if restart_requested and self.world == 1:
                self._exec_restart(step)
            self._say(f"| training {'stopped for a restart' if restart_requested else 'preempted'}"
                      f" at step {step} (checkpoint saved)")
            return
        if last_validated != step:
            self.validate(step)
            self._save(step, epoch)
        self._say(f"| training finished at step {step}")

    def _log(self, step: int, metrics: Dict[str, torch.Tensor], dt: float,
             frames: int) -> None:
        """The log line and scalars of update ``step``; with more than one
        rank (every rank calls it), the losses' means over the ranks and
        the frames of all of them, printed by rank 0."""
        if self.world > 1:
            names = list(metrics)
            values = torch.stack([metrics[k].detach().double() for k in names]
                                 + [torch.tensor(float(frames), dtype=torch.float64,
                                                 device=self.device)])
            all_reduce_mean_([values])
            metrics = dict(zip(names, values[:-1]))
            frames = float(values[-1]) * self.world
        metrics = {k: float(v) for k, v in metrics.items()}
        lr = float(self.state.schedule(step))
        sps = self.log_interval * self.accum / max(dt, 1e-9)
        audio_sps = (frames * self.cfg.get("hop_size", 512)
                     / self.cfg.get("audio_sample_rate", 44100) / max(dt, 1e-9))
        fs = self._feed_stats
        n_it = self.log_interval * self.accum
        feed = (f" | feed: collate {fs['collate_s'] / n_it * 1e3:.1f}"
                f" xfer {fs['dispatch_s'] / n_it * 1e3:.1f}"
                f" starve {fs['starve_s'] / n_it * 1e3:.1f} ms/it")
        for k in fs:
            fs[k] = 0.0
        if self.rank != 0:
            return
        print(f"| step {step} | " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
              + f" | lr={lr:.2e} | {sps:.2f} it/s | {audio_sps:.1f} audio-s/s" + feed)
        if self.writer:
            for k, v in metrics.items():
                self.writer.add_scalar(f"training/{k}", v, step)
            self.writer.add_scalar("training/lr", lr, step)
            self.writer.add_scalar("training/audio_s_per_s", audio_sps, step)

    def _start_trace(self, steps: int):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        print(f"| capturing profiler trace for {steps} steps -> "
              f"{Path(self.cfg['work_dir']) / 'trace'}")
        return prof

    def _stop_trace(self, prof) -> None:
        prof.stop()
        trace_dir = Path(self.cfg["work_dir"]) / "trace"
        trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_dir / "trace.json"))
        print("| profiler trace capture complete")

    def _exec_restart(self, step: int, save: bool = True) -> None:
        """Replace this process with a fresh ``python -m
        xiaoicesing_io_tpu_torch.cli`` of the same arguments, which resumes
        from the last checkpoint.  ``save=False`` (the stall watchdog) skips
        the flush.  A no-op with more than one rank: a rank cannot restart
        alone."""
        if self.world > 1:
            return
        if save and self.writer:
            self.writer.flush()
        pkg_root = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        argv = [sys.executable, "-m", "xiaoicesing_io_tpu_torch.cli"] + sys.argv[1:]
        print(f"| re-exec at step {step}: {' '.join(argv)}", flush=True)
        os.execve(sys.executable, argv, env)

    @torch.no_grad()
    def validate(self, step: int, sanity: bool = False) -> Dict[str, float]:
        """Losses over the valid set in batches of ``max_val_batch_size``
        (and ``max_val_batch_frames``), averaged weighted by batch size;
        then the extras (not at the sanity validation).  Every rank runs the
        whole set alike, with no collective; the extras run only at one
        rank."""
        from .variance import batch_tensors

        val_sampler = BatchSampler(
            self.valid_dataset, max_batch_frames=self.cfg.get("max_val_batch_frames", 60000),
            max_batch_size=self.cfg.get("max_val_batch_size", 1), shuffle_sample=False,
            sort_by_similar_size=False, disallow_empty_batch=False, pad_batch_assignment=False)
        val_sampler.set_epoch(0)
        batches = list(val_sampler)
        if sanity:
            batches = batches[: max(1, self.cfg.get("num_sanity_val_steps", 1))]
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(self.cfg.get("seed", 0)))
        model = self.state.model
        was_training = model.training
        model.eval()
        totals: Dict[str, float] = {}
        weights = 0
        try:
            for indices in batches:
                batch = batch_tensors(self.valid_dataset.collate(indices), self.device)
                out = self.val_losses_fn(batch, generator)
                self._heartbeat = time.time()
                for k, v in out.items():
                    totals[k] = totals.get(k, 0.0) + float(v) * len(indices)
                weights += len(indices)
            losses = {k: v / max(weights, 1e-9) for k, v in totals.items()}
            total = sum(losses.values())
            self._say(f"| validation @ step {step}: total={total:.4f} "
                      + " ".join(f"{k}={v:.4f}" for k, v in losses.items()))
            if self.writer:
                self.writer.add_scalar("validation/total_loss", total, step)
                for k, v in losses.items():
                    self.writer.add_scalar(f"validation/{k}", v, step)
            if self.on_validation_extras is not None and not sanity and self.world == 1:
                self.on_validation_extras(self, step)
        finally:
            model.train(was_training)
        return losses
