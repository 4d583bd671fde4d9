"""Checkpoints in the reference format, with the reference's retention.

Counterpart of the JAX package's ``training/checkpoint.py``.  A checkpoint
is ``<work_dir>/model_ckpt_steps_{N}.ckpt``, a ``torch.save`` of
``{"category", "global_step", "state_dict", "optimizer_states", "epoch"}``
with the model's tensors under ``model.<reference name>``: the file the
reference's Lightning trainer writes.  The newest ``num_ckpt_keep`` by step
are kept, and besides them, from ``permanent_ckpt_start``, every
``permanent_ckpt_interval``-th.

Every command that needs a model's weights (``infer``, ``eval``,
``export``, ``drop_spk``) reads them through :func:`load_model_state_dict`,
which also takes the JAX package's checkpoint directories
``model_ckpt_steps_N/`` (through ``training/jax_bridge.py``).  It reads
the highest step of either kind, and the ``.ckpt`` where both have it.
The JAX package's ``load_params_for_inference`` prefers any directory to
any ``.ckpt``; that fits a trainer that writes directories, but this one
writes ``.ckpt`` files, so a run resumed here after ``convert_ckpt`` must
not be shadowed by the older directory it came from.  Training resumes
from ``.ckpt`` files only: a JAX directory newer than all of them must be
converted first (``convert_ckpt``), or resume would go back in time.

A save writes a temporary name and ``os.replace``-s it into place, so an
interrupted save leaves no ``model_ckpt_steps_*.ckpt`` behind: resume takes
the last complete one, and the next save removes the leftover.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, List, Optional

import torch

CKPT_RE = re.compile(r"model_ckpt_steps_(\d+)\.ckpt$")
PARTIAL_SUFFIX = ".partial"


def checkpoint_step(path) -> int:
    return int(CKPT_RE.search(Path(path).name).group(1))


def list_checkpoints(work_dir) -> List[Path]:
    """Complete checkpoints of ``work_dir``, by step."""
    work_dir = Path(work_dir)
    if not work_dir.exists():
        return []
    return sorted((p for p in work_dir.iterdir() if p.is_file() and CKPT_RE.search(p.name)),
                  key=checkpoint_step)


def latest_checkpoint(work_dir) -> Optional[Path]:
    ckpts = list_checkpoints(work_dir)
    return ckpts[-1] if ckpts else None


class CheckpointManager:
    def __init__(self, work_dir, category: str, num_ckpt_keep: int = 5,
                 permanent_ckpt_start: int = 0, permanent_ckpt_interval: int = -1):
        self.work_dir = Path(work_dir)
        self.category = category
        self.num_ckpt_keep = num_ckpt_keep
        self.permanent_ckpt_start = permanent_ckpt_start
        self.permanent_ckpt_interval = permanent_ckpt_interval
        self.work_dir.mkdir(parents=True, exist_ok=True)

    def _is_permanent(self, step: int) -> bool:
        return (self.permanent_ckpt_interval > 0 and step >= self.permanent_ckpt_start
                and (step - self.permanent_ckpt_start) % self.permanent_ckpt_interval == 0)

    def save(self, state, step: int, epoch: int = 0) -> Path:
        """Write ``model_ckpt_steps_{step}.ckpt`` of ``state`` (a
        :class:`~.train_state.TrainState`), then apply the retention."""
        path = self.work_dir / f"model_ckpt_steps_{step}.ckpt"
        partial = path.with_name(path.name + PARTIAL_SUFFIX)
        payload = {
            "category": self.category,
            "global_step": step,
            "epoch": epoch,
            "state_dict": {f"model.{k}": v.detach().cpu()
                           for k, v in state.model.state_dict().items()},
            "optimizer_states": [state.optimizer.state_dict()],
        }
        torch.save(payload, partial)
        os.replace(partial, path)
        self._cleanup()
        return path

    def _cleanup(self) -> None:
        for p in self.work_dir.glob("model_ckpt_steps_*.ckpt" + PARTIAL_SUFFIX):
            p.unlink(missing_ok=True)
        deletable = [p for p in list_checkpoints(self.work_dir)
                     if not self._is_permanent(checkpoint_step(p))]
        for p in deletable[: max(0, len(deletable) - self.num_ckpt_keep)]:
            p.unlink()

    def restore_latest(self, state) -> Dict:
        """Load the latest checkpoint into ``state``; returns ``{"step",
        "epoch"}`` (zeros without a checkpoint).  Raises where the work dir
        holds a JAX checkpoint directory newer than every ``.ckpt``."""
        from ..utils import orbax_ckpt

        path = latest_checkpoint(self.work_dir)
        jax_dir = orbax_ckpt.latest_checkpoint(self.work_dir)
        if jax_dir is not None and (path is None or orbax_ckpt.checkpoint_dir_step(jax_dir)
                                    > checkpoint_step(path)):
            raise RuntimeError(
                f"{jax_dir} (a JAX checkpoint) is newer than every model_ckpt_steps_*.ckpt of "
                f"{self.work_dir}; training resumes from .ckpt files only: convert it first "
                f"(python -m xiaoicesing_io_tpu_torch.cli convert_ckpt --exp <exp>)")
        if path is None:
            return {"step": 0, "epoch": 0}
        return load_checkpoint(path, state, expected_category=self.category)


def load_checkpoint(path, state, expected_category: Optional[str] = None) -> Dict:
    """Load a checkpoint's model and optimizer into ``state`` and set its
    step; checks the category."""
    # reference Lightning checkpoints hold more than tensors
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if expected_category is not None and ckpt.get("category") != expected_category:
        raise ValueError(f"Checkpoint at {path} has category {ckpt.get('category')!r}, "
                         f"expected {expected_category!r}")
    state.model.load_state_dict({k.removeprefix("model."): v
                                 for k, v in ckpt["state_dict"].items()}, strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer_states"][0])
    step = int(ckpt["global_step"])
    state.step = step
    state.micro = step * state.accum
    return {"step": step, "epoch": int(ckpt.get("epoch", 0))}


def find_model_checkpoint(work_dir, ckpt_steps: Optional[int] = None) -> Path:
    """The checkpoint a command reads its weights from: the highest step (or,
    with ``ckpt_steps``, that exact step) over ``model_ckpt_steps_N.ckpt``
    files and JAX checkpoint directories ``model_ckpt_steps_N/``; where both
    kinds have that step (as ``convert_ckpt`` writes it), the ``.ckpt``, which
    holds the same weights and needs no ``tensorstore``."""
    from ..utils import orbax_ckpt

    found = ([(checkpoint_step(p), 1, p) for p in list_checkpoints(work_dir)]
             + [(orbax_ckpt.checkpoint_dir_step(p), 0, p)
                for p in orbax_ckpt.list_checkpoints(work_dir)])
    if ckpt_steps is not None:  # exact match: step 2000 must not load 12000
        found = [c for c in found if c[0] == int(ckpt_steps)]
    if found:
        return max(found, key=lambda c: c[:2])[2]
    what = "" if ckpt_steps is None else f" of step {ckpt_steps}"
    raise FileNotFoundError(f"No checkpoint{what} (model_ckpt_steps_*.ckpt or a JAX "
                            f"model_ckpt_steps_*/ directory) found in {work_dir}")


def load_model_state_dict(work_dir, cfg, category: str,
                          ckpt_steps: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The model weights of :func:`find_model_checkpoint`'s checkpoint as a
    reference-format state dict (``model.`` prefix optional; load it with
    ``load_acoustic_state_dict`` or ``load_variance_state_dict``).  A JAX
    directory's ``category`` must be ``category``."""
    path = find_model_checkpoint(work_dir, ckpt_steps)
    if path.is_dir():
        from ..utils.orbax_ckpt import read_checkpoint, read_meta
        from .jax_bridge import model_state_dict_from_jax

        meta = read_meta(path)
        if meta.get("category") != category:
            raise ValueError(f"Checkpoint at {path} has category {meta.get('category')!r}, "
                             f"expected {category!r}")
        params, _ = read_checkpoint(path, subtree="params")
        return model_state_dict_from_jax(params, cfg, category)
    # reference Lightning checkpoints hold more than tensors
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt.get("state_dict", ckpt)
