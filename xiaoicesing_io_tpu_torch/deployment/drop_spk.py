"""Speaker-embedding scrubbing for privacy.

Counterpart of the JAX package's ``deployment/drop_spk.py``: drop (or retain)
speaker ids in a checkpoint's speaker table with a zeros, random, mean or
cyclic fill.  It works on the checkpoint the runners read
(``training/checkpoint.find_model_checkpoint``): a reference-format
``model_ckpt_steps_*.ckpt``, whose every other tensor and key is written
back as it was, or a JAX checkpoint directory, which is converted with its
optimizer state (``training/jax_bridge.py``; needs ``tensorstore``) and
written as a reference-format ``.ckpt``: to ``out``, or beside the
directory as ``model_ckpt_steps_N.ckpt``, which the runners then read in
its place.  The JAX package writes an orbax directory instead.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional, Set

import numpy as np
import torch

# the speaker tables of the reference's models: the acoustic encoder's and
# the variance model's own
SPK_TABLES = ("model.fs2.spk_embed.weight", "model.spk_embed.weight")


def modify_spk_embed(spk_embed: np.ndarray, drop_ids: Optional[Set[int]] = None,
                     retain_ids: Optional[Set[int]] = None, fill: str = "zeros",
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """A copy of ``spk_embed`` ``[num_spk, H]`` with the dropped rows (or all
    but the retained ones) filled; ``random`` draws one standard normal row
    per dropped id from ``rng``, in id order."""
    num_spk, hidden = spk_embed.shape
    all_ids = set(range(num_spk))
    if drop_ids is not None:
        drop = set(drop_ids).intersection(all_ids)
    else:
        if retain_ids is None:
            raise ValueError("Either drop_ids or retain_ids must be given.")
        drop = all_ids - set(retain_ids)
    out = np.array(spk_embed, copy=True)
    rng = rng or np.random.default_rng()
    if fill == "zeros":
        fills = [np.zeros(hidden, out.dtype) for _ in drop]
    elif fill == "random":
        fills = [rng.standard_normal(hidden).astype(out.dtype) for _ in drop]
    elif fill == "mean":
        mean = out.mean(axis=0)
        fills = [mean for _ in drop]
    elif fill == "cyclic":
        retain = sorted(all_ids - drop)
        if not retain:
            raise ValueError("cyclic fill requires at least one retained speaker")
        fills = [out[retain[i % len(retain)]] for i in range(len(drop))]
    else:
        raise ValueError(f"unknown fill method {fill}")
    for spk_id, f in zip(sorted(drop), fills):
        out[spk_id] = f
    return out


def drop_speakers(exp: str, spk: List[str], fill: str = "zeros",
                  work_dir_root: str = "checkpoints", retain: bool = False,
                  out: Optional[str] = None, overwrite: bool = False) -> Path:
    """Scrub speakers (names through the experiment's ``spk_map.json``, or
    numeric ids) in the latest checkpoint of ``<work_dir_root>/<exp>``.
    ``retain=True`` keeps the listed speakers and scrubs all others.  With
    ``out`` the scrubbed checkpoint is written there (an existing file only
    with ``overwrite``); otherwise the checkpoint is edited in place, which
    needs ``overwrite``: the new file is written beside it and swapped in
    after the save succeeded (a JAX directory stays, and the ``.ckpt`` of its
    step is written beside it).  Returns the path written."""
    from ..training.checkpoint import find_model_checkpoint

    work_dir = Path(work_dir_root) / exp
    path = find_model_checkpoint(work_dir)
    spk_map = {}
    if (work_dir / "spk_map.json").exists():
        spk_map = json.loads((work_dir / "spk_map.json").read_text(encoding="utf-8"))
    ids = {spk_map[s] if s in spk_map else int(s) for s in spk}
    if out is not None:
        dest = Path(out)
        if dest.exists() and not overwrite:
            raise FileExistsError(f"{dest} exists; pass --overwrite to replace it")
    elif not overwrite:
        raise PermissionError(f"refusing to edit {path} in place without --overwrite "
                              f"(pass --out to write elsewhere)")
    else:
        dest = path.with_name(path.name + ".ckpt") if path.is_dir() else path

    if path.is_dir():
        from ..config import load_config
        from ..training.jax_bridge import checkpoint_from_jax
        from ..utils.orbax_ckpt import read_checkpoint

        cfg = load_config(None, exp_name=exp, work_dir_root=work_dir_root, infer=True)
        ckpt = checkpoint_from_jax(cfg, *read_checkpoint(path))
    else:
        # reference Lightning checkpoints hold more than tensors
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("state_dict", ckpt)
    tables = [k for k in SPK_TABLES if k in state]
    if not tables:
        raise KeyError(f"{path} has no speaker embedding table ({', '.join(SPK_TABLES)})")
    for k in tables:
        table = state[k]
        scrubbed = modify_spk_embed(table.float().numpy(), drop_ids=None if retain else ids,
                                    retain_ids=ids if retain else None, fill=fill)
        state[k] = torch.from_numpy(scrubbed).to(table.dtype)

    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_name(dest.name + ".scrub_tmp")
    torch.save(ckpt, tmp)
    os.replace(tmp, dest)
    what = f"all speakers except {sorted(ids)}" if retain else f"speakers {sorted(ids)}"
    print(f"| scrubbed {what} -> {dest}")
    return dest
