"""Finetuning from a checkpoint and parameter freezing (counterpart of the
JAX package's ``training/finetune.py``).

Prefixes (``frozen_params``, ``finetune_ignored_params``) match the
reference state-dict names, with or without a leading ``model.``, e.g.
``fs2.encoder`` or ``model.diffusion.velocity_fn.residual_layers.0``.  The
JAX package matches them against its flax paths instead
(``fs2.encoder.layers_0`` where the reference says ``fs2.encoder.layers.0``,
``backbone`` where it says ``diffusion.velocity_fn``), so a prefix written
for one package can select other tensors, or none, in the other.

The finetune source is a reference-format ``.ckpt`` file (this package's
own checkpoints are such files) or a JAX checkpoint directory
``model_ckpt_steps_N/``, whose params are carried under the reference names
(``training/jax_bridge.state_dict_from_jax``; reading one needs
``tensorstore``).  Its ``meta.json`` category is checked as the JAX package
checks it; then both kinds merge alike.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import torch


def _norm_prefix(p: str) -> str:
    return p.removeprefix("model.")


def freeze_parameters(model: torch.nn.Module, frozen_prefixes: List[str]) -> int:
    """Turn off ``requires_grad`` of every parameter whose name starts with
    one of the prefixes; returns how many tensors were frozen."""
    prefixes = [_norm_prefix(p) for p in frozen_prefixes]
    n = 0
    for name, p in model.named_parameters():
        if any(name.startswith(pre) for pre in prefixes):
            p.requires_grad_(False)
            n += 1
    print(f"| freezing {n} parameter tensors (prefixes: {list(frozen_prefixes)})")
    return n


def load_finetune_params(model: torch.nn.Module, cfg, model_category: str) -> None:
    """Copy the tensors of ``finetune_ckpt_path`` into ``model``, skipping
    names under ``finetune_ignored_params``, names the model lacks, and,
    unless ``finetune_strict_shapes`` (default on, then it raises),
    tensors whose shape differs."""
    from ..models.toplevel import _ALIASES, _VARIANCE_ALIASES, _reference_state_dict

    ckpt_path = Path(cfg["finetune_ckpt_path"])
    blacklist = [_norm_prefix(b) for b in (cfg.get("finetune_ignored_params") or [])]
    strict_shapes = cfg.get("finetune_strict_shapes", True)
    def check(category):
        if category not in (None, model_category):
            raise ValueError(f"Finetune checkpoint category {category!r} != {model_category!r}")

    if ckpt_path.is_dir():
        from ..utils.orbax_ckpt import read_checkpoint, read_meta
        from .jax_bridge import state_dict_from_jax

        if not (ckpt_path / "meta.json").exists():
            raise ValueError(f"finetune_ckpt_path {str(ckpt_path)!r} is a directory without "
                             "meta.json: no complete JAX checkpoint")
        check(read_meta(ckpt_path).get("category"))
        params, _ = read_checkpoint(ckpt_path, subtree="params")
        state_dict = state_dict_from_jax(params, cfg, model_category)
    else:
        # reference Lightning checkpoints hold more than tensors
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        check(ckpt.get("category"))
        state_dict = ckpt.get("state_dict", ckpt)
    variance = model_category == "variance"
    src = _reference_state_dict(
        state_dict, _VARIANCE_ALIASES if variance else _ALIASES,
        ("pitch_predictor", "variance_predictor") if variance else ("diffusion",))
    dst = model.state_dict()
    loaded = skipped = mismatched = 0
    with torch.no_grad():
        for name, v in src.items():
            if any(name.startswith(b) for b in blacklist):
                skipped += 1
                continue
            if name not in dst:
                continue
            if dst[name].shape != v.shape:
                if strict_shapes:
                    raise ValueError(
                        f"Shape mismatch for {name}: {tuple(dst[name].shape)} vs "
                        f"{tuple(v.shape)} (set finetune_strict_shapes: false to skip)")
                print(f"| Unmatched keys: {name} {tuple(dst[name].shape)} {tuple(v.shape)}")
                mismatched += 1
                continue
            dst[name].copy_(v)
            loaded += 1
    print(f"| finetune load: {loaded} tensors loaded, {skipped} blacklisted, "
          f"{mismatched} shape-mismatched")
