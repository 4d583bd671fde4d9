"""Carrying a JAX training run onto the port.

The JAX package trains into orbax directories ``model_ckpt_steps_N/``
(``params`` and optax's ``opt_state``, with a ``meta.json``).  This module
turns such a checkpoint into the reference-format ``model_ckpt_steps_N.ckpt``
that the port's trainer writes and every port command reads, optimizer
state included, so that training resumes on the card where the JAX run
stopped.

* The weights go through the port's carriers (``utils/jax_weights.py``)
  into the port's model, loaded strictly.  The carriers take what they know
  and would drop any other leaf without a word, so the result is checked:
  the port's copy of the JAX package's converter (``utils/torch_ckpt.py``)
  maps the carried state dict back, and that tree must equal the
  checkpoint's ``params`` leaf for leaf, bit for bit.
* The optimizer state has one of the layouts the JAX package's
  ``build_optimizer`` and freezing give: the chain ``[clip, adamw]``
  (``[adamw]`` without clipping), adamw being ``[ScaleByAdamState(count, mu,
  nu), EmptyState, ScaleByScheduleState(count)]``; that chain inside
  ``optax.MultiSteps`` (``accumulate_grad_batches`` > 1: ``mini_step``,
  ``gradient_step``, ``inner_opt_state``, ``acc_grads``, ``skip_state``);
  either inside ``optax.multi_transform`` (``frozen_params``:
  ``inner_states.trainable.inner_state``, the frozen leaves of ``mu``,
  ``nu`` and ``acc_grads`` stored as ``None``).  Any other layout, or one
  that disagrees with the config, raises.  ``mu`` and ``nu`` go through the
  same carrier into the ``exp_avg`` and ``exp_avg_sq`` of the AdamW that the
  port's own ``TrainState(model, cfg)`` builds, ``step`` being Adam's
  ``count``; the port's AdamW then takes the updates optax would
  (``training/train_state.py``).

``jax_tree_from_state`` is the inverse: a port model and AdamW state as the
JAX package's ``{"params", "opt_state"}`` tree, to hold a conversion against
its source.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

ADAM_KEYS = {"count", "mu", "nu"}
MULTISTEPS_KEYS = {"mini_step", "gradient_step", "inner_opt_state", "acc_grads", "skip_state"}


def task_category(cfg) -> Optional[str]:
    """``acoustic`` or ``variance`` from the config's ``task_cls``; None
    when it names neither."""
    task_cls = str(cfg.get("task_cls", "")).lower()
    for category in ("acoustic", "variance"):
        if category in task_cls:
            return category
    return None


def _root(params: dict) -> dict:
    return params["params"] if "params" in params else params


def _flat(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _unflat(flat: Dict[Tuple[str, ...], Any]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _dotted(path) -> str:
    return ".".join(path)


def _same_bits(ours: np.ndarray, theirs) -> bool:
    theirs = np.asarray(theirs)
    return (ours.dtype == theirs.dtype and ours.shape == theirs.shape
            and np.ascontiguousarray(ours).tobytes() == np.ascontiguousarray(theirs).tobytes())


def _tree_differences(ours: dict, theirs: dict) -> List[str]:
    a, b = _flat(ours), _flat(theirs)
    out = [f"missing from the checkpoint: {_dotted(k)}" for k in a if k not in b]
    out += [f"not carried into the port's model: {_dotted(k)}" for k in b if k not in a]
    out += [f"differs: {_dotted(k)} {np.shape(a[k])} vs {np.shape(b[k])}"
            for k in a if k in b and not _same_bits(a[k], b[k])]
    return out


def _family(category: str):
    """(model class, carrier JAX -> port, converter port -> JAX)."""
    from ..models.toplevel import AcousticModel, VarianceModel
    from ..utils import jax_weights, torch_ckpt

    if category == "acoustic":
        return AcousticModel, jax_weights.acoustic_state_dict_from_jax, torch_ckpt.convert_acoustic
    if category == "variance":
        return VarianceModel, jax_weights.variance_state_dict_from_jax, torch_ckpt.convert_variance
    raise ValueError(f"unknown checkpoint category {category!r} (acoustic or variance)")


def _category_of(model) -> str:
    from ..models.toplevel import VarianceModel

    return "variance" if isinstance(model, VarianceModel) else "acoustic"


def state_dict_from_jax(params: dict, cfg, category: str) -> Dict[str, torch.Tensor]:
    """The JAX ``params`` tree carried into a state dict under the port's
    names, in f32; raises, naming the leaves, unless the port's converter
    maps it back onto ``params`` bit for bit."""
    _, carry, convert = _family(category)
    p = _root(params)
    sd = carry(p, cfg)
    bad = _tree_differences(convert(sd, cfg)["params"], p)
    if bad:
        raise ValueError(f"the {category} checkpoint does not round-trip through the port's "
                         f"carrier ({len(bad)} leaves): " + "; ".join(bad[:20]))
    return sd


def model_from_jax(params: dict, cfg, category: str) -> torch.nn.Module:
    """The port's model of ``cfg`` (on the CPU, in f32) holding the JAX
    ``params`` tree (:func:`state_dict_from_jax`, loaded strictly)."""
    from ..models.toplevel import load_acoustic_state_dict, load_variance_state_dict

    cls = _family(category)[0]
    vocab = int(np.shape(_root(params)["fs2"]["txt_embed"]["embedding"])[0])
    model = cls.from_config(cfg, vocab)
    load = load_variance_state_dict if category == "variance" else load_acoustic_state_dict
    load(model, state_dict_from_jax(params, cfg, category))
    return model


def model_state_dict_from_jax(params: dict, cfg, category: str) -> Dict[str, torch.Tensor]:
    """The state dict (port names, buffers included, as the port's trainer
    saves it under ``model.``) of :func:`model_from_jax`."""
    return model_from_jax(params, cfg, category).state_dict()


def _unwrap(opt_state, cfg) -> Tuple[dict, Any, Optional[dict], bool]:
    """(Adam's state, the schedule's count, MultiSteps' state or None,
    frozen) of a JAX optimizer state, checked against the config."""
    freezing = bool(cfg.get("freezing_enabled", False) and cfg.get("frozen_params"))
    accum = max(1, int(cfg.get("accumulate_grad_batches", 1) or 1))
    state = opt_state
    if isinstance(state, dict) and set(state) == {"inner_states"}:
        if not freezing:
            raise ValueError("the optimizer state is optax.multi_transform's (frozen "
                             "parameters), but the config freezes none (freezing_enabled, "
                             "frozen_params)")
        inner = state["inner_states"]
        if (not isinstance(inner, dict) or set(inner) != {"trainable", "frozen"}
                or inner["frozen"] != {"inner_state": None}):
            raise ValueError(f"unknown multi_transform layout: labels {sorted(inner)}")
        state = inner["trainable"]["inner_state"]
    elif freezing:
        raise ValueError("the config freezes parameters (frozen_params), but the optimizer "
                         "state is not optax.multi_transform's")
    multi = None
    if isinstance(state, dict) and set(state) == MULTISTEPS_KEYS:
        if accum == 1:
            raise ValueError("the optimizer state is optax.MultiSteps' (gradient "
                             "accumulation), but the config's accumulate_grad_batches is 1")
        multi, state = state, state["inner_opt_state"]
    elif accum > 1:
        raise ValueError(f"the config accumulates {accum} batches, but the optimizer state is "
                         f"not optax.MultiSteps'")
    clip = bool(cfg.get("clip_grad_norm", 1.0))
    ok = isinstance(state, list) and len(state) == (2 if clip else 1) \
        and (not clip or state[0] is None)
    adamw = state[-1] if ok else None
    ok = ok and isinstance(adamw, list) and len(adamw) == 3 and isinstance(adamw[0], dict) \
        and set(adamw[0]) == ADAM_KEYS and adamw[1] is None \
        and isinstance(adamw[2], dict) and set(adamw[2]) == {"count"}
    if not ok:
        raise ValueError(
            "not an optimizer state of the JAX package's build_optimizer: expected the chain "
            f"[{'clip, ' if clip else ''}adamw] with adamw [ScaleByAdamState(count, mu, nu), "
            "EmptyState, ScaleByScheduleState(count)]")
    return adamw[0], adamw[2]["count"], multi, freezing


def _filled(tree, template: dict, what: str) -> Tuple[dict, set]:
    """``tree`` (the params layout, ``None`` at frozen leaves) with zeros at
    its ``None`` leaves, and the paths of those leaves; raises where its
    leaves or shapes differ from ``template``'s."""
    flat, ref = _flat(tree), _flat(template)
    bad = [f"missing {_dotted(k)}" for k in ref if k not in flat]
    bad += [f"extra {_dotted(k)}" for k in flat if k not in ref]
    bad += [f"{_dotted(k)} {np.shape(flat[k])} vs {np.shape(ref[k])}" for k in ref
            if k in flat and flat[k] is not None and np.shape(flat[k]) != np.shape(ref[k])]
    if bad:
        raise ValueError(f"{what} does not match the parameters ({len(bad)} leaves): "
                         + "; ".join(bad[:20]))
    none = {k for k, v in flat.items() if v is None}
    return _unflat({k: np.zeros(np.shape(ref[k]), np.float32) if k in none else flat[k]
                    for k in ref}), none


def optimizer_state_from_jax(opt_state, model: torch.nn.Module, cfg, step: int) -> dict:
    """The ``state_dict()`` of the AdamW that ``TrainState(model, cfg)``
    builds, holding the JAX optimizer state ``opt_state`` of update ``step``
    (``meta.json``'s).  With ``frozen_params`` the model's parameters are
    frozen first (``finetune.freeze_parameters``), as the port's trainer
    does, and the frozen set must be the checkpoint's."""
    from .finetune import freeze_parameters
    from .train_state import TrainState

    adam, sched_count, multi, freezing = _unwrap(opt_state, cfg)
    counts = {"Adam's count": int(adam["count"]), "the schedule's count": int(sched_count),
              "meta.json's step": int(step)}
    if multi is not None:
        counts["MultiSteps' gradient_step"] = int(multi["gradient_step"])
    if len(set(counts.values())) != 1:
        raise ValueError(f"the optimizer state's counts disagree: {counts}")
    category = _category_of(model)
    _, carry, convert = _family(category)
    template = convert(model.state_dict(), cfg)["params"]
    mu, frozen = _filled(adam["mu"], template, "Adam's mu")
    nu, frozen_nu = _filled(adam["nu"], template, "Adam's nu")
    if multi is not None:
        # the JAX trainer saves only at update boundaries
        if int(multi["mini_step"]) != 0:
            raise ValueError(f"the checkpoint was saved within an update (MultiSteps' "
                             f"mini_step {int(multi['mini_step'])}); the JAX trainer saves "
                             f"only at update boundaries")
        acc, frozen_acc = _filled(multi["acc_grads"], template, "MultiSteps' acc_grads")
        held = [_dotted(k) for k, v in _flat(acc).items() if np.any(np.asarray(v) != 0)]
        if held:
            raise ValueError(f"MultiSteps' acc_grads hold gradients ({held[:5]}); the JAX "
                             f"trainer saves only at update boundaries")
        if frozen_acc != frozen:
            raise ValueError("acc_grads and mu disagree on the frozen parameters")
    if frozen_nu != frozen:
        raise ValueError("mu and nu disagree on the frozen parameters")
    flags = carry(_unflat({k: np.full(np.shape(v), float(k in frozen), np.float32)
                           for k, v in _flat(template).items()}), cfg)
    if freezing:
        freeze_parameters(model, cfg["frozen_params"])
    names = dict(model.named_parameters())
    theirs = sorted(n for n in names if bool(flags[n].all()))
    ours = sorted(n for n, p in names.items() if not p.requires_grad)
    if theirs != ours:
        raise ValueError(f"the checkpoint's frozen parameters differ from those frozen_params "
                         f"selects in the port (prefixes match reference names here, flax "
                         f"paths in the JAX package): only in the checkpoint "
                         f"{sorted(set(theirs) - set(ours))[:5]}, only in the port "
                         f"{sorted(set(ours) - set(theirs))[:5]}")
    mu, nu = carry(mu, cfg), carry(nu, cfg)
    state = TrainState(model, cfg)
    ids = {id(p): n for n, p in names.items()}
    count = counts["Adam's count"]
    for p in state.params:
        n = ids[id(p)]
        state.optimizer.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                                    "exp_avg": mu[n].to(p.device),
                                    "exp_avg_sq": nu[n].to(p.device)}
    if count > 0:  # the learning rate the port's trainer leaves after update count - 1
        for group in state.optimizer.param_groups:
            group["lr"] = float(state.schedule(count - 1))
    return state.optimizer.state_dict()


def checkpoint_from_jax(cfg, tree: dict, meta: dict) -> dict:
    """The JAX checkpoint ``tree`` (``{"params", "opt_state"}``) with its
    ``meta`` as the payload of the port's ``CheckpointManager.save``."""
    category, step = meta.get("category"), int(meta["step"])
    if task_category(cfg) not in (None, category):
        raise ValueError(f"the checkpoint's category is {category!r}, the config's task_cls "
                         f"{cfg.get('task_cls')!r}")
    model = model_from_jax(tree["params"], cfg, category)
    optimizer = optimizer_state_from_jax(tree["opt_state"], model, cfg, step)
    return {
        "category": category,
        "global_step": step,
        "epoch": int(meta.get("epoch", 0)),
        "state_dict": {f"model.{k}": v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer_states": [optimizer],
    }


def convert_jax_tree(cfg, tree: dict, meta: dict, out_dir) -> Path:
    """Write :func:`checkpoint_from_jax` as
    ``<out_dir>/model_ckpt_steps_{step}.ckpt``, under a temporary name moved
    into place, as the port's ``CheckpointManager.save`` writes it."""
    payload = checkpoint_from_jax(cfg, tree, meta)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"model_ckpt_steps_{payload['global_step']}.ckpt"
    partial = path.with_name(path.name + ".partial")
    torch.save(payload, partial)
    os.replace(partial, path)
    return path


def convert_jax_checkpoint(cfg, ckpt_dir, out_dir) -> Path:
    """Read the JAX checkpoint directory ``ckpt_dir`` (``utils/orbax_ckpt.py``:
    needs ``tensorstore``) and write it as a reference-format ``.ckpt`` into
    ``out_dir`` (:func:`convert_jax_tree`); returns its path."""
    from ..utils.orbax_ckpt import read_checkpoint

    tree, meta = read_checkpoint(ckpt_dir)
    return convert_jax_tree(cfg, tree, meta, out_dir)


def _as_tree(sd: Dict[str, torch.Tensor], category: str, cfg) -> dict:
    return _family(category)[2](sd, cfg)["params"]


def jax_tree_from_state(model: torch.nn.Module, optimizer_state: dict, cfg) -> dict:
    """The inverse of the conversion: ``model`` and the ``state_dict()`` of
    its ``TrainState``'s AdamW as the JAX package's ``{"params",
    "opt_state"}`` tree, in the layout the config gives (``MultiSteps`` with
    ``accumulate_grad_batches`` > 1, ``multi_transform`` with
    ``frozen_params``; frozen leaves ``None``), saved at an update
    boundary."""
    category = _category_of(model)
    sd = model.state_dict()
    params = _as_tree(sd, category, cfg)
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    states = optimizer_state["state"]
    if len(states) != len(trainable):
        raise ValueError(f"{len(states)} optimizer states for {len(trainable)} trainable "
                         f"parameters")
    count = {int(s["step"]) for s in states.values()}
    if len(count) != 1:
        raise ValueError(f"the parameters' steps differ: {sorted(count)}")
    count = np.asarray(count.pop(), np.int32)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}

    def moment(key):
        moments = {n: states[i][key] for i, n in enumerate(trainable)}
        tree = _as_tree({k: moments.get(k, torch.zeros_like(v)) for k, v in sd.items()},
                        category, cfg)
        flags = _flat(_as_tree({k: torch.full_like(v, float(k in frozen))
                                for k, v in sd.items()}, category, cfg))
        return _unflat({k: None if bool(np.all(flags[k] == 1)) else v
                        for k, v in _flat(tree).items()})

    inner = [[{"count": count, "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}, None,
              {"count": count}]]
    if cfg.get("clip_grad_norm", 1.0):
        inner.insert(0, None)
    if max(1, int(cfg.get("accumulate_grad_batches", 1) or 1)) > 1:
        zeros = _unflat({k: None if v is None else np.zeros_like(v)
                         for k, v in _flat(inner[-1][0]["mu"]).items()})
        inner = {"mini_step": np.asarray(0, np.int32), "gradient_step": count,
                 "inner_opt_state": inner, "acc_grads": zeros, "skip_state": ()}
    if cfg.get("freezing_enabled", False) and cfg.get("frozen_params"):
        inner = {"inner_states": {"frozen": {"inner_state": None},
                                  "trainable": {"inner_state": inner}}}
    return {"params": params, "opt_state": inner}
