"""Host utilities shared across the port."""

from __future__ import annotations

import contextlib
import importlib
import inspect
import os
import re
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch


def filter_kwargs(kwargs: Dict[str, Any], fn: Callable) -> Dict[str, Any]:
    """Keep only the kwargs that ``fn``'s signature accepts."""
    sig = inspect.signature(fn)
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()):
        return dict(kwargs)
    return {k: v for k, v in kwargs.items() if k in sig.parameters}


def build_object_from_class_name(cls_path: str, base_cls=None, *args, **kwargs):
    """Instantiate the class at the dotted path ``pkg.mod.Class`` with the
    kwargs its ``__init__`` accepts; raises ``TypeError`` when ``base_cls``
    is given and the class is not its subclass."""
    mod_name, cls_name = cls_path.rsplit(".", 1)
    cls = getattr(importlib.import_module(mod_name), cls_name)
    if base_cls is not None and not issubclass(cls, base_cls):
        raise TypeError(f"{cls_path} is not a subclass of {base_cls}")
    return cls(*args, **filter_kwargs(kwargs, cls.__init__))


def fresh_seed() -> int:
    """Entropy for unseeded runs: every invocation differs."""
    return int.from_bytes(os.urandom(4), "little")


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when CUDA is asked for (or defaulted to) and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return device


@contextlib.contextmanager
def exact_f32():
    """Run the block's f32 products, convolutions and cuDNN recurrences in
    full f32 (TF32 off); the process's settings come back afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def load_reference_weights(module: torch.nn.Module, state_dict: Dict[str, torch.Tensor],
                           unused: Iterable[str] = ()) -> None:
    """``module.load_state_dict(state_dict)`` that lets a state dict lack the
    BatchNorm step counters and the tensors under the ``unused`` prefixes
    (modules of the reference that its forward pass never reads); any other
    missing or unexpected name raises."""
    missing, unexpected = module.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")
               and not k.startswith(tuple(unused))]
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing[:8]}, unexpected "
                       f"{unexpected[:8]}")


def _mix64(x: int) -> int:
    """splitmix64's finaliser: every bit of ``x`` reaches every bit out."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def seed_for(seed: int, salt: int, device_type: str) -> int:
    """The 64-bit seed ``generator_from_seed`` gives a generator of
    ``device_type`` for a 32-bit ``seed`` and ``salt``.  On the card (Philox
    keeps all 64 bits) a salt below 256 seeds ``(seed << 8) | salt`` and a
    larger one a 64-bit mix of both.  torch's CPU generator keeps only its
    seed's low 32 bits, so on the CPU every salt seeds the mix, whose low 32
    bits depend on every bit of the seed and of the salt."""
    seed, salt = int(seed) & 0xFFFFFFFF, int(salt) & 0xFFFFFFFF
    if device_type == "cuda" and salt < 256:
        return (seed << 8) | salt
    return _mix64((seed << 32) | salt)


def generator_from_seed(seed: Optional[int], device: torch.device,
                        salt: int = 0) -> Optional[torch.Generator]:
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` (32-bit) and a
    32-bit salt (``seed_for``), so diffusion noise and vocoder source noise
    draw distinct streams.  ``None`` for ``seed=None``: no randomness."""
    if seed is None:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(seed_for(seed, salt, torch.device(device).type))
    return g


def collate_nd(arrays: Sequence[np.ndarray], pad_value=0, max_len: Optional[int] = None,
               dtype=None, rows: Optional[int] = None) -> np.ndarray:
    """Pad a list of nd-arrays along dim 0 to a common length (``max_len``,
    default the longest) and stack them; ``dtype`` casts in the placement
    write, and ``rows`` over-allocates the batch axis with padding rows."""
    tgt = max(a.shape[0] for a in arrays) if max_len is None else max_len
    arr0 = np.asarray(arrays[0])
    n = max(len(arrays), rows or 0)
    shape = (n, tgt, *arr0.shape[1:])
    dt = np.dtype(dtype) if dtype is not None else arr0.dtype
    if pad_value == 0:
        out = np.zeros(shape, dtype=dt)
    else:
        out = np.full(shape, pad_value, dtype=dt)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
    return out


def random_continuous_masks(B: int, T: int, rng: np.random.Generator) -> np.ndarray:
    """bool ``[B, T]``, True on one random span ``[start, end)`` per row
    (two sorted cut points drawn from ``rng``; the span may be empty)."""
    ends = rng.integers(0, T + 1, size=(B, 2))
    ends.sort(axis=1)
    idx = np.arange(T)[None, :]
    return (idx >= ends[:, :1]) & (idx < ends[:, 1:])


def batch_by_size(indices: Sequence[int], num_frames_fn: Callable[[int], int],
                  max_batch_frames: int = 80000, max_batch_size: int = 48) -> List[List[int]]:
    """Group dataset indices, in the given order, into batches capped by
    total frames (every item padded to the batch's longest) and item count:
    a batch closes when the next item would exceed either cap."""
    batches: List[List[int]] = []
    cur: List[int] = []
    cur_max = 0
    for idx in indices:
        idx = int(idx)
        n = num_frames_fn(idx)
        if n > max_batch_frames:
            raise ValueError(
                f"item {idx} has {n} frames which exceeds max_batch_frames={max_batch_frames}")
        new_max = max(cur_max, n)
        if cur and (len(cur) + 1 > max_batch_size or new_max * (len(cur) + 1) > max_batch_frames):
            batches.append(cur)
            cur, new_max = [], n
        cur.append(idx)
        cur_max = new_max
    if cur:
        batches.append(cur)
    return batches


_CKPT_STEP = re.compile(r"model_ckpt_steps_(\d+)")


def parse_ckpt_step(name: str) -> Optional[int]:
    """The step in a name holding ``model_ckpt_steps_<N>``, else None."""
    m = _CKPT_STEP.search(str(name))
    return int(m.group(1)) if m else None
