"""Host utilities shared across the port."""

from __future__ import annotations

import inspect
import os
from typing import Any, Callable, Dict, Optional, Union

import torch


def filter_kwargs(kwargs: Dict[str, Any], fn: Callable) -> Dict[str, Any]:
    """Keep only the kwargs that ``fn``'s signature accepts."""
    sig = inspect.signature(fn)
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()):
        return dict(kwargs)
    return {k: v for k, v in kwargs.items() if k in sig.parameters}


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


def generator_from_seed(seed: Optional[int], device: torch.device,
                        salt: int = 0) -> Optional[torch.Generator]:
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` (32-bit) and a
    salt, so diffusion noise and vocoder source noise draw distinct streams.
    ``None`` for ``seed=None``: no randomness."""
    if seed is None:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) & 0xFFFFFFFF) << 8) | (salt & 0xFF))
    return g
