"""Vocoder registry: classes under their name and its lowercase form
(``NsfHifiGAN`` in ``wrapper.py``, ``DDSP`` in ``ddsp.py``); an unknown name
resolves as a dotted import path ``pkg.mod.Class``."""

from __future__ import annotations

import importlib

VOCODERS = {}


def register_vocoder(cls):
    VOCODERS[cls.__name__.lower()] = cls
    VOCODERS[cls.__name__] = cls
    return cls


def get_vocoder_cls(name: str):
    from . import ddsp, wrapper  # noqa: F401  (register DDSP and NsfHifiGAN)

    if name in VOCODERS:
        return VOCODERS[name]
    if "." in name:
        pkg, _, cls_name = name.rpartition(".")
        return getattr(importlib.import_module(pkg), cls_name)
    raise KeyError(
        f"unknown vocoder {name!r}; registered: {sorted(VOCODERS)} "
        "(or pass a dotted import path pkg.mod.Class)"
    )
