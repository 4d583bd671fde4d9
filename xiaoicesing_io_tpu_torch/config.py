"""Configuration: a dict with attribute access, loaded from YAML or JSON.

Same semantics as the JAX package's ``config.py`` for inference: recursive
``base_config`` inheritance with deep merge, and the work dir's saved config
merged in.  (Training's ``reset`` and ``key=value`` overrides are not ported
yet.)

PyYAML is imported only when a ``.yaml`` file is parsed.  The acoustic
defaults (``base.yaml`` + ``acoustic.yaml`` merged) ship as
``configs/acoustic.json``, so the port loads them where PyYAML is absent;
``base_config: [acoustic.yaml]`` resolves to that file.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Mapping, Optional, Union

PathLike = Union[str, os.PathLike]

BUILTIN_CONFIG_DIR = Path(__file__).parent / "configs"


class Config(dict):
    """A dict with attribute access."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value


def _plain(obj: Any) -> Any:
    if isinstance(obj, Mapping):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _wrap(obj: Any) -> Any:
    if isinstance(obj, Mapping):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def deep_merge(base: dict, new: Mapping) -> dict:
    """Merge ``new`` into ``base`` in place: a dict value refines, any other
    value replaces."""
    for k, v in new.items():
        if k in base and isinstance(base[k], dict) and isinstance(v, Mapping):
            deep_merge(base[k], v)
        else:
            base[k] = _plain(v) if isinstance(v, Mapping) else v
    return base


def read_file(path: PathLike) -> dict:
    path = Path(path)
    with open(path, "r", encoding="utf-8") as f:
        if path.suffix == ".json":
            return json.load(f) or {}
        import yaml

        return yaml.safe_load(f) or {}


def _resolve_base(base: str, relative_to: Path) -> Path:
    """A ``base_config`` entry: relative to the including file, to the CWD,
    then the builtin configs (by name, or by stem with ``.json``)."""
    name = Path(base).name
    cand = [relative_to / base, Path(base), BUILTIN_CONFIG_DIR / name,
            BUILTIN_CONFIG_DIR / (Path(name).stem + ".json")]
    for c in cand:
        if c.exists():
            return c
    raise FileNotFoundError(f"base_config {base!r} not found (searched {[str(c) for c in cand]})")


def _load_chain(path: Path, seen: Optional[set] = None) -> dict:
    seen = seen if seen is not None else set()
    rp = path.resolve()
    if rp in seen:
        raise ValueError(f"base_config cycle involving {path}")
    seen.add(rp)
    raw = read_file(path)
    bases = raw.pop("base_config", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for b in bases:
        deep_merge(merged, _load_chain(_resolve_base(b, path.parent), seen))
    deep_merge(merged, raw)
    return merged


def load_config(
    config_path: Optional[PathLike] = None,
    *,
    exp_name: Optional[str] = None,
    work_dir_root: PathLike = "checkpoints",
    infer: bool = False,
) -> Config:
    """Precedence (lowest to highest): base_config chain < file itself <
    saved work-dir ``config.yaml`` / ``config.json``."""
    merged: dict = {}
    if config_path is not None:
        merged = _load_chain(Path(config_path))

    if exp_name:
        work_dir = Path(work_dir_root) / exp_name
        saved = next((p for p in (work_dir / "config.yaml", work_dir / "config.json")
                      if p.exists()), None)
        if saved is not None:
            saved_cfg = read_file(saved)
            if config_path is None:
                merged = saved_cfg
            else:
                deep_merge(merged, saved_cfg)
        elif config_path is None:
            raise FileNotFoundError(
                f"no saved config.yaml or config.json in '{work_dir}' (experiments resolve "
                f"under '{Path(work_dir_root).resolve()}')"
            )
        merged["exp_name"] = exp_name
        merged["work_dir"] = str(work_dir)

    merged["infer"] = infer

    from .compat import migrate_legacy_keys

    migrate_legacy_keys(merged)
    return _wrap(merged)


def acoustic_defaults() -> Config:
    """The shipped acoustic configuration (``base.yaml`` + ``acoustic.yaml``)."""
    return load_config(BUILTIN_CONFIG_DIR / "acoustic.json")
