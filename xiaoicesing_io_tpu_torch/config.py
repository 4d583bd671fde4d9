"""Configuration: a dict with attribute access, loaded from YAML or JSON.

Same semantics as the JAX package's ``config.py``: recursive ``base_config``
inheritance with deep merge, the work dir's saved config merged in unless
``reset``, ``key=value`` overrides on top (``a.b=1,c=[2,3]``, literals
coerced), and :meth:`Config.save` of the merged config into the work dir.

PyYAML is imported only when a ``.yaml`` file is parsed or written.  The acoustic and
variance defaults (``base.yaml`` merged with ``acoustic.yaml`` or
``variance.yaml``) ship as ``configs/acoustic.json`` and
``configs/variance.json``, so the port loads them where PyYAML is absent;
``base_config: [acoustic.yaml]`` resolves to the first file and
``[variance.yaml]`` to the second.
"""

from __future__ import annotations

import ast
import json
import os
from pathlib import Path
from typing import Any, Iterable, Mapping, Optional, Union

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

    def copy(self) -> "Config":
        """A copy whose nested dicts are copied at every level; lists are
        shared."""
        return Config({k: (v.copy() if isinstance(v, dict) else v) for k, v in self.items()})

    def subset(self, keys: Iterable[str]) -> "Config":
        """The entries of ``keys`` that the config has."""
        return Config({k: self[k] for k in keys if k in self})

    def save(self, path: PathLike) -> None:
        """Write the config as YAML (``config.yaml`` of a work dir)."""
        import yaml

        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            yaml.safe_dump(_plain(self), f, sort_keys=True, allow_unicode=True)

    @staticmethod
    def from_yaml(path: PathLike) -> "Config":
        return load_config(path)


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


def coerce_value(s: str) -> Any:
    """A ``key=value`` override's value: a Python literal where it parses as
    one, ``true`` / ``false`` / ``null`` in any case, else the string."""
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        low = s.strip().lower()
        if low in ("true", "false"):
            return low == "true"
        if low in ("null", "none", "~"):
            return None
        return s


def parse_overrides(spec: Union[str, Mapping, None]) -> dict:
    """``"a.b=1,c=[2,3]"`` -> ``{"a": {"b": 1}, "c": [2, 3]}``; commas inside
    brackets do not split."""
    if not spec:
        return {}
    if isinstance(spec, Mapping):
        return dict(spec)
    items, depth, cur = [], 0, []
    for ch in spec:
        if ch in "[({":
            depth += 1
        elif ch in "])}":
            depth -= 1
        if ch == "," and depth == 0:
            items.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        items.append("".join(cur))
    out: dict = {}
    for item in items:
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form key=value")
        k, v = item.split("=", 1)
        node = out
        parts = k.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = coerce_value(v)
    return out


def load_config(
    config_path: Optional[PathLike] = None,
    *,
    exp_name: Optional[str] = None,
    work_dir_root: PathLike = "checkpoints",
    overrides: Union[str, Mapping, None] = None,
    reset: bool = False,
    infer: bool = False,
    save: bool = False,
) -> Config:
    """Precedence (lowest to highest): base_config chain < file itself <
    saved work-dir ``config.yaml`` / ``config.json`` (unless ``reset``) <
    ``overrides``.  ``save`` writes the result to the work dir's
    ``config.yaml``."""
    merged: dict = {}
    if config_path is not None:
        merged = _load_chain(Path(config_path))

    work_dir = None
    if exp_name:
        work_dir = Path(work_dir_root) / exp_name
        saved = next((p for p in (work_dir / "config.yaml", work_dir / "config.json")
                      if p.exists()), None)
        if saved is not None and not reset:
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

    deep_merge(merged, parse_overrides(overrides))
    merged["infer"] = infer

    from .compat import migrate_legacy_keys

    migrate_legacy_keys(merged)
    cfg = _wrap(merged)
    if save and work_dir is not None:
        cfg.save(work_dir / "config.yaml")
    return cfg


def acoustic_defaults() -> Config:
    """The shipped acoustic configuration (``base.yaml`` + ``acoustic.yaml``)."""
    return load_config(BUILTIN_CONFIG_DIR / "acoustic.json")


def variance_defaults() -> Config:
    """The shipped variance configuration (``base.yaml`` + ``variance.yaml``)."""
    return load_config(BUILTIN_CONFIG_DIR / "variance.json")
