"""Reading the JAX package's checkpoint directories without JAX.

The JAX package saves ``<work_dir>/model_ckpt_steps_{N}/`` with orbax's
``StandardCheckpointer`` and writes a ``meta.json`` (``step``, ``category``)
beside it last; a directory without ``meta.json`` is an interrupted save and
is never read.  Orbax stores the tree in ``_METADATA`` (plain JSON: each
leaf's path, with ``key_type`` 1 for a sequence index and 2 for a dict key,
and its ``value_type``) and each array as a zarr array named by the dotted
path (``params.fs2.txt_embed.embedding``), inside an OCDBT key-value store
whose nodes are zstd-compressed.  ``tensorstore`` reads that store; it needs
only numpy and ``ml_dtypes``, so the port reads the directory without
``jax``, ``flax`` or ``orbax``.  It is imported inside the reader alone: a
host without it (a GPU host with PyTorch alone) gets an ``ImportError`` that
names the ``convert_ckpt`` command, which writes the same checkpoint as a
reference-format ``.ckpt`` on a host that has it.

Counterpart of ``list_checkpoints``, ``latest_checkpoint`` and the restore
in ``load_checkpoint`` / ``load_params_for_inference`` of the JAX package's
``training/checkpoint.py``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from urllib.parse import quote
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

CKPT_DIR_RE = re.compile(r"model_ckpt_steps_(\d+)$")
SEQUENCE_KEY = 1  # key_type of a sequence index (2: a dict key)
# leaves orbax writes no data for: None (optax's EmptyState, a frozen
# parameter's moments) and the empty tuple (MultiSteps' skip_state)
EMPTY_VALUES = {"None": lambda: None, "Tuple": tuple}


def checkpoint_dir_step(path) -> int:
    return int(CKPT_DIR_RE.search(Path(path).name).group(1))


def list_checkpoints(work_dir) -> List[Path]:
    """The complete JAX checkpoint directories of ``work_dir`` (those with a
    ``meta.json``), by step."""
    work_dir = Path(work_dir)
    if not work_dir.exists():
        return []
    out = [p for p in work_dir.iterdir()
           if p.is_dir() and CKPT_DIR_RE.search(p.name) and (p / "meta.json").exists()]
    return sorted(out, key=checkpoint_dir_step)


def latest_checkpoint(work_dir) -> Optional[Path]:
    ckpts = list_checkpoints(work_dir)
    return ckpts[-1] if ckpts else None


def read_meta(path) -> Dict[str, Any]:
    return json.loads((Path(path) / "meta.json").read_text())


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading a JAX checkpoint directory needs the tensorstore package, which this "
            "host lacks; convert it where the JAX package is installed: python -m "
            "xiaoicesing_io_tpu_torch.cli convert_ckpt --exp <exp> (writes "
            "model_ckpt_steps_N.ckpt, which every command of this package reads)") from e
    return tensorstore


def _containers(node):
    """Nodes -> dicts, or lists where the keys were sequence indices,
    recursively."""
    if not isinstance(node, _Node):
        return node
    items = {k: _containers(v) for k, v in node.items.items()}
    if node.kind == SEQUENCE_KEY:
        if sorted(items) != list(range(len(items))):
            raise ValueError(f"a sequence of the tree has indices {sorted(items)}")
        return [items[i] for i in range(len(items))]
    return items


class _Node:
    """A container of the tree being rebuilt; its kind (sequence or dict) is
    the ``key_type`` of the keys that index it."""

    def __init__(self):
        self.kind: Optional[int] = None
        self.items: Dict[Any, Any] = {}

    def key(self, k: Dict[str, Any], where: str):
        kind = int(k["key_type"])
        if self.kind is None:
            self.kind = kind
        elif self.kind != kind:
            raise ValueError(f"{where}: the tree mixes sequence and dict keys at {k['key']!r}")
        return int(k["key"]) if kind == SEQUENCE_KEY else k["key"]


def read_checkpoint(path, subtree: Optional[str] = None) -> Tuple[Any, Dict[str, Any]]:
    """``(tree, meta)`` of the JAX checkpoint directory ``path``: the nested
    tree orbax's ``StandardCheckpointer().restore(path)`` returns (dicts,
    lists for sequences, ``None`` and empty tuples where orbax stores no
    data, numpy arrays at the leaves; bf16 leaves as ``ml_dtypes`` arrays)
    and ``meta.json``.  With ``subtree`` (``"params"``), only the leaves
    under that top-level key are read, and the tree is that key's."""
    ts = _tensorstore()
    path = Path(path).resolve()
    meta = read_meta(path)
    info = json.loads((path / "_METADATA").read_text())
    if not info.get("use_ocdbt", True) or info.get("use_zarr3", False):
        raise ValueError(f"{path}: not the layout the JAX package saves (OCDBT, zarr v2)")
    store = f"file://{quote(str(path))}/|ocdbt:"
    context = ts.Context()
    root = _Node()
    reads = []
    for entry in info["tree_metadata"].values():
        keys = entry["key_metadata"]
        if subtree is not None and keys[0]["key"] != subtree:
            continue
        name = ".".join(str(k["key"]) for k in keys)
        node = root
        for k in keys[:-1]:
            node = node.items.setdefault(node.key(k, name), _Node())
        last = node.key(keys[-1], name)
        value = entry["value_metadata"]["value_type"]
        if value == "np.ndarray":
            url = f"{store}{quote(name, safe='')}/|zarr2:"
            reads.append((node.items, last, ts.open(url, open=True, read=True,
                                                    context=context)))
        elif value in EMPTY_VALUES:
            node.items[last] = EMPTY_VALUES[value]()
        else:
            raise ValueError(f"{path}: leaf {name} has value_type {value!r}, which this "
                             f"reader does not know")
    pending = [(holder, key, store.result().read()) for holder, key, store in reads]
    for holder, key, data in pending:
        holder[key] = np.asarray(data.result())
    tree = _containers(root)
    if subtree is not None:
        if subtree not in tree:
            raise KeyError(f"{path} has no {subtree!r} tree")
        tree = tree[subtree]
    return tree, meta

