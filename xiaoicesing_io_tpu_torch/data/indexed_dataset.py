"""Random-access binarized dataset: one HDF5 file of items.

Counterpart of the JAX package's ``data/indexed_dataset.py``, on the same
format: one group per item number, one dataset per attribute; the builder
keeps only the ``allowed_attr`` attributes and numbers items itself unless
told otherwise.  Sets binarized by the JAX package or the reference load as
they are, and sets written here load there.  The file goes through
:mod:`.hdf5`, the numpy reader and writer of the subset of HDF5 these sets
use, so no HDF5 library is needed.  Items are dicts of numpy arrays; a 0-d
value comes back as a Python scalar.
"""

from __future__ import annotations

import pathlib
import threading
from collections import deque
from typing import Dict, Iterable, Optional

from .hdf5 import H5Reader, H5Writer


class IndexedDataset:
    def __init__(self, path, prefix: str, num_cache: int = 0):
        self.path = pathlib.Path(path) / f"{prefix}.data"
        if not self.path.exists():
            raise FileNotFoundError(f"IndexedDataset not found: {self.path}")
        self.reader: Optional[H5Reader] = None
        self.groups: Dict[str, int] = {}  # item number -> its group's object header
        self.cache = deque(maxlen=num_cache)
        self.num_cache = num_cache
        self._open_lock = threading.Lock()

    def _ensure_open(self):
        # a prefetch thread pool can race two threads through the first
        # access; without the lock both would open the file and one handle
        # would leak
        if self.reader is None:
            with self._open_lock:
                if self.reader is None:
                    reader = H5Reader(self.path)
                    self.groups = reader.links(reader.root)
                    self.reader = reader

    def __getitem__(self, i: int) -> dict:
        self._ensure_open()
        if i < 0 or i >= len(self.groups):
            raise IndexError("index out of range")
        if self.num_cache > 0:
            for c in self.cache:
                if c[0] == i:
                    return c[1]
        item = {}
        for k, addr in self.reader.links(self.groups[str(i)]).items():
            v = self.reader.read(addr)
            item[k] = v.item() if v.shape == () else v
        if self.num_cache > 0:
            self.cache.appendleft((i, item))
        return item

    def __len__(self):
        self._ensure_open()
        return len(self.groups)

    def close(self):
        if self.reader is not None:
            self.reader.close()
            self.reader = None


class IndexedDatasetBuilder:
    def __init__(self, path, prefix: str, allowed_attr: Optional[Iterable[str]] = None,
                 auto_increment: bool = True):
        self.path = pathlib.Path(path) / f"{prefix}.data"
        self.prefix = prefix
        self.dset = H5Writer(self.path)
        self.counter = 0
        self.auto_increment = auto_increment
        self.allowed_attr = set(allowed_attr) if allowed_attr is not None else None

    def add_item(self, item: Dict, item_no: Optional[int] = None) -> int:
        if (self.auto_increment and item_no is not None) or (
            not self.auto_increment and item_no is None
        ):
            raise ValueError("auto_increment and provided item_no are mutually exclusive")
        if self.allowed_attr is not None:
            item = {k: item[k] for k in self.allowed_attr if k in item}
        if self.auto_increment:
            item_no = self.counter
            self.counter += 1
        self.dset.add_group(str(item_no), {k: v for k, v in item.items() if v is not None})
        return item_no

    def finalize(self):
        self.dset.close()
