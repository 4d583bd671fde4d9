"""Binarized datasets and their batch collators.

Counterpart of the JAX package's ``data/dataset.py``: a set is the
``<prefix>.data`` item store (:mod:`.indexed_dataset`) and the
``<prefix>.meta`` pickle beside it (item lengths under ``lengths`` or the
config's ``dataset_size_key``, names, per-attribute lengths).  The collators
pad frames to multiples of :data:`FRAME_BUCKET` and tokens and notes to
multiples of :data:`TOKEN_BUCKET`, and return numpy batches equal to the JAX
package's key for key, in dtype and shape.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..utils import collate_nd
from .indexed_dataset import IndexedDataset

FRAME_BUCKET = 128
TOKEN_BUCKET = 32

#: auto-preload limit: a set whose ``.data`` file is smaller is held in RAM
PRELOAD_AUTO_MAX_BYTES = 512 * 1024 * 1024


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class BaseDataset:
    def __init__(self, data_dir, prefix: str, size_key: str = "lengths",
                 preload: Optional[bool] = None):
        """``preload``: True/False force; None = preload iff the ``.data``
        file is under :data:`PRELOAD_AUTO_MAX_BYTES`."""
        self.data_dir = Path(data_dir)
        self.prefix = prefix
        with open(self.data_dir / f"{prefix}.meta", "rb") as f:
            self.metadata = pickle.load(f)
        self.sizes = np.asarray(self.metadata[size_key])
        self._ds = IndexedDataset(self.data_dir, prefix)
        self._preloaded = None
        if preload is None:
            try:
                preload = (self.data_dir / f"{prefix}.data").stat().st_size \
                    < PRELOAD_AUTO_MAX_BYTES
            except OSError:
                preload = False
        if preload:
            self._preloaded = [self._ds[i] for i in range(len(self._ds))]

    def __len__(self):
        return len(self.sizes)

    def num_frames(self, index: int) -> int:
        return int(self.sizes[index])

    def attr_len(self, key: str, index: int) -> int:
        """Length of attribute ``key`` of item ``index``, from the metadata
        alone (no read of the item)."""
        return int(self.metadata[key][index])

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self._preloaded is not None:
            return self._preloaded[index]
        return self._ds[index]


class AcousticDataset(BaseDataset):
    def __init__(self, data_dir, prefix, cfg, preload=None):
        if preload is None:
            preload = cfg.get("dataset_preload", None)
        super().__init__(data_dir, prefix, size_key=cfg.get("dataset_size_key", "lengths"),
                         preload=preload)
        self.cfg = cfg
        self.required_variances = [
            v for v in ("energy", "breathiness", "voicing", "tension")
            if cfg.get(f"use_{v}_embed", False)
        ]

    def collate(self, indices: List[int], pad_to_bucket: bool = True,
                pad_batch_to: int = 0, pad_frames_to: int = 0,
                pad_tokens_to: int = 0) -> Dict[str, np.ndarray]:
        """``pad_frames_to`` / ``pad_tokens_to`` are minimum padded lengths;
        ``pad_batch_to`` adds all-zero rows up to that many."""
        samples = [self[i] for i in indices]
        T_f = max(max(s["mel"].shape[0] for s in samples), pad_frames_to)
        T_ph = max(max(len(s["tokens"]) for s in samples), pad_tokens_to)
        if pad_to_bucket:
            T_f = _round_up(T_f, FRAME_BUCKET)
            T_ph = _round_up(T_ph, TOKEN_BUCKET)
        n = max(len(samples), pad_batch_to)
        batch = {
            "tokens": collate_nd([s["tokens"] for s in samples], max_len=T_ph,
                                 dtype=np.int32, rows=n),
            "mel": collate_nd([s["mel"] for s in samples], max_len=T_f,
                              dtype=np.float32, rows=n),
            "mel2ph": collate_nd([s["mel2ph"] for s in samples], max_len=T_f,
                                 dtype=np.int32, rows=n),
            "f0": collate_nd([s["f0"] for s in samples], max_len=T_f,
                             dtype=np.float32, rows=n),
        }
        for v in self.required_variances:
            batch[v] = collate_nd([s[v] for s in samples], max_len=T_f,
                                  dtype=np.float32, rows=n)
        for key, on in (("key_shift", "use_key_shift_embed"), ("speed", "use_speed_embed")):
            if self.cfg.get(on, False):
                out = np.zeros((n, T_f), np.float32)
                out[: len(samples)] = np.asarray([s[key] for s in samples], np.float32)[:, None]
                batch[key] = out
        if self.cfg.get("use_spk_id", False):
            ids = np.zeros(n, np.int32)
            ids[: len(samples)] = [s["spk_id"] for s in samples]
            batch["spk_ids"] = ids
        return batch


class VarianceDataset(BaseDataset):
    def __init__(self, data_dir, prefix, cfg, preload=None):
        if preload is None:
            preload = cfg.get("dataset_preload", None)
        super().__init__(data_dir, prefix, size_key=cfg.get("dataset_size_key", "lengths"),
                         preload=preload)
        self.cfg = cfg
        self.predict_variances = [
            v for v in ("energy", "breathiness", "voicing", "tension")
            if cfg.get(f"predict_{v}", False)
        ]

    def collate(self, indices: List[int], pad_to_bucket: bool = True,
                pad_batch_to: int = 0, pad_frames_to: int = 0,
                pad_tokens_to: int = 0, pad_notes_to: int = 0) -> Dict[str, np.ndarray]:
        """``pad_*_to`` are minimum padded lengths; ``pad_batch_to`` adds
        all-zero rows up to that many."""
        cfg = self.cfg
        samples = [self[i] for i in indices]
        T_ph = max(max(len(s["tokens"]) for s in samples), pad_tokens_to)
        if pad_to_bucket:
            T_ph = _round_up(T_ph, TOKEN_BUCKET)
        n = max(len(samples), pad_batch_to)

        def frames(key, T, dtype, **kw):
            return collate_nd([s[key] for s in samples], max_len=T, dtype=dtype, rows=n, **kw)

        batch = {"tokens": frames("tokens", T_ph, np.int32),
                 "ph_dur": frames("ph_dur", T_ph, np.int32)}
        if cfg.get("predict_dur", True):
            batch["ph2word"] = frames("ph2word", T_ph, np.int32)
            batch["midi"] = frames("midi", T_ph, np.int32)
        if "mel2ph" in samples[0]:
            T_f = max(max(s["mel2ph"].shape[0] for s in samples), pad_frames_to)
            if pad_to_bucket:
                T_f = _round_up(T_f, FRAME_BUCKET)
            batch["mel2ph"] = frames("mel2ph", T_f, np.int32)
            batch["pitch"] = frames("pitch", T_f, np.float32)
            batch["uv"] = frames("uv", T_f, bool)
        if cfg.get("predict_pitch", True):
            T_n = max(max(s["note_midi"].shape[0] for s in samples), pad_notes_to)
            if pad_to_bucket:
                T_n = _round_up(T_n, TOKEN_BUCKET)
            batch["note_midi"] = frames("note_midi", T_n, np.float32, pad_value=-1.0)
            batch["note_rest"] = frames("note_rest", T_n, bool, pad_value=True)
            batch["note_dur"] = frames("note_dur", T_n, np.int32)
            if cfg.get("use_glide_embed", False):
                batch["note_glide"] = frames("note_glide", T_n, np.int32)
            batch["mel2note"] = frames("mel2note", batch["mel2ph"].shape[1], np.int32)
            batch["base_pitch"] = frames("base_pitch", batch["mel2ph"].shape[1], np.float32)
        for v in self.predict_variances:
            batch[v] = frames(v, batch["mel2ph"].shape[1], np.float32)
        if cfg.get("use_spk_id", False):
            ids = np.zeros(n, np.int32)
            ids[: len(samples)] = [s["spk_id"] for s in samples]
            batch["spk_ids"] = ids
        return batch
