"""The binarizers' common base (the JAX package's
``preprocessing/base_binarizer.py``): per-speaker raw directories and the
speaker map, the train/valid split by ``test_prefixes``, the phoneme
coverage check with its distribution figure and hard mismatch error, item
processing (optionally over ``spawn`` workers), the augmentation fan-out,
and ``{prefix}.data`` (the port's numpy HDF5 codec) with its pickled
``{prefix}.meta`` of per-attribute lengths, names and speaker ids.
"""

from __future__ import annotations

import contextlib
import json
import pickle
import random
import shutil
import time
import warnings
from collections import defaultdict
from copy import deepcopy
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..data.indexed_dataset import IndexedDatasetBuilder
from ..utils import resolve_device
from ..utils.multiprocess import chunked_multiprocess_run
from ..utils.phonemes import PhonemeDictionary, locate_dictionary
from ..utils.plot import distribution_to_figure
from ..utils.text_encoder import TokenTextEncoder


class BinarizationError(Exception):
    pass


def save_distribution(directory: Path, filename: str, title: str, x_label: str, items,
                      values) -> None:
    """The distribution bar chart as ``directory / filename``, best effort."""
    try:
        fig = distribution_to_figure(title=title, x_label=x_label,
                                     y_label="Number of occurrences", items=items,
                                     values=values)
        if fig is None:
            print(f"| matplotlib is not installed: no {filename}")
            return
        fig.savefig(fname=directory / filename, bbox_inches="tight", pad_inches=0.25)
        print(f"| save summary to '{directory / filename}'")
    except Exception as e:  # noqa: BLE001 - a figure never stops binarization
        print(f"| WARN: failed to save {filename}: {e}")


class BaseBinarizer:
    """``device`` is where the pitch extractor and the separator run their
    nets (RMVPE, vocal remover); default CUDA, which raises without it.
    ``stage_seconds`` sums the wall seconds of each stage of the items this
    process binarized (load, mel, pitch, separation, curves, augmentation,
    write)."""

    def __init__(self, cfg, data_attrs: Optional[List[str]] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        data_dir = cfg["raw_data_dir"]
        if not isinstance(data_dir, list):
            data_dir = [data_dir]
        self.raw_data_dirs = [Path(d) for d in data_dir]
        self.binary_data_dir = Path(cfg["binary_data_dir"])
        self.data_attrs = data_attrs or []
        self.binarization_args = cfg["binarization_args"]
        self.augmentation_args = cfg.get("augmentation_args", {})

        self.spk_ids = list(cfg.get("spk_ids", []) or [])
        self.speakers = cfg["speakers"]
        self.spk_map = self.build_spk_map()

        self.stage_seconds: Dict[str, float] = defaultdict(float)
        self.items: Dict[str, dict] = {}
        self.item_names: Optional[list] = None
        self._train_item_names: Optional[list] = None
        self._valid_item_names: Optional[list] = None

        self.dictionary = PhonemeDictionary.load(
            locate_dictionary(cfg.get("dictionary"), cfg.get("work_dir")))
        self.phone_encoder = TokenTextEncoder(self.dictionary.phoneme_list)
        self.timestep = cfg["hop_size"] / cfg["audio_sample_rate"]
        from ..models.pe import initialize_pe

        self.pitch_extractor = initialize_pe(cfg, device=self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stage_seconds[name] += time.perf_counter() - t0

    def build_spk_map(self) -> Dict[str, int]:
        assert isinstance(self.speakers, list), "Speakers must be a list"
        assert len(self.speakers) == len(self.raw_data_dirs), (
            "Number of raw data dirs must equal number of speaker names!")
        if len(self.spk_ids) == 0:
            self.spk_ids = list(range(len(self.raw_data_dirs)))
        else:
            assert len(self.spk_ids) == len(self.raw_data_dirs), (
                "Length of explicitly given spk_ids must equal the number of raw datasets.")
        assert max(self.spk_ids) < self.cfg["num_spk"], (
            f"Index in spk_id sequence {self.spk_ids} is out of range. "
            "All values should be smaller than num_spk.")
        spk_map: Dict[str, int] = {}
        for spk_name, spk_id in zip(self.speakers, self.spk_ids):
            if spk_name in spk_map and spk_map[spk_name] != spk_id:
                raise ValueError(
                    f"Invalid speaker ID assignment. Name '{spk_name}' is assigned "
                    f"with different speaker IDs: {spk_map[spk_name]} and {spk_id}.")
            spk_map[spk_name] = spk_id
        print("| spk_map: ", spk_map)
        return spk_map

    def load_meta_data(self, raw_data_dir: Path, ds_id: int, spk_id: int):
        raise NotImplementedError()

    def split_train_valid_set(self, item_names):
        """``test_prefixes`` rules, in order: an exact item name, an exact name
        within a speaker, a name prefix, a prefix within a speaker."""
        prefixes = {str(pr): 1 for pr in self.cfg["test_prefixes"]}
        valid_item_names: Dict[str, int] = {}
        for prefix in deepcopy(prefixes):
            if prefix in item_names:
                valid_item_names[prefix] = 1
                prefixes.pop(prefix)
        for match in (lambda name, p: name.split(":")[-1] == p,
                      lambda name, p: name.startswith(p),
                      lambda name, p: name.split(":")[-1].startswith(p)):
            for prefix in deepcopy(prefixes):
                matched = False
                for name in item_names:
                    if match(name, prefix):
                        valid_item_names[name] = 1
                        matched = True
                if matched:
                    prefixes.pop(prefix)
        if len(prefixes) != 0:
            warnings.warn(
                "The following rules in test_prefixes have no matching names in "
                f"the dataset: {', '.join(prefixes.keys())}", category=UserWarning)
        valid = list(valid_item_names.keys())
        assert len(valid) > 0, "Validation set is empty!"
        train = [x for x in item_names if x not in set(valid)]
        assert len(train) > 0, "Training set is empty!"
        return train, valid

    @property
    def train_item_names(self):
        return self._train_item_names

    @property
    def valid_item_names(self):
        return self._valid_item_names

    def meta_data_iterator(self, prefix):
        names = self.train_item_names if prefix == "train" else self.valid_item_names
        for item_name in names:
            yield item_name, self.items[item_name]

    def process(self):
        for ds_id, (spk_id, data_dir) in enumerate(zip(self.spk_ids, self.raw_data_dirs)):
            self.load_meta_data(Path(data_dir), ds_id=ds_id, spk_id=spk_id)
        self.item_names = sorted(self.items.keys())
        self._train_item_names, self._valid_item_names = self.split_train_valid_set(
            self.item_names)
        if self.binarization_args.get("shuffle", False):
            random.shuffle(self.item_names)

        self.binary_data_dir.mkdir(parents=True, exist_ok=True)
        with open(self.binary_data_dir / "spk_map.json", "w", encoding="utf-8") as f:
            json.dump(self.spk_map, f)
        shutil.copy(locate_dictionary(self.cfg.get("dictionary"), self.cfg.get("work_dir")),
                    self.binary_data_dir / "dictionary.txt")
        self.check_coverage()
        self.process_dataset("valid")
        self.process_dataset(
            "train", num_workers=int(self.binarization_args.get("num_workers", 0)),
            apply_augmentation=any(
                args.get("enabled", False) for args in self.augmentation_args.values()))

    def check_coverage(self):
        ph_required = set(self.dictionary.phoneme_list)
        phoneme_map = {ph: 0 for ph in ph_required}
        ph_occurred: List[str] = []
        for item_name in self.items:
            ph_seq = self.items[item_name]["ph_seq"]
            if len(ph_seq) == 0:
                raise BinarizationError(f"Empty tokens in {item_name}.")
            ph_occurred += ph_seq
        for ph in ph_occurred:
            if ph in phoneme_map:
                phoneme_map[ph] += 1
        occurred = set(ph_occurred)

        print("===== Phoneme Distribution Summary =====")
        for i, key in enumerate(sorted(phoneme_map.keys())):
            end = "\n" if i == len(ph_required) - 1 else ",\n" if i % 10 == 9 else ", "
            print(f"'{key}': {phoneme_map[key]}", end=end)
        keys = sorted(phoneme_map.keys())
        save_distribution(self.binary_data_dir, "phoneme_distribution.jpg",
                          "Phoneme Distribution Summary", "Phoneme", keys,
                          [phoneme_map[k] for k in keys])

        if occurred != ph_required:
            raise BinarizationError(
                "transcriptions and dictionary mismatch.\n"
                f" (+) {sorted(occurred.difference(ph_required))}\n"
                f" (-) {sorted(ph_required.difference(occurred))}")

    def process_item(self, item_name, meta_data, binarization_args):
        raise NotImplementedError()

    def arrange_data_augmentation(self, data_iterator):
        """-> {item_name: [{'func': aug_fn, 'kwargs': {...}}, ...]}."""
        return {}

    def process_dataset(self, prefix, num_workers=0, apply_augmentation=False):
        builder = IndexedDatasetBuilder(self.binary_data_dir, prefix=prefix,
                                        allowed_attr=self.data_attrs)
        total_sec = {k: 0.0 for k in self.spk_map}
        total_raw_sec = {k: 0.0 for k in self.spk_map}
        extra_info = {"names": {}, "spk_ids": {}, "spk_names": {}, "lengths": {}}
        max_no = -1
        args = [[item_name, meta_data, self.binarization_args]
                for item_name, meta_data in self.meta_data_iterator(prefix)]
        aug_map = (self.arrange_data_augmentation(self.meta_data_iterator(prefix))
                   if apply_augmentation else {})

        def register(_item, item_no):
            nonlocal max_no
            max_no = max(max_no, item_no)
            for k, v in _item.items():
                if isinstance(v, np.ndarray):
                    extra_info.setdefault(k, {})[item_no] = v.shape[0]
            extra_info["names"][item_no] = _item["name"].split(":", 1)[-1]
            extra_info["spk_ids"][item_no] = _item["spk_id"]
            extra_info["spk_names"][item_no] = _item["spk_name"]
            extra_info["lengths"][item_no] = _item["length"]

        def postprocess(_item):
            if _item is None:
                return
            with self.stage("write"):
                register(_item, builder.add_item(_item))
            total_raw_sec[_item["spk_name"]] += _item["seconds"]
            total_sec[_item["spk_name"]] += _item["seconds"]
            for task in aug_map.get(_item["name"], []):
                with self.stage("augmentation"):
                    aug_item = task["func"](_item, **task["kwargs"])
                with self.stage("write"):
                    register(aug_item, builder.add_item(aug_item))
                total_sec[aug_item["spk_name"]] += aug_item["seconds"]

        try:
            if num_workers > 0:
                for item in chunked_multiprocess_run(self.process_item, args, num_workers):
                    postprocess(item)
            else:
                for a in args:
                    postprocess(self.process_item(*a))
            for k in extra_info:
                assert set(extra_info[k]) == set(range(max_no + 1)), (
                    "Item numbering is not consecutive.")
                extra_info[k] = [v for _, v in sorted(extra_info[k].items())]
        except KeyboardInterrupt:
            builder.finalize()
            raise
        builder.finalize()
        if prefix == "train":
            extra_info.pop("names")
            extra_info.pop("spk_names")
        with open(self.binary_data_dir / f"{prefix}.meta", "wb") as f:
            pickle.dump(extra_info, f)
        if apply_augmentation:
            ratio = sum(total_sec.values()) / max(sum(total_raw_sec.values()), 1e-9)
            print(f"| {prefix} total duration (before augmentation): "
                  f"{sum(total_raw_sec.values()):.2f}s")
            print(f"| {prefix} total duration (after augmentation): "
                  f"{sum(total_sec.values()):.2f}s ({ratio:.2f}x)")
        else:
            print(f"| {prefix} total duration: {sum(total_sec.values()):.2f}s")
