"""Acoustic binarizer (the JAX package's ``preprocessing/acoustic_binarizer.py``):
``transcriptions.csv`` (name, ph_seq, ph_dur) and wavs -> mel, mel2ph, f0
and the optional smoothed energy, breathiness, voicing and tension, with
pitch-shift and time-stretch augmentation arranged from the global
``random`` module in the JAX package's order of draws, so that a seeded run
gives its augmented set item for item.
"""

from __future__ import annotations

import csv
import random
from copy import deepcopy
from pathlib import Path

import numpy as np

from ..dsp.features import get_breathiness, get_energy, get_tension, get_voicing
from ..dsp.hnsep import DecomposedWaveform
from ..ops.mel import MelConfig, MelSpectrogram
from ..utils.audio import load_wav
from ..utils.curves import smooth_curve
from .align import sec_to_mel2x
from .augmentation import SpectrogramStretchAugmentation
from .base_binarizer import BaseBinarizer

ACOUSTIC_ITEM_ATTRIBUTES = [
    "spk_id", "mel", "tokens", "mel2ph", "f0",
    "energy", "breathiness", "voicing", "tension", "key_shift", "speed",
]


class AcousticBinarizer(BaseBinarizer):
    def __init__(self, cfg, device=None):
        super().__init__(cfg, data_attrs=ACOUSTIC_ITEM_ATTRIBUTES, device=device)
        self.need_energy = cfg.get("use_energy_embed", False)
        self.need_breathiness = cfg.get("use_breathiness_embed", False)
        self.need_voicing = cfg.get("use_voicing_embed", False)
        self.need_tension = cfg.get("use_tension_embed", False)
        assert cfg.get("mel_base", "e") == "e", "Mel base must be 'e'."
        self.mel_extractor = MelSpectrogram(MelConfig.from_config(cfg))

    def load_meta_data(self, raw_data_dir: Path, ds_id, spk_id):
        meta = {}
        with open(raw_data_dir / "transcriptions.csv", "r", encoding="utf-8") as f:
            for label in csv.DictReader(f):
                item_name = label["name"]
                d = {
                    "wav_fn": str(raw_data_dir / "wavs" / f"{item_name}.wav"),
                    "ph_seq": label["ph_seq"].split(),
                    "ph_dur": [float(x) for x in label["ph_dur"].split()],
                    "spk_id": spk_id,
                    "spk_name": self.speakers[ds_id],
                }
                assert len(d["ph_seq"]) == len(d["ph_dur"]), (
                    f"Lengths of ph_seq and ph_dur mismatch in '{item_name}'.")
                assert all(x >= 0 for x in d["ph_dur"]), (
                    f"Negative ph_dur found in '{item_name}'.")
                meta[f"{ds_id}:{item_name}"] = d
        self.items.update(meta)

    def process_item(self, item_name, meta_data, binarization_args):
        cfg = self.cfg
        with self.stage("load"):
            waveform, _ = load_wav(meta_data["wav_fn"], sr=cfg["audio_sample_rate"], mono=True)
        with self.stage("mel"):
            mel = self.mel_extractor.numpy(waveform).astype(np.float32)
        length = mel.shape[0]
        item = {
            "name": item_name,
            "wav_fn": meta_data["wav_fn"],
            "spk_id": meta_data["spk_id"],
            "spk_name": meta_data["spk_name"],
            "seconds": length * self.timestep,
            "length": length,
            "mel": mel,
            "tokens": np.array(self.phone_encoder.encode(meta_data["ph_seq"]), np.int64),
            "ph_dur": np.array(meta_data["ph_dur"], np.float32),
        }
        item["mel2ph"] = sec_to_mel2x(item["ph_dur"], length, self.timestep)

        with self.stage("pitch"):
            f0, uv = self.pitch_extractor.get_pitch(
                waveform, cfg["audio_sample_rate"], length, hop_size=cfg["hop_size"],
                f0_min=cfg["f0_min"], f0_max=cfg["f0_max"], interp_uv=True)
        if uv.all():
            print(f"Skipped '{item_name}': empty gt f0")
            return None
        item["f0"] = f0.astype(np.float32)

        smooth_n = lambda key: round(cfg[f"{key}_smooth_width"] / self.timestep)  # noqa: E731
        if self.need_energy:
            with self.stage("curves"):
                energy = get_energy(waveform, length, hop_size=cfg["hop_size"],
                                    win_size=cfg["win_size"])
                item["energy"] = smooth_curve(energy, smooth_n("energy"))

        if self.need_breathiness or self.need_voicing or self.need_tension:
            with self.stage("separation"):
                dw = DecomposedWaveform(
                    waveform, cfg["audio_sample_rate"], f0 * ~uv, hop_size=cfg["hop_size"],
                    fft_size=cfg["fft_size"], win_size=cfg["win_size"],
                    algorithm=cfg.get("hnsep", "world"), model_path=cfg.get("hnsep_ckpt"),
                    device=self.device)
                dw.harmonic()
            with self.stage("curves"):
                if self.need_breathiness:
                    item["breathiness"] = smooth_curve(get_breathiness(dw, length=length),
                                                       smooth_n("breathiness"))
                if self.need_voicing:
                    item["voicing"] = smooth_curve(get_voicing(dw, length=length),
                                                   smooth_n("voicing"))
                if self.need_tension:
                    tension = smooth_curve(get_tension(dw, length=length, domain="logit"),
                                           smooth_n("tension"))
            if self.need_tension:
                if np.isnan(tension).any():
                    print("Error:", item_name)
                    return None
                item["tension"] = tension

        if cfg.get("use_key_shift_embed", False):
            item["key_shift"] = 0.0
        if cfg.get("use_speed_embed", False):
            item["speed"] = 1.0
        return item

    def arrange_data_augmentation(self, data_iterator):
        """Augmentation tasks by item name.  The draws from ``random`` come in
        the JAX package's order: the random pitch shifts (``choices``, then a
        ``uniform`` each), the fixed shifts (``choices`` a target), the time
        stretches (``choices`` of raw items, ``choices`` of tasks, then a
        ``random`` each)."""
        cfg = self.cfg
        aug_map: dict = {}
        aug_list: list = []
        all_item_names = [name for name, _ in data_iterator]
        total_scale = 0.0

        def add(name, task):
            aug_map.setdefault(name, []).append(task)
            aug_list.append(task)

        rps = self.augmentation_args.get("random_pitch_shifting", {})
        if rps.get("enabled", False):
            key_shift_min, key_shift_max = rps["range"]
            assert cfg.get("use_key_shift_embed", False), (
                "Random pitch shifting augmentation requires use_key_shift_embed == True.")
            assert key_shift_min < 0 < key_shift_max
            aug_ins = SpectrogramStretchAugmentation(cfg, rps)
            scale = rps["scale"]
            for name in random.choices(all_item_names, k=int(scale * len(all_item_names))):
                rand = random.uniform(-1, 1)
                key_shift = key_shift_min * abs(rand) if rand < 0 else key_shift_max * rand
                add(name, {"name": name, "func": aug_ins.process_item,
                           "kwargs": {"key_shift": key_shift}})
            total_scale += scale

        fps = self.augmentation_args.get("fixed_pitch_shifting", {})
        if fps.get("enabled", False):
            targets = fps["targets"]
            scale = fps["scale"]
            spk_id_size = max(self.spk_ids) + 1
            assert not rps.get("enabled", False)
            assert len(targets) == len(set(targets))
            assert cfg.get("use_spk_id", False)
            assert cfg["num_spk"] >= (1 + len(targets)) * spk_id_size
            assert scale < 1
            aug_ins = SpectrogramStretchAugmentation(cfg, fps)
            for i, target in enumerate(targets):
                for name in random.choices(all_item_names, k=int(scale * len(all_item_names))):
                    replace = self.spk_ids[int(name.split(":", 1)[0])] + (i + 1) * spk_id_size
                    add(name, {"name": name, "func": aug_ins.process_item,
                               "kwargs": {"key_shift": target, "replace_spk_id": replace}})
            total_scale += scale * len(targets)

        rts = self.augmentation_args.get("random_time_stretching", {})
        if rts.get("enabled", False):
            speed_min, speed_max = rts["range"]
            assert cfg.get("use_speed_embed", False), (
                "Random time stretching augmentation requires use_speed_embed == True.")
            assert 0 < speed_min < 1 < speed_max
            aug_ins = SpectrogramStretchAugmentation(cfg, rts)
            scale = rts["scale"]
            k_from_raw = int(scale / (1 + total_scale) * len(all_item_names))
            k_from_aug = int(total_scale * scale / (1 + total_scale) * len(all_item_names))
            k_mutate = int(total_scale * scale / (1 + scale) * len(all_item_names))
            aug_types = [0] * k_from_raw + [1] * k_from_aug + [2] * k_mutate
            aug_items = random.choices(all_item_names, k=k_from_raw) + random.choices(
                aug_list, k=k_from_aug + k_mutate)
            for aug_type, aug_item in zip(aug_types, aug_items):
                speed = speed_min * (speed_max / speed_min) ** random.random()
                if aug_type == 0:
                    add(aug_item, {"name": aug_item, "func": aug_ins.process_item,
                                   "kwargs": {"speed": speed}})
                elif aug_type == 1:
                    task = {"name": aug_item["name"], "func": aug_item["func"],
                            "kwargs": deepcopy(aug_item["kwargs"])}
                    task["kwargs"]["speed"] = speed
                    add(aug_item["name"], task)
                else:
                    aug_item["kwargs"]["speed"] = speed
            total_scale += scale
        return aug_map
