"""Variance binarizer (the JAX package's ``preprocessing/variance_binarizer.py``):
score transcriptions (ph_num, note_seq, note_dur, note_glide), optionally
read from sibling ``.ds`` files (``prefer_ds``, cached), frame durations by
cumsum-round-diff, mel2ph and mel2note, ph2word from ph_num, the
phoneme-level mean MIDI by scatter averaging, note MIDI with nearest-rest
interpolation, the smoothed base pitch, pitch in semitones with its uv mask,
and energy, breathiness, voicing and tension taken from the ``.ds`` or
extracted.  MIDI and glide coverage summaries included.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

import numpy as np

from ..dsp.features import get_breathiness, get_energy, get_tension, get_voicing
from ..dsp.hnsep import DecomposedWaveform
from ..utils.audio import load_wav
from ..utils.curves import interp_f0, resample_align_curve, smooth_curve
from ..utils.music import hz_to_midi, midi_to_note, note_to_midi
from .align import dur_to_mel2x, frames_from_sec
from .base_binarizer import BaseBinarizer, BinarizationError, save_distribution

VARIANCE_ITEM_ATTRIBUTES = [
    "spk_id", "tokens", "ph_dur", "midi", "ph2word", "mel2ph",
    "note_midi", "note_rest", "note_dur", "note_glide", "mel2note",
    "base_pitch", "pitch", "uv",
    "energy", "breathiness", "voicing", "tension",
]
DS_INDEX_SEP = "#"


class VarianceBinarizer(BaseBinarizer):
    def __init__(self, cfg, device=None):
        super().__init__(cfg, data_attrs=VARIANCE_ITEM_ATTRIBUTES, device=device)
        self.use_glide_embed = cfg.get("use_glide_embed", False)
        glide_types = cfg.get("glide_types", [])
        assert "none" not in glide_types, (
            "Type name 'none' is reserved and should not appear in glide_types."
        )
        self.glide_map = {"none": 0, **{t: i + 1 for i, t in enumerate(glide_types)}}
        self.predict_variances = any(
            cfg.get(f"predict_{v}", False)
            for v in ("energy", "breathiness", "voicing", "tension")
        )
        self.prefer_ds = self.binarization_args.get("prefer_ds", False)
        self.cached_ds = {}

    def load_attr_from_ds(self, ds_id, name, attr, idx=0):
        item_name = f"{ds_id}:{name}"
        item_name_with_idx = f"{item_name}{DS_INDEX_SEP}{idx}"
        if item_name_with_idx in self.cached_ds:
            ds = self.cached_ds[item_name_with_idx][0]
        elif item_name in self.cached_ds:
            ds = self.cached_ds[item_name][idx]
        else:
            ds_path = self.raw_data_dirs[ds_id] / "ds" / f"{name}{DS_INDEX_SEP}{idx}.ds"
            cache_key = item_name_with_idx
            if not ds_path.exists():
                ds_path = self.raw_data_dirs[ds_id] / "ds" / f"{name}.ds"
                cache_key = item_name
            if not ds_path.exists():
                return None
            with open(ds_path, "r", encoding="utf8") as f:
                ds = json.load(f)
            if not isinstance(ds, list):
                ds = [ds]
            self.cached_ds[cache_key] = ds
            ds = ds[idx]
        return ds.get(attr)

    def load_meta_data(self, raw_data_dir: Path, ds_id, spk_id):
        cfg = self.cfg
        meta = {}
        with open(raw_data_dir / "transcriptions.csv", "r", encoding="utf8") as f:
            for label in csv.DictReader(f):
                item_name = label["name"]
                item_idx = (
                    int(item_name.rsplit(DS_INDEX_SEP, 1)[-1])
                    if DS_INDEX_SEP in item_name else 0
                )

                def require(attr, optional=False):
                    value = (
                        self.load_attr_from_ds(ds_id, item_name, attr, item_idx)
                        if self.prefer_ds else None
                    )
                    if value is None:
                        value = label.get(attr)
                    if value is None and not optional:
                        raise ValueError(
                            f"Missing required attribute {attr} of item '{item_name}'."
                        )
                    return value

                d = {
                    "ds_idx": item_idx,
                    "spk_id": spk_id,
                    "spk_name": self.speakers[ds_id],
                    "wav_fn": str(raw_data_dir / "wavs" / f"{item_name}.wav"),
                    "ph_seq": require("ph_seq").split(),
                    "ph_dur": [float(x) for x in require("ph_dur").split()],
                }
                assert len(d["ph_seq"]) == len(d["ph_dur"]), (
                    f"Lengths of ph_seq and ph_dur mismatch in '{item_name}'."
                )
                assert all(x >= 0 for x in d["ph_dur"]), (
                    f"Negative ph_dur found in '{item_name}'."
                )
                if cfg["predict_dur"]:
                    d["ph_num"] = [int(x) for x in require("ph_num").split()]
                    assert len(d["ph_seq"]) == sum(d["ph_num"]), (
                        f"Sum of ph_num does not equal length of ph_seq in '{item_name}'."
                    )
                if cfg["predict_pitch"]:
                    d["note_seq"] = require("note_seq").split()
                    d["note_dur"] = [float(x) for x in require("note_dur").split()]
                    assert all(x >= 0 for x in d["note_dur"]), (
                        f"Negative note_dur found in '{item_name}'."
                    )
                    assert len(d["note_seq"]) == len(d["note_dur"]), (
                        f"Lengths of note_seq and note_dur mismatch in '{item_name}'."
                    )
                    assert any(n != "rest" for n in d["note_seq"]), (
                        f"All notes are rest in '{item_name}'."
                    )
                    if self.use_glide_embed:
                        note_glide = require("note_glide", optional=True)
                        if note_glide is None:
                            note_glide = ["none"] * len(d["note_seq"])
                        else:
                            note_glide = note_glide.split()
                            assert len(note_glide) == len(d["note_seq"]), (
                                f"Lengths of note_seq and note_glide mismatch in '{item_name}'."
                            )
                            assert all(g in self.glide_map for g in note_glide), (
                                f"Invalid glide type found in '{item_name}'."
                            )
                        d["note_glide"] = note_glide
                meta[f"{ds_id}:{item_name}"] = d
        self.items.update(meta)

    def check_coverage(self):
        super().check_coverage()
        if not self.cfg["predict_pitch"]:
            return
        midi_map = {}
        for item_name in self.items:
            for note in self.items[item_name]["note_seq"]:
                if note == "rest":
                    continue
                m = note_to_midi(note, round_midi=True)
                midi_map[m] = midi_map.get(m, 0) + 1
        print("===== MIDI Pitch Distribution Summary =====")
        for i, key in enumerate(sorted(midi_map.keys())):
            end = "\n" if i == len(midi_map) - 1 else ",\n" if i % 10 == 9 else ", "
            print(f"'{midi_to_note(key)}': {midi_map[key]}", end=end)
        midis = sorted(midi_map.keys())
        keys = range(midis[0], midis[-1] + 1)
        save_distribution(self.binary_data_dir, "midi_distribution.jpg",
                          "MIDI Pitch Distribution Summary", "MIDI Key",
                          [midi_to_note(m) for m in keys], [midi_map.get(m, 0) for m in keys])

        if self.use_glide_embed:
            glide_count = {g: 0 for g in self.glide_map}
            for item_name in self.items:
                for glide in self.items[item_name]["note_glide"]:
                    if glide == "none" or glide not in self.glide_map:
                        glide_count["none"] += 1
                    else:
                        glide_count[glide] += 1
            print("===== Glide Type Distribution Summary =====")
            print(", ".join(f"'{k}': {v}" for k, v in glide_count.items()))
            if any(n == 0 for n in glide_count.values()):
                raise BinarizationError(
                    "Missing glide types in dataset: "
                    f"{sorted([g for g, n in glide_count.items() if n == 0], key=lambda k: self.glide_map[k])}"
                )

    def process_item(self, item_name, meta_data, binarization_args):
        cfg = self.cfg
        ds_id, name = item_name.split(":", 1)
        name = name.rsplit(DS_INDEX_SEP, 1)[0]
        ds_id = int(ds_id)
        ds_seg_idx = meta_data["ds_idx"]
        seconds = sum(meta_data["ph_dur"])
        length = round(seconds / self.timestep)
        T_ph = len(meta_data["ph_seq"])
        item = {
            "name": item_name,
            "wav_fn": meta_data["wav_fn"],
            "spk_id": meta_data["spk_id"],
            "spk_name": meta_data["spk_name"],
            "seconds": seconds,
            "length": length,
            "tokens": np.array(self.phone_encoder.encode(meta_data["ph_seq"]), np.int64),
        }
        ph_dur_sec = np.asarray(meta_data["ph_dur"], np.float32)
        ph_dur = frames_from_sec(ph_dur_sec, self.timestep)
        item["ph_dur"] = ph_dur
        mel2ph = dur_to_mel2x(ph_dur, length)
        if cfg["predict_pitch"] or self.predict_variances:
            item["mel2ph"] = mel2ph

        # waveform / f0
        wav_path = Path(meta_data["wav_fn"])
        if wav_path.exists():
            with self.stage("load"):
                waveform, _ = load_wav(wav_path, sr=cfg["audio_sample_rate"], mono=True)
        elif not self.prefer_ds:
            raise FileNotFoundError(meta_data["wav_fn"])
        else:
            waveform = None

        f0 = uv = None
        if self.prefer_ds:
            f0_seq = self.load_attr_from_ds(ds_id, name, "f0_seq", idx=ds_seg_idx)
            if f0_seq is not None:
                f0 = resample_align_curve(
                    np.array(f0_seq.split(), np.float32),
                    original_timestep=float(
                        self.load_attr_from_ds(ds_id, name, "f0_timestep", idx=ds_seg_idx)
                    ),
                    target_timestep=self.timestep,
                    align_length=length,
                )
                uv = f0 == 0
                f0, _ = interp_f0(f0, uv)
        if f0 is None:
            with self.stage("pitch"):
                f0, uv = self.pitch_extractor.get_pitch(
                    waveform, cfg["audio_sample_rate"], length, hop_size=cfg["hop_size"],
                    f0_min=cfg["f0_min"], f0_max=cfg["f0_max"], interp_uv=True)
        if uv.all():
            print(f"Skipped '{item_name}': empty gt f0")
            return None
        pitch = hz_to_midi(np.asarray(f0, np.float32)).astype(np.float32)

        if cfg["predict_dur"]:
            ph_num = np.asarray(meta_data["ph_num"], np.int64)
            item["ph2word"] = dur_to_mel2x(ph_num, T_ph)
            mel2dur = np.take(np.insert(ph_dur.astype(np.float64), 0, 1), mel2ph)
            ph_midi = np.zeros(T_ph + 1)
            np.add.at(ph_midi, mel2ph, pitch / mel2dur)
            item["midi"] = np.clip(np.round(ph_midi[1:]), 0, 127).astype(np.int64)

        if cfg["predict_pitch"]:
            note_midi = np.array(
                [note_to_midi(n, round_midi=False) if n != "rest" else -1
                 for n in meta_data["note_seq"]],
                np.float32,
            )
            note_rest = note_midi < 0
            idx_known = np.where(~note_rest)[0]
            idx_rest = np.where(note_rest)[0]
            if len(idx_rest) > 0:
                nearest = idx_known[
                    np.abs(idx_rest[:, None] - idx_known[None, :]).argmin(axis=1)
                ]
                note_midi[idx_rest] = note_midi[nearest]
            item["note_midi"] = note_midi
            item["note_rest"] = note_rest
            note_dur = frames_from_sec(np.asarray(meta_data["note_dur"], np.float32),
                                       self.timestep)
            item["note_dur"] = note_dur
            mel2note = dur_to_mel2x(note_dur, length)
            item["mel2note"] = mel2note
            if self.use_glide_embed:
                item["note_glide"] = np.array(
                    [self.glide_map.get(x, 0) for x in meta_data["note_glide"]], np.int64
                )
            frame_midi = np.take(np.insert(note_midi, 0, 0.0), mel2note)
            item["base_pitch"] = smooth_curve(
                frame_midi.astype(np.float32),
                round(cfg["midi_smooth_width"] / self.timestep),
            )

        if cfg["predict_pitch"] or self.predict_variances:
            item["pitch"] = pitch
            item["uv"] = uv

        smooth_n = lambda key: round(cfg[f"{key}_smooth_width"] / self.timestep)  # noqa: E731

        def curve_from_ds_or(fallback, attr):
            if self.prefer_ds:
                seq = self.load_attr_from_ds(ds_id, name, attr, idx=ds_seg_idx)
                if seq is not None:
                    return resample_align_curve(
                        np.array(seq.split(), np.float32),
                        original_timestep=float(self.load_attr_from_ds(
                            ds_id, name, f"{attr}_timestep", idx=ds_seg_idx
                        )),
                        target_timestep=self.timestep,
                        align_length=length,
                    ), False
            return fallback(), True

        dw = None
        if waveform is not None:
            with self.stage("separation"):
                dw = DecomposedWaveform(
                    waveform, cfg["audio_sample_rate"], f0 * ~uv, hop_size=cfg["hop_size"],
                    fft_size=cfg["fft_size"], win_size=cfg["win_size"],
                    algorithm=cfg.get("hnsep", "world"), model_path=cfg.get("hnsep_ckpt"),
                    device=self.device)
                # without .ds curves the harmonic part is needed: time it here
                if not self.prefer_ds and any(cfg.get(f"predict_{v}", False)
                                              for v in ("breathiness", "voicing", "tension")):
                    dw.harmonic()
        with self.stage("curves"):
            if cfg.get("predict_energy", False):
                energy, from_wav = curve_from_ds_or(
                    lambda: get_energy(waveform, length, hop_size=cfg["hop_size"],
                                       win_size=cfg["win_size"]),
                    "energy",
                )
                item["energy"] = smooth_curve(energy, smooth_n("energy")) if from_wav else energy
            if cfg.get("predict_breathiness", False):
                b, from_wav = curve_from_ds_or(
                    lambda: get_breathiness(dw, length=length), "breathiness"
                )
                item["breathiness"] = smooth_curve(b, smooth_n("breathiness")) if from_wav else b
            if cfg.get("predict_voicing", False):
                v, from_wav = curve_from_ds_or(lambda: get_voicing(dw, length=length), "voicing")
                item["voicing"] = smooth_curve(v, smooth_n("voicing")) if from_wav else v
            if cfg.get("predict_tension", False):
                t, from_wav = curve_from_ds_or(
                    lambda: get_tension(dw, length=length, domain="logit"), "tension"
                )
                t = smooth_curve(t, smooth_n("tension")) if from_wav else t
                if np.isnan(t).any():
                    print("Error:", item_name)
                    return None
                item["tension"] = t
            return item
