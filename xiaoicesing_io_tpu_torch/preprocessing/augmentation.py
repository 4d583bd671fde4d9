"""Spectral-domain stretch augmentation, pitch shift and time stretch (the
JAX package's ``preprocessing/augmentation.py``): the mel recomputed with
keyshift and speed inside the STFT, f0 re-extracted at the new speed and
scaled by 2^(key_shift / 12), the variance curves resampled to the new
frame rate, the item's key set kept.

f0 is re-extracted with the built-in tracker (``dsp/pitch.py``) whatever
``pe`` names, as the JAX package does.
"""

from __future__ import annotations

from copy import deepcopy
from functools import wraps

import numpy as np

from ..dsp.pitch import get_pitch
from ..ops.mel import MelConfig, MelSpectrogram
from ..utils.audio import load_wav
from ..utils.curves import resample_align_curve
from .align import sec_to_mel2x

VARIANCE_CHECKLIST = ["energy", "breathiness", "voicing", "tension"]


def require_same_keys(fn):
    """An augmented item keeps exactly the key set of its source."""

    @wraps(fn)
    def wrapper(self, item, **kwargs):
        res = fn(self, item, **kwargs)
        assert set(res.keys()) == set(item.keys()), (
            "Augmentation must not change the key set of the data item.")
        return res

    return wrapper


class SpectrogramStretchAugmentation:
    def __init__(self, cfg, augmentation_args: dict):
        self.cfg = cfg
        self.augmentation_args = augmentation_args
        self.timestep = cfg["hop_size"] / cfg["audio_sample_rate"]
        self.mel_extractor = MelSpectrogram(MelConfig.from_config(cfg))

    @require_same_keys
    def process_item(self, item: dict, key_shift=0.0, speed=1.0, replace_spk_id=None) -> dict:
        cfg = self.cfg
        aug_item = deepcopy(item)
        waveform, _ = load_wav(aug_item["wav_fn"], sr=cfg["audio_sample_rate"], mono=True)
        mel = self.mel_extractor.numpy(waveform, keyshift=key_shift, speed=speed)
        aug_item["mel"] = mel.astype(np.float32)

        if speed != 1.0 or cfg.get("use_speed_embed", False):
            aug_item["length"] = mel.shape[0]
            real_speed = int(np.round(cfg["hop_size"] * speed)) / cfg["hop_size"]
            aug_item["speed"] = real_speed
            aug_item["seconds"] /= real_speed
            aug_item["ph_dur"] = aug_item["ph_dur"] / real_speed
            aug_item["mel2ph"] = sec_to_mel2x(aug_item["ph_dur"], aug_item["length"],
                                              self.timestep)
            f0, _ = get_pitch(
                waveform, cfg["audio_sample_rate"], aug_item["length"],
                hop_size=cfg["hop_size"], f0_min=cfg["f0_min"], f0_max=cfg["f0_max"],
                speed=speed, interp_uv=True,
            )
            aug_item["f0"] = f0.astype(np.float32)
            for v_name in VARIANCE_CHECKLIST:
                if v_name in item and isinstance(item[v_name], np.ndarray):
                    aug_item[v_name] = resample_align_curve(
                        aug_item[v_name], original_timestep=self.timestep,
                        target_timestep=self.timestep * real_speed,
                        align_length=aug_item["length"])

        if key_shift != 0.0 or cfg.get("use_key_shift_embed", False):
            if replace_spk_id is None:
                aug_item["key_shift"] = key_shift
            else:
                aug_item["spk_id"] = replace_spk_id
            aug_item["f0"] = aug_item["f0"] * 2 ** (key_shift / 12)

        return aug_item
