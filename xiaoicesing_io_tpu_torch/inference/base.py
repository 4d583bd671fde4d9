"""Shared plumbing of the SVS inference runners: the speaker map and mixes.

Counterpart of the JAX package's ``inference/base.py``: with ``use_spk_id``
the runner reads ``spk_map.json`` from the work dir (a non-empty name -> id
map without duplicate ids), and :meth:`BaseSVSInfer.load_speaker_mix` turns
a segment's ``spk_mix`` (frame level) or ``ph_spk_mix`` (token level) into
ids and proportions: one speaker (solo), fixed proportions (static) or
proportion curves (dynamic), checked and normalised to sum to 1.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.curves import resample_align_curve


def speaker_mix_embed(table: torch.Tensor, spk_mix_id: torch.Tensor,
                      spk_mix_value: torch.Tensor) -> torch.Tensor:
    """The speakers' embeddings ``table[spk_mix_id]`` weighted by their
    proportions ``[B, T|1, N]`` and summed: ``[B, T|1, H]``."""
    return (table[spk_mix_id] * spk_mix_value[..., None]).sum(dim=2)


class BaseSVSInfer:
    def __init__(self, cfg):
        self.cfg = cfg
        self.timestep = cfg["hop_size"] / cfg["audio_sample_rate"]
        self.spk_map: Dict[str, int] = {}
        if cfg.get("use_spk_id", False):
            with open(Path(cfg["work_dir"]) / "spk_map.json", "r", encoding="utf8") as f:
                self.spk_map = json.load(f)
            assert isinstance(self.spk_map, dict) and len(self.spk_map) > 0, \
                "Invalid or empty speaker map!"
            assert len(self.spk_map) == len(set(self.spk_map.values())), \
                "Duplicate speaker id in speaker map!"

    def load_speaker_mix(self, param_src: dict, summary_dst: dict, mix_mode: str = "frame",
                         mix_length: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """-> (``spk_mix_id`` int ``[1, 1, N]``, ``spk_mix_value`` float
        ``[1, T|1, N]``): ``T`` = ``mix_length`` for a dynamic mix, 1 else.
        Without a mix in ``param_src`` the first speaker of the map sings solo."""
        assert mix_mode in ("token", "frame")
        param_key = "spk_mix" if mix_mode == "frame" else "ph_spk_mix"
        summary_solo_key = "spk" if mix_mode == "frame" else "ph_spk"
        spk_mix_map = param_src.get(param_key)
        dynamic = False
        if spk_mix_map is None:
            spk_mix_map = {next(iter(self.spk_map.keys())): 1.0}
        else:
            for name in spk_mix_map:
                assert name in self.spk_map, f"Speaker '{name}' not found."
        if len(spk_mix_map) == 1:
            summary_dst[summary_solo_key] = list(spk_mix_map.keys())[0]
        elif any(isinstance(v, str) for v in spk_mix_map.values()):
            summary_dst[param_key] = f"dynamic({'|'.join(spk_mix_map.keys())})"
            dynamic = True
        else:
            mix = "|".join(f"{n}:{spk_mix_map[n]:.3f}" for n in spk_mix_map)
            summary_dst[param_key] = f"static({mix})"

        ids, values = [], []
        if dynamic:
            for name, val in spk_mix_map.items():
                ids.append(self.spk_map[name])
                if isinstance(val, str):
                    arr = np.array(val.split(), np.float32)
                    if mix_mode == "token":
                        assert len(arr) == mix_length, (
                            "Speaker mix checks failed. In dynamic token-level mix, "
                            "number of proportion values must equal number of tokens."
                        )
                        cur = arr
                    else:
                        cur = resample_align_curve(arr, float(param_src["spk_mix_timestep"]),
                                                   self.timestep, mix_length)
                    assert (cur >= 0).all(), (
                        f"Speaker mix checks failed.\nProportions of speaker "
                        f"'{name}' on some {mix_mode}s are negative."
                    )
                else:
                    assert val >= 0, (
                        f"Speaker mix checks failed.\nProportion of speaker '{name}' is negative."
                    )
                    cur = np.full(mix_length, val, np.float32)
                values.append(cur)
            spk_mix_id = np.asarray(ids, np.int32)[None, None]
            spk_mix_value = np.stack(values, axis=1)[None]  # [1, T, N]
            s = spk_mix_value.sum(axis=2, keepdims=True)
            assert (s > 0).all(), (
                "Speaker mix checks failed.\nProportions of speaker mix on some frames sum to zero."
            )
            spk_mix_value = spk_mix_value / s
        else:
            for name, val in spk_mix_map.items():
                ids.append(self.spk_map[name])
                assert val >= 0, (
                    f"Speaker mix checks failed.\nProportion of speaker '{name}' is negative."
                )
                values.append(val)
            spk_mix_id = np.asarray(ids, np.int32)[None, None]
            spk_mix_value = np.asarray(values, np.float32)[None, None]  # [1, 1, N]
            s = spk_mix_value.sum()
            assert s > 0, "Speaker mix checks failed.\nProportions of speaker mix sum to zero."
            spk_mix_value = spk_mix_value / s
        return spk_mix_id, spk_mix_value
