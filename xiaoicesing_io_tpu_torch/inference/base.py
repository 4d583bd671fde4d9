"""Shared plumbing of the SVS inference runners.

Counterpart of the JAX package's ``inference/base.py``.  Speaker mixes are not
ported yet: a config with ``use_spk_id`` raises ``NotImplementedError``.
"""

from __future__ import annotations


class BaseSVSInfer:
    def __init__(self, cfg):
        self.cfg = cfg
        self.timestep = cfg["hop_size"] / cfg["audio_sample_rate"]
        if cfg.get("use_spk_id", False):
            raise NotImplementedError(
                "speaker ids and speaker mixes are not ported yet (use_spk_id: true)"
            )
