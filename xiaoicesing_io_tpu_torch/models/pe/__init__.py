"""Pitch-extractor registry (the JAX package's ``models/pe/__init__.py``):
``pe`` names ``parselmouth`` (the built-in autocorrelation tracker,
Praat-style, so it answers the same config key), ``harvest`` (the
coarse-to-fine extractor of ``models/pe/harvest.py``) or ``rmvpe`` (the
neural extractor, on the card).  The first two run on the host.
"""

from __future__ import annotations


class AutocorrelationPE:
    """The built-in Boersma-style tracker (``dsp/pitch.py``)."""

    def get_pitch(self, waveform, samplerate, length, *, hop_size,
                  f0_min=65, f0_max=1100, speed=1, interp_uv=False):
        from ...dsp.pitch import get_pitch

        return get_pitch(waveform, samplerate, length, hop_size=hop_size,
                         f0_min=f0_min, f0_max=f0_max, speed=speed, interp_uv=interp_uv)


def initialize_pe(cfg, device=None):
    """The extractor ``cfg["pe"]`` names; RMVPE runs on ``device``."""
    pe = cfg.get("pe", "parselmouth")
    if pe == "parselmouth":
        return AutocorrelationPE()
    if pe == "harvest":
        from .harvest import HarvestPE

        return HarvestPE()
    if pe == "rmvpe":
        from .rmvpe import RMVPE

        return RMVPE(cfg["pe_ckpt"], device=device)
    raise ValueError(f" [x] Unknown f0 extractor: {pe}")
