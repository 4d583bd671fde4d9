"""Musical pitch conversions (librosa-free).

librosa semantics for ``note_to_midi``, ``midi_to_note``, ``hz_to_midi`` and
``midi_to_hz`` (key transposition of ``.ds`` files).
"""

from __future__ import annotations

import re

import numpy as np

_PITCH_CLASS = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
_ACC = {"#": 1, "♯": 1, "s": 1, "b": -1, "!": -1, "♭": -1, "𝄪": 2, "𝄫": -2, "♮": 0}
_NOTE_RE = re.compile(r"^([A-Ga-g])([#♯sb!♭𝄪𝄫♮]*)([+-]?\d+)?([+-]\d+)?$")
_NOTE_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]


def note_to_midi(note: str, round_midi: bool = False):
    m = _NOTE_RE.match(note)
    if m is None:
        raise ValueError(f"Improper note format: {note!r}")
    letter, accidentals, octave, cents = m.groups()
    offset = sum(_ACC[ch] for ch in accidentals)
    octave = int(octave) if octave else 0
    cents = int(cents) * 1e-2 if cents else 0.0
    value = 12 * (octave + 1) + _PITCH_CLASS[letter.upper()] + offset + cents
    return int(round(value)) if round_midi else value


def midi_to_note(midi, unicode: bool = False) -> str:
    m = int(round(midi))
    name = _NOTE_NAMES[m % 12]
    if unicode:
        name = name.replace("#", "♯")
    return f"{name}{m // 12 - 1}"


def hz_to_midi(f):
    f = np.asarray(f, dtype=np.float64)
    return 12.0 * (np.log2(np.maximum(f, 1e-10)) - np.log2(440.0)) + 69.0


def midi_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    return 440.0 * 2.0 ** ((m - 69.0) / 12.0)
