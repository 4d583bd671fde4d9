"""Phoneme dictionary loading (grapheme -> phoneme sequence TSV).

Same behavior as the JAX package's ``utils/phonemes.py``, without
process-global state: a ``PhonemeDictionary`` object is built once and passed
where needed.  ``AP`` (aspiration) and ``SP`` (space/silence) are reserved
entries mapping to themselves.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

RESERVED = {"AP": ["AP"], "SP": ["SP"]}


class PhonemeDictionary:
    def __init__(self, mapping: Dict[str, List[str]]):
        self.mapping: Dict[str, List[str]] = dict(RESERVED)
        self.mapping.update(mapping)
        phones = set()
        for seq in self.mapping.values():
            phones.update(seq)
        self.phoneme_list: List[str] = sorted(phones)
        # two-part consonant-vowel split
        consonants, vowels = set(), set()
        for seq in self.mapping.values():
            if not seq or seq[0] in ("AP", "SP"):
                continue
            if len(seq) == 1:
                vowels.add(seq[0])
            else:
                consonants.add(seq[0])
                vowels.add(seq[1])
        self.consonants = sorted(consonants)
        self.vowels = sorted(vowels)

    @staticmethod
    def load(path) -> "PhonemeDictionary":
        mapping: Dict[str, List[str]] = {}
        with open(path, "r", encoding="utf8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                word, phones = line.split("\t")
                mapping[word] = phones.split()
        return PhonemeDictionary(mapping)

    def save_raw(self, path) -> None:
        with open(path, "w", encoding="utf8") as f:
            for word, seq in self.mapping.items():
                if word in RESERVED:
                    continue
                f.write(f"{word}\t{' '.join(seq)}\n")


def locate_dictionary(dictionary: Optional[str], work_dir: Optional[str] = None) -> Path:
    """Search order: the path itself, then the work dir."""
    if dictionary is not None:
        p = Path(dictionary)
        if p.exists():
            return p
        if work_dir is not None:
            for cand in (Path(work_dir) / p.name, Path(work_dir) / "dictionary.txt"):
                if cand.exists():
                    return cand
    elif work_dir is not None:
        cand = Path(work_dir) / "dictionary.txt"
        if cand.exists():
            return cand
    raise FileNotFoundError(
        f"Unable to locate dictionary file (dictionary={dictionary!r}, work_dir={work_dir!r})"
    )
