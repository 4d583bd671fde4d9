"""Phoneme token <-> id mapping.

The reference DiffSinger ``TokenTextEncoder``: a sorted phoneme vocabulary with
``<PAD>`` pinned to id 0 and all real phonemes at 1-based ids, so token id 0
doubles as the padding / "no phoneme" sentinel that masks carry through the
whole model stack.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Union

import numpy as np

PAD = "<PAD>"
PAD_INDEX = 0


class TokenTextEncoder:
    def __init__(self, vocab_list: Iterable[str]):
        self.vocab_list: List[str] = sorted(vocab_list)
        self._index = {ph: i + 1 for i, ph in enumerate(self.vocab_list)}

    def encode(self, sentence: Union[str, Sequence[str]]) -> List[int]:
        phones = sentence.strip().split() if isinstance(sentence, str) else sentence
        return [PAD_INDEX if ph == PAD else self._index[ph] for ph in phones]

    def decode(self, ids, strip_padding: bool = False) -> str:
        ids = np.asarray(list(ids))
        if strip_padding:
            ids = np.trim_zeros(ids)
        return " ".join(self.vocab_list[i - 1] if i >= 1 else PAD for i in ids.tolist())

    @property
    def vocab_size(self) -> int:
        return len(self.vocab_list) + 1

    def __len__(self) -> int:
        return self.vocab_size

    def store_to_file(self, filename) -> None:
        with open(filename, "w", encoding="utf8") as f:
            f.write(PAD + "\n")
            for tok in self.vocab_list:
                f.write(tok + "\n")
