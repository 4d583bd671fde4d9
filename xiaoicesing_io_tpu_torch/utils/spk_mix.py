"""Command-line speaker mixes (copy of the JAX package's ``utils/spk_mix.py``).

"a" / "a|b" / "a:0.5|b:0.5" -> normalised {name: proportion}; speakers
given without a proportion share what the others leave.
"""

from __future__ import annotations

import re
from typing import Dict


def parse_commandline_spk_mix(mix: str) -> Dict[str, float]:
    name_pattern = r"[0-9A-Za-z_-]+"
    proportion_pattern = r"\d+(\.\d+)?"
    single = rf"{name_pattern}(:{proportion_pattern})?"
    assert re.fullmatch(rf"{single}(\|{single})*", mix) is not None, \
        f"Invalid mix pattern: {mix}"
    without_proportion = set()
    proportion_map: Dict[str, float] = {}
    for component in mix.split("|"):
        parts = component.split(":")
        assert parts[0] not in without_proportion and parts[0] not in proportion_map, \
            f"Duplicate speaker name: {parts[0]}"
        if ":" in component:
            proportion_map[parts[0]] = float(parts[1])
        else:
            without_proportion.add(parts[0])
    given = sum(proportion_map.values())
    assert given < 1 or len(without_proportion) == 0, (
        "Proportion of all speakers should be specified if the sum of all "
        "given proportions are larger than 1."
    )
    for name in without_proportion:
        proportion_map[name] = (1 - given) / len(without_proportion)
    total = sum(proportion_map.values())
    assert total > 0, "Sum of all proportions should be positive."
    return {k: v / total for k, v in proportion_map.items()}
