"""BOP dataset registry: object name <-> id and symmetric-object sets.

Public BOP-benchmark metadata (same facts as the reference's
`tools_for_BOP/common_dataset_info.py`). The port's copy of
`zebrapose_tpu/data/dataset_info.py`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

_LM_NAMES = ("ape", "benchvise", "bowl", "cam", "can", "cat", "cup",
             "driller", "duck", "eggbox", "glue", "holepuncher", "iron",
             "lamp", "phone")

_YCBV_NAMES = ("master_chef_can", "cracker_box", "sugar_box",
               "tomato_soup_can", "mustard_bottle", "tuna_fish_can",
               "pudding_box", "gelatin_box", "potted_meat_can", "banana",
               "pitcher_base", "bleach_cleanser", "bowl", "mug",
               "power_drill", "wood_block", "scissors", "large_marker",
               "large_clamp", "extra_large_clamp", "foam_brick")

# itodd objects WITHOUT symmetry (all others are symmetric)
_ITODD_ASYM_IDS = {1, 6, 10, 13, 15, 16, 20, 21, 22, 26}


def _numbered(n: int) -> Dict[str, int]:
    return {f"obj{i:02d}": i for i in range(1, n + 1)}


_REGISTRY: Dict[str, Tuple[Dict[str, int], frozenset]] = {
    "lm": ({n: i + 1 for i, n in enumerate(_LM_NAMES)},
           frozenset({"eggbox", "glue", "cup", "bowl"})),
    "lmo": ({n: i + 1 for i, n in enumerate(_LM_NAMES)},
            frozenset({"eggbox", "glue", "cup", "bowl"})),
    "ycbv": ({n: i + 1 for i, n in enumerate(_YCBV_NAMES)},
             frozenset({"bowl", "wood_block", "large_clamp",
                        "extra_large_clamp", "foam_brick"})),
    "tless": (_numbered(30), frozenset(_numbered(30))),
    "tudl": (_numbered(3), frozenset()),
    "itodd": (_numbered(28),
              frozenset(f"obj{i:02d}" for i in range(1, 29)
                        if i not in _ITODD_ASYM_IDS)),
}


def get_obj_info(dataset_name: str
                 ) -> Tuple[Dict[str, int], frozenset]:
    """(name -> obj_id, symmetric-object names). Ref: get_obj_info."""
    if dataset_name not in _REGISTRY:
        raise ValueError(f"unknown dataset: {dataset_name}")
    return _REGISTRY[dataset_name]


def lookup_obj_id(dataset_name: str, obj_name: str) -> int:
    """obj_name -> obj_id with a helpful error naming the valid objects
    (a bare KeyError was the round-2 CLI failure mode)."""
    names, _ = get_obj_info(dataset_name)
    if obj_name not in names:
        raise ValueError(
            f"unknown object {obj_name!r} for dataset "
            f"{dataset_name!r}; valid: {', '.join(sorted(names))}")
    return names[obj_name]


def get_sym_obj_ids(dataset_name: str) -> List[int]:
    names, syms = get_obj_info(dataset_name)
    return sorted(names[n] for n in syms)


def is_symmetric(dataset_name: str, obj_name: str) -> bool:
    _, syms = get_obj_info(dataset_name)
    return obj_name in syms
