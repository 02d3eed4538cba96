"""Grid search — the cartesian expansion of list-valued train#params,
the port's copy of `expand` from `shifu_tpu/train/grid_search.py`
(`core/dtrain/gs/GridSearch.java:44-65`). `config/inspector` reads it;
the grid-search trainer itself is ROADMAP A3.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Tuple

# slots whose *normal* value is already a list
LIST_VALUED = {"numhiddennodes", "activationfunc"}


def _is_grid_axis(key: str, value: Any) -> bool:
    if not isinstance(value, list):
        return False
    if key.lower() in LIST_VALUED:
        return any(isinstance(v, list) for v in value)
    return True


def expand(params: Dict[str, Any]) -> List[Dict[str, Any]]:
    """→ list of concrete param dicts (length 1 when no grid)."""
    axes: List[Tuple[str, List[Any]]] = []
    base: Dict[str, Any] = {}
    for k, v in params.items():
        if _is_grid_axis(k, v):
            axes.append((k, v))
        else:
            base[k] = v
    if not axes:
        return [dict(params)]
    combos = []
    for values in itertools.product(*(v for _, v in axes)):
        c = dict(base)
        for (k, _), val in zip(axes, values):
            c[k] = val
        combos.append(c)
    return combos
