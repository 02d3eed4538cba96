"""Grid search — the cartesian expansion of list-valued train#params,
the port's copy of `shifu_tpu/train/grid_search.py`
(`core/dtrain/gs/GridSearch.java:44-65`): any param whose value is a
list of candidates (a list of lists for slots that are themselves
lists, e.g. NumHiddenNodes) is a grid axis, and `processor/train` keeps
the combination with the best validation error
(`TrainModelProcessor.findBestParams:1255`). A gridConfigFile with one
`key:v1,v2` line per axis is also accepted.
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


def parse_grid_config_file(path: str) -> Dict[str, Any]:
    """gridConfigFile format: `key:v1,v2,...` per line
    (GridSearch gridConfigFile branch)."""
    out: Dict[str, Any] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or ":" not in line:
                continue
            k, vs = line.split(":", 1)
            vals: List[Any] = []
            for tok in vs.split(","):
                tok = tok.strip()
                try:
                    vals.append(int(tok))
                except ValueError:
                    try:
                        vals.append(float(tok))
                    except ValueError:
                        vals.append(tok)
            out[k.strip()] = vals
    return out
