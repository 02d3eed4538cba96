"""The reading half of `shifu_tpu/processor/norm.py`:
`selected_candidates` (line 39), `load_normalized_meta` and
`load_normalized` (lines 283-294). Writing the normalized and cleaned
layouts (`norm.run`) comes with the init/stats/norm slice.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from shifu_tpu_torch.config.column_config import ColumnConfig


def selected_candidates(ccs: List[ColumnConfig]) -> List[ColumnConfig]:
    """Columns that feed the model: finalSelect ones if varselect ran,
    else all candidates (NormalizeUDF column-selection rule)."""
    final = [c for c in ccs if c.finalSelect and c.is_candidate]
    if final:
        return final
    return [c for c in ccs if c.is_candidate]


def load_normalized_meta(path: str) -> Dict:
    """Read only meta.json (denseNames/indexNames)."""
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def load_normalized(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    data = dict(np.load(os.path.join(path, "data.npz")))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return data, meta
