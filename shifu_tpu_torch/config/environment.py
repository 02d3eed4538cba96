"""Environment knobs the serving and tree-training slices read.

A copy of the reading half of `shifu_tpu/config/environment.py` for the
four serving knobs and the two tree-build knobs: same names, same
defaults, and the same warn-and-run parsing (a malformed value logs a
warning and falls back to the default instead of failing the process).
The JAX package's routing and TPU-dispatch knobs (`SHIFU_TPU_HIST`,
`SHIFU_TPU_SPLIT_FUSED`, `SHIFU_TPU_TREE_SCAN`, ...) have no counterpart:
the tensors' device picks the route here.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, NamedTuple, Optional

log = logging.getLogger("shifu_tpu_torch")


class Knob(NamedTuple):
    name: str
    default: object
    doc: str


KNOBS: Dict[str, Knob] = {k.name: k for k in (
    Knob("SHIFU_TPU_SERVE_BUCKETS", "1,8,64,512",
         "padded-row shape-bucket ladder for the serving plane "
         "(comma-separated ascending row counts; sizes beyond the top "
         "bucket pad to its next doubling)"),
    Knob("SHIFU_TPU_SERVE_MAX_DELAY_MS", 2.0,
         "micro-batcher admission deadline: a queued request waits at "
         "most this long for co-riders before its batch is scored"),
    Knob("SHIFU_TPU_SERVE_QUEUE_DEPTH", 1024,
         "bounded admission-queue depth for the scorer service; a full "
         "queue rejects submits instead of buffering unbounded"),
    Knob("SHIFU_TPU_SERVE_PORT", 8488,
         "HTTP/JSON listener port for `serve` (0 = ephemeral)"),
    Knob("SHIFU_TPU_HIST_SUBTRACT", "1",
         "sibling-subtraction trick in GBT histogram builds"),
    Knob("SHIFU_TPU_HIST_FUSED", "0",
         "1 = GBT level builds bin numeric values inside the histogram "
         "kernel (no materialized bin-index matrix); needs FusedBins "
         "inputs from gbdt.make_fused_inputs"),
)}


def _require(name: str) -> Knob:
    k = KNOBS.get(name)
    if k is None:
        raise KeyError(f"{name} is not a knob of shifu_tpu_torch")
    return k


def knob_int(name: str, default: Optional[int] = None) -> Optional[int]:
    k = _require(name)
    raw = os.environ.get(name)
    fallback = default if default is not None else k.default
    if raw is None or raw.strip() == "":
        return fallback
    try:
        return int(float(raw))
    except ValueError:
        log.warning("ignoring malformed %s=%r (want int); using %r",
                    name, raw, fallback)
        return fallback


def knob_float(name: str,
               default: Optional[float] = None) -> Optional[float]:
    k = _require(name)
    raw = os.environ.get(name)
    fallback = default if default is not None else k.default
    if raw is None or raw.strip() == "":
        return fallback
    try:
        return float(raw)
    except ValueError:
        log.warning("ignoring malformed %s=%r (want float); using %r",
                    name, raw, fallback)
        return fallback


def knob_str(name: str, default: Optional[str] = None) -> Optional[str]:
    k = _require(name)
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default if default is not None else k.default
    return raw


def knob_bool(name: str, default: Optional[bool] = None) -> bool:
    """bool/flag knobs: "0"/"false"/"no"/"off" (any case) are False,
    anything else set is True; unset uses the registry default."""
    k = _require(name)
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        raw = str(k.default if default is None else default)
    return raw.strip().lower() not in ("0", "false", "no", "off", "none")
