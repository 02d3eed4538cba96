"""Environment knobs of the port's serving, training and pipeline steps.

A copy of the reading half of `shifu_tpu/config/environment.py` for the
four serving knobs, the two tree-build knobs, the two NN compute-dtype
knobs, the two resilience knobs `train` refuses (ROADMAP A8), the
streaming triggers of stats, norm, eval and the analysis steps (stats,
norm, a resident eval and varselect's analysis frame honour theirs by
raising: the streaming steps are ROADMAP A6; posttrain, correlation,
PSI and `eval -norm`/`-score` read in chunks or refuse), the `export
-t ume` exporter hook, the host-assembly threads of the streaming
trainers (`data/pipeline.map_prefetch`) and the row-state tier of the
streaming GBT builder: same names, same
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
    Knob("SHIFU_TPU_NN_COMPUTE", "float32",
         "NN forward/backward compute dtype (float32 | bfloat16)"),
    Knob("SHIFU_TPU_COMPUTE_DTYPE", None,
         "default compute dtype for NN forward+backward (float32 | "
         "bfloat16); params/optimizer state stay f32 and matmuls "
         "accumulate in f32. Per-model train params and "
         "SHIFU_TPU_NN_COMPUTE override it"),
    Knob("SHIFU_TPU_MAX_RESTARTS", 0,
         "supervised in-process restarts around the train step (the "
         "port refuses a value above 0: ROADMAP A8)"),
    Knob("SHIFU_TPU_RESUME", "0",
         "1 = skip steps whose completion manifest matches inputs (the "
         "port's train refuses it: ROADMAP A8)"),
    Knob("SHIFU_TPU_STATS_CHUNK_ROWS", None,
         "explicit stats streaming chunk rows; 0 forces resident"),
    Knob("SHIFU_TPU_STATS_STREAM_BYTES", 2 * 1024 ** 3,
         "raw-bytes threshold that auto-triggers streaming stats"),
    Knob("SHIFU_TPU_NORM_CHUNK_ROWS", None,
         "explicit norm streaming chunk rows; 0 forces resident"),
    Knob("SHIFU_TPU_NORM_STREAM_BYTES", 2 * 1024 ** 3,
         "raw-bytes threshold that auto-triggers streaming norm"),
    Knob("SHIFU_TPU_EVAL_CHUNK_ROWS", None,
         "explicit eval streaming chunk rows; 0 forces resident"),
    Knob("SHIFU_TPU_EVAL_STREAM_BYTES", 2 * 1024 ** 3,
         "raw-bytes threshold that auto-triggers streaming eval"),
    Knob("SHIFU_TPU_ANALYSIS_CHUNK_ROWS", None,
         "explicit analysis-step chunk rows; 0 forces resident"),
    Knob("SHIFU_TPU_ANALYSIS_STREAM_BYTES", 2 * 1024 ** 3,
         "raw-bytes threshold that auto-triggers sampled analysis"),
    Knob("SHIFU_TPU_UME_EXPORTER", None,
         "pkg.module:Class hook for `export -t ume` bundles"),
    Knob("SHIFU_TPU_PREFETCH_WORKERS", 2,
         "host-assembly threads for map_prefetch; 0 = sequential"),
    Knob("SHIFU_TPU_GBT_RESIDENT_STATE", "auto",
         "streaming GBT row-state tier: 1 keeps node/pred/grad/hess on "
         "the device (no host sync inside a level, one a round), 0 "
         "forces the host-numpy state path, auto picks by the "
         "SHIFU_TPU_GBT_STATE_BUDGET_MB fit"),
    Knob("SHIFU_TPU_GBT_STATE_BUDGET_MB", 2048,
         "device budget for resident streaming-GBT row state; auto mode "
         "goes resident when ~24 B/train row + ~12 B/val row fits"),
)}


def _require(name: str) -> Knob:
    k = KNOBS.get(name)
    if k is None:
        raise KeyError(f"{name} is not a knob of shifu_tpu_torch")
    return k


def knob_raw(name: str) -> Optional[str]:
    """The knob's raw environment value (None when unset)."""
    _require(name)
    return os.environ.get(name)


def knob_is_set(name: str) -> bool:
    v = knob_raw(name)
    return v is not None and v.strip() != ""


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
