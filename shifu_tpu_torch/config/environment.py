"""Environment knobs of the port's serving, training and pipeline steps.

A copy of the reading half of `shifu_tpu/config/environment.py` for the
four serving knobs, the two tree-build knobs, the two NN compute-dtype
knobs, the checkpoint and resume knobs (the supervised restarts, the
`step_guard` resume, the background checkpoint writer and its slots,
the abort-marker directory), the
streaming triggers of stats, norm, eval and the analysis steps (past
its trigger each step reads its raw set in chunks: the streaming stats,
norm and eval, the exact chunked correlation and PSI, posttrain, and
varselect's sampled analysis frame, capped by
SHIFU_TPU_ANALYSIS_MAX_ROWS), the `export -t ume` exporter hook, the
prefetch depth and host-assembly threads of the chunked readers
(`data/pipeline.prefetch`, `map_prefetch`, `map_stream`) and the
row-state tier of the streaming GBT builder, and the serving plane's
health, registry and fleet knobs with the retry and fault-injection
knobs they read (`resilience.py`), and the closed loop's knobs (the
row log, the refresh controller, the shadow and canary arms and the
fleet's refresh budget), and the pipeline DAG's admission and lease
knobs (`pipeline/scheduler.py`): same names, types and
defaults, and the same warn-and-run parsing (a malformed value logs a
warning and falls back to the default instead of failing the process).
`knobs_rows` lists them for the `knobs` verb.
The JAX package's routing and TPU-dispatch knobs (`SHIFU_TPU_HIST`,
`SHIFU_TPU_SPLIT_FUSED`, `SHIFU_TPU_TREE_SCAN`, ...) have no counterpart:
the tensors' device picks the route here.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, NamedTuple, Optional

log = logging.getLogger("shifu_tpu_torch")


class Knob(NamedTuple):
    name: str
    type: str            # int | float | str | bool | flag
    default: object      # documented default; None = unset (auto/off)
    doc: str


KNOBS: Dict[str, Knob] = {k.name: k for k in (
    Knob("SHIFU_TPU_SERVE_BUCKETS", "str", "1,8,64,512",
         "padded-row shape-bucket ladder for the serving plane "
         "(comma-separated ascending row counts; sizes beyond the top "
         "bucket pad to its next doubling)"),
    Knob("SHIFU_TPU_SERVE_MAX_DELAY_MS", "float", 2.0,
         "micro-batcher admission deadline: a queued request waits at "
         "most this long for co-riders before its batch is scored"),
    Knob("SHIFU_TPU_SERVE_QUEUE_DEPTH", "int", 1024,
         "bounded admission-queue depth for the scorer service; a full "
         "queue rejects submits instead of buffering unbounded"),
    Knob("SHIFU_TPU_SERVE_PORT", "int", 8488,
         "HTTP/JSON listener port for `serve` (0 = ephemeral)"),
    Knob("SHIFU_TPU_HIST_SUBTRACT", "bool", "1",
         "sibling-subtraction trick in GBT histogram builds"),
    Knob("SHIFU_TPU_HIST_FUSED", "bool", "0",
         "1 = GBT level builds bin numeric values inside the histogram "
         "kernel (no materialized bin-index matrix); needs FusedBins "
         "inputs from gbdt.make_fused_inputs"),
    Knob("SHIFU_TPU_NN_COMPUTE", "str", "float32",
         "NN forward/backward compute dtype (float32 | bfloat16)"),
    Knob("SHIFU_TPU_COMPUTE_DTYPE", "str", None,
         "default compute dtype for NN forward+backward (float32 | "
         "bfloat16); params/optimizer state stay f32 and matmuls "
         "accumulate in f32. Per-model train params and "
         "SHIFU_TPU_NN_COMPUTE override it"),
    Knob("SHIFU_TPU_MAX_RESTARTS", "int", 0,
         "supervised in-process restarts around the train step"),
    Knob("SHIFU_TPU_RESUME", "flag", "0",
         "1 = skip steps whose completion manifest matches inputs"),
    Knob("SHIFU_TPU_CKPT_ASYNC", "flag", "1",
         "1 = background checkpoint writer (snapshot on-thread, "
         "serialize+publish off-thread); 0 = fully synchronous saves"),
    Knob("SHIFU_TPU_STATS_CHUNK_ROWS", "int", None,
         "explicit stats streaming chunk rows; 0 forces resident"),
    Knob("SHIFU_TPU_STATS_STREAM_BYTES", "int", 2 * 1024 ** 3,
         "raw-bytes threshold that auto-triggers streaming stats"),
    Knob("SHIFU_TPU_NORM_CHUNK_ROWS", "int", None,
         "explicit norm streaming chunk rows; 0 forces resident"),
    Knob("SHIFU_TPU_NORM_STREAM_BYTES", "int", 2 * 1024 ** 3,
         "raw-bytes threshold that auto-triggers streaming norm"),
    Knob("SHIFU_TPU_EVAL_CHUNK_ROWS", "int", None,
         "explicit eval streaming chunk rows; 0 forces resident"),
    Knob("SHIFU_TPU_EVAL_STREAM_BYTES", "int", 2 * 1024 ** 3,
         "raw-bytes threshold that auto-triggers streaming eval"),
    Knob("SHIFU_TPU_ANALYSIS_CHUNK_ROWS", "int", None,
         "explicit analysis-step chunk rows; 0 forces resident"),
    Knob("SHIFU_TPU_ANALYSIS_STREAM_BYTES", "int", 2 * 1024 ** 3,
         "raw-bytes threshold that auto-triggers sampled analysis"),
    Knob("SHIFU_TPU_ANALYSIS_MAX_ROWS", "int", 2_000_000,
         "row cap for the sampled analysis frame (varselect)"),
    Knob("SHIFU_TPU_UME_EXPORTER", "str", None,
         "pkg.module:Class hook for `export -t ume` bundles"),
    Knob("SHIFU_TPU_PREFETCH_DEPTH", "int", 2,
         "chunks buffered ahead of the consumer; 0 = sequential"),
    Knob("SHIFU_TPU_PREFETCH_WORKERS", "int", 2,
         "host-assembly threads for map_prefetch; 0 = sequential"),
    Knob("SHIFU_TPU_GBT_RESIDENT_STATE", "str", "auto",
         "streaming GBT row-state tier: 1 keeps node/pred/grad/hess on "
         "the device (no host sync inside a level, one a round), 0 "
         "forces the host-numpy state path, auto picks by the "
         "SHIFU_TPU_GBT_STATE_BUDGET_MB fit"),
    Knob("SHIFU_TPU_GBT_STATE_BUDGET_MB", "int", 2048,
         "device budget for resident streaming-GBT row state; auto mode "
         "goes resident when ~24 B/train row + ~12 B/val row fits"),
    Knob("SHIFU_TPU_RETRY_ATTEMPTS", "int", 4,
         "max attempts per retried remote call (the webhook alert sink)"),
    Knob("SHIFU_TPU_RETRY_BASE_S", "float", 0.05,
         "first retry backoff delay (seconds)"),
    Knob("SHIFU_TPU_RETRY_MAX_S", "float", 2.0,
         "retry backoff cap (seconds)"),
    Knob("SHIFU_TPU_FAULT", "str", None,
         "deterministic fault spec <site>:<kind>:<nth>[;...]"),
    Knob("SHIFU_TPU_METRICS", "flag", "0",
         "1 = persist metric points to tmp/metrics/metrics.jsonl "
         "(serving snapshots, eval guardrails, drift, SLO health); "
         "unset/0 = no files written (reads still work)"),
    Knob("SHIFU_TPU_METRICS_ROLLUP", "int", 4 * 1024 * 1024,
         "metrics.jsonl size (bytes) that triggers rollup compaction "
         "(older half aggregated, recent half kept raw, atomic "
         "rewrite); 0 = never compact"),
    Knob("SHIFU_TPU_METRICS_FLUSH_S", "float", 30.0,
         "period of the serving plane's background metrics flush "
         "(serve.* gauges from ScorerService.stats)"),
    Knob("SHIFU_TPU_WATCH_INTERVAL_S", "float", 30.0,
         "tick period of the `watch --monitor-only` loop"),
    Knob("SHIFU_TPU_SLO_FILE", "str", None,
         "path to slo.json; unset = <model set>/slo.json when present, "
         "else the built-in default guardrails (obs/health/slo.py)"),
    Knob("SHIFU_TPU_DRIFT_THRESHOLD", "float", 0.2,
         "per-feature PSI above which a window emits a `drift` event "
         "(0.2 = the conventional 'significant shift' cutoff)"),
    Knob("SHIFU_TPU_ALERT_WEBHOOK", "str", None,
         "URL the webhook alert sink POSTs SLO transition records to; "
         "unset = sink disabled"),
    Knob("SHIFU_TPU_ALERT_WEBHOOK_TIMEOUT_S", "float", 3.0,
         "per-attempt connect+read timeout of the webhook alert POST "
         "(retried with backoff, then absorbed)"),
    Knob("SHIFU_TPU_REGISTRY_KEEP", "int", 3,
         "registry gc retention: versions kept per model (the HEAD "
         "version is always kept regardless)"),
    Knob("SHIFU_TPU_FLEET_HBM_MB", "int", 4096,
         "device-memory budget for resident fleet models (manifest param "
         "bytes + bucket-ladder working set per model); exceeding it "
         "LRU-evicts the coldest resident model back to host"),
    Knob("SHIFU_TPU_FLEET_SLO_P99_MS", "float", 50.0,
         "high-priority p99 latency SLO (ms): admission sheds "
         "low-priority load at 429 above it, and the SLO autotuner "
         "steers each model's admission deadline toward it"),
    Knob("SHIFU_TPU_FLEET_SHED_WINDOW", "int", 64,
         "recent high-priority request latencies the fleet admission "
         "controller computes its rolling p99 over"),
    Knob("SHIFU_TPU_REFRESH_WINDOW_ROWS", "int", 100_000,
         "max drifted-window rows the refresh controller keeps (newest "
         "kept) as the incremental-training window a breach retrains "
         "on"),
    Knob("SHIFU_TPU_REFRESH_TOLERANCE", "float", 0.005,
         "eval-guardrail tolerance: a challenger whose guardrail "
         "metric (AUC) is below incumbent - tolerance is HELD, not "
         "promoted; within-tolerance or better promotes"),
    Knob("SHIFU_TPU_REFRESH_COOLDOWN_S", "float", 900.0,
         "min seconds between breach-scheduled refreshes; breaches "
         "during an in-flight refresh or inside the cooldown are "
         "coalesced (counted, visible in `health`), so a flapping PSI "
         "signal cannot stack retrains"),
    Knob("SHIFU_TPU_INGEST_SEGMENT_ROWS", "int", 4096,
         "rows a row-log partition buffers before its open segment "
         "seals into an immutable seg-*.rows file (data/ingest.py; "
         "smaller = lower latency to readers, more segment files)"),
    Knob("SHIFU_TPU_INGEST_SEGMENT_AGE_S", "float", 30.0,
         "max seconds a non-empty open row-log segment may buffer "
         "before the next append seals it regardless of row count, "
         "bounding how stale a slow trickle can keep readers"),
    Knob("SHIFU_TPU_INGEST_WINDOW_ROWS", "int", 65_536,
         "max rows one `watch --ingest` tick consumes from the row log "
         "per read_window (the drift window size cap; the rest stays "
         "committed for the next tick)"),
    Knob("SHIFU_TPU_SHADOW_PCT", "float", 0.0,
         "fraction of live requests mirrored to a challenger arm "
         "during the shadow phase (response discarded, latency + "
         "score sketch recorded per arm); 0 = shadow plane off "
         "unless a canary run sets it live"),
    Knob("SHIFU_TPU_SHADOW_QUEUE", "int", 64,
         "bounded depth of the shadow mirror queue; a full queue "
         "DROPS the mirror (drop-counted) instead of slowing the "
         "primary request path"),
    Knob("SHIFU_TPU_CANARY_PCT", "float", 0.05,
         "fraction of live requests the canary phase routes to the "
         "challenger arm (deterministic per-request assignment; the "
         "rest stay on the incumbent primary)"),
    Knob("SHIFU_TPU_CANARY_MIN_REQUESTS", "int", 32,
         "min scored requests PER ARM before a canary phase may "
         "decide (shadow → canary and canary → verdict both wait "
         "for this much live evidence)"),
    Knob("SHIFU_TPU_CANARY_WINDOW_S", "float", 60.0,
         "max seconds a canary phase waits for its per-arm request "
         "quorum; expiry without quorum rolls the challenger back "
         "(no evidence ⇒ no promotion)"),
    Knob("SHIFU_TPU_CANARY_PSI_MAX", "float", 0.25,
         "max score-distribution PSI between the incumbent and "
         "challenger arms a live verdict may promote through "
         "(above = the challenger scores a different population)"),
    Knob("SHIFU_TPU_CANARY_P99_FACTOR", "float", 1.5,
         "max challenger-arm p99 as a multiple of the incumbent "
         "arm's p99 during canary; above = SLO breach, automatic "
         "rollback"),
    Knob("SHIFU_TPU_FLEET_REFRESH_BUDGET", "int", 1,
         "max tenant refreshes a fleet drift tick may schedule — a "
         "breach storm (N tenants drifting at once) defers the rest "
         "to later ticks instead of launching N concurrent retrains"),
    Knob("SHIFU_TPU_DAG_WORKERS", "int", 2,
         "pipeline DAG scheduler, timeshared mode: concurrent "
         "device-using nodes (host-only nodes are admitted "
         "immediately; sliced mode admits by device-slice leases)"),
    Knob("SHIFU_TPU_DAG_SLICE", "str", "auto",
         "DAG device-slice leases: auto = lease disjoint cards to "
         "concurrent device nodes when the pool holds >1 card, "
         "1 = force slicing, 0 = timeshared admission"),
    Knob("SHIFU_TPU_DAG_DEVICES", "int", None,
         "card pool size the DAG slice allocator leases from (None = "
         "torch.cuda.device_count(), read only for a DAG that holds a "
         "device node)"),
)}


def knobs_rows() -> List[dict]:
    """One row per knob: name, type, default, current value (unset →
    ''), doc — the `knobs` verb's table."""
    rows = []
    for k in sorted(KNOBS.values()):
        cur = os.environ.get(k.name)
        rows.append({"name": k.name, "type": k.type,
                     "default": "" if k.default is None else str(k.default),
                     "current": "" if cur is None else cur, "doc": k.doc})
    return rows


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
