"""Step records, costs and profiler traces — the port's copy of
`shifu_tpu/profiling.py` (without the XLA compile cache, which has no
counterpart on the card).

- every CLI command appends one JSON line to
  `tmp/metrics/steps.jsonl` (`step_metrics`): the step, its wall
  seconds and rc, the card's memory (`device_stats`: only when the
  step already made CUDA's context), the input pipeline's stage
  timers (``inputPipeline``, drained from `data/pipeline.py`), the
  retries, resilience events and restarts, the `trace` block of a
  traced step and what the layers below queued (`set_step_extra`: the
  trainer's `roofline`, the DAG's `dag` report); the finished record
  is mirrored into the metrics store (`obs/health/store.
  flush_step_record`);
- `--profile <cmd>` captures a `torch.profiler` trace (host ops, and
  the CUDA kernels when a card is present) under
  `tmp/profile/<run_id>/trace.json`, named after the span tracer's
  run id so `trace ls` pairs the two (`maybe_profile`);
- `roofline` combines the analytic per-row costs of a model spec
  (`mlp_/wdl_/mtl_/tree_row_costs`) with a measured rows/s into the
  `roofline` block, against the card's peaks below.

A failure of the metrics plane is absorbed and never fails the step.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Optional

log = logging.getLogger("shifu_tpu_torch")

# enrichments queued by deeper layers (the train processor's roofline
# block, the DAG's report) for the step record step_metrics is
# currently building — the same drain-at-exit pattern as the stage
# timers
_step_extras: Dict = {}


def set_step_extra(key: str, value) -> None:
    """Attach one key to the step_metrics record being recorded (the
    processor layer knows the roofline; cli.py owns the record)."""
    _step_extras[key] = value


def device_stats() -> Dict:
    """The card's backend, count and memory (bytes in use, their peak
    over the process, the card's total) — only when this process has
    already made CUDA's context: a host-only step (`init`, `save`) or a
    CPU run reports nothing, and this never initializes CUDA itself."""
    out: Dict = {}
    try:
        import torch
        if not torch.cuda.is_initialized():
            return out
        idx = torch.cuda.current_device()
        out["backend"] = "cuda"
        out["deviceCount"] = int(torch.cuda.device_count())
        out["peakBytesInUse"] = int(torch.cuda.max_memory_allocated(idx))
        out["bytesInUse"] = int(torch.cuda.memory_allocated(idx))
        out["bytesLimit"] = int(
            torch.cuda.get_device_properties(idx).total_memory)
    except Exception as e:  # noqa: BLE001 — metrics must never fail a run
        out["error"] = str(e)
    return out


@contextlib.contextmanager
def step_metrics(root: str, step: str, extra: Optional[Dict] = None):
    """Record one step's structured metrics to tmp/metrics/steps.jsonl.
    Yields a dict the caller may enrich (e.g. rows=, rc=). Each record
    also carries the input-pipeline stage timers (host_parse_s,
    host_assemble_s, h2d_s, device_step_s, input_stall_s — see
    data/pipeline.py) and any resilience retry counters accrued while
    the step ran."""
    rec: Dict = {"step": step, "startedAt": round(time.time(), 3)}
    if extra:
        rec.update(extra)
    _step_extras.clear()   # the interval belongs to THIS step
    from shifu_tpu_torch import resilience
    try:
        # the interval belongs to THIS step: drop whatever an earlier
        # caller in the same process left behind
        from shifu_tpu_torch.data.pipeline import drain_stage_timers
        drain_stage_timers()
        resilience.retry_stats(reset=True)
        resilience.drain_events()
    except Exception as e:  # noqa: BLE001 — metrics must never fail a run
        resilience.absorbed("metrics.pre-drain", e)
    t0 = time.time()
    try:
        yield rec
    finally:
        rec["wallSeconds"] = round(time.time() - t0, 3)
        rec.update(device_stats())
        if _step_extras:
            rec.update(_step_extras)
            _step_extras.clear()
        try:
            from shifu_tpu_torch.data.pipeline import drain_stage_timers
            stages = drain_stage_timers()
            if stages:
                rec["inputPipeline"] = stages
            retries = resilience.retry_stats(reset=True)
            if retries:
                rec["retries"] = retries
            # supervised-restart records accrued while the step ran
            # (each also lands as its own durable steps.jsonl line the
            # moment it happens)
            events = resilience.drain_events()
            if events:
                rec["events"] = events
                restarts = [e.get("restart", 0) for e in events
                            if e.get("event") == "restart"]
                if restarts:
                    rec["restarts"] = max(restarts)
            if resilience.preempt_requested():
                rec["preempted"] = True
        except Exception as e:  # noqa: BLE001 — metrics must never fail a run
            resilience.absorbed("metrics.enrich", e)
        try:
            mdir = os.path.join(root, "tmp", "metrics")
            os.makedirs(mdir, exist_ok=True)
            with open(os.path.join(mdir, "steps.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError as e:
            log.warning("metrics: could not write steps.jsonl: %s", e)
        try:
            # mirror the finished record into the persistent metrics
            # store (no-op unless SHIFU_TPU_METRICS=1)
            from shifu_tpu_torch.obs.health import store as health_store
            health_store.flush_step_record(root, rec)
        except Exception as e:  # noqa: BLE001 — metrics must never fail a run
            log.warning("metrics store flush failed (absorbed): %s", e)


# ---------------------------------------------------------------------------
# roofline accounting
# ---------------------------------------------------------------------------
#
# Analytic per-row FLOPs and bytes moved come from the model spec alone;
# utilization divides a measured throughput by the card's peaks below:
# NVIDIA H100 80GB HBM3 (SXM), 700 W, data sheet — f32 outside the
# tensor cores (the NN trainer's cuBLAS GEMMs with TF32 off) 67 TFLOP/s,
# dense bf16 on the tensor cores 989 TFLOP/s, HBM3 3.35 TB/s.
# `mxu_util` and `hbm_util` keep the JAX package's key names: the share
# of the card's FLOP/s and memory-rate peaks.

H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
H100_PEAK_HBM_BPS = 3.35e12

# the record schemas, the JAX package's `profiling.*_FIELDS` tuple for
# tuple, so a record of either package reads with the other's keys:
# the `roofline` block
ROOFLINE_FIELDS = ("family", "compute_dtype", "flops_per_row",
                   "bytes_per_row", "rows_per_s", "flops_per_s",
                   "bytes_per_s", "arith_intensity", "ridge_intensity",
                   "mxu_util", "hbm_util", "bound")

# a serving benchmark's record (latency percentiles, occupancy, the
# warm-up seconds), and the tree route's extra keys
SERVING_FIELDS = ("qps_offered", "qps_sustained", "requests",
                  "rejected", "rows_per_s", "p50_ms", "p95_ms",
                  "p99_ms", "batch_occupancy", "rows_per_batch",
                  "serve_warm_s", "device_step_budget_ms",
                  "compile_cache_misses_steady")
TREE_SERVE_FIELDS = ("tree_route", "fused_rows_per_s",
                     "xla_rows_per_s", "fused_speedup")

# the fleet's stats()["fleet"] block (serve/fleet.py)
FLEET_FIELDS = ("models_resident", "evictions", "rewarm_s",
                "shed_rate", "p99_ms_by_class", "swaps", "swap_s")

# the closed loop's records: a refresh, the row log, a canary
REFRESH_FIELDS = ("breach_to_promoted_s", "swap_s", "rewarm_s",
                  "swap_compile_misses", "guardrail")
INGEST_FIELDS = ("rows", "rows_per_s", "segments",
                 "breach_latency_s", "bitwise_identical")
CANARY_FIELDS = ("breach_to_live_s", "rollback_recovery_s",
                 "failed_requests", "shadow_requests",
                 "canary_requests", "arm_psi", "promote_verdict",
                 "rollback_verdict")

# the pipeline DAG's `dag` block (pipeline/scheduler.py): the block's
# top-level keys, and each entry of its `nodes` list. `devices` is the
# size of the lease a node held (0 for host and never-leased nodes,
# None in timeshared mode); `total_devices` the pool leased from (None
# when timeshared), `max_concurrent` the peak of device nodes running
# at once, and `occupancy` lease-weighted when sliced
# (Σ run_s·devices / wall·total)
DAG_FIELDS = ("node", "state", "deps", "queue_s", "run_s", "devices",
              "critical_path")
DAG_SUMMARY_FIELDS = ("workers", "total_devices", "wall_s",
                      "critical_path_s", "occupancy", "max_concurrent",
                      "failed", "nodes")
SLICE_FIELDS = ("slices_leased", "max_concurrent", "occupancy",
                "sliced_speedup")

# the span tracer's `trace` block (obs/trace.py): total spans recorded,
# ring-buffer drops, and the top-3 span names by self time
TRACE_FIELDS = ("span_count", "dropped_spans", "top_self")

# a metrics-store point (obs/health/store.py) and an SLO evaluation
# (obs/health/slo.py)
METRIC_FIELDS = ("ts", "name", "value", "kind", "tags")
HEALTH_FIELDS = ("slo", "metric", "state", "value", "warn", "breach",
                 "window_s")

# a sharded stats run's record (the multi-card data plane)
SHARD_FIELDS = ("hosts", "rows", "rows_per_s", "rows_per_s_1host",
                "scaling_efficiency", "merge_collective_s",
                "bitwise_identical")


def mlp_row_costs(input_dim: int, hidden_dims, n_out: int = 1,
                  train: bool = True, dtype_bytes: int = 4):
    """Analytic (flops, bytes) per data row for an MLP (NN family).

    FLOPs: 2·d_in·d_out per matmul, and a train step costs ~3× forward
    (forward, activation-grad, and weight-grad matmuls). Bytes: every
    activation is written once and read once (2× each layer width) in
    the compute dtype, doubled again for the backward pass; per-row
    weight traffic amortizes across the batch and is excluded.
    """
    dims = [int(input_dim)] + [int(d) for d in hidden_dims] + [int(n_out)]
    mm = sum(2 * a * b for a, b in zip(dims, dims[1:]))
    flops = (3 if train else 1) * mm
    bytes_ = 2 * dtype_bytes * sum(dims) * (2 if train else 1)
    return float(flops), float(bytes_)


def wdl_row_costs(dense_dim: int, n_cat: int, embed_size: int,
                  hidden_dims, train: bool = True, dtype_bytes: int = 4):
    """WDL = deep MLP over [dense ‖ embeddings] + wide linear logit.
    Embedding rows are gathered per example (read fwd, read+write in
    the backward scatter)."""
    deep_in = int(dense_dim) + int(n_cat) * int(embed_size)
    flops, bytes_ = mlp_row_costs(deep_in, hidden_dims, 1, train,
                                  dtype_bytes)
    flops += 2 * (int(dense_dim) + int(n_cat))
    bytes_ += dtype_bytes * int(n_cat) * int(embed_size) * \
        (3 if train else 1)
    return float(flops), float(bytes_)


def mtl_row_costs(input_dim: int, hidden_dims, n_tasks: int,
                  train: bool = True, dtype_bytes: int = 4):
    """MTL = shared trunk MLP + one linear head per task; exactly an
    MLP whose output width is the task count."""
    return mlp_row_costs(input_dim, hidden_dims, int(n_tasks), train,
                         dtype_bytes)


def tree_row_costs(n_cols: int, n_bins: int, max_depth: int,
                   n_trees: int = 1, subtract: bool = True,
                   phase: str = "build"):
    """GBT/RF per-row costs, by phase.

    phase="build" — level building: each level accumulates a
    gradient-weighted histogram per (node slot, column, bin), for the
    gradient and the hessian, counted as a node one-hot (slots×R)
    against a bin one-hot (R×C·n_bins); sibling subtraction halves the
    slots actually built below the root. Bytes: the int32 bin row (or
    f32 value row on the fused path) plus grad/hess, re-read a level.

    phase="infer" — the fused ensemble kernel (K2): binning compares
    every value against its cut row, every packed node's routed bin is
    a one-hot feature contraction (S = n_trees · padded node slots), and
    the breadth-first walk runs max_depth select steps. Bytes: the raw
    f32 value row in, one f32 score out — the node block and cuts stay
    on chip across a row tile. The same analytic counts as the JAX
    package's.
    """
    if phase == "infer":
        s = n_trees * (2 ** (int(max_depth) + 1) - 1)
        flops = (int(n_cols) * max(int(n_bins) - 2, 1)   # binning
                 + 2 * int(n_cols) * s                   # routed bins
                 + 4 * s                                 # broadcasts
                 + 3 * int(max_depth) * s)               # select walk
        bytes_ = 4 * int(n_cols) + 4
        return float(flops), float(bytes_)
    flops = 0.0
    for d in range(int(max_depth)):
        slots = 2 ** d
        if subtract and d > 0:
            slots /= 2
        flops += 2 * 2 * slots * int(n_cols) * int(n_bins)
    bytes_ = int(max_depth) * (4 * int(n_cols) + 8)
    return float(flops * n_trees), float(bytes_ * n_trees)


def roofline(family: str, flops_per_row: float, bytes_per_row: float,
             rows_per_s: float, compute_dtype: str = "float32",
             peak_flops: Optional[float] = None,
             peak_bytes_per_s: float = H100_PEAK_HBM_BPS) -> Dict:
    """Combine analytic per-row costs with a measured rows/s into the
    `roofline` block (steps.jsonl): achieved flops_per_s / bytes_per_s,
    arithmetic intensity vs the ridge point, and the shares of the
    card's FLOP/s and memory-rate peaks that say whether the shape is
    compute- or bandwidth-bound."""
    dtype = str(compute_dtype)
    if peak_flops is None:
        peak_flops = H100_PEAK_FLOPS.get(dtype, H100_PEAK_FLOPS["float32"])
    rows = max(float(rows_per_s), 0.0)
    fps = float(flops_per_row) * rows
    bps = float(bytes_per_row) * rows
    ai = float(flops_per_row) / bytes_per_row if bytes_per_row else 0.0
    ridge = peak_flops / peak_bytes_per_s if peak_bytes_per_s else 0.0
    return {"family": family,
            "compute_dtype": dtype,
            "flops_per_row": float(flops_per_row),
            "bytes_per_row": float(bytes_per_row),
            "rows_per_s": round(rows, 3),
            "flops_per_s": round(fps, 3),
            "bytes_per_s": round(bps, 3),
            "arith_intensity": round(ai, 4),
            "ridge_intensity": round(ridge, 4),
            "mxu_util": round(fps / peak_flops, 4) if peak_flops else 0.0,
            "hbm_util": round(bps / peak_bytes_per_s, 4)
            if peak_bytes_per_s else 0.0,
            "bound": "compute" if ai >= ridge else "memory"}


PROFILE_FILE = "trace.json"


@contextlib.contextmanager
def maybe_profile(root: str, step: str, enabled: bool):
    """A `torch.profiler` trace around a step when --profile is set:
    host ops, plus the CUDA kernels when a card is present, exported
    as a Chrome trace to `tmp/profile/<run_id>/trace.json`. The
    directory is named by the tracer's run id, so the device trace and
    the host span trace (`tmp/trace/<run_id>.trace.json`) of one step
    are siblings that `trace ls` pairs."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from shifu_tpu_torch.obs import trace as obs_trace
    out = os.path.join(root, "tmp", "profile",
                       obs_trace.current_run_id(step))
    os.makedirs(out, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield out
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(out, PROFILE_FILE))
        log.info("profiler trace written to %s (open in "
                 "ui.perfetto.dev)", out)
