"""Persistent per-workspace metrics store — `tmp/metrics/metrics.jsonl`,
counterpart of `shifu_tpu/obs/health/store.py`.

One JSON line per metric point, the fields `METRIC_FIELDS`
(`ts`/`name`/`value`/`kind`/`tags`, the JAX package's
`profiling.METRIC_FIELDS`), so either package reads the other's file.
Points accrue in a per-process buffer and hit disk on `flush()`:

- the append is one buffered `write()` of whole lines onto an O_APPEND
  handle, so concurrent writers (a `serve` flusher and a `watch` loop
  sharing a workspace) interleave at line granularity;
- when the file outgrows ``SHIFU_TPU_METRICS_ROLLUP`` bytes, `flush`
  compacts it: the older half of the points aggregate into per-name
  per-bucket `rollup` points (count/sum/min/max/last) while the recent
  half stays raw, and the rewritten file commits through
  `fileio.atomic_write`.

`flush` runs through `fault_point("obs.metrics_flush")` and RAISES on
failure; every caller absorbs the error (the serving flusher, the watch
loop, eval). With ``SHIFU_TPU_METRICS`` unset the module is inert:
`emit` drops points and `flush` touches no files.

`step_completed` is `step_guard`'s exit hook (a ``step.completed``
counter and a flush); `flush_step_record` is `profiling.step_metrics`'
(the finished steps.jsonl record as points: wall seconds, the stage
timers, the roofline block, the dag summary).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Iterable, List, Optional

from shifu_tpu_torch.config.environment import knob_bool, knob_int
from shifu_tpu_torch.profiling import METRIC_FIELDS  # noqa: F401 — the line schema
from shifu_tpu_torch.resilience import absorbed, fault_point, make_lock

log = logging.getLogger("shifu_tpu_torch")

METRICS_FILE = "metrics.jsonl"

# seconds per rollup aggregation bucket: compacted points collapse to
# at most one rollup line per (name, tags) per bucket
ROLLUP_BUCKET_S = 300.0


def metrics_enabled() -> bool:
    """The single gate: no point is buffered and no file is written
    unless SHIFU_TPU_METRICS is set truthy."""
    return knob_bool("SHIFU_TPU_METRICS")


def metrics_path(root: str) -> str:
    return os.path.join(root, "tmp", "metrics", METRICS_FILE)


def _point(ts: float, name: str, value, kind: str, tags: Dict) -> Dict:
    return dict(zip(METRIC_FIELDS,
                    (round(float(ts), 3), name, value, kind, tags)))


class MetricsStore:
    """Buffered writer + reader for one workspace's metric series."""

    def __init__(self, root: str):
        self.root = root
        self._lock = make_lock("obs.metrics")
        self._buf: List[dict] = []

    # -- write side ----------------------------------------------------
    def emit(self, name: str, value, kind: str = "gauge",
             ts: Optional[float] = None, **tags) -> None:
        """Buffer one metric point (no I/O until flush). `kind` is
        gauge | counter | event | rollup; tags are flat str→scalar."""
        if not metrics_enabled():
            return
        pt = _point(time.time() if ts is None else ts, name, value,
                    kind, tags)
        with self._lock:
            self._buf.append(pt)

    def counter(self, name: str, value: float = 1.0, **tags) -> None:
        self.emit(name, value, kind="counter", **tags)

    def event(self, name: str, **tags) -> None:
        """A discrete occurrence (`drift`, `breach`, `warn`, ...) —
        what `health` tails."""
        self.emit(f"event.{name}", 1.0, kind="event", **tags)

    def flush(self) -> int:
        """Append buffered points; compact when past the size bound.
        Raises on failure (after re-buffering the points so a transient
        error loses nothing) — callers absorb."""
        if not metrics_enabled():
            with self._lock:
                self._buf.clear()
            return 0
        with self._lock:
            pts, self._buf = self._buf, []
        if not pts:
            return 0
        try:
            fault_point("obs.metrics_flush")
            path = metrics_path(self.root)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            data = "".join(json.dumps(p) + "\n" for p in pts)
            with open(path, "a", encoding="utf-8") as f:
                f.write(data)
            self._maybe_rollup(path)
        except Exception:
            with self._lock:
                self._buf = pts + self._buf
            raise
        return len(pts)

    # -- rollup compaction --------------------------------------------
    def _maybe_rollup(self, path: str) -> None:
        cap = knob_int("SHIFU_TPU_METRICS_ROLLUP")
        if cap is None or cap <= 0:
            return
        try:
            size = os.path.getsize(path)
        except OSError:
            return
        if size > cap:
            self.rollup(path)

    def rollup(self, path: Optional[str] = None) -> None:
        """Compact the file: the older half of the points aggregate into
        `rollup` lines (one per name+tags per ROLLUP_BUCKET_S bucket,
        value = {count,sum,min,max,last}); the recent half is kept
        verbatim. The rewrite commits atomically."""
        from shifu_tpu_torch.fileio import atomic_write
        path = path or metrics_path(self.root)
        points = _read_lines(path)
        if len(points) < 8:
            return
        points.sort(key=lambda p: p.get("ts", 0.0))
        split = len(points) // 2
        old, recent = points[:split], points[split:]
        agg: Dict[tuple, dict] = {}
        passthrough: List[dict] = []
        for p in old:
            if p.get("kind") == "rollup":
                passthrough.append(p)   # already compacted once
                continue
            tags = p.get("tags") or {}
            bucket = int(p.get("ts", 0.0) // ROLLUP_BUCKET_S)
            key = (p.get("name"), bucket,
                   tuple(sorted((str(k), str(v))
                                for k, v in tags.items())))
            v = p.get("value")
            v = float(v) if isinstance(v, (int, float)) else 0.0
            a = agg.get(key)
            if a is None:
                # stamped with the newest contributing point's ts so
                # compacted points never sort after newer raw points
                agg[key] = {"ts": p.get("ts", 0.0),
                            "name": p.get("name"),
                            "count": 1, "sum": v, "min": v, "max": v,
                            "last": v, "tags": dict(tags, of=p.get("kind"))}
            else:
                a["ts"] = max(a["ts"], p.get("ts", 0.0))
                a["count"] += 1
                a["sum"] += v
                a["min"] = min(a["min"], v)
                a["max"] = max(a["max"], v)
                a["last"] = v
        rolled = [_point(a["ts"], a["name"],
                         {"count": a["count"], "sum": round(a["sum"], 6),
                          "min": a["min"], "max": a["max"],
                          "last": a["last"]},
                         "rollup", a["tags"])
                  for a in agg.values()]
        out = sorted(passthrough + rolled, key=lambda p: p["ts"]) + recent
        with atomic_write(path, "w") as f:
            for p in out:
                f.write(json.dumps(p) + "\n")
        log.info("metrics rollup: %d points → %d (%d raw kept)",
                 len(points), len(out), len(recent))

    # -- read side -----------------------------------------------------
    def read_points(self, names: Optional[Iterable[str]] = None,
                    since: Optional[float] = None,
                    kinds: Optional[Iterable[str]] = None) -> List[dict]:
        """Points from disk plus the unflushed buffer, time-ordered.
        Reading works with the store knob off (`health` inspects
        history someone else recorded)."""
        pts = _read_lines(metrics_path(self.root))
        with self._lock:
            pts += list(self._buf)
        nameset = set(names) if names is not None else None
        kindset = set(kinds) if kinds is not None else None
        out = [p for p in pts
               if (nameset is None or p.get("name") in nameset)
               and (since is None or p.get("ts", 0.0) >= since)
               and (kindset is None or p.get("kind") in kindset)]
        out.sort(key=lambda p: p.get("ts", 0.0))
        return out

    def series(self, name: str, since: Optional[float] = None,
               limit: int = 0) -> List[tuple]:
        """(ts, value) pairs for one metric; rollup points contribute
        their `last` sample so trends span compacted history."""
        out = []
        for p in self.read_points(names=[name], since=since):
            v = p.get("value")
            if p.get("kind") == "rollup" and isinstance(v, dict):
                v = v.get("last")
            if isinstance(v, (int, float)):
                out.append((p["ts"], float(v)))
        return out[-limit:] if limit else out

    def events(self, limit: int = 10,
               names: Optional[Iterable[str]] = None) -> List[dict]:
        nameset = None if names is None else {f"event.{n}" for n in names}
        ev = self.read_points(names=nameset, kinds=["event"])
        return ev[-limit:]


def _read_lines(path: str) -> List[dict]:
    out: List[dict] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError as e:
        absorbed("health.events-read", e)
    return out


# ---------------------------------------------------------------------------
# per-process store registry
# ---------------------------------------------------------------------------

_stores: Dict[str, MetricsStore] = {}
_stores_lock = make_lock("obs.metrics_registry")


def store(root: str) -> MetricsStore:
    key = os.path.abspath(root)
    with _stores_lock:
        st = _stores.get(key)
        if st is None:
            st = _stores[key] = MetricsStore(root)
        return st


# ---------------------------------------------------------------------------
# step-record flush (the step_metrics seam)
# ---------------------------------------------------------------------------

def flush_step_record(root: str, rec: Dict) -> None:
    """Convert one finished step record (the dict step_metrics is about
    to persist to steps.jsonl) into metric points and flush: wall
    seconds, every numeric stage timer, the roofline block, the dag
    summary. Tagged by step (+ run_id when a trace run is live). Raises
    on flush failure — the caller absorbs."""
    st = store(root)
    if not metrics_enabled():
        return
    step = str(rec.get("step", "?"))
    tags: Dict = {"step": step}
    try:
        from shifu_tpu_torch.obs import trace as obs_trace
        if obs_trace.active():
            tags["run_id"] = obs_trace.current_run_id()
    except Exception as e:  # noqa: BLE001 — trace linkage is best-effort
        absorbed("health.trace-link", e)
    st.emit("step.wall_s", rec.get("wallSeconds", 0.0),
            rc=rec.get("rc"), **tags)
    wall = float(rec.get("wallSeconds") or 0.0)
    for k, v in (rec.get("inputPipeline") or {}).items():
        if isinstance(v, (int, float)):
            st.emit(f"stage.{k}", v, **tags)
    stall = (rec.get("inputPipeline") or {}).get("input_stall_s")
    if isinstance(stall, (int, float)) and wall > 0:
        st.emit("step.input_stall_frac", round(float(stall) / wall, 6),
                **tags)
    roof = rec.get("roofline")
    if isinstance(roof, dict):
        rt = dict(tags, family=roof.get("family"),
                  bound=roof.get("bound"))
        for k, v in roof.items():
            if isinstance(v, (int, float)):
                st.emit(f"roofline.{k}", v, **rt)
    dag = rec.get("dag")
    if isinstance(dag, dict):
        for k, v in dag.items():
            if isinstance(v, (int, float)):
                st.emit(f"dag.{k}", v, **tags)
    st.flush()


def eval_metrics(root: str, eval_name: str, perf: Dict,
                 model: str = "") -> None:
    """Buffer the eval guardrail metrics (AUC and friends) the moment
    the eval processor computes them; the step-exit flush
    (`step_completed`, `flush_step_record`) persists them. Never
    raises."""
    try:
        st = store(root)
        tags = {"eval": eval_name}
        if model:
            tags["model"] = model
        for key, name in (("areaUnderRoc", "eval.auc"),
                          ("weightedAreaUnderRoc", "eval.weighted_auc"),
                          ("accuracy", "eval.accuracy")):
            v = perf.get(key)
            if isinstance(v, (int, float)):
                st.emit(name, float(v), **tags)
    except Exception as e:  # noqa: BLE001 — health must not fail eval
        log.warning("eval metrics emit failed (step unaffected): %s", e)


def step_completed(root: str, step: str) -> None:
    """The `step_guard` exit hook: count the completed step and flush,
    so even a step without metrics leaves a heartbeat. Never raises."""
    try:
        st = store(root)
        st.counter("step.completed", 1.0, step=step)
        st.flush()
    except Exception as e:  # noqa: BLE001 — health must not fail the step
        log.warning("metrics flush failed (step unaffected): %s", e)
