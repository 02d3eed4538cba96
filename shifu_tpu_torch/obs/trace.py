"""Span-based flight recorder, the host half of the trace plane — the
port's copy of `shifu_tpu/obs/trace.py`.

`span("family.stage", **attrs)` is a context manager that records one
host span (wall start, duration, thread, parentage via a thread-local
stack) into a per-process bounded ring buffer; `record_span` backfills
a span from timestamps a layer already measured (the scheduler's
`ready_t`/`start_t`, the serving plane's batch splits). With
`SHIFU_TPU_TRACE` unset both are zero-cost no-ops — `span()` returns a
shared inert object without touching a lock or the clock.

Per step, `trace_run` (entered by `cli.main` around every command):

- generates the run_id that also names the `maybe_profile` device
  trace (`tmp/profile/<run_id>/`, a `torch.profiler` Chrome trace),
  so host spans and CUDA kernels for one step are sibling,
  discoverable artifacts (`trace ls` pairs them);
- exports this process's spans to `<trace_dir>/spans.<pid>.jsonl` via
  `fileio.atomic_write` (first line is a clock record carrying the
  host's offset to the coordinator clock);
- on the coordinator (the process that *created* the trace dir — it
  publishes `SHIFU_TPU_TRACE_DIR` so the DAG's `python -m
  shifu_tpu_torch` node processes land their span files in the same
  workspace), merges every `spans.*.jsonl` into one Chrome-trace-event
  JSON at `tmp/trace/<run_id>.trace.json`, ordering events by
  offset-corrected clocks — open it in ui.perfetto.dev;
- attaches the `trace` summary block (`profiling.TRACE_FIELDS`) to the
  step's steps.jsonl record.

Export runs through `fault_point("obs.export")` and is wrapped so a
trace-plane failure can never fail the step it was watching.

Span names are *registered*: every literal must be a `family.stage`
from SPAN_FAMILIES below, and every registry entry must be emitted
somewhere in the package (`tests/test_torch_trace.py` scans both
ways), so the vocabulary in traces stays enumerable. The JAX package's
`dist` family (its watched collectives) comes back with the multi-card
data plane.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import logging
import os
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from shifu_tpu_torch.config.environment import knob_bool, knob_int, knob_str
from shifu_tpu_torch.resilience import make_lock

log = logging.getLogger(__name__)

# the span-name vocabulary: family → stages. The registry test holds
# call sites and this table together both ways (an unknown
# "family.stage" literal fails it; so does a registered stage no file
# of the package emits).
SPAN_FAMILIES: Dict[str, Tuple[str, ...]] = {
    # the per-command root span trace_run opens
    "run": ("step",),
    # DAG scheduler: one node span per scheduled node (parent = run),
    # with queue (ready→dispatch) and run (dispatch→done) children
    "dag": ("node", "queue", "run"),
    # input pipeline stage timers, re-emitted as spans of the step
    "input": ("host_parse", "host_assemble", "h2d"),
    # serving plane: one request span with the submit_timed splits as
    # children, plus one flush span per formed batch
    "serve": ("request", "queue", "pad", "h2d", "device", "d2h",
              "flush"),
    # model fleet: one warm span per (re-)warm of a registry model
    # into residency, one evict span per LRU eviction back to host,
    # one swap span per in-place param hot-swap into resident
    # executables (the refresh loop's zero-recompile promotion)
    "fleet": ("warm", "evict", "swap"),
    # async checkpoint writer seams
    "ckpt": ("stage", "publish"),
    # the health plane's monitor loop: one window span per ingested
    # drift window, one evaluate span per SLO pass
    "watch": ("window", "evaluate"),
    # drift-triggered refresh: one run span per breach-scheduled
    # retrain→guardrail→promote cycle, one guardrail span per
    # challenger-vs-incumbent eval decision, one rollback span per
    # registry rollback + live re-swap
    "refresh": ("run", "guardrail", "rollback"),
    # live promotion: one run span per staged shadow→canary→promoted
    # cycle, one decide span per live-arm comparison, one rollback
    # span per canary breach (registry rollback + arm teardown)
    "canary": ("run", "decide", "rollback"),
    # shadow plane: one score span per mirrored request the side
    # thread replays against the challenger arm (discarded response)
    "shadow": ("score",),
}


def span_registered(name: str) -> bool:
    """True when `name` is a declared `family.stage` (the registry
    test's membership test)."""
    family, _, stage = name.partition(".")
    return stage in SPAN_FAMILIES.get(family, ())


# wall = monotonic + offset, computed once so retro spans recorded from
# monotonic timestamps land on the same clock as live spans
_MONO_OFFSET = time.time() - time.monotonic()


def wall(t_mono: float) -> float:
    """Convert a `time.monotonic()` timestamp to wall-clock seconds."""
    return t_mono + _MONO_OFFSET


_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class Tracer:
    """Per-process bounded span ring buffer. Thread-safe; overflow
    drops the OLDEST span (ring semantics) and counts the drop."""

    def __init__(self, run_id: str, trace_dir: str, coordinator: bool,
                 cap: int, clock_offset_s: float = 0.0):
        self.run_id = run_id
        self.trace_dir = trace_dir
        self.coordinator = coordinator
        self.clock_offset_s = float(clock_offset_s)
        self.root_id: Optional[str] = None
        self._cap = max(int(cap), 1)
        self._lock = make_lock("obs.trace")
        self._spans: collections.deque = collections.deque()
        self._dropped = 0
        self._total = 0
        self._next = 0
        self._child_s: Dict[str, float] = collections.defaultdict(float)
        self._open: Dict[str, tuple] = {}

    def new_id(self) -> str:
        with self._lock:
            self._next += 1
            return f"{os.getpid()}:{self._next}"

    def opened(self, sid: str, name: str, t0_mono: float) -> None:
        with self._lock:
            self._open[sid] = (name, t0_mono,
                               threading.current_thread().name)

    def closed(self, sid: str, name: str, parent: Optional[str],
               t0_mono: float, t1_mono: float, attrs: Dict,
               track: Optional[str] = None) -> None:
        rec = {"id": sid, "parent": parent, "name": name,
               "ts": wall(t0_mono), "dur": max(t1_mono - t0_mono, 0.0),
               "pid": os.getpid(),
               "tid": threading.get_ident(),
               "thread": threading.current_thread().name}
        if track is not None:
            rec["tid"] = zlib.crc32(track.encode()) & 0x7FFFFFFF
            rec["thread"] = track
        if attrs:
            rec["args"] = attrs
        with self._lock:
            self._open.pop(sid, None)
            self._total += 1
            if parent is not None:
                self._child_s[parent] += rec["dur"]
            if len(self._spans) >= self._cap:
                self._spans.popleft()
                self._dropped += 1
            self._spans.append(rec)

    def spans(self) -> List[dict]:
        with self._lock:
            return list(self._spans)

    def open_snapshot(self) -> List[dict]:
        now = time.monotonic()
        with self._lock:
            return [{"name": name, "age_s": round(now - t0, 3),
                     "thread": thread}
                    for name, t0, thread in self._open.values()]

    def summary(self) -> Dict:
        """The steps.jsonl `trace` block, keyed by TRACE_FIELDS."""
        from shifu_tpu_torch import profiling
        with self._lock:
            retained = list(self._spans)
            total, dropped = self._total, self._dropped
            child = dict(self._child_s)
        self_s: Dict[str, float] = collections.defaultdict(float)
        for rec in retained:
            self_s[rec["name"]] += max(
                rec["dur"] - child.get(rec["id"], 0.0), 0.0)
        top = [{"name": n, "self_s": round(s, 6)}
               for n, s in sorted(self_s.items(),
                                  key=lambda kv: -kv[1])[:3]]
        return dict(zip(profiling.TRACE_FIELDS, (total, dropped, top)))

    def export(self) -> Optional[str]:
        """Write this process's span file; on the coordinator, merge
        every host's file into the run's .trace.json. Raises on
        failure — trace_run absorbs it (the step must not fail)."""
        from shifu_tpu_torch import fileio, resilience
        resilience.fault_point("obs.export")
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir,
                            f"spans.{os.getpid()}.jsonl")
        with fileio.atomic_write(path, "w") as f:
            f.write(json.dumps(
                {"clock": {"pid": os.getpid(),
                           "offset_s": self.clock_offset_s,
                           "exported_at": round(time.time(), 3)}}) + "\n")
            for rec in self.spans():
                f.write(json.dumps(rec) + "\n")
        if not self.coordinator:
            return None
        out = os.path.join(os.path.dirname(self.trace_dir),
                           f"{self.run_id}.trace.json")
        merge_trace(self.trace_dir, out)
        return out


class _Noop:
    """The disabled-path span: a shared inert context manager."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("_tr", "name", "attrs", "id", "parent", "_t0")

    def __init__(self, tr: Tracer, name: str, attrs: Dict):
        self._tr = tr
        self.name = name
        self.attrs = attrs
        self.id = ""
        self.parent: Optional[str] = None

    def __enter__(self):
        tr = self._tr
        st = _stack()
        self.parent = st[-1] if st else tr.root_id
        self.id = tr.new_id()
        st.append(self.id)
        self._t0 = time.monotonic()
        tr.opened(self.id, self.name, self._t0)
        return self

    def __exit__(self, et, ev, tb):
        t1 = time.monotonic()
        st = _stack()
        if st and st[-1] == self.id:
            st.pop()
        if et is not None:
            self.attrs = dict(self.attrs, error=repr(ev))
        self._tr.closed(self.id, self.name, self.parent, self._t0, t1,
                        self.attrs)
        return False


class _Run:
    __slots__ = ("root", "step", "run_id", "enabled", "tracer")

    def __init__(self, root, step, run_id, enabled, tracer):
        self.root = root
        self.step = step
        self.run_id = run_id
        self.enabled = enabled
        self.tracer = tracer


_RUN: Optional[_Run] = None


def active() -> bool:
    """True when a trace run is recording (the cheap guard layers use
    before computing span attributes)."""
    run = _RUN
    return run is not None and run.enabled


def span(name: str, **attrs):
    """Record a span around a `with` block. Zero-cost no-op unless a
    `trace_run` with `SHIFU_TPU_TRACE=1` is active."""
    run = _RUN
    if run is None or not run.enabled:
        return _NOOP
    return _Span(run.tracer, name, attrs)


def record_span(name: str, t0_mono: float, t1_mono: float,
                parent: Optional[str] = None,
                track: Optional[str] = None, **attrs) -> Optional[str]:
    """Backfill one span from monotonic timestamps a layer already
    measured. `parent` defaults to the calling thread's open span (or
    the run root); `track` groups the event onto a named synthetic
    Perfetto track instead of the recording thread's. Returns the span
    id (for parenting children), or None when tracing is off."""
    run = _RUN
    if run is None or not run.enabled:
        return None
    tr = run.tracer
    if parent is None:
        st = _stack()
        parent = st[-1] if st else tr.root_id
    sid = tr.new_id()
    tr.closed(sid, name, parent, t0_mono, t1_mono, attrs, track=track)
    return sid


def open_spans() -> List[dict]:
    """Currently open spans (name, age, thread) — what a watchdog
    cites when a deadline fires."""
    run = _RUN
    if run is None or not run.enabled:
        return []
    return run.tracer.open_snapshot()


def current_run_id(step: Optional[str] = None) -> str:
    """The active trace run's id, or a fresh one for an untraced step —
    either way the id `maybe_profile` should name its output after so
    device and host traces pair up under tmp/."""
    run = _RUN
    if run is not None:
        return run.run_id
    return f"{step or 'run'}-{int(time.time())}-{os.getpid()}"


@contextlib.contextmanager
def trace_run(root: str, step: str):
    """Per-command trace scope: start the tracer (when enabled), open
    the `run.step` root span, and at exit attach the TRACE_FIELDS
    summary to the step record and export/merge the span files."""
    global _RUN
    if _RUN is not None:        # nested command in-process: passthrough
        yield None
        return
    if not knob_bool("SHIFU_TPU_TRACE"):
        yield None
        return
    env_dir = knob_str("SHIFU_TPU_TRACE_DIR")
    coordinator = not env_dir
    if env_dir:
        tdir = env_dir
        run_id = os.path.basename(os.path.normpath(tdir)) \
            or f"{step}-{os.getpid()}"
    else:
        run_id = f"{step}-{int(time.time())}-{os.getpid()}"
        tdir = os.path.join(root, "tmp", "trace", run_id)
        # the DAG's node processes inherit the workspace so their span
        # files join this run's merge
        os.environ["SHIFU_TPU_TRACE_DIR"] = tdir
    tracer = Tracer(run_id=run_id, trace_dir=tdir,
                    coordinator=coordinator,
                    cap=knob_int("SHIFU_TPU_TRACE_BUF"))
    run = _Run(root, step, run_id, True, tracer)
    _RUN = run
    root_span = span("run.step", step=step)
    root_span.__enter__()
    tracer.root_id = root_span.id
    try:
        yield run
    finally:
        root_span.__exit__(None, None, None)
        try:
            from shifu_tpu_torch import profiling
            profiling.set_step_extra("trace", tracer.summary())
        except Exception as e:  # noqa: BLE001 — never fail the step
            log.warning("trace summary failed: %s", e)
        try:
            out = tracer.export()
            if out:
                log.info("merged trace written to %s (open in "
                         "ui.perfetto.dev)", out)
        except Exception as e:  # noqa: BLE001 — never fail the step
            log.warning("trace export failed (step unaffected): %s", e)
        if coordinator:
            os.environ.pop("SHIFU_TPU_TRACE_DIR", None)
        _RUN = None


# ---------------------------------------------------------------------------
# merge + discovery
# ---------------------------------------------------------------------------

def merge_trace(trace_dir: str, out_path: str) -> Dict:
    """Merge every `spans.*.jsonl` under `trace_dir` into one
    Chrome-trace-event JSON at `out_path`, subtracting each file's
    recorded clock offset so cross-host spans order correctly."""
    from shifu_tpu_torch import fileio
    events: List[dict] = []
    for path in sorted(glob.glob(os.path.join(trace_dir,
                                              "spans.*.jsonl"))):
        offset = 0.0
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if "clock" in rec:
                    offset = float(rec["clock"].get("offset_s", 0.0))
                    continue
                args = dict(rec.get("args", {}))
                args["id"] = rec.get("id")
                if rec.get("parent") is not None:
                    args["parent"] = rec["parent"]
                events.append({
                    "name": rec["name"],
                    "cat": rec["name"].split(".", 1)[0],
                    "ph": "X",
                    "ts": int((rec["ts"] - offset) * 1e6),
                    "dur": max(int(rec["dur"] * 1e6), 1),
                    "pid": rec.get("pid", 0),
                    "tid": rec.get("tid", 0),
                    "args": args,
                })
    events.sort(key=lambda e: e["ts"])
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    with fileio.atomic_write(out_path, "w") as f:
        json.dump(doc, f)
    return doc


def trace_ls(root: str) -> List[dict]:
    """Discoverable run artifacts under `<root>/tmp`: one row per
    run_id pairing the merged span trace (tmp/trace/) with the
    maybe_profile device trace (tmp/profile/) that shares its name."""
    trace_dir = os.path.join(root, "tmp", "trace")
    profile_dir = os.path.join(root, "tmp", "profile")
    runs: Dict[str, dict] = {}

    def _row(run_id: str) -> dict:
        return runs.setdefault(run_id, {"run_id": run_id, "trace": None,
                                        "span_files": 0, "profile": None})

    for path in sorted(glob.glob(os.path.join(trace_dir,
                                              "*.trace.json"))):
        rid = os.path.basename(path)[:-len(".trace.json")]
        _row(rid)["trace"] = path
    for d in sorted(glob.glob(os.path.join(trace_dir, "*"))):
        if os.path.isdir(d):
            _row(os.path.basename(d))["span_files"] = len(
                glob.glob(os.path.join(d, "spans.*.jsonl")))
    for d in sorted(glob.glob(os.path.join(profile_dir, "*"))):
        if os.path.isdir(d):
            _row(os.path.basename(d))["profile"] = d
    return [runs[k] for k in sorted(runs)]
