"""Fault injection, bounded retry, markers, preemption and supervised
restarts — the port's copy of `shifu_tpu/resilience.py`:

1. **Deterministic fault injection** (`fault_point`): the env spec

       SHIFU_TPU_FAULT=<site>:<kind>:<nth>[;<site>:<kind>:<nth>...]

   makes an instrumented site misbehave on specific calls. ``kind`` is
   ``oserror`` | ``timeout`` (raise OSError / TimeoutError), ``kill``
   (SIGKILL the process — a real mid-step crash) or ``preempt`` (set
   the graceful-shutdown flag that SIGTERM sets). ``nth`` is a 1-based
   per-site call counter: ``2`` fires on exactly the 2nd call, ``1-3``
   on calls 1..3, ``2+`` on every call from the 2nd on. The static
   sites are listed in ``FAULT_SITES`` (plus the dynamic
   ``step.<name>`` at each processor step's start). Unset (the
   default) this is dead code.
2. **Bounded retry with backoff** (`retrying`, the `retry`
   decorator): transient errors (timeouts, connection and other OS
   errors) are retried with exponential backoff under
   ``SHIFU_TPU_RETRY_ATTEMPTS`` / ``_BASE_S`` / ``_MAX_S``; permanent
   ones (a missing file, a permission error, a value error) propagate
   at once (`is_transient`). Every retried failure is counted by site
   (`retry_stats`), which each step's ``steps.jsonl`` record and the
   `test` verb's closing line report.
3. **Deliberate absorbs** (`absorbed`, `absorb_counts`): a per-site
   counter for every exception swallowed by design.
4. **The abort scope** (`set_abort_scope`): the model set's ``tmp/``,
   set by `step_guard` and by `pipeline.scheduler.run_dag`. A step's
   start and each supervised attempt clear a stale abort or preempt
   marker there (`clear_abort`, `clear_preempt_marker`), as the JAX
   package's do. The DAG's first failing node publishes an abort
   marker (`publish_abort`): the JAX package's record, which
   `check_abort` reads back. A ``scheme://`` scope (a model set on
   remote storage) keeps its markers there, through fsspec.
5. **Preemption-safe shutdown** (`graceful_shutdown` /
   `preempt_requested` / `Preempted`): SIGTERM/SIGINT set a flag the
   epoch loops check at step boundaries; the trainer saves a final
   checkpoint and raises `Preempted`, which the CLI turns into
   ``PREEMPT_RC`` (75) — a rerun with ``SHIFU_TPU_RESUME=1`` picks up
   at the saved step. Leaving the scope flushes the background
   checkpoint writer.
6. **Supervised restarts** (`supervise`): the train step is re-invoked
   on preemption or a transient failure up to
   ``SHIFU_TPU_MAX_RESTARTS`` times (default 0 = off) with exponential
   backoff; each attempt restores from its checkpoint directory.
   Each restart record is appended to the scope's
   ``metrics/steps.jsonl`` and buffered (`note_event`) for the step's
   own record, which `profiling.step_metrics` drains
   (`drain_events`).
7. **Startup hygiene** (`sweep_stale`): the ``.tmp.*`` residue a
   killed `fileio.atomic_write` leaves in a directory, local or
   ``scheme://``, is removed when a step or the row log starts.

`atomic_write` and `atomic_path` stay in `fileio.py` (their
``atomic.commit`` site fires just before the rename). The multi-host
pieces are ROADMAP A8.3: the peer side of the markers (a barrier that
waits on a peer's abort marker, `check_preempt_marker`),
`publish_preempt` (the broadcast from the signal handler),
`preempt_exit_sync` (the ordered exit and its ``preempt.ack.*``
markers) and `dump_thread_stacks` (the collective watchdog's).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import logging
import os
import random
import re
import signal
import sys
import threading
import time
from typing import Callable, Iterator, List, NamedTuple, Optional

from shifu_tpu_torch.config.environment import (knob_float, knob_int,
                                                knob_str)

log = logging.getLogger("shifu_tpu_torch")

# OSError subclasses that signal a durable condition a retry cannot fix
_PERMANENT_OSERRORS = (FileNotFoundError, PermissionError, IsADirectoryError,
                       NotADirectoryError, FileExistsError)

# non-stdlib exception type names treated as transient without importing
# their (optional) packages
_TRANSIENT_NAMES = frozenset({
    "FSTimeoutError", "ServerTimeoutError", "ClientError",
    "ClientConnectorError", "ClientOSError", "ReadTimeoutError",
    "ConnectTimeoutError", "IncompleteReadError", "EndpointConnectionError",
    "SlowDown", "ThrottlingException",
})


def make_lock(name: str, reentrant: bool = False):
    """A plain (or reentrant) lock; `name` documents what it guards."""
    del name
    return threading.RLock() if reentrant else threading.Lock()


def is_transient(exc: BaseException) -> bool:
    """Whether a retry could plausibly succeed. Permanent conditions —
    missing file, bad permissions, value errors — return False."""
    if isinstance(exc, _PERMANENT_OSERRORS):
        return False
    if isinstance(exc, (TimeoutError, ConnectionError, InterruptedError,
                        OSError)):
        return True
    return type(exc).__name__ in _TRANSIENT_NAMES


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

class _FaultRule(NamedTuple):
    site: str
    kind: str       # oserror | timeout | kill | preempt
    lo: int
    hi: float       # inclusive; inf for "N+"


# every static fault site of the port (`step.<name>` sites are
# dynamic); the JAX package's others are its collectives (`dist.*`,
# A8.3)
FAULT_SITES = (
    "fs.exists", "fs.size", "fs.list", "fs.open",
    "reader.read", "reader.native",
    "ckpt.save", "ckpt.stage", "ckpt.publish", "ckpt.saved",
    "ckpt.restore", "ckpt.reshard",
    "atomic.commit", "pipeline.fetch", "serve.request",
    "serve.route", "registry.publish", "obs.metrics_flush", "obs.alert",
    "obs.webhook", "watch.window", "refresh.swap",
    "ingest.append", "ingest.seal", "ingest.offset",
    "refresh.schedule", "refresh.guardrail", "refresh.promote",
    "canary.start", "canary.decide", "canary.rollback", "shadow.score",
    "dag.node", "dag.slice", "obs.export",
)

_NTH_RE = re.compile(r"^(\d+)(\+|-(\d+))?$")
_rules_cache: tuple = ("", [])
# per-site call counters, process-wide so the Nth call is the Nth call
# across retries too
_counts: collections.Counter = collections.Counter()


def reset_faults() -> None:
    """Reset per-site call counters (test isolation)."""
    _counts.clear()


def _parse_fault_spec(raw: str) -> List[_FaultRule]:
    rules = []
    for part in re.split(r"[;,]", raw):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) != 3:
            raise ValueError(
                f"bad SHIFU_TPU_FAULT entry {part!r}: want "
                "<site>:<kind>:<nth> (nth = N | N-M | N+)")
        site, kind, nth = bits
        kind = kind.lower()
        if kind not in ("oserror", "timeout", "kill", "preempt"):
            raise ValueError(f"bad SHIFU_TPU_FAULT kind {kind!r}: want "
                             "oserror | timeout | kill | preempt")
        m = _NTH_RE.match(nth.strip())
        if not m:
            raise ValueError(f"bad SHIFU_TPU_FAULT nth {nth!r}: want "
                             "N | N-M | N+")
        lo = int(m.group(1))
        hi = float("inf") if m.group(2) == "+" else \
            int(m.group(3)) if m.group(3) else lo
        rules.append(_FaultRule(site.strip(), kind, lo, hi))
    return rules


def fault_point(site: str) -> None:
    """Instrumentation seam: no-op unless SHIFU_TPU_FAULT names `site`."""
    global _rules_cache
    raw = knob_str("SHIFU_TPU_FAULT", "") or ""
    if not raw:
        return
    if _rules_cache[0] != raw:
        _rules_cache = (raw, _parse_fault_spec(raw))
    rules = [r for r in _rules_cache[1] if r.site == site]
    if not rules:
        return
    _counts[site] += 1
    n = _counts[site]
    for r in rules:
        if r.lo <= n <= r.hi:
            if r.kind == "kill":
                log.error("fault injection: SIGKILL at %s (call %d)",
                          site, n)
                os.kill(os.getpid(), signal.SIGKILL)
            if r.kind == "preempt":
                log.warning("fault injection: preempt at %s (call %d)",
                            site, n)
                request_preempt()
                return
            exc = TimeoutError if r.kind == "timeout" else OSError
            raise exc(f"injected {r.kind} at {site} (call {n})")


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------

# per-site retry accounting (the `test` verb's closing line and each
# step's tmp/metrics/steps.jsonl record) — thread-safe: retried I/O can
# run on pipeline prefetch workers
_retry_lock = make_lock("resilience.retry_stats")
_retry_stats: dict = {}


def _note_retry(site: str, exc: BaseException) -> None:
    with _retry_lock:
        d = _retry_stats.setdefault(site, {"attempts": 0, "lastError": ""})
        d["attempts"] += 1
        d["lastError"] = f"{type(exc).__name__}: {exc}"


def retry_stats(reset: bool = False) -> dict:
    """{site: {attempts, lastError}} for every retried call since the
    last reset. `attempts` counts RETRIED failures — zero means every
    call succeeded first try (the dict is then empty)."""
    with _retry_lock:
        out = {k: dict(v) for k, v in _retry_stats.items()}
        if reset:
            _retry_stats.clear()
    return out


def reset_retry_stats() -> None:
    with _retry_lock:
        _retry_stats.clear()


def retrying(site: str, fn: Callable, *args, **kwargs):
    """Call `fn(*args, **kwargs)` with bounded exponential-backoff
    retries on transient errors. The site's fault point fires before
    every attempt, so injected faults go through the real loop."""
    attempts = max(knob_int("SHIFU_TPU_RETRY_ATTEMPTS"), 1)
    base = knob_float("SHIFU_TPU_RETRY_BASE_S")
    cap = knob_float("SHIFU_TPU_RETRY_MAX_S")
    for attempt in range(1, attempts + 1):
        try:
            fault_point(site)
            return fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — classified below
            if attempt >= attempts or not is_transient(e):
                raise
            _note_retry(site, e)
            delay = min(cap, base * 2 ** (attempt - 1))
            delay *= 0.5 + random.random()  # jitter: 0.5x..1.5x
            log.warning("%s: transient %s (attempt %d/%d), retrying in "
                        "%.2fs: %s", site, type(e).__name__, attempt,
                        attempts, delay, e)
            time.sleep(delay)


def retry(site: str):
    """Decorator form of `retrying`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return retrying(site, fn, *args, **kwargs)
        return wrapped
    return deco


# ---------------------------------------------------------------------------
# deliberate absorbs
# ---------------------------------------------------------------------------

_absorb_lock = threading.Lock()
_absorb_counts: collections.Counter = collections.Counter()


def absorbed(site: str, exc: Optional[BaseException] = None) -> None:
    """Record a deliberate exception absorb at `site` (dotted
    module.purpose name). Bumps the per-site counter and logs the error
    at debug — never raises."""
    with _absorb_lock:
        _absorb_counts[site] += 1
    if exc is not None:
        log.debug("absorbed[%s]: %r", site, exc)


def absorb_counts() -> dict:
    """{site: count} snapshot of deliberate absorbs this process."""
    with _absorb_lock:
        return dict(_absorb_counts)


# ---------------------------------------------------------------------------
# abort and preempt markers, durable event records
# ---------------------------------------------------------------------------

# the model set's tmp/ directory: set by step_guard on entry so code
# deep in the stack reaches the markers without a root argument
_abort_scope: Optional[str] = None
_ABORT_NAME = "abort.marker"
_PREEMPT_NAME = "preempt.marker"


def set_abort_scope(tmp_dir: Optional[str]) -> None:
    """Point the abort/preempt markers and the durable event records at
    the model set's ``tmp/`` directory (None unsets it)."""
    global _abort_scope
    _abort_scope = tmp_dir


def _remote(path: str) -> bool:
    from shifu_tpu_torch.fileio import has_scheme
    return has_scheme(path)


def _marker_path(name: str) -> Optional[str]:
    d = _abort_scope
    if not d:
        return None
    if _remote(d):
        return d.rstrip("/") + "/" + name
    return os.path.join(d, name)


def _read_marker(path: Optional[str], what: str) -> Optional[dict]:
    if not path:
        return None
    try:
        if _remote(path):
            import fsspec
            fs, key = fsspec.core.url_to_fs(path)
            if not fs.exists(key):
                return None
            with fs.open(key, "r") as f:
                raw = f.read()
        else:
            if not os.path.exists(path):
                return None
            with open(path) as f:
                raw = f.read()
        return json.loads(raw)
    except FileNotFoundError:
        return None
    except Exception as e:  # noqa: BLE001 — corrupt marker still counts
        return {"site": "unknown", "process": -1,
                "error": f"unreadable {what} marker: {e}"}


def _clear_marker(path: Optional[str], what: str) -> None:
    if not path:
        return
    try:
        if _remote(path):
            import fsspec
            fs, key = fsspec.core.url_to_fs(path)
            if fs.exists(key):
                fs.rm(key)
        elif os.path.exists(path):
            os.remove(path)
    except Exception as e:  # noqa: BLE001 — best-effort
        log.warning("could not clear %s marker %s: %s", what, path, e)


def check_abort() -> Optional[dict]:
    """The abort marker's record under the scope (`publish_abort`'s
    ``site``, ``process``, ``error``, ``time``), or None: what a caller
    reads to learn which DAG node failed. An unreadable marker still
    counts, as a record with ``site`` "unknown"."""
    return _read_marker(_marker_path(_ABORT_NAME), "abort")


def clear_abort() -> None:
    """Remove a stale abort marker (step start, restart attempt)."""
    _clear_marker(_marker_path(_ABORT_NAME), "abort")


def publish_abort(site: str, exc: BaseException,
                  process: Optional[int] = None) -> None:
    """Atomically write the abort marker under the scope: the JAX
    package's record (``site``, ``process``, ``error``, ``time``).
    `process` defaults to 0: the port runs one process. Best-effort: a
    failure to publish never masks the original exception."""
    path = _marker_path(_ABORT_NAME)
    if not path:
        return
    rec = {"site": site, "process": 0 if process is None else process,
           "error": f"{type(exc).__name__}: {exc}",
           "time": round(time.time(), 3)}
    try:
        from shifu_tpu_torch.fileio import atomic_write
        if not _remote(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        with atomic_write(path) as f:
            f.write(json.dumps(rec))
        log.error("abort marker published at %s (site=%s): %s", path,
                  site, rec["error"])
    except Exception as e:  # noqa: BLE001 — never mask the original
        log.warning("could not publish abort marker %s: %s", path, e)


def clear_preempt_marker() -> None:
    """Remove a stale preempt marker (step start, restart attempt)."""
    _clear_marker(_marker_path(_PREEMPT_NAME), "preempt")


# resilience events (supervised restarts) — buffered for the step's
# steps.jsonl record, which profiling.step_metrics drains; each is
# also appended as a standalone line the moment it happens, because a
# killed process may never reach the step record
_events_lock = make_lock("resilience.events")
_events: List[dict] = []


def note_event(rec: dict) -> None:
    with _events_lock:
        _events.append(rec)


def drain_events() -> List[dict]:
    """Snapshot AND clear buffered resilience events (step_metrics)."""
    with _events_lock:
        out = list(_events)
        _events.clear()
    return out


def _append_steps_jsonl(rec: dict) -> None:
    """Durable append to the scope's metrics/steps.jsonl (local scopes
    only: a remote scope keeps the in-memory event instead)."""
    d = _abort_scope
    if not d or _remote(d):
        return
    try:
        mdir = os.path.join(d, "metrics")
        os.makedirs(mdir, exist_ok=True)
        with open(os.path.join(mdir, "steps.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError as e:
        log.warning("could not append event to steps.jsonl: %s", e)


# ---------------------------------------------------------------------------
# preemption-safe shutdown
# ---------------------------------------------------------------------------

#: exit code of a preempted but checkpointed run (EX_TEMPFAIL): a
#: supervisor that sees it reruns with SHIFU_TPU_RESUME=1
PREEMPT_RC = 75


class Preempted(RuntimeError):
    """Raised at a step boundary after a SIGTERM/SIGINT (or an injected
    ``preempt`` fault) once the final checkpoint is saved."""
    rc = PREEMPT_RC


_preempt = threading.Event()


def request_preempt() -> None:
    _preempt.set()


def preempt_requested() -> bool:
    return _preempt.is_set()


def clear_preempt() -> None:
    _preempt.clear()


def _flush_checkpoints() -> None:
    """Make an in-flight background checkpoint durable (a preempt exits
    rc 75 right after the scope unwinds). Nothing to flush when the
    checkpoint module was never imported."""
    ckpt = sys.modules.get("shifu_tpu_torch.train.checkpoint")
    if ckpt is None:
        return
    try:
        ckpt.flush_saves(reraise=False)
    except Exception as e:  # noqa: BLE001 — the unwind must go on
        absorbed("preempt.ckpt-flush", e)


@contextlib.contextmanager
def graceful_shutdown(note: str = "watching") -> Iterator[None]:
    """SIGTERM/SIGINT set the preemption flag (cleared on entry) while
    the block runs: the loop stops at its next boundary (an epoch loop
    checkpoints and raises `Preempted`); a second signal restores the
    previous handlers and raises KeyboardInterrupt at once. Leaving
    the block flushes the background checkpoint writer. The handlers
    are installed on the main thread only (`signal.signal` raises
    elsewhere)."""
    clear_preempt()
    previous = {}

    def _handler(signum, frame):  # noqa: ARG001 — signal API
        if _preempt.is_set():
            for sig, handler in previous.items():
                signal.signal(sig, handler)
            raise KeyboardInterrupt(f"second signal {signum} during {note}")
        log.warning("signal %d: stopping %s at the next boundary "
                    "(a checkpointed trainer exits rc=%d; rerun with "
                    "SHIFU_TPU_RESUME=1 to resume)", signum, note,
                    PREEMPT_RC)
        request_preempt()

    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous[sig] = signal.signal(sig, _handler)
    try:
        yield
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        _flush_checkpoints()


# ---------------------------------------------------------------------------
# supervised restart loop
# ---------------------------------------------------------------------------

def _device_count(device) -> int:
    """The cards torch sees for a run on `device` (1 for the CPU): what
    a restart resumes on."""
    if device is None or str(device).startswith("cpu"):
        return 1
    import torch
    return int(torch.cuda.device_count()) if torch.cuda.is_available() \
        else 0


def supervise(fn: Callable[[], "object"], step: str = "train",
              max_restarts: Optional[int] = None, device=None):
    """Run `fn()` under a restart supervisor: on `Preempted` or a
    transient failure, re-invoke it up to ``SHIFU_TPU_MAX_RESTARTS``
    times (default 0 — supervision off) with exponential backoff. The
    trainers restore from their checkpoint directory on entry, so each
    re-invocation resumes at the last saved step. Restart records (with
    the cards torch sees for the run's `device`) are appended to
    ``steps.jsonl`` when a scope is set.
    Permanent errors and an exhausted budget re-raise."""
    if max_restarts is None:
        max_restarts = max(knob_int("SHIFU_TPU_MAX_RESTARTS"), 0)
    base = knob_float("SHIFU_TPU_RETRY_BASE_S")
    cap = knob_float("SHIFU_TPU_RETRY_MAX_S")
    restarts = 0
    while True:
        clear_preempt()
        clear_abort()
        clear_preempt_marker()
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — classified below
            restartable = isinstance(e, Preempted) or is_transient(e)
            if restarts >= max_restarts or not restartable:
                raise
            restarts += 1
            delay = min(cap, base * 2 ** (restarts - 1))
            err = f"{type(e).__name__}: {e}"
            log.warning("supervise[%s]: restart %d/%d in %.2fs after %s",
                        step, restarts, max_restarts, delay, err)
            rec = {"step": step, "event": "restart", "restart": restarts,
                   "maxRestarts": max_restarts, "error": err,
                   "time": round(time.time(), 3),
                   "devices": _device_count(device)}
            note_event(rec)
            _append_steps_jsonl(rec)
            time.sleep(delay)


# ---------------------------------------------------------------------------
# startup hygiene
# ---------------------------------------------------------------------------

def sweep_stale_tmp_remote(directory: str) -> int:
    """Remote twin of the local sweep: delete the orphaned dot-prefixed
    temp keys that a `fileio._remote_atomic_write` killed between upload
    and commit left under a ``scheme://`` directory. Returns the count
    removed (0 when the directory does not exist yet)."""
    import fsspec
    fs, key = fsspec.core.url_to_fs(directory.rstrip("/"))
    try:
        names = fs.ls(key, detail=False)
    except FileNotFoundError:
        return 0
    n = 0
    for full in names:
        base = full.rstrip("/").rpartition("/")[2]
        if base.startswith(".tmp."):
            try:
                fs.rm(full, recursive=True)
                n += 1
            except FileNotFoundError:  # raced with another sweeper
                pass
    return n


def sweep_stale(directory: str) -> int:
    """Remove leftover ``.tmp.*`` files and directories of killed
    earlier writers (`fileio.atomic_write`, `atomic_path`) from a local
    or ``scheme://`` `directory`; returns the count removed.
    Best-effort: a failed sweep logs and returns 0, startup hygiene
    never fails a step."""
    from shifu_tpu_torch import fileio
    try:
        if fileio.has_scheme(directory):
            return sweep_stale_tmp_remote(directory)
        if not os.path.isdir(directory):
            return 0
        n = 0
        for name in os.listdir(directory):
            if name.startswith(".tmp."):
                fileio._scrub(os.path.join(directory, name))
                n += 1
        return n
    except Exception as e:  # noqa: BLE001 — best-effort
        log.warning("sweep_stale: could not sweep %s: %s", directory, e)
        return 0
