"""Fault injection, bounded retry and deliberate absorbs — the port's
copy of the parts of `shifu_tpu/resilience.py` that the serving plane,
the health plane, the registry and the fleet call:

1. **Deterministic fault injection** (`fault_point`): the env spec

       SHIFU_TPU_FAULT=<site>:<kind>:<nth>[;<site>:<kind>:<nth>...]

   makes an instrumented site misbehave on specific calls. ``kind`` is
   ``oserror`` | ``timeout`` (raise OSError / TimeoutError), ``kill``
   (SIGKILL the process — a real mid-publish crash) or ``preempt`` (set
   the graceful-shutdown flag that SIGTERM sets). ``nth`` is a 1-based
   per-site call counter: ``2`` fires on exactly the 2nd call, ``1-3``
   on calls 1..3, ``2+`` on every call from the 2nd on. The sites of
   this slice are listed in ``FAULT_SITES``. Unset (the default) this
   is dead code.
2. **Bounded retry with backoff** (`retrying`): transient errors
   (timeouts, connection and other OS errors) are retried with
   exponential backoff under ``SHIFU_TPU_RETRY_ATTEMPTS`` /
   ``_BASE_S`` / ``_MAX_S``; permanent ones (a missing file, a
   permission error) propagate at once (`is_transient`).
3. **Deliberate absorbs** (`absorbed`, `absorb_counts`): a per-site
   counter for every exception the health plane swallows by design.
4. **Preemption flag** (`request_preempt`, `preempt_requested`,
   `graceful_shutdown`): SIGTERM/SIGINT set a flag the watch loop
   checks at tick boundaries, as `cli serve` stops on them.

`atomic_write` and `atomic_path` stay in `fileio.py`. The abort and
preempt markers, `supervise`, `step_guard`, checkpoint faults and the
remaining sites of the JAX package's ``FAULT_SITES`` are ROADMAP A8.1,
but for ``shadow.score``, which comes with the shadow arm (A7.4).
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import random
import re
import signal
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


# the static fault sites of the port's serving and health planes
FAULT_SITES = (
    "serve.route", "registry.publish", "obs.metrics_flush", "obs.alert",
    "obs.webhook", "watch.window", "refresh.swap",
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
            delay = min(cap, base * 2 ** (attempt - 1))
            delay *= 0.5 + random.random()  # jitter: 0.5x..1.5x
            log.warning("%s: transient %s (attempt %d/%d), retrying in "
                        "%.2fs: %s", site, type(e).__name__, attempt,
                        attempts, delay, e)
            time.sleep(delay)


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
# preemption flag
# ---------------------------------------------------------------------------

_preempt = threading.Event()


def request_preempt() -> None:
    _preempt.set()


def preempt_requested() -> bool:
    return _preempt.is_set()


def clear_preempt() -> None:
    _preempt.clear()


@contextlib.contextmanager
def graceful_shutdown(note: str = "watching") -> Iterator[None]:
    """SIGTERM/SIGINT set the preemption flag (cleared on entry) while
    the block runs (the loop stops at its next boundary); a second
    signal restores the
    previous handlers and raises KeyboardInterrupt at once. No-op off
    the main thread (`signal.signal` would raise)."""
    clear_preempt()
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    previous = {}

    def _handler(signum, frame):  # noqa: ARG001 — signal API
        if _preempt.is_set():
            for sig, handler in previous.items():
                signal.signal(sig, handler)
            raise KeyboardInterrupt(f"second signal {signum} during {note}")
        log.warning("signal %d: stopping %s at the next boundary",
                    signum, note)
        request_preempt()

    for sig in (signal.SIGTERM, signal.SIGINT):
        previous[sig] = signal.signal(sig, _handler)
    try:
        yield
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
