"""Declarative SLO watchdog over the metrics store — counterpart of
`shifu_tpu/obs/health/slo.py`.

`slo.json` (``SHIFU_TPU_SLO_FILE``, else `<root>/slo.json`, else the
defaults below) declares guardrails as a list of rules:

    {"slos": [
      {"name": "serve_p99",   "metric": "serve.p99_ms",
       "op": "<=", "warn": 50.0, "breach": 200.0,
       "window_s": 3600, "agg": "last"},
      {"name": "drift",       "metric": "drift.psi_max",
       "op": "<=", "warn": 0.1, "breach": 0.25},
      {"name": "auc",         "metric": "eval.auc",
       "op": ">=", "warn": 0.75, "breach": 0.70},
      ...
    ]}

`op` orients the guardrail (`<=` = smaller-is-better latency-style,
`>=` = larger-is-better AUC-style); `agg` folds the points inside
`window_s` (last | mean | max | min). A rule with no data is `ok` —
absence of evidence never pages anyone.

`SloEvaluator` carries hysteresis so a flapping metric does not spam
alerts: a state DEGRADES immediately (one bad sample is a real warn/
breach) but RECOVERS only after `clear` consecutive better
evaluations. Every evaluation emits one `health.<slo>` gauge; every
state TRANSITION emits a `breach`/`warn`/`recovered` event and fans
out to the alert sinks, each dispatch routed through
`fault_point("obs.alert")` and absorbed — a dead webhook can never
take down the watch loop. Records are shaped by `HEALTH_FIELDS` (the
JAX package's `profiling.HEALTH_FIELDS`).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional

from shifu_tpu_torch.config.environment import knob_float, knob_str
from shifu_tpu_torch.obs.health import store as health_store
from shifu_tpu_torch.profiling import HEALTH_FIELDS
from shifu_tpu_torch.resilience import fault_point, retrying

log = logging.getLogger("shifu_tpu_torch")

_RANK = {"ok": 0, "warn": 1, "breach": 2}
ALERTS_FILE = "alerts.jsonl"

DEFAULT_SLOS: List[Dict] = [
    {"name": "serve_p99", "metric": "serve.p99_ms", "op": "<=",
     "warn": 50.0, "breach": 200.0, "window_s": 3600.0, "agg": "last"},
    {"name": "serve_rejects", "metric": "serve.reject_rate", "op": "<=",
     "warn": 0.01, "breach": 0.05, "window_s": 3600.0, "agg": "last"},
    {"name": "drift", "metric": "drift.psi_max", "op": "<=",
     "warn": 0.1, "breach": 0.25, "window_s": 86400.0, "agg": "last"},
    {"name": "auc", "metric": "eval.auc", "op": ">=",
     "warn": 0.75, "breach": 0.70, "window_s": 7 * 86400.0, "agg": "last"},
    {"name": "input_stall", "metric": "step.input_stall_frac", "op": "<=",
     "warn": 0.20, "breach": 0.50, "window_s": 86400.0, "agg": "mean"},
]


def load_slos(root: str) -> List[Dict]:
    """SHIFU_TPU_SLO_FILE > <root>/slo.json > DEFAULT_SLOS."""
    path = knob_str("SHIFU_TPU_SLO_FILE") or os.path.join(root, "slo.json")
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        slos = doc.get("slos", doc) if isinstance(doc, dict) else doc
        if not isinstance(slos, list):
            raise ValueError(f"{path}: expected a list or {{'slos': [...]}}")
        for s in slos:
            for req in ("name", "metric", "warn", "breach"):
                if req not in s:
                    raise ValueError(f"{path}: slo missing {req!r}: {s}")
        return slos
    return [dict(s) for s in DEFAULT_SLOS]


def _classify(value: float, slo: Dict) -> str:
    op = slo.get("op", "<=")
    warn, breach = float(slo["warn"]), float(slo["breach"])
    if op == ">=":   # larger-is-better (AUC-style guardrail)
        if value < breach:
            return "breach"
        return "warn" if value < warn else "ok"
    if value > breach:
        return "breach"
    return "warn" if value > warn else "ok"


def _aggregate(values: List[float], agg: str) -> Optional[float]:
    if not values:
        return None
    if agg == "mean":
        return sum(values) / len(values)
    if agg == "max":
        return max(values)
    if agg == "min":
        return min(values)
    return values[-1]   # "last"


# ---------------------------------------------------------------------------
# alert sinks
# ---------------------------------------------------------------------------

def log_sink(record: Dict) -> None:
    lvl = logging.ERROR if record["state"] == "breach" else logging.WARNING
    log.log(lvl, "SLO %s: %s %s=%s (warn %s / breach %s)",
            record["state"].upper(), record["slo"], record["metric"],
            record["value"], record["warn"], record["breach"])


def file_sink(record: Dict, root: Optional[str] = None) -> None:
    """Append to tmp/metrics/alerts.jsonl next to the metrics store."""
    path = os.path.join(root or ".", "tmp", "metrics", ALERTS_FILE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(record) + "\n")


def webhook_sink(record: Dict) -> None:
    """POST the record to SHIFU_TPU_ALERT_WEBHOOK (PagerDuty/Slack-
    style receivers). No knob → no-op.

    Each attempt is a bounded-timeout HTTP POST
    (SHIFU_TPU_ALERT_WEBHOOK_TIMEOUT_S connect+read) retried through
    `resilience.retrying` (`obs.webhook` site: exponential backoff,
    SHIFU_TPU_RETRY_ATTEMPTS tries) — then the final failure raises
    OUT of this sink and is absorbed by `SloEvaluator.alert`'s
    per-sink `obs.alert` guard, so an unreachable webhook can never
    fail a watch tick, only log."""
    url = knob_str("SHIFU_TPU_ALERT_WEBHOOK")
    if not url:
        return
    timeout_s = float(knob_float("SHIFU_TPU_ALERT_WEBHOOK_TIMEOUT_S"))
    body = json.dumps(record).encode()

    def _post() -> None:
        import urllib.request
        req = urllib.request.Request(
            url, data=body,
            headers={"Content-Type": "application/json"})
        resp = urllib.request.urlopen(req, timeout=timeout_s)
        try:
            status = getattr(resp, "status", 200)
            if int(status) >= 400:   # paranoid: urlopen raises on 4xx/5xx
                raise OSError(f"webhook POST returned {status}")
        finally:
            resp.close()

    retrying("obs.webhook", _post)


class SloEvaluator:
    """Evaluates the rules over the store; owns hysteresis + alerting."""

    def __init__(self, root: str, slos: Optional[List[Dict]] = None,
                 clear: int = 2):
        self.root = root
        self.slos = slos if slos is not None else load_slos(root)
        self.clear = max(1, int(clear))
        self._state: Dict[str, str] = {}
        self._better_streak: Dict[str, int] = {}
        # transitions since the last drain (the watch loop's retrain
        # seam reads breaches from here)
        self.transitions: List[Dict] = []
        self._sinks: List[Callable[[Dict], None]] = [
            log_sink, lambda r: file_sink(r, root), webhook_sink]

    def register_sink(self, sink: Callable[[Dict], None]) -> None:
        self._sinks.append(sink)

    # -- evaluation ----------------------------------------------------

    def _record(self, slo: Dict, state: str, value) -> Dict:
        return dict(zip(HEALTH_FIELDS,
                        (slo["name"], slo["metric"], state, value,
                         slo["warn"], slo["breach"],
                         slo.get("window_s", 3600.0))))

    def evaluate(self, now: Optional[float] = None) -> List[Dict]:
        """One pass over every rule: read the window, classify, apply
        hysteresis, emit gauges, alert on transitions. Returns the
        HEALTH_FIELDS records (one per rule)."""
        now = time.time() if now is None else now
        st = health_store.store(self.root)
        out: List[Dict] = []
        for slo in self.slos:
            window = float(slo.get("window_s", 3600.0))
            series = st.series(slo["metric"], since=now - window)
            value = _aggregate([v for _, v in series],
                               slo.get("agg", "last"))
            raw = "ok" if value is None else _classify(value, slo)
            state = self._hysteresis(slo["name"], raw, value)
            rec = self._record(slo, state, value)
            out.append(rec)
            st.emit(f"health.{slo['name']}", _RANK[state], kind="gauge",
                    metric=slo["metric"],
                    value_seen=value if value is not None else "")
        return out

    def drain_transitions(self) -> List[Dict]:
        """State transitions since the last drain (already alerted);
        the watch loop routes `breach` ones to its retrain seam."""
        out, self.transitions = self.transitions, []
        return out

    def _hysteresis(self, name: str, raw: str, value=None) -> str:
        """Degrade immediately; recover only after `clear` consecutive
        better observations (flap damping)."""
        prev = self._state.get(name, "ok")
        if _RANK[raw] >= _RANK[prev]:
            new = raw
            self._better_streak[name] = 0
        else:
            streak = self._better_streak.get(name, 0) + 1
            if streak >= self.clear:
                new, streak = raw, 0
            else:
                new = prev
            self._better_streak[name] = streak
        if new != prev:
            self._transition(name, prev, new, value)
        self._state[name] = new
        return new

    def _transition(self, name: str, prev: str, new: str,
                    value=None) -> None:
        st = health_store.store(self.root)
        kind = new if new != "ok" else "recovered"
        st.event(kind, slo=name, **{"from": prev, "to": new})
        slo = next((s for s in self.slos if s["name"] == name), {})
        rec = self._record(slo or {"name": name, "metric": "?",
                                   "warn": None, "breach": None},
                           new, value)
        rec["from"] = prev
        rec["ts"] = round(time.time(), 3)
        self.transitions.append(rec)
        self.alert(rec)

    # -- alert fan-out -------------------------------------------------

    def alert(self, record: Dict) -> None:
        """Dispatch to every sink; each sink routed through the
        obs.alert fault site and absorbed independently — one dead
        sink never silences the others, and no sink failure ever
        propagates to the caller."""
        for sink in self._sinks:
            try:
                fault_point("obs.alert")
                sink(record)
            except Exception as e:  # noqa: BLE001 — absorbed by design
                log.warning("alert sink %s failed (absorbed): %s",
                            getattr(sink, "__name__", sink), e)


# ---------------------------------------------------------------------------
# point-in-time health (the /healthz and `shifu health` read path)
# ---------------------------------------------------------------------------

def health_state(root: str) -> Dict:
    """Stateless snapshot: classify every rule against the store RIGHT
    NOW (no hysteresis — this is a read, not the watchdog) plus the
    recent breach/warn event tail. Works with the metrics knob off so
    operators can always inspect history someone else recorded."""
    now = time.time()
    st = health_store.store(root)
    slos: List[Dict] = []
    worst = "ok"
    for slo in load_slos(root):
        window = float(slo.get("window_s", 3600.0))
        series = st.series(slo["metric"], since=now - window)
        value = _aggregate([v for _, v in series], slo.get("agg", "last"))
        state = "ok" if value is None else _classify(value, slo)
        if _RANK[state] > _RANK[worst]:
            worst = state
        slos.append(dict(name=slo["name"], metric=slo["metric"],
                         state=state, value=value,
                         samples=len(series)))
    events = st.events(limit=5, names=["breach", "warn", "recovered",
                                       "refresh", "canary",
                                       "fleet_drift"])
    return {"status": worst, "slos": slos, "recent_events": events}
