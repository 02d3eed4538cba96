"""`watch` — the long-running drift/SLO loop and the closed loop it
drives, counterpart of `shifu_tpu/obs/health/watch.py`.

Every ``SHIFU_TPU_WATCH_INTERVAL_S`` seconds the loop takes one tick:

  1. collect the next data window — with ``--ingest <log>`` the next
     committed rows of the durable row log (`data/ingest.py`),
     consumed exactly once: the ``watch`` consumer offset commits only
     AFTER the window's drift observe (and the refresh controller's
     `note_window`) landed, so a killed watch replays the window instead
     of skipping it. Without a log, the rows appended to the training
     dataPath since the last tick (line-atomic: each part file is
     consumed only up to its last newline and a torn partial carries
     into the next tick), or the next injected window (tests, replays);
  2. feed the window to the `RollingDrift` monitor (binned on the card
     by default) behind the `watch.window` fault site — a poisoned
     window is logged, counted, and SKIPPED, never fatal;
  3. run the `SloEvaluator` — drift thresholds, latency/AUC
     guardrails, hysteresis, alert fan-out; each transition into breach
     goes to `on_breach`;
  4. flush the metrics store (absorbed).

RETRAIN TRIGGER: pass a `refresh.RefreshController` as
`run_monitor(..., refresh=...)` and a breach schedules the warm-start
retrain → guardrail → atomic promote → in-place swap run; every observed
window also reaches the controller as retrain fodder. Without a
controller `on_breach` only logs that the loop is open
(`--monitor-only`). `FleetDriftWatch` runs per-tenant drift and SLO
loops in one fleet tick under SHIFU_TPU_FLEET_REFRESH_BUDGET.

The loop honours the preemption contract of the port's `cli serve`:
SIGTERM/SIGINT finish the current tick and exit cleanly with everything
flushed (`resilience.graceful_shutdown`). Under a trace run each
observed window is a `watch.window` span and each SLO pass a
`watch.evaluate` span (tenant-tagged in the fleet watch).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np

import torch

from shifu_tpu_torch import resilience
from shifu_tpu_torch.config.environment import knob_float
from shifu_tpu_torch.obs.health import store as health_store
from shifu_tpu_torch.obs.health.drift import RollingDrift
from shifu_tpu_torch.obs.health.slo import SloEvaluator
from shifu_tpu_torch.obs import trace as obs_trace

log = logging.getLogger("shifu_tpu_torch")

def on_breach(record: Dict, refresh=None) -> Optional[str]:
    """Called once per SLO transition into `breach`. With a
    `RefreshController` attached this schedules its retrain → guardrail
    → promote → swap run (coalesced under its cooldown/in-flight
    hysteresis) and returns the outcome; without one it only logs that
    the loop is open (`--monitor-only`)."""
    if refresh is not None:
        return refresh.handle_breach(record)
    log.warning("breach of %r — no refresh controller attached "
                "(monitor-only; run `watch` with --registry/--model-name "
                "to close the loop)", record.get("slo"))
    return None


def _production_window(ctx, tail: Dict):
    """Rows appended to the training dataPath since the last tick (None
    when nothing new), tracked as a byte cursor per part file.
    Line-atomic — only bytes up to each file's last newline are
    consumed, so a row the writer is mid-append on is carried into the
    next tick whole. A rewritten-shorter file resets its cursor. The
    first file's header line (no headerPath) is not a row. Parquet
    parts (immutable whole-file appends, no torn line) and parts that
    are not local files (``scheme://``) take the whole table's row
    slice past the last tick's row count instead."""
    from shifu_tpu_torch.data import reader
    mc = ctx.model_config
    try:
        _, header, files, first, has_header, simple = \
            reader._table_layout(mc, None)
    except FileNotFoundError:
        return None, tail
    if any(reader.is_parquet(f) or not os.path.isfile(f) for f in files):
        table = reader.read_raw_table(mc)
        seen = tail.get("__rows__", 0)
        if len(table) < seen:
            seen = 0
        tail["__rows__"] = len(table)
        if len(table) == seen:
            return None, tail
        return table.select(np.arange(seen, len(table))), tail
    lines = []
    for path in files:
        pos = tail.get(path, 0)
        size = os.path.getsize(path)
        if size < pos:   # rewritten shorter: fresh window
            pos = 0
        if size <= pos:
            continue
        with open(path, "rb") as f:
            f.seek(pos)
            chunk = f.read(size - pos)
        cut = chunk.rfind(b"\n")
        if cut < 0:
            continue   # no complete line yet — carry the partial
        got = chunk[:cut].decode("utf-8", "replace").splitlines()
        if pos == 0 and has_header and path == first:
            got = got[1:]
        lines.extend(ln for ln in got if ln.strip())
        tail[path] = pos + cut + 1
    if not lines:
        return None, tail
    names = simple if simple is not None else list(header)
    return reader._rows_table(lines, names, mc.dataSet.dataDelimiter or "|",
                              files[0]), tail


def run_monitor(ctx, interval_s: Optional[float] = None,
                iterations: Optional[int] = None,
                windows: Optional[Iterable] = None,
                refresh=None, ingest_log=None,
                device: "str | torch.device" = "cuda") -> int:
    """The monitor loop. `iterations` bounds the run (None = until
    SIGTERM); `windows` injects an explicit window sequence of `Table`s
    (tests, replays) instead of tailing the dataPath; `refresh` attaches
    a `RefreshController` so breaches retrain instead of only alerting;
    `ingest_log` (a `data.ingest.RowLog` or its root) consumes the
    windows from the durable row log with exactly-once offset commits;
    `device` bins the windows."""
    from shifu_tpu_torch.config.environment import knob_int
    from shifu_tpu_torch.data import ingest as ingest_mod

    root = ctx.path_finder.root
    st = health_store.store(root)
    interval = interval_s if interval_s is not None \
        else knob_float("SHIFU_TPU_WATCH_INTERVAL_S")
    drift = RollingDrift(ctx, device=device)
    slo = SloEvaluator(root)
    injected = iter(windows) if windows is not None else None
    if isinstance(ingest_log, str):
        ingest_log = ingest_mod.RowLog(ingest_log)
    tail: Dict = {}
    ticks = windows_ok = windows_failed = 0
    log.info("watch: monitoring %s every %.1fs (%d features with "
             "frozen bins)%s", root, interval, drift.n_features,
             f" from row log {ingest_log.root}" if ingest_log else "")

    with resilience.graceful_shutdown("watching"):
        while not resilience.preempt_requested():
            tick_t0 = time.monotonic()

            # 1. next window
            df, win = None, None
            if injected is not None:
                df = next(injected, None)
                if df is None and iterations is None:
                    break   # replay exhausted
            elif ingest_log is not None:
                win = ingest_log.read_window(
                    ingest_mod.WATCH_CONSUMER,
                    max_rows=knob_int("SHIFU_TPU_INGEST_WINDOW_ROWS"))
                if win is not None:
                    df = ingest_mod.frame_from_rows(
                        win.lines, ingest_log.header, ingest_log.delimiter)
            else:
                df, tail = _production_window(ctx, tail)

            # 2. drift over the window — absorbed: a bad window can
            # never kill the monitor. With a row log the consumer offset
            # commits only AFTER the observe landed and the window
            # reached the refresh controller: a crash or an absorbed
            # fault before the commit REPLAYS the window next tick
            if df is not None and len(df):
                try:
                    with obs_trace.span("watch.window", rows=len(df)):
                        resilience.fault_point("watch.window")
                        snap = drift.observe(df)
                    _emit_drift(st, snap)
                    if refresh is not None:
                        refresh.note_window(df)
                    if win is not None:
                        ingest_log.commit(ingest_mod.WATCH_CONSUMER,
                                          win.end)
                    windows_ok += 1
                except Exception as e:  # noqa: BLE001 — absorbed
                    windows_failed += 1
                    st.counter("watch.window_failed")
                    log.warning("watch: window skipped (absorbed): %s", e)

            # 3. guardrails (the evaluator alerts on transitions;
            # breaches additionally hit the retrain seam)
            with obs_trace.span("watch.evaluate"):
                slo.evaluate()
            for rec in slo.drain_transitions():
                if rec["state"] == "breach":
                    on_breach(rec, refresh)

            # 4. persist — absorbed
            st.counter("watch.tick")
            try:
                st.flush()
            except Exception as e:  # noqa: BLE001 — absorbed
                log.warning("watch: flush failed (absorbed): %s", e)

            ticks += 1
            if iterations is not None and ticks >= iterations:
                break
            spent = time.monotonic() - tick_t0
            wait = max(0.0, interval - spent)
            deadline = time.monotonic() + wait
            while time.monotonic() < deadline:
                if resilience.preempt_requested():
                    break
                time.sleep(min(0.2, max(0.0,
                                        deadline - time.monotonic())))

    try:
        st.flush()
    except Exception as e:  # noqa: BLE001 — absorbed
        log.warning("watch: final flush failed (absorbed): %s", e)
    log.info("watch: %d tick(s), %d window(s) ok, %d skipped",
             ticks, windows_ok, windows_failed)
    return 0


class FleetDriftWatch:
    """Per-tenant drift + SLO loops inside ONE fleet watch tick, with
    fleet-wide breach-storm coalescing.

    Drift is a per-tenant question (tenant A's feature mix shifting says
    nothing about tenant B), but retrain capacity is a fleet-wide
    resource. Each registered tenant gets its own `RollingDrift` (frozen
    against that tenant's training bins) and `SloEvaluator` (that
    tenant's workspace SLOs). One `tick()` evaluates every tenant and
    collects the breach transitions; at most
    ``SHIFU_TPU_FLEET_REFRESH_BUDGET`` of them schedule a refresh THIS
    tick — the rest wait in a FIFO (one slot per tenant: a tenant
    already pending just refreshes its breach record) and drain under
    the same budget on later ticks, so a correlated storm becomes a
    bounded rolling retrain, never N concurrent training runs on the
    card. Per-tenant refresh controllers keep their own coalescing on
    top."""

    def __init__(self, store_root: str,
                 refresh_budget: Optional[int] = None,
                 device: "str | torch.device" = "cuda"):
        from shifu_tpu_torch.config.environment import knob_int
        self.store_root = store_root
        self.device = device
        self.budget = int(refresh_budget if refresh_budget is not None
                          else knob_int("SHIFU_TPU_FLEET_REFRESH_BUDGET"))
        self.budget = max(self.budget, 1)
        self._tenants: Dict[str, Dict] = {}
        self._pending: Dict[str, Dict] = {}   # tenant → breach record
        self.ticks = 0
        self.breaches = 0
        self.scheduled = 0
        self.deferred = 0

    def add_tenant(self, name: str, ctx, refresh=None) -> None:
        """Register one tenant: its ProcessorContext (frozen training
        bins → RollingDrift baseline; workspace root → SLOs) and an
        optional RefreshController that breaches schedule into."""
        self._tenants[name] = {
            "ctx": ctx, "drift": RollingDrift(ctx, device=self.device),
            "slo": SloEvaluator(ctx.path_finder.root),
            "refresh": refresh, "windows": 0, "last_snap": None}
        log.info("fleet-drift: tenant %s registered (%d features)",
                 name, self._tenants[name]["drift"].n_features)

    def observe(self, name: str, df) -> Optional[Dict]:
        """Feed one arriving window (a `Table`) to one tenant's drift
        monitor. Absorbed: a poisoned window is skipped and counted,
        like the single-model watch tick."""
        t = self._tenants[name]
        st = health_store.store(self.store_root)
        if df is None or not len(df):
            return None
        try:
            with obs_trace.span("watch.window", rows=len(df),
                                tenant=name):
                resilience.fault_point("watch.window")
                snap = t["drift"].observe(df)
        except Exception as e:  # noqa: BLE001 — absorbed
            st.counter("watch.window_failed", tenant=name)
            log.warning("fleet-drift: %s window skipped (absorbed): %s",
                        name, e)
            return None
        t["windows"] += 1
        t["last_snap"] = snap
        # the tenant's OWN store first — its SloEvaluator reads drift
        # series from the tenant workspace; the fleet store gets the
        # same points tenant-tagged for fleet-wide dashboards
        try:
            st_tenant = health_store.store(t["ctx"].path_finder.root)
            st_tenant.emit("drift.psi_max", snap["psi_max"],
                           window=snap["window"])
            st_tenant.emit("drift.psi_mean", snap["psi_mean"],
                           window=snap["window"])
            st_tenant.flush()
        except Exception as e:  # noqa: BLE001 — absorbed
            log.warning("fleet-drift: %s tenant store emit failed "
                        "(absorbed): %s", name, e)
        st.emit("drift.psi_max", snap["psi_max"], tenant=name,
                window=snap["window"])
        st.emit("drift.psi_mean", snap["psi_mean"], tenant=name,
                window=snap["window"])
        if snap["drifted"]:
            st.event("drift", tenant=name,
                     features=",".join(snap["drifted"]),
                     psi_max=snap["psi_max"], window=snap["window"])
        if t["refresh"] is not None:
            t["refresh"].note_window(df)
        return snap

    def tick(self) -> Dict[str, str]:
        """Evaluate every tenant's SLOs, then schedule breaches under
        the fleet budget. Returns {tenant: outcome} for every tenant
        acted on this tick (the scheduled outcome or "deferred")."""
        self.ticks += 1
        st = health_store.store(self.store_root)
        for name, t in self._tenants.items():
            with obs_trace.span("watch.evaluate", tenant=name):
                t["slo"].evaluate()
            for rec in t["slo"].drain_transitions():
                if rec["state"] != "breach":
                    continue
                self.breaches += 1
                # one slot per tenant: a tenant already queued just gets
                # the newest breach record, not a second slot
                self._pending[name] = dict(rec, tenant=name)
        outcomes: Dict[str, str] = {}
        launched = 0
        for name in list(self._pending):
            if launched >= self.budget:
                break
            rec = self._pending.pop(name)
            launched += 1
            self.scheduled += 1
            outcomes[name] = on_breach(
                rec, self._tenants[name]["refresh"]) or "alerted"
        if self._pending:
            self.deferred += len(self._pending)
            st.counter("watch.fleet_deferred", value=len(self._pending))
            st.event("fleet_drift", phase="storm",
                     deferred=",".join(sorted(self._pending)),
                     budget=self.budget, launched=launched)
            log.warning("fleet-drift: breach storm — %d tenant(s) deferred "
                        "past the budget of %d (%s)", len(self._pending),
                        self.budget, sorted(self._pending))
            for name in self._pending:
                outcomes.setdefault(name, "deferred")
        try:
            st.flush()
        except Exception as e:  # noqa: BLE001 — absorbed
            log.warning("fleet-drift: flush failed (absorbed): %s", e)
        return outcomes

    def stats(self) -> Dict:
        return {"tenants": {n: {"windows": t["windows"],
                                "psi_max": (t["last_snap"] or
                                            {}).get("psi_max")}
                            for n, t in self._tenants.items()},
                "ticks": self.ticks, "breaches": self.breaches,
                "scheduled": self.scheduled, "deferred": self.deferred,
                "pending": sorted(self._pending),
                "budget": self.budget}


def _emit_drift(st, snap: Dict) -> None:
    """Snapshot → metric points + a `drift` event when any feature is
    over threshold."""
    st.emit("drift.psi_max", snap["psi_max"], window=snap["window"])
    st.emit("drift.psi_mean", snap["psi_mean"], window=snap["window"])
    st.emit("drift.ks_max", snap["ks_max"], window=snap["window"])
    for name, f in snap["features"].items():
        st.emit("drift.feature_psi", f["psi"], feature=name,
                window=snap["window"])
    if snap["drifted"]:
        st.event("drift", features=",".join(snap["drifted"]),
                 psi_max=snap["psi_max"], window=snap["window"])
