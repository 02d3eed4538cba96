"""`watch --monitor-only` — the long-running drift/SLO loop,
counterpart of `shifu_tpu/obs/health/watch.py`.

Every ``SHIFU_TPU_WATCH_INTERVAL_S`` seconds the loop takes one tick:

  1. collect the next data window — the rows appended to the training
     dataPath since the last tick (line-atomic: each part file is
     consumed only up to its last newline and a torn partial carries
     into the next tick), or the next injected window (tests, replays);
  2. feed the window to the `RollingDrift` monitor (binned on the card
     by default) behind the `watch.window` fault site — a poisoned
     window is logged, counted, and SKIPPED, never fatal;
  3. run the `SloEvaluator` — drift thresholds, latency/AUC
     guardrails, hysteresis, alert fan-out;
  4. flush the metrics store (absorbed).

The loop honours the preemption contract of the port's `cli serve`:
SIGTERM/SIGINT finish the current tick and exit cleanly with everything
flushed (`resilience.graceful_shutdown`).

The retrain trigger (full `watch`: the refresh controller) and the
durable row log (`--ingest`) are ROADMAP A7.4: `run_monitor` raises
`NotImplementedError` naming it when asked for either, and `on_breach`
only logs that the loop is open. `FleetDriftWatch` (per-tenant drift
with a fleet-wide refresh budget, SHIFU_TPU_FLEET_REFRESH_BUDGET) comes
with the refresh controller it schedules. The `watch.window` /
`watch.evaluate` spans of the JAX package's trace are ROADMAP A8.5.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Iterable, Optional

import torch

from shifu_tpu_torch import resilience
from shifu_tpu_torch.config.environment import knob_float
from shifu_tpu_torch.obs.health import store as health_store
from shifu_tpu_torch.obs.health.drift import RollingDrift
from shifu_tpu_torch.obs.health.slo import SloEvaluator

log = logging.getLogger("shifu_tpu_torch")

A74 = ("is not ported yet (ROADMAP A7.4: data/ingest.py, the refresh and "
       "canary controllers, full `watch`)")


def on_breach(record: Dict, refresh=None) -> Optional[str]:
    """Called once per SLO transition into `breach`: logs that the loop
    is open (`--monitor-only`). A refresh controller is ROADMAP A7.4."""
    if refresh is not None:
        raise NotImplementedError(f"the refresh controller {A74}")
    log.warning("breach of %r — no refresh controller attached "
                "(monitor-only)", record.get("slo"))
    return None


def _production_window(ctx, tail: Dict):
    """Rows appended to the training dataPath since the last tick (None
    when nothing new), tracked as a byte cursor per part file.
    Line-atomic — only bytes up to each file's last newline are
    consumed, so a row the writer is mid-append on is carried into the
    next tick whole. A rewritten-shorter file resets its cursor. The
    first file's header line (no headerPath) is not a row."""
    from shifu_tpu_torch.data import reader
    mc = ctx.model_config
    try:
        _, header, files, first, has_header, simple = \
            reader._table_layout(mc, None)
    except FileNotFoundError:
        return None, tail
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
    (tests, replays) instead of tailing the dataPath; `device` bins the
    windows. A refresh controller or a row log raises (ROADMAP A7.4)."""
    if refresh is not None:
        raise NotImplementedError(f"watch without --monitor-only {A74}")
    if ingest_log is not None:
        raise NotImplementedError(f"watch --ingest {A74}")
    root = ctx.path_finder.root
    st = health_store.store(root)
    interval = interval_s if interval_s is not None \
        else knob_float("SHIFU_TPU_WATCH_INTERVAL_S")
    drift = RollingDrift(ctx, device=device)
    slo = SloEvaluator(root)
    injected = iter(windows) if windows is not None else None
    tail: Dict = {}
    ticks = windows_ok = windows_failed = 0
    log.info("watch: monitoring %s every %.1fs (%d features with "
             "frozen bins)", root, interval, drift.n_features)

    with resilience.graceful_shutdown("watching"):
        while not resilience.preempt_requested():
            tick_t0 = time.monotonic()

            # 1. next window
            df = None
            if injected is not None:
                df = next(injected, None)
                if df is None and iterations is None:
                    break   # replay exhausted
            else:
                df, tail = _production_window(ctx, tail)

            # 2. drift over the window — absorbed: a bad window can
            # never kill the monitor
            if df is not None and len(df):
                try:
                    resilience.fault_point("watch.window")
                    snap = drift.observe(df)
                    _emit_drift(st, snap)
                    windows_ok += 1
                except Exception as e:  # noqa: BLE001 — absorbed
                    windows_failed += 1
                    st.counter("watch.window_failed")
                    log.warning("watch: window skipped (absorbed): %s", e)

            # 3. guardrails (the evaluator alerts on transitions)
            slo.evaluate()
            for rec in slo.drain_transitions():
                if rec["state"] == "breach":
                    on_breach(rec)

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
