"""Live-traffic promotion: shadow → canary → promoted, the verdict from
the fleet's arms — counterpart of `shifu_tpu/obs/health/canary.py`.

`CanaryController` owns the staged state machine for ONE challenger:

  start     `fault_point("canary.start")`: warm the challenger as a
            fleet ARM (`FleetService.start_arms` — its own resident
            service, captured there; the primary entry is PINNED to the
            incumbent version), publish the challenger version with
            ``canary.verdict = "pending"`` (HEAD moves OPTIMISTICALLY —
            the pinned fleet keeps serving the incumbent until the live
            verdict), and persist the state file (``CANARY.json`` next
            to HEAD, write-tmp-then-rename) naming the run, the
            published version, the baseline HEAD and the phase — the
            SIGKILL recovery record.

  shadow    mirror `shadow_pct` of live traffic to the challenger on the
            fleet's bounded side queue (response discarded, latency and
            score sketch recorded). Advance when BOTH arms reach the
            `SHIFU_TPU_CANARY_MIN_REQUESTS` quorum; a
            `SHIFU_TPU_CANARY_WINDOW_S` expiry without quorum (or a
            shadow plane that mostly errors) rolls back.

  canary    route `canary_pct` of REAL traffic to the challenger
            (deterministic Weyl assignment, serve/fleet.py). Every poll
            re-checks the live SLO: a challenger p99 above
            ``max(slo_p99_ms, p99_factor × primary p99)`` rolls back at
            once — clients never see a failure, because canary routing
            just switches off and any challenger error already fell back
            to the primary inside the fleet.

  decide    `fault_point("canary.decide")`: the rule reads the LIVE
            comparison — score PSI between arms
            (`SHIFU_TPU_CANARY_PSI_MAX`), the per-arm SLO and zero
            challenger fallbacks — never the offline eval.

  promote   record the verdict and the observed window in the published
            version's manifest (`registry.annotate`), tear the arm down
            and `FleetService.swap_in_place` the fleet onto the
            (already-HEAD) challenger.

  rollback  `fault_point("canary.rollback")`: routing off, arm down,
            `registry.rollback` re-pins HEAD to the baseline, a re-swap
            proves the fleet serves it, and the abandoned version's
            manifest records WHY. The state file goes only after the
            registry is consistent.

SIGKILL mid-run: the rerun (or a `watch` restart) calls
`CanaryController.recover` — a state file in a non-terminal phase means
the verdict never landed, so HEAD rolls back to the recorded baseline
and the state file is cleared.

The ``canary.run`` / ``canary.decide`` / ``canary.rollback`` spans of
the JAX package's trace are ROADMAP A8.5.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

from shifu_tpu_torch import fileio, resilience
from shifu_tpu_torch.config.environment import knob_float, knob_int
from shifu_tpu_torch.obs.health import store as health_store
from shifu_tpu_torch.resilience import absorbed

log = logging.getLogger("shifu_tpu_torch")

STATE_FILE = "CANARY.json"

# terminal phases: the state file only outlives a crash when the run
# died BEFORE the verdict landed — recover() rolls those back
_TERMINAL = ("promoted", "rolled_back")


def state_path(registry_root: str, name: str) -> str:
    return os.path.join(registry_root, "models", name, STATE_FILE)


def read_state(registry_root: str, name: str) -> Optional[Dict[str, Any]]:
    try:
        with open(state_path(registry_root, name), encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class CanaryController:
    """Staged live promotion of one challenger into one fleet model."""

    def __init__(self, fleet, registry_root: str, model_name: str,
                 store_root: Optional[str] = None,
                 shadow_pct: Optional[float] = None,
                 canary_pct: Optional[float] = None,
                 min_requests: Optional[int] = None,
                 window_s: Optional[float] = None,
                 psi_max: Optional[float] = None,
                 p99_factor: Optional[float] = None,
                 slo_p99_ms: Optional[float] = None,
                 poll_s: float = 0.05):
        self.fleet = fleet
        self.registry_root = registry_root
        self.model_name = model_name
        self.store_root = store_root
        self.shadow_pct = float(
            shadow_pct if shadow_pct is not None
            else (knob_float("SHIFU_TPU_SHADOW_PCT") or 0.25))
        self.canary_pct = float(
            canary_pct if canary_pct is not None
            else knob_float("SHIFU_TPU_CANARY_PCT"))
        self.min_requests = int(
            min_requests if min_requests is not None
            else knob_int("SHIFU_TPU_CANARY_MIN_REQUESTS"))
        self.window_s = float(
            window_s if window_s is not None
            else knob_float("SHIFU_TPU_CANARY_WINDOW_S"))
        self.psi_max = float(
            psi_max if psi_max is not None
            else knob_float("SHIFU_TPU_CANARY_PSI_MAX"))
        self.p99_factor = float(
            p99_factor if p99_factor is not None
            else knob_float("SHIFU_TPU_CANARY_P99_FACTOR"))
        self.slo_p99_ms = float(
            slo_p99_ms if slo_p99_ms is not None
            else getattr(fleet, "_slo_p99_ms", 50.0))
        self.poll_s = float(poll_s)

    # -- store plumbing -------------------------------------------------

    def _store(self):
        root = self.store_root or getattr(self.fleet, "_workspace_root",
                                          None)
        return health_store.store(root) if root else None

    def _event(self, phase: str, **tags) -> None:
        st = self._store()
        if st is None:
            return
        try:
            st.event("canary", model=self.model_name, phase=phase, **tags)
            st.flush()
        except Exception as e:  # noqa: BLE001 — observability is absorbed
            absorbed("canary.event-flush", e)

    # -- state file (the SIGKILL recovery record) -----------------------

    def _write_state(self, state: Dict[str, Any]) -> None:
        with fileio.atomic_write(state_path(self.registry_root,
                                            self.model_name),
                                 encoding="utf-8") as f:
            json.dump(state, f, indent=1, sort_keys=True)

    def _clear_state(self) -> None:
        try:
            os.remove(state_path(self.registry_root, self.model_name))
        except OSError as e:
            absorbed("canary.state-clear", e)

    # -- the run ---------------------------------------------------------

    def run(self, challenger_dir: str, run_name: str,
            refresh_block: Optional[Dict[str, Any]] = None
            ) -> Dict[str, Any]:
        """Drive one challenger through shadow → canary → verdict.
        Returns ``{"outcome": "promoted" | "rolled_back", "version",
        "prev_head", "verdict"}``. Any exception after the optimistic
        publish leaves the state file in place — `recover` (or the next
        run) rolls HEAD back; the fleet primary never moved."""
        from shifu_tpu_torch import registry

        # a stale state file (an earlier SIGKILL) must resolve before a
        # new optimistic publish can move HEAD again
        self.recover(self.registry_root, self.model_name,
                     fleet=self.fleet, store_root=self.store_root)

        t0 = time.monotonic()
        # -- start: arm up, optimistic publish, state persisted ---------
        resilience.fault_point("canary.start")
        self.fleet.start_arms(self.model_name, challenger_dir,
                              version=run_name, shadow_pct=self.shadow_pct,
                              canary_pct=0.0)
        try:
            prev_head = registry.head(self.registry_root, self.model_name)
            extra = {"canary": {"verdict": "pending", "run": run_name,
                                "baseline": prev_head}}
            if refresh_block:
                extra["refresh"] = refresh_block
            version = registry.publish(self.registry_root, self.model_name,
                                       challenger_dir, extra=extra)
            self._write_state({
                "model": self.model_name, "run": run_name,
                "version": version, "prev_head": prev_head,
                "phase": "shadow", "challenger_dir": challenger_dir,
                "ts": time.time()})
        except BaseException:
            self.fleet.stop_arms(self.model_name)
            raise
        self._event("shadow", run=run_name, version=version,
                    shadow_pct=self.shadow_pct)

        try:
            verdict = self._drive_phases(version, run_name)
            window = self._window_block(verdict, t0)
            if verdict["decision"] == "promote":
                return self._promote(version, prev_head, run_name, verdict,
                                     window)
            return self._rollback(version, prev_head, run_name, verdict,
                                  window)
        except BaseException as e:
            # traffic safety first: routing off and arm down (idempotent);
            # the state file STAYS so recover() can finish the registry
            # rollback the crash interrupted
            self.fleet.stop_arms(self.model_name)
            self._event("aborted", run=run_name, version=version,
                        error=str(e)[:200])
            raise

    def _drive_phases(self, version: str, run_name: str) -> Dict[str, Any]:
        """Shadow quorum → canary flip → live watch → decide."""
        deadline = time.monotonic() + self.window_s
        # -- shadow: build score evidence without touching responses --
        while True:
            a = self.fleet.arm_stats(self.model_name) or {}
            reqs = a.get("requests", {})
            if reqs.get("shadow", 0) >= self.min_requests and \
                    reqs.get("primary", 0) >= self.min_requests:
                break
            if time.monotonic() > deadline:
                return {"decision": "rollback",
                        "reason": "shadow quorum not reached inside the "
                                  "canary window", "stats": a}
            if a.get("shadow_errors", 0) > self.min_requests:
                return {"decision": "rollback",
                        "reason": "shadow plane failing against the "
                                  "challenger", "stats": a}
            time.sleep(self.poll_s)
        self.fleet.set_canary_pct(self.model_name, self.canary_pct,
                                  phase="canary")
        self._write_state_phase("canary", version, run_name)
        self._event("canary", run=run_name, version=version,
                    canary_pct=self.canary_pct)

        # -- canary: real traffic, live breach watch ------------------
        while True:
            a = self.fleet.arm_stats(self.model_name) or {}
            breach = self._live_breach(a)
            if breach is not None:
                return {"decision": "rollback", "reason": breach,
                        "stats": a}
            if a.get("requests", {}).get("canary", 0) >= self.min_requests:
                break
            if time.monotonic() > deadline:
                return {"decision": "rollback",
                        "reason": "canary quorum not reached inside the "
                                  "canary window", "stats": a}
            time.sleep(self.poll_s)

        resilience.fault_point("canary.decide")
        a = self.fleet.arm_stats(self.model_name) or {}
        decision, reason = self.decide(a, self.psi_max, self.p99_factor,
                                       self.slo_p99_ms)
        return {"decision": decision, "reason": reason, "stats": a}

    def _live_breach(self, a: Dict[str, Any]) -> Optional[str]:
        """Mid-canary SLO check (every poll): a challenger p99 above the
        band is a breach NOW — rollback does not wait for the quorum."""
        p99 = (a.get("p99_ms") or {})
        c, p = p99.get("canary"), p99.get("primary")
        if c is None:
            return None
        ceiling = max(self.slo_p99_ms,
                      self.p99_factor * p if p else self.slo_p99_ms)
        if c > ceiling:
            return (f"canary p99 {c:.3f}ms breached the live SLO band "
                    f"(ceiling {ceiling:.3f}ms)")
        return None

    @staticmethod
    def decide(arm_stats: Dict[str, Any], psi_max: float,
               p99_factor: float, slo_p99_ms: float):
        """The LIVE promotion rule, bare: score PSI between arms within
        band, challenger p99 inside the live SLO band, and zero
        challenger-absorbed request failures."""
        psi = arm_stats.get("arm_psi")
        if psi is None:
            return "rollback", "no score-distribution evidence"
        if psi > psi_max:
            return "rollback", (f"score PSI between arms {psi:.4f} > "
                                f"{psi_max} — the challenger scores a "
                                "different population")
        p99 = arm_stats.get("p99_ms") or {}
        c, p = p99.get("canary"), p99.get("primary")
        if c is not None:
            ceiling = max(slo_p99_ms, p99_factor * p if p else slo_p99_ms)
            if c > ceiling:
                return "rollback", (f"canary p99 {c:.3f}ms above the live "
                                    f"band (ceiling {ceiling:.3f}ms)")
        if arm_stats.get("canary_fallbacks", 0) > 0:
            return "rollback", ("challenger failed live requests "
                                "(absorbed by primary fallback)")
        return "promote", "live arms within guardrails"

    # -- terminal transitions --------------------------------------------

    def _window_block(self, verdict: Dict[str, Any],
                      t0: float) -> Dict[str, Any]:
        a = verdict.get("stats") or {}
        return {"requests": a.get("requests"), "p99_ms": a.get("p99_ms"),
                "arm_psi": a.get("arm_psi"),
                "shadow_dropped": a.get("shadow_dropped"),
                "canary_fallbacks": a.get("canary_fallbacks"),
                "window_s": round(time.monotonic() - t0, 3)}

    def _promote(self, version: str, prev_head: Optional[str],
                 run_name: str, verdict: Dict[str, Any],
                 window: Dict[str, Any]) -> Dict[str, Any]:
        from shifu_tpu_torch import registry
        block = {"verdict": "promote", "reason": verdict["reason"],
                 "run": run_name, "baseline": prev_head,
                 "live_window": window}
        registry.annotate(self.registry_root, self.model_name, version,
                          {"canary": block})
        # arm down first (unpins the primary), THEN swap the fleet onto
        # the already-HEAD challenger — in-flight requests score wholly
        # old or new, never mixed
        self.fleet.stop_arms(self.model_name)
        swap = self.fleet.swap_in_place(self.model_name)
        self._clear_state()
        self._event("promoted", run=run_name, version=version, swap=swap,
                    arm_psi=window.get("arm_psi"))
        log.info("canary: %s promoted %s/%s from live arms (%s; swap=%s)",
                 run_name, self.model_name, version, verdict["reason"],
                 swap)
        return {"outcome": "promoted", "version": version,
                "prev_head": prev_head, "verdict": block, "swap": swap}

    def _rollback(self, version: str, prev_head: Optional[str],
                  run_name: str, verdict: Dict[str, Any],
                  window: Dict[str, Any]) -> Dict[str, Any]:
        from shifu_tpu_torch import registry
        resilience.fault_point("canary.rollback")
        # 1. traffic: canary routing off, arm down — every request is on
        #    the incumbent primary again (it never stopped)
        self.fleet.stop_arms(self.model_name)
        # 2. registry: HEAD re-pinned to the baseline, the abandoned
        #    version records why
        if prev_head is not None:
            registry.rollback(self.registry_root, self.model_name,
                              to=prev_head)
        try:
            registry.annotate(
                self.registry_root, self.model_name, version,
                {"canary": {"verdict": "rollback",
                            "reason": verdict["reason"], "run": run_name,
                            "baseline": prev_head, "live_window": window}})
        except OSError as e:
            absorbed("canary.audit", e)   # the annotation is best-effort
        # 3. fleet: a re-swap proves serving == HEAD (a noop when the
        #    primary never moved — which it didn't)
        swap = "none"
        try:
            swap = self.fleet.swap_in_place(self.model_name)
        except Exception as e:  # noqa: BLE001 — absorbed: the primary
            # still serves the baseline regardless
            log.warning("canary: re-swap after rollback failed "
                        "(incumbent still resident): %s", e)
        self._clear_state()
        self._event("rolled_back", run=run_name, version=version,
                    to=prev_head or "?", reason=verdict["reason"])
        log.warning("canary: %s rolled back %s/%s → %s (%s)", run_name,
                    self.model_name, version, prev_head, verdict["reason"])
        return {"outcome": "rolled_back", "version": version,
                "prev_head": prev_head,
                "verdict": {"verdict": "rollback",
                            "reason": verdict["reason"],
                            "live_window": window},
                "swap": swap}

    def _write_state_phase(self, phase: str, version: str,
                           run_name: str) -> None:
        state = read_state(self.registry_root, self.model_name) or {}
        state.update({"phase": phase, "version": version, "run": run_name,
                      "ts": time.time()})
        self._write_state(state)

    # -- crash recovery ---------------------------------------------------

    @classmethod
    def recover(cls, registry_root: str, model_name: str,
                fleet=None, store_root: Optional[str] = None
                ) -> Optional[str]:
        """Resolve a canary run a crash interrupted: a state file in a
        non-terminal phase means no verdict ever landed, so HEAD rolls
        back to the recorded baseline (the arm evidence died with the
        process) and the state file clears. Returns "rolled_back" when
        recovery acted, None when there was nothing to recover."""
        from shifu_tpu_torch import registry
        state = read_state(registry_root, model_name)
        if not state or state.get("phase") in _TERMINAL:
            return None
        prev = state.get("prev_head")
        version = state.get("version")
        log.warning("canary: recovering interrupted run %s (%s/%s at phase "
                    "%r) — rolling back to %s", state.get("run"),
                    model_name, version, state.get("phase"), prev)
        if prev is not None and \
                registry.head(registry_root, model_name) == version:
            registry.rollback(registry_root, model_name, to=prev)
        try:
            registry.annotate(
                registry_root, model_name, version,
                {"canary": {"verdict": "rollback",
                            "reason": "interrupted mid-canary "
                                      "(recovered on rerun)",
                            "run": state.get("run"), "baseline": prev}})
        except OSError as e:
            absorbed("canary.audit-recover", e)
        try:
            os.remove(state_path(registry_root, model_name))
        except OSError as e:
            absorbed("canary.state-clear", e)
        if fleet is not None:
            try:
                fleet.stop_arms(model_name)
                fleet.swap_in_place(model_name)
            except Exception as e:  # noqa: BLE001 — fleet may be fresh
                absorbed("canary.fleet-reswap", e)
        if store_root:
            try:
                st = health_store.store(store_root)
                st.event("canary", model=model_name, phase="recovered",
                         run=state.get("run"), version=version,
                         to=prev or "?")
                st.flush()
            except Exception as e:  # noqa: BLE001 — absorbed
                absorbed("canary.event-flush", e)
        return "rolled_back"
