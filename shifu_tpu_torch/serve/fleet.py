"""Multi-tenant model fleet: N registry models in one serve process —
counterpart of `shifu_tpu/serve/fleet.py`.

`FleetService` resolves each model's HEAD version from a
`shifu_tpu_torch.registry` root and runs one `ScorerService` per model
on one device (the card by default). Three planes on top of the
single-model service:

- **Device-memory budget + LRU residency.** Each model's device working
  set is estimated from its manifest (param bytes + top bucket ×
  working-row bytes). Models warm lazily on first hit (on the card: the
  service captures its CUDA graphs then, while other models' batcher
  threads keep launching — captures are thread-local); when the
  resident set would exceed `SHIFU_TPU_FLEET_HBM_MB`, the
  least-recently-used resident model is evicted (its service closes,
  its graphs and their memory pool are dropped) and re-warmed on its
  next hit, re-resolving HEAD. Evictions and re-warm seconds are
  counted.

- **Priority admission.** Each manifest carries `priority: high|low`.
  A rolling p99 over recent high-priority request latencies
  (`SHIFU_TPU_FLEET_SHED_WINDOW`) drives a hysteresis shed switch:
  above `SHIFU_TPU_FLEET_SLO_P99_MS` low-priority submits are rejected
  with `ShedReject` (a `queue.Full`, so the HTTP front end answers 429
  + `Retry-After`) until the p99 recovers below 70% of the SLO.
  High-priority traffic is never shed.

- **SLO autotuning.** `SloAutotuner.step()` reads each model's own
  `serve.p99_ms` history from the metrics store (falling back to the
  live service window) and steers the model's micro-batch admission
  deadline toward the SLO band — halving it when p99 overshoots,
  growing it 1.25× when p99 is under half the SLO — and proposes
  trimmed bucket ladders when observed request sizes never reach the
  upper rungs (applied on the next re-warm). Every adjustment lands in
  the store as an `autotune` event.

`swap_in_place` promotes a new HEAD into a resident model through
`ScorerService.swap_params` (no recapture), or evicts and re-warms it
when the shapes changed. The fleet summary block carries
`FLEET_FIELDS` (the JAX package's `profiling.FLEET_FIELDS`).

- **Live-promotion arms.** `start_arms` warms a challenger next to a
  model's primary (its own `ScorerService`, captured at `start_arms`
  from the primary's warm-up request, so neither arm captures under
  traffic) and pins the primary to its version. Every admitted request
  gets one deterministic Weyl assignment (`arm_assign`): a canary hit
  scores on the challenger for real (a challenger failure falls back
  to the primary, counted), and `shadow_pct` of the primary's requests
  are mirrored onto a bounded queue that a worker thread scores on the
  challenger behind the `shadow.score` fault site (a full queue drops
  the mirror). `_ArmState` keeps each arm's latency window (p99) and a
  16-bin score sketch, whose PSI between the arms (`arm_psi`) is what
  `obs/health/canary.CanaryController` decides on; `stop_arms` turns
  routing off first, then the worker and the challenger.

Under a trace run each (re-)warm, eviction, in-place swap and shadow
replay leaves a `fleet.warm` / `fleet.evict` / `fleet.swap` /
`shadow.score` span, and the stage timers `fleet_rewarm_s`,
`fleet_evictions` and `fleet_swap_s` accrue into the step record.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import torch

from shifu_tpu_torch import registry
from shifu_tpu_torch.config import environment as env
from shifu_tpu_torch.data import pipeline
from shifu_tpu_torch.obs import trace as obs_trace
from shifu_tpu_torch.profiling import FLEET_FIELDS
from shifu_tpu_torch.resilience import absorbed, fault_point, make_lock
from shifu_tpu_torch.serve.service import ScorerService

PRIORITIES = ("high", "low")



class ShedReject(queue.Full):
    """Low-priority admission shed — a `queue.Full` so every 429 path
    (HTTP and in-process callers already handling queue-full) treats
    it uniformly; carries the class and a Retry-After hint."""

    def __init__(self, model: str, priority: str,
                 retry_after_s: float = 1.0):
        super().__init__(
            f"low-priority load shed for model {model!r} "
            "(high-priority p99 over SLO)")
        self.model = model
        self.priority = priority
        self.retry_after_s = retry_after_s


class _Entry:
    """One registry model's fleet state (residency + tuning)."""

    def __init__(self, name: str, version: str, vdir: str,
                 manifest: Dict[str, Any]):
        self.name = name
        self.version = version
        self.vdir = vdir
        self.manifest = manifest
        self.priority = manifest.get("priority") or "high"
        self.ladder = tuple(int(b) for b in manifest.get("ladder") or ())
        delay_ms = manifest.get("max_delay_ms")
        self.max_delay_s: Optional[float] = (
            float(delay_ms) / 1e3 if delay_ms else None)
        top = self.ladder[-1] if self.ladder else 0
        row_bytes = int(manifest.get("working_row_bytes") or 0)
        self.hbm_bytes = int(manifest.get("param_bytes") or 0) \
            + top * row_bytes
        self.service: Optional[ScorerService] = None
        self.warmed_once = False
        self.max_rows_seen = 0
        # pinned: a live canary compares arms against THIS version — an
        # eviction re-warm must not re-resolve HEAD out from under the
        # comparison (HEAD may already name the challenger)
        self.pinned = False


# score-distribution sketch resolution: fixed [0, 1] bins, so two arms'
# sketches are always PSI-comparable without a shared binning pass
ARM_SCORE_BINS = 16
# an arm's latency/score evidence below this mass is noise, not a p99
ARM_MIN_SAMPLES = 8


def arm_assign(seq: int, pct: float) -> bool:
    """Deterministic per-request arm assignment: the low-discrepancy
    Weyl sequence `frac(seq · φ)` compared against the routed fraction.
    Same admission order ⇒ same assignment, and any window of requests
    routes ≈ pct without a shared RNG."""
    if pct <= 0.0:
        return False
    if pct >= 1.0:
        return True
    return (seq * 0.6180339887498949) % 1.0 < pct


class _ArmState:
    """One model's live challenger arm: a resident challenger service
    plus the shadow mirror queue and the per-arm evidence (latency
    windows, score sketches) a live promotion verdict reads."""

    def __init__(self, model: str, version: str, vdir: str,
                 shadow_pct: float, canary_pct: float,
                 window: int, queue_depth: int):
        self.model = model
        self.version = version
        self.vdir = vdir
        self.shadow_pct = float(shadow_pct)
        self.canary_pct = float(canary_pct)
        self.phase = "shadow"
        self.service: Optional[ScorerService] = None
        self.seq = 0                      # per-model admission counter
        self.lat = {a: collections.deque(maxlen=max(window, 8))
                    for a in ("primary", "canary", "shadow")}
        self.hist = {"primary": np.zeros(ARM_SCORE_BINS, np.float64),
                     "challenger": np.zeros(ARM_SCORE_BINS, np.float64)}
        self.counts = {"primary": 0, "canary": 0, "shadow": 0}
        self.shadow_dropped = 0
        self.shadow_errors = 0
        self.canary_fallbacks = 0
        self.queue: "queue.Queue" = queue.Queue(maxsize=max(queue_depth, 1))
        self.worker: Optional[threading.Thread] = None
        self._lock = make_lock("fleet.arm")

    def note(self, arm: str, total_s: float, out) -> None:
        """Fold one scored request into the arm's evidence: latency
        window + score sketch (canary and shadow both score the
        challenger, so they share its sketch)."""
        side = "challenger" if arm in ("canary", "shadow") else "primary"
        try:
            scores = None
            for v in (out or {}).values():
                if v is not None:
                    scores = np.asarray(v, np.float64).ravel()
                    break
            with self._lock:
                self.lat[arm].append(float(total_s))
                self.counts[arm] += 1
                if scores is not None and scores.size:
                    h, _ = np.histogram(np.clip(scores, 0.0, 1.0),
                                        bins=ARM_SCORE_BINS,
                                        range=(0.0, 1.0))
                    self.hist[side] += h
        except Exception as e:  # noqa: BLE001 — evidence-keeping
            absorbed("fleet.arm-evidence", e)  # can't fail a request

    def p99_ms(self, arm: str) -> Optional[float]:
        with self._lock:
            lat = np.asarray(self.lat[arm], np.float64)
        if lat.size < ARM_MIN_SAMPLES:
            return None
        return float(np.percentile(lat, 99) * 1e3)

    def arm_psi(self) -> Optional[float]:
        """Score-distribution PSI between the two arms' sketches — the
        live analog of the offline eval guardrail. None until both
        arms carry enough mass to compare."""
        from shifu_tpu_torch.ops.stats import psi_metric
        with self._lock:
            p = self.hist["primary"].copy()
            c = self.hist["challenger"].copy()
        if p.sum() < ARM_MIN_SAMPLES or c.sum() < ARM_MIN_SAMPLES:
            return None
        return float(psi_metric(p / p.sum(), c / c.sum()))

    def stats(self) -> Dict[str, Any]:
        return {
            "challenger_version": self.version,
            "phase": self.phase,
            "shadow_pct": self.shadow_pct,
            "canary_pct": self.canary_pct,
            "requests": dict(self.counts),
            "p99_ms": {a: (round(v, 3) if (v := self.p99_ms(a))
                           is not None else None)
                       for a in ("primary", "canary", "shadow")},
            "shadow_dropped": self.shadow_dropped,
            "shadow_errors": self.shadow_errors,
            "canary_fallbacks": self.canary_fallbacks,
            "arm_psi": (round(v, 6) if (v := self.arm_psi())
                        is not None else None),
        }


class FleetService:
    """N registry models behind one submit surface; thread-safe."""

    def __init__(self, registry_root: str,
                 names: Optional[List[str]] = None,
                 workspace_root: Optional[str] = None,
                 hbm_budget_mb: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 slo_p99_ms: Optional[float] = None,
                 device: "str | torch.device" = "cuda"):
        from shifu_tpu_torch import resolve_device
        self.device = resolve_device(device)
        self._registry_root = registry_root
        self._workspace_root = workspace_root
        self._queue_depth = queue_depth
        if names is None:
            names = [row["name"] for row in registry.ls(registry_root)]
        if not names:
            raise FileNotFoundError(
                f"fleet: no published models under {registry_root}")
        if hbm_budget_mb is None:
            hbm_budget_mb = env.knob_int("SHIFU_TPU_FLEET_HBM_MB")
        # fractional MB welcome (tiny test/bench models are sub-MB)
        self._budget_bytes = int(float(hbm_budget_mb) * (1 << 20)) \
            if hbm_budget_mb else 0   # 0 = unlimited
        self._slo_p99_ms = float(
            slo_p99_ms if slo_p99_ms is not None
            else env.knob_float("SHIFU_TPU_FLEET_SLO_P99_MS"))
        window = env.knob_int("SHIFU_TPU_FLEET_SHED_WINDOW")
        # LRU order: least-recently-used first
        self._entries: "collections.OrderedDict[str, _Entry]" = \
            collections.OrderedDict()
        for name in names:
            version, vdir, manifest = registry.resolve(
                registry_root, name)
            self._entries[name] = _Entry(name, version, vdir, manifest)
        # reentrant: swap_in_place holds it across _ensure_resident
        self._lock = make_lock("fleet.registry", reentrant=True)
        self._lat = {p: collections.deque(maxlen=max(window, 8))
                     for p in PRIORITIES}
        self._lat_lock = make_lock("fleet.lat")
        self._shedding = False
        self._shed = {p: 0 for p in PRIORITIES}
        self._admitted = {p: 0 for p in PRIORITIES}
        self._evictions = 0
        self._rewarm_s = 0.0
        self._swaps = 0
        self._swap_s = 0.0
        self._arms: Dict[str, _ArmState] = {}

    # -- residency (HBM budget + LRU) ----------------------------------
    def models(self) -> List[str]:
        return list(self._entries)

    def resident(self) -> List[str]:
        with self._lock:
            return [n for n, e in self._entries.items()
                    if e.service is not None]

    def _resident_bytes(self) -> int:
        return sum(e.hbm_bytes for e in self._entries.values()
                   if e.service is not None)

    def _evict_locked(self, entry: _Entry) -> None:
        with obs_trace.span("fleet.evict", model=entry.name,
                            version=entry.version):
            entry.service.close()    # drops its graphs and their pool
        entry.service = None
        self._evictions += 1
        pipeline.add_stage_count("fleet_evictions")

    def _service(self, vdir: str, entry: _Entry,
                 tags: Dict[str, str]) -> ScorerService:
        return ScorerService(
            models_dir=vdir, ladder=entry.ladder or None,
            max_delay=entry.max_delay_s, queue_depth=self._queue_depth,
            device=self.device, workspace_root=self._workspace_root,
            priority=entry.priority, metrics_tags=tags)

    def _ensure_resident(self, name: str) -> ScorerService:
        with self._lock:
            entry = self._entries[name]
            self._entries.move_to_end(name)   # touch: most recent last
            if entry.service is not None:
                return entry.service
            # a (re-)warm re-resolves HEAD, so a registry promote
            # followed by eviction hot-swaps the model without a
            # process restart. A PINNED entry (live canary in flight)
            # keeps its version: the incumbent serves it until the arm
            # comparison reaches a verdict, even if HEAD already names
            # the challenger
            try:
                version, vdir, manifest = registry.resolve(
                    self._registry_root, name)
            except FileNotFoundError:
                version = entry.version
            if entry.pinned:
                version = entry.version
            if version != entry.version:
                fresh = _Entry(name, version, vdir, manifest)
                fresh.warmed_once = entry.warmed_once
                # same key slot → LRU position is preserved
                self._entries[name] = entry = fresh
            if self._budget_bytes:
                for victim in list(self._entries.values()):
                    if self._resident_bytes() + entry.hbm_bytes \
                            <= self._budget_bytes:
                        break
                    if victim is entry or victim.service is None:
                        continue
                    self._evict_locked(victim)
            t0 = time.monotonic()
            with obs_trace.span("fleet.warm", model=name,
                                version=entry.version,
                                rewarm=entry.warmed_once):
                svc = self._service(entry.vdir, entry, {"model": name})
                svc.start()
            if entry.warmed_once:
                # a RE-warm (post-eviction) — the steady-state cost the
                # budget trades for; first warms land on serve_warm_s
                self._rewarm_s += time.monotonic() - t0
                pipeline.add_stage_time("fleet_rewarm_s",
                                        time.monotonic() - t0)
            entry.warmed_once = True
            entry.service = svc
            return svc

    def swap_in_place(self, name: str) -> str:
        """Hot-promote `name`'s registry HEAD into the running fleet
        WITHOUT restart or recapture: the new version's params are
        copied into the storage the resident service's live graphs read
        (`ScorerService.swap_params`), checked against a cold start
        before going live. Returns what happened:

        - ``"swapped"``  — in-place param swap (no graph captured; a
          batch scores wholly old-or-new, never mixed);
        - ``"rewarmed"`` — shapes/dtypes/kinds changed, so the entry
          was evicted and re-warmed against the new HEAD;
        - ``"cold"``     — the model was not resident; the new HEAD is
          adopted and warms on its next hit;
        - ``"noop"``     — already serving HEAD.

        The `refresh.swap` fault point fires before any mutation, so
        an injected fault here leaves the incumbent version serving
        untouched.  A parity-gate failure propagates (nothing was
        mutated) — the refresh controller answers it by rolling the
        registry HEAD back, keeping HEAD == what is actually serving.
        """
        fault_point("refresh.swap")
        with self._lock:
            entry = self._entries[name]
            version, vdir, manifest = registry.resolve(
                self._registry_root, name)
            if entry.service is None:
                fresh = _Entry(name, version, vdir, manifest)
                fresh.warmed_once = entry.warmed_once
                self._entries[name] = fresh
                return "cold"
            if version == entry.version:
                return "noop"
            t0 = time.monotonic()
            with obs_trace.span("fleet.swap", model=name,
                                version=version,
                                from_version=entry.version):
                swapped = entry.service.swap_params(vdir)
            if swapped:
                entry.version = version
                entry.vdir = vdir
                entry.manifest = manifest
                self._swaps += 1
                self._swap_s += time.monotonic() - t0
                pipeline.add_stage_time("fleet_swap_s",
                                        time.monotonic() - t0)
                return "swapped"
            # structural change — fall back to evict + re-warm (which
            # re-resolves HEAD and recaptures/selfchecks from scratch)
            self._evict_locked(entry)
            self._ensure_resident(name)
            return "rewarmed"

    # -- live-promotion arms (shadow + canary) -------------------------
    def start_arms(self, name: str, challenger_dir: str,
                   version: str = "challenger",
                   shadow_pct: Optional[float] = None,
                   canary_pct: float = 0.0) -> Dict[str, Any]:
        """Warm a challenger arm next to `name`'s primary and open the
        shadow plane. The challenger becomes resident (its own service
        from `challenger_dir`, warmed — on the card: captured — here,
        from the primary's warm-up request; registry HEAD does not move
        and the primary entry is pinned to its version for the arm's
        lifetime). Canary routing starts at `canary_pct` (default 0 —
        shadow only until `set_canary_pct`)."""
        if shadow_pct is None:
            shadow_pct = env.knob_float("SHIFU_TPU_SHADOW_PCT")
        with self._lock:
            if name in self._arms:
                raise RuntimeError(
                    f"fleet: model {name!r} already has a live arm "
                    f"({self._arms[name].version})")
            entry = self._entries[name]
            entry.pinned = True
            proto = entry.service._proto if entry.service is not None \
                else None
            arm = _ArmState(name, version, challenger_dir,
                            shadow_pct, canary_pct,
                            env.knob_int("SHIFU_TPU_FLEET_SHED_WINDOW"),
                            env.knob_int("SHIFU_TPU_SHADOW_QUEUE"))
        try:
            svc = self._service(challenger_dir, entry,
                                {"model": name, "arm": "challenger"})
            svc.start(proto=proto)
        except BaseException:
            with self._lock:
                entry.pinned = False
            raise
        arm.service = svc
        arm.worker = threading.Thread(
            target=self._shadow_worker, args=(arm,),
            name=f"shadow-{name}", daemon=True)
        arm.worker.start()
        with self._lock:
            self._arms[name] = arm
        return arm.stats()

    def stop_arms(self, name: str) -> None:
        """Tear the arm down: canary routing off first (every later
        request goes to the primary — the zero-failed-requests rollback
        path), then the shadow thread and the challenger service.
        Idempotent."""
        with self._lock:
            arm = self._arms.pop(name, None)
            entry = self._entries.get(name)
            if entry is not None:
                entry.pinned = False
        if arm is None:
            return
        arm.canary_pct = 0.0
        arm.shadow_pct = 0.0
        # drop the backlog BEFORE the shutdown sentinel: the arm is
        # dead, so mirrored requests still queued are moot, and a slow
        # challenger must not keep scoring them after teardown
        try:
            while True:
                arm.queue.get_nowait()
        except queue.Empty:
            pass
        try:
            arm.queue.put(None, timeout=5.0)
        except queue.Full:
            pass                              # daemon thread — bounded leak
        if arm.worker is not None:
            arm.worker.join(timeout=5.0)
        if arm.service is not None:
            arm.service.close()

    def set_canary_pct(self, name: str, pct: float,
                       phase: Optional[str] = None) -> None:
        """Retarget the canary routed fraction live (the controller's
        shadow → canary phase flip)."""
        arm = self._arms.get(name)
        if arm is None:
            raise KeyError(f"fleet: model {name!r} has no live arm")
        arm.canary_pct = float(pct)
        if phase is not None:
            arm.phase = phase

    def arm_stats(self, name: str) -> Optional[Dict[str, Any]]:
        arm = self._arms.get(name)
        return arm.stats() if arm is not None else None

    def _shadow_worker(self, arm: _ArmState) -> None:
        """Drain the shadow mirror queue against the challenger arm.
        Everything in here is absorbed — a shadow failure or overload
        is COUNTED, never propagated; the primary path only ever
        touched the bounded queue."""
        while True:
            item = arm.queue.get()
            if item is None:
                return
            try:
                with obs_trace.span("shadow.score", model=arm.model,
                                    version=arm.version):
                    fault_point("shadow.score")
                    out, timing = arm.service.submit_timed(timeout=5.0,
                                                           **item)
                    arm.note("shadow", timing["total_s"], out)
            except Exception:  # noqa: BLE001 — absorbed by design
                arm.shadow_errors += 1

    def start(self, names: Optional[List[str]] = None) -> "FleetService":
        """Warm `names` (default: every model, in declaration order) up
        to the HBM budget — later models LRU-evict earlier ones when
        they don't all fit."""
        for name in names or list(self._entries):
            self._ensure_resident(name)
        return self

    def close(self) -> None:
        for name in list(self._arms):
            self.stop_arms(name)
        with self._lock:
            for entry in self._entries.values():
                if entry.service is not None:
                    entry.service.close()
                    entry.service = None
        self._flush_metrics()

    def __enter__(self) -> "FleetService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- admission (priority shed) -------------------------------------
    def _note_latency(self, priority: str, total_s: float) -> None:
        with self._lat_lock:
            self._lat[priority].append(float(total_s))

    def _class_p99_ms(self, priority: str) -> Optional[float]:
        with self._lat_lock:
            lat = np.asarray(self._lat[priority], np.float64)
        if not lat.size:
            return None
        return float(np.percentile(lat, 99) * 1e3)

    def set_slo(self, slo_p99_ms: float) -> None:
        """Retarget the shed SLO live (bench/autotune calibration)."""
        self._slo_p99_ms = float(slo_p99_ms)

    def set_hbm_budget(self, hbm_budget_mb: float) -> None:
        """Resize the residency budget live (0 = unlimited).
        Shrinking takes effect at the next warm — already-resident
        models are not proactively evicted."""
        with self._lock:
            self._budget_bytes = int(float(hbm_budget_mb) * (1 << 20)) \
                if hbm_budget_mb else 0

    def _shed_active(self) -> bool:
        """Hysteresis switch over the rolling high-priority p99:
        engage above the SLO, release below 70% of it."""
        p99 = self._class_p99_ms("high")
        if p99 is None:
            return self._shedding
        if self._shedding:
            self._shedding = p99 >= 0.7 * self._slo_p99_ms
        else:
            self._shedding = p99 > self._slo_p99_ms
        return self._shedding

    # -- request path --------------------------------------------------
    def submit_timed(self, model: str,
                     timeout: Optional[float] = 30.0, **blocks
                     ) -> Tuple[Dict[str, np.ndarray],
                                Dict[str, float]]:
        fault_point("serve.route")
        entry = self._entries.get(model)
        if entry is None:
            raise KeyError(f"fleet: unknown model {model!r} "
                           f"(have {self.models()})")
        if entry.priority == "low" and self._shed_active():
            self._shed["low"] += 1
            if entry.service is not None:
                entry.service.note_rejected("low")
            raise ShedReject(model, "low")
        # live-promotion arms: one deterministic assignment per admitted
        # request. A canary hit scores on the challenger for real; any
        # challenger failure falls back to the primary (counted), so an
        # arm never fails a client. Arm latencies stay out of the fleet
        # shed window — a slow challenger must trip the canary verdict,
        # not the incumbent's load shedder.
        arm = self._arms.get(model)
        to_canary = False
        if arm is not None and arm.service is not None:
            seq = arm.seq
            arm.seq += 1
            to_canary = arm_assign(seq, arm.canary_pct)
        if to_canary:
            try:
                out, timing = arm.service.submit_timed(
                    timeout=timeout, **blocks)
                timing["arm"] = "canary"
                arm.note("canary", timing["total_s"], out)
                self._admitted[entry.priority] += 1
                return out, timing
            except Exception:  # noqa: BLE001 — the arm absorbs its
                # own failures; the request still gets a real answer
                arm.canary_fallbacks += 1
        svc = self._ensure_resident(model)
        n = 0
        for v in blocks.values():
            if v is not None:
                n = int(np.asarray(v).shape[0])
                break
        entry.max_rows_seen = max(entry.max_rows_seen, n)
        out, timing = svc.submit_timed(timeout=timeout, **blocks)
        timing["arm"] = "primary"
        self._admitted[entry.priority] += 1
        self._note_latency(entry.priority, timing["total_s"])
        if arm is not None and arm.service is not None:
            arm.note("primary", timing["total_s"], out)
            if arm_assign(arm.seq, arm.shadow_pct):
                # mirror onto the bounded queue; full ⇒ drop, never
                # block — the shadow plane cannot slow this request
                try:
                    arm.queue.put_nowait(dict(blocks))
                except queue.Full:
                    arm.shadow_dropped += 1
        return out, timing

    def submit(self, model: str, timeout: Optional[float] = 30.0,
               **blocks) -> Dict[str, np.ndarray]:
        return self.submit_timed(model, timeout=timeout, **blocks)[0]

    # -- monitoring ----------------------------------------------------
    def rejected_by_class(self) -> Dict[str, int]:
        """429s per priority class: per-service queue-full rejections
        plus fleet-level sheds."""
        out = {p: self._shed[p] for p in PRIORITIES}
        with self._lock:
            for entry in self._entries.values():
                if entry.service is not None:
                    for p, v in entry.service.rejected_by_class.items():
                        out[p] = out.get(p, 0) + v
        return out

    def shed_rate(self) -> float:
        offered_low = self._admitted["low"] + self._shed["low"]
        return self._shed["low"] / offered_low if offered_low else 0.0

    def stats(self) -> Dict[str, Any]:
        per_model = {}
        with self._lock:
            for name, entry in self._entries.items():
                st = {"version": entry.version,
                      "priority": entry.priority,
                      "resident": entry.service is not None,
                      "hbm_bytes": entry.hbm_bytes,
                      "max_delay_ms": (entry.max_delay_s or 0.0) * 1e3
                      if entry.max_delay_s else None}
                if entry.service is not None:
                    st.update(entry.service.stats())
                per_model[name] = st
            resident = sum(1 for e in self._entries.values()
                           if e.service is not None)
        vals = {
            "models_resident": resident,
            "evictions": self._evictions,
            "rewarm_s": round(self._rewarm_s, 4),
            "swaps": self._swaps,
            "swap_s": round(self._swap_s, 4),
            "shed_rate": round(self.shed_rate(), 6),
            "p99_ms_by_class": {
                p: (round(v, 3) if (v := self._class_p99_ms(p))
                    is not None else None)
                for p in PRIORITIES},
        }
        return {
            "fleet": {k: vals[k] for k in FLEET_FIELDS},
            "shedding": self._shedding,
            "slo_p99_ms": self._slo_p99_ms,
            "hbm_budget_bytes": self._budget_bytes,
            "hbm_resident_bytes": self._resident_bytes(),
            "rejected_by_class": self.rejected_by_class(),
            "canary": {name: arm.stats()
                       for name, arm in list(self._arms.items())},
            "models": per_model,
        }

    def flush_metrics(self) -> None:
        """Force a store flush now: every resident service's serve.*
        snapshot (tagged model=...) plus the fleet-level gauges — the
        autotuner's history source between periodic flushes."""
        with self._lock:
            services = [e.service for e in self._entries.values()
                        if e.service is not None]
        for svc in services:
            svc._flush_metrics()
        self._flush_metrics()

    def _flush_metrics(self) -> None:
        """Fleet-level gauges into the metrics store (per-model serve.*
        points come from each service's own flusher, tagged model=...).
        Absorbed — metrics must never degrade serving."""
        try:
            from shifu_tpu_torch.obs.health import store as health_store
            if self._workspace_root is None or \
                    not health_store.metrics_enabled():
                return
            st = health_store.store(self._workspace_root)
            snap = self.stats()["fleet"]
            st.emit("serve.models_resident", snap["models_resident"])
            st.emit("serve.evictions", snap["evictions"],
                    kind="counter")
            st.emit("serve.shed_rate", snap["shed_rate"])
            for p, v in snap["p99_ms_by_class"].items():
                if v is not None:
                    st.emit("serve.p99_ms_class", v, priority=p)
            for name, arm in list(self._arms.items()):
                a = arm.stats()
                for side in ("primary", "canary", "shadow"):
                    if a["p99_ms"][side] is not None:
                        st.emit("serve.arm_p99_ms", a["p99_ms"][side],
                                model=name, arm=side)
                if a["arm_psi"] is not None:
                    st.emit("canary.arm_psi", a["arm_psi"], model=name)
                st.emit("canary.shadow_dropped", a["shadow_dropped"],
                        kind="counter", model=name)
                st.emit("canary.fallbacks", a["canary_fallbacks"],
                        kind="counter", model=name)
            st.flush()
        except Exception as e:  # noqa: BLE001 — absorbed by design
            absorbed("fleet.metrics-emit", e)

    def health_state(self) -> Optional[Dict[str, Any]]:
        if self._workspace_root is None:
            return None
        try:
            from shifu_tpu_torch.obs.health import slo as slo_mod
            return slo_mod.health_state(self._workspace_root)
        except Exception:  # noqa: BLE001 — liveness must not break
            return None


class SloAutotuner:
    """Per-model SLO steering over the fleet's own metrics history."""

    def __init__(self, fleet: FleetService,
                 slo_p99_ms: Optional[float] = None,
                 min_delay_ms: float = 0.25,
                 max_delay_ms: float = 20.0):
        self._fleet = fleet
        self._slo = float(slo_p99_ms if slo_p99_ms is not None
                          else fleet._slo_p99_ms)
        self._min_ms = float(min_delay_ms)
        self._max_ms = float(max_delay_ms)

    def _observed_p99_ms(self, name: str,
                         entry: _Entry) -> Optional[float]:
        """The model's own recent p99: metrics-store `serve.p99_ms`
        points tagged with this model, falling back to the live
        service's latency window when no history is stored."""
        root = self._fleet._workspace_root
        if root is not None:
            try:
                from shifu_tpu_torch.obs.health import store as health_store
                pts = health_store.store(root).read_points(
                    names=["serve.p99_ms"])
                vals = [float(p["value"]) for p in pts
                        if (p.get("tags") or {}).get("model") == name
                        and isinstance(p.get("value"), (int, float))]
                if vals:
                    return float(np.median(vals[-20:]))
            except Exception as e:  # noqa: BLE001 — fall back to live
                absorbed("fleet.p99-probe", e)
        if entry.service is not None:
            lat = entry.service.stats().get("latency", {})
            if "p99_ms" in lat:
                return float(lat["p99_ms"])
        return None

    def step(self) -> List[Dict[str, Any]]:
        """One tuning pass over every model; returns the adjustment
        records (before/after) and emits each as an `autotune` event."""
        records = []
        for name, entry in list(self._fleet._entries.items()):
            p99 = self._observed_p99_ms(name, entry)
            if p99 is None:
                continue
            before_ms = (entry.max_delay_s * 1e3
                         if entry.max_delay_s is not None
                         else env.knob_float(
                             "SHIFU_TPU_SERVE_MAX_DELAY_MS"))
            if p99 > self._slo:
                # over SLO: stop waiting for co-riders
                after_ms = max(before_ms / 2.0, self._min_ms)
            elif p99 < 0.5 * self._slo:
                # comfortably under: trade headroom for occupancy
                after_ms = min(before_ms * 1.25, self._max_ms)
            else:
                after_ms = before_ms   # in the band — converged
            if after_ms != before_ms:
                entry.max_delay_s = after_ms / 1e3
                if entry.service is not None:
                    # MicroBatcher reads max_delay per flush decision,
                    # so a live service retunes without restart
                    entry.service._batcher.max_delay = after_ms / 1e3
            ladder = self._trim_ladder(entry)
            rec = {"model": name, "p99_ms_before": round(p99, 3),
                   "slo_p99_ms": self._slo,
                   "max_delay_ms_before": round(before_ms, 4),
                   "max_delay_ms_after": round(after_ms, 4),
                   "ladder": list(ladder)}
            records.append(rec)
            self._emit(rec)
        return records

    def _trim_ladder(self, entry: _Entry) -> Tuple[int, ...]:
        """Drop ladder rungs no observed request size needs (keeping
        one rung of headroom). Applied to the entry only — a resident
        service keeps its captured ladder until its next re-warm."""
        ladder = entry.ladder
        if not ladder or entry.max_rows_seen <= 0:
            return ladder
        keep = 1
        for i, b in enumerate(ladder):
            if b >= entry.max_rows_seen:
                keep = i + 1
                break
        else:
            return ladder
        trimmed = ladder[:min(keep + 1, len(ladder))]
        if trimmed != ladder:
            entry.ladder = trimmed
        return trimmed

    def _emit(self, rec: Dict[str, Any]) -> None:
        root = self._fleet._workspace_root
        if root is None:
            return
        try:
            from shifu_tpu_torch.obs.health import store as health_store
            st = health_store.store(root)
            st.event("autotune", model=rec["model"],
                     p99_ms_before=rec["p99_ms_before"],
                     max_delay_ms_before=rec["max_delay_ms_before"],
                     max_delay_ms_after=rec["max_delay_ms_after"])
            st.emit("serve.autotune_delay_ms",
                    rec["max_delay_ms_after"], model=rec["model"])
            st.flush()
        except Exception as e:  # noqa: BLE001 — absorbed by design
            absorbed("fleet.autotune-event", e)
