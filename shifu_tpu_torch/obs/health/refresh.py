"""Drift breach → warm-start retrain → eval guardrail → atomic promote →
in-place hot swap → instant rollback: the closed loop, counterpart of
`shifu_tpu/obs/health/refresh.py`.

`RefreshController` plugs into the watch loop's `on_breach` seam
(obs/health/watch.py). A breach of any SLO schedules ONE refresh run:

  schedule   clone the model set into a challenger workspace under
             ``tmp/refresh/run****`` (parent ModelConfig with paths
             absolutized, ColumnConfig copied), seed it with the
             incumbent's model files and turn ``train#isContinuous`` on,
             and point its dataPath at the accumulated drift window
             (the rows the watch loop saw arrive, capped at
             ``SHIFU_TPU_REFRESH_WINDOW_ROWS``; no window → the full
             training table). With an ingest row log bound (`watch
             --ingest`) the window is read from the ``refresh`` consumer
             offset and written byte for byte; the exact (segment,
             offset) range lands in the published manifest
             (``refresh.ingest_window``) and the offset commits only
             after that write. `fault_point("refresh.schedule")`.

  train      `norm` + `train` inside the clone, in process, on the
             controller's device: the NN resumes from the incumbent's
             params (`processor/train._continuous_init`), a GBT appends
             trees to the incumbent's (`train_tree._continuous_trees`,
             kernels K3/K4 and K5).

  guardrail  score the incumbent AND the challenger over the SAME
             held-out eval set (`_build_eval_dataset` once, two
             `Scorer`s through `_score_dataset`: kernel K1 or K2 twice)
             and compare weighted AUCs (`ops/metrics.weighted_auc`). The
             challenger is REFUSED unless ``challenger_auc >=
             incumbent_auc - SHIFU_TPU_REFRESH_TOLERANCE``. The decision
             lands in the metrics store as a ``refresh`` event.
             `fault_point("refresh.guardrail")`: a faulted eval fails
             the run — the incumbent keeps serving, HEAD never moved.

  promote    `registry.publish` (two renames) with the verdict in the
             manifest. `fault_point("refresh.promote")`.

  swap       `FleetService.swap_in_place`: an in-place param copy into
             the resident CUDA graphs (no capture), or evict + re-warm
             when the shape changed (a GBT warm start appends trees). A
             swap failure AFTER publish rolls back at once:
             `registry.rollback` + a re-swap to re-pin the incumbent.

LIVE MODE: with `canary=` the trained challenger goes through the staged
shadow → canary controller (obs/health/canary.py) instead of the offline
guardrail, and the verdict comes from the fleet's arms.

HYSTERESIS: breaches arriving while a refresh is in flight or within
``SHIFU_TPU_REFRESH_COOLDOWN_S`` of the last run are COALESCED — one
retrain absorbs the storm; the count is an event and a counter in the
store (`health` shows it) and in `stats()`.

The ``refresh.run`` / ``refresh.guardrail`` / ``refresh.rollback`` spans
and the ``refresh_*_s`` stage timers of the JAX package's trace are
ROADMAP A8.5.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from shifu_tpu_torch import fileio, resilience
from shifu_tpu_torch.config.environment import knob_float, knob_int
from shifu_tpu_torch.obs.health import store as health_store

log = logging.getLogger("shifu_tpu_torch")


class GuardrailHold(RuntimeError):
    """The challenger was refused (metric regressed beyond tolerance) —
    promotion did not happen, the incumbent keeps serving. Raised only
    out of `refresh_once`; the controller absorbs it into a `held`
    outcome."""


class RefreshController:
    """Owns the breach → promote pipeline for ONE model set.

    `ctx` is the incumbent's ProcessorContext. `registry_root` +
    `model_name` bind promotion to a registry model (None → the
    guardrail still runs, but the verdict is report-only). `fleet` is
    the live FleetService to hot-swap (None → publish moves HEAD; the
    next serve restart picks it up). `post_train` is a test seam called
    with the challenger workspace after training, before the guardrail.
    `ingest_log` (a `data.ingest.RowLog` or its root) makes the
    challenger train on the ``refresh`` consumer's window. `canary`
    switches promotion to LIVE mode (True for knob defaults or a dict of
    CanaryController overrides); it needs registry_root, model_name and
    fleet. `device` trains and scores the challenger (the card unless
    the caller passes "cpu").
    """

    def __init__(self, ctx, registry_root: Optional[str] = None,
                 model_name: Optional[str] = None,
                 fleet=None, eval_name: Optional[str] = None,
                 cooldown_s: Optional[float] = None,
                 tolerance: Optional[float] = None,
                 window_rows: Optional[int] = None,
                 post_train=None, ingest_log=None, canary=None,
                 device: "str | torch.device" = "cuda"):
        from shifu_tpu_torch import resolve_device
        self.ctx = ctx
        self.device = resolve_device(device)
        if isinstance(ingest_log, str):
            from shifu_tpu_torch.data.ingest import RowLog
            ingest_log = RowLog(ingest_log)
        self.ingest_log = ingest_log
        self.registry_root = registry_root
        self.model_name = model_name
        self.fleet = fleet
        self.eval_name = eval_name
        self.cooldown_s = cooldown_s if cooldown_s is not None \
            else knob_float("SHIFU_TPU_REFRESH_COOLDOWN_S")
        self.tolerance = tolerance if tolerance is not None \
            else knob_float("SHIFU_TPU_REFRESH_TOLERANCE")
        self.window_rows = int(window_rows if window_rows is not None
                               else knob_int("SHIFU_TPU_REFRESH_WINDOW_ROWS"))
        self.post_train = post_train
        self.canary = canary
        self.runs = 0
        self.promoted = 0
        self.held = 0
        self.rolled_back = 0
        self.coalesced = 0
        self.last_outcome: Optional[str] = None
        self._window_frames: List[Any] = []
        self._window_len = 0
        self._in_flight = False
        self._last_done: Optional[float] = None

    # -- window accumulation (fed by the watch loop) --------------------

    def note_window(self, df) -> None:
        """Remember the newest arriving rows (a `Table`) as retrain
        fodder; keeps at most `window_rows` of tail (oldest tables
        dropped whole)."""
        if df is None or not len(df):
            return
        self._window_frames.append(df)
        self._window_len += len(df)
        while self._window_frames and \
                self._window_len - len(self._window_frames[0]) \
                >= self.window_rows:
            self._window_len -= len(self._window_frames[0])
            self._window_frames.pop(0)

    def _take_window(self):
        if not self._window_frames:
            return None
        from shifu_tpu_torch.data.reader import Table
        df = Table.concat(self._window_frames)
        if len(df) > self.window_rows:
            df = df.select(np.arange(len(df) - self.window_rows, len(df)))
        self._window_frames, self._window_len = [], 0
        return df

    # -- breach entry point ----------------------------------------------

    def handle_breach(self, record: Dict) -> str:
        """One SLO transition into breach. Returns the outcome:
        promoted | held | rolled_back | coalesced | failed."""
        st = health_store.store(self.ctx.path_finder.root)
        now = time.monotonic()
        if self._in_flight or (self._last_done is not None
                               and now - self._last_done < self.cooldown_s):
            self.coalesced += 1
            st.counter("refresh.coalesced")
            st.event("refresh", phase="coalesced",
                     slo=record.get("slo", "?"), count=self.coalesced)
            log.info("refresh: breach of %r coalesced (%s, %d so far)",
                     record.get("slo"),
                     "in flight" if self._in_flight else "cooldown",
                     self.coalesced)
            return "coalesced"
        self._in_flight = True
        try:
            outcome = self.refresh_once(record)
        except GuardrailHold as e:
            outcome = "held"
            self.held += 1
            log.warning("refresh: challenger held: %s", e)
        except Exception as e:  # noqa: BLE001 — a failed refresh must
            # never kill the watch loop; the incumbent keeps serving
            outcome = "failed"
            st.event("refresh", phase="failed", error=str(e)[:200])
            log.warning("refresh: run failed (incumbent keeps serving): %s",
                        e)
        finally:
            self._in_flight = False
            self._last_done = time.monotonic()
        self.last_outcome = outcome
        return outcome

    # -- the pipeline ------------------------------------------------------

    def incumbent_models_dir(self) -> str:
        """Registry HEAD when bound (the deployment's source of truth),
        else the workspace's own models/."""
        if self.registry_root and self.model_name:
            from shifu_tpu_torch import registry
            try:
                _, vdir, _ = registry.resolve(self.registry_root,
                                              self.model_name)
                return vdir
            except FileNotFoundError:
                pass
        return self.ctx.path_finder.models_path()

    def refresh_once(self, record: Dict) -> str:
        """The full schedule → train → guardrail → promote → swap run.
        Raises GuardrailHold when the challenger is refused; any other
        exception means the run failed before changing anything the
        incumbent depends on."""
        st = health_store.store(self.ctx.path_finder.root)
        t_breach = time.monotonic()
        self.runs += 1
        run_name = f"run{self.runs:04d}"

        # -- schedule: challenger workspace ------------------------------
        resilience.fault_point("refresh.schedule")
        window, win = None, None
        if self.ingest_log is not None:
            from shifu_tpu_torch.data.ingest import REFRESH_CONSUMER
            win = self.ingest_log.read_window(REFRESH_CONSUMER,
                                              max_rows=self.window_rows)
        if win is None:
            window = self._take_window()
        w_rows = win.rows if win is not None \
            else (0 if window is None else len(window))
        st.event("refresh", phase="scheduled", slo=record.get("slo", "?"),
                 run=run_name, window_rows=w_rows)
        clone = self._prepare_challenger(run_name, window, raw_window=win)
        if win is not None:
            # the training set's write IS this consumer's downstream
            # commit point: the window now exists byte for byte in the
            # clone, so the offset may move — a crash before this line
            # replays the window, never skips it
            from shifu_tpu_torch.data.ingest import REFRESH_CONSUMER
            self.ingest_log.commit(REFRESH_CONSUMER, win.end)

        # -- train: warm-start incremental epochs or trees ---------------
        self._train_challenger(clone)
        if self.post_train is not None:
            self.post_train(clone)

        # -- live mode: verdict from real traffic, not the eval ----------
        if self.canary and self.registry_root and self.model_name \
                and self.fleet is not None:
            return self._canary_promote(clone, run_name, record, win, st,
                                        t_breach)

        # -- guardrail: challenger vs incumbent on held-out eval ---------
        verdict = self.guardrail(os.path.join(clone, "models"))
        st.emit("refresh.guardrail_delta", verdict["delta"], kind="gauge",
                run=run_name)
        st.event("refresh", phase="guardrail", run=run_name,
                 decision=verdict["decision"],
                 incumbent=round(verdict["incumbent"], 6),
                 challenger=round(verdict["challenger"], 6),
                 tolerance=self.tolerance)
        if verdict["decision"] != "promote":
            raise GuardrailHold(
                f"challenger {verdict['challenger']:.6f} vs incumbent "
                f"{verdict['incumbent']:.6f} (tolerance "
                f"{self.tolerance}): {verdict['reason']}")

        if not (self.registry_root and self.model_name):
            # report-only mode: verdict recorded, nothing to promote
            self.promoted += 1
            st.event("refresh", phase="promoted", run=run_name,
                     version="(unbound)", swap="none")
            return "promoted"

        # -- promote: two-rename atomic registry commit -------------------
        from shifu_tpu_torch import registry
        resilience.fault_point("refresh.promote")
        prev_head = registry.head(self.registry_root, self.model_name)
        refresh_block = {
            "run": run_name, "slo": record.get("slo", "?"),
            "incumbent_auc": verdict["incumbent"],
            "challenger_auc": verdict["challenger"],
            "refreshed_from": prev_head}
        if win is not None:
            # the exact (segment, offset) range retrained on —
            # `RowLog.read_range(start, end)` re-reads it bitwise
            refresh_block["ingest_window"] = dict(
                win.range_record(), log=self.ingest_log.root)
        version = registry.publish(
            self.registry_root, self.model_name,
            os.path.join(clone, "models"),
            extra={"refresh": refresh_block})

        # -- swap: in place into the running fleet ------------------------
        swap = "none"
        if self.fleet is not None:
            try:
                swap = self.fleet.swap_in_place(self.model_name)
            except Exception as e:  # noqa: BLE001 — any swap failure
                # (parity gate, injected fault) → instant rollback
                self._rollback(version, prev_head, e)
                self.rolled_back += 1
                st.event("refresh", phase="rolled_back", run=run_name,
                         version=version, to=prev_head or "?",
                         error=str(e)[:200])
                return "rolled_back"
        self.promoted += 1
        wall = time.monotonic() - t_breach
        st.emit("refresh.breach_to_promoted_s", wall, kind="gauge",
                run=run_name)
        st.event("refresh", phase="promoted", run=run_name,
                 version=version, swap=swap,
                 breach_to_promoted_s=round(wall, 3))
        log.info("refresh: %s promoted as %s/%s (swap=%s, %.2fs "
                 "breach→promoted)", run_name, self.model_name, version,
                 swap, wall)
        return "promoted"

    def _canary_promote(self, clone: str, run_name: str, record: Dict,
                        win, st, t_breach: float) -> str:
        """Live promotion: hand the trained challenger to the staged
        shadow → canary controller and map its traffic-derived verdict
        onto this controller's outcomes. The offline eval never runs."""
        from shifu_tpu_torch import registry
        from shifu_tpu_torch.obs.health.canary import CanaryController

        prev_head = registry.head(self.registry_root, self.model_name)
        refresh_block = {"run": run_name, "slo": record.get("slo", "?"),
                         "refreshed_from": prev_head, "mode": "live"}
        if win is not None:
            refresh_block["ingest_window"] = dict(
                win.range_record(), log=self.ingest_log.root)
        overrides = self.canary if isinstance(self.canary, dict) else {}
        ctl = CanaryController(
            self.fleet, self.registry_root, self.model_name,
            store_root=self.ctx.path_finder.root, **overrides)
        result = ctl.run(os.path.join(clone, "models"), run_name,
                         refresh_block=refresh_block)
        if result["outcome"] == "promoted":
            self.promoted += 1
            wall = time.monotonic() - t_breach
            st.emit("refresh.breach_to_promoted_s", wall, kind="gauge",
                    run=run_name)
            st.event("refresh", phase="promoted", run=run_name,
                     version=result["version"],
                     swap=result.get("swap", "none"),
                     mode="live", breach_to_promoted_s=round(wall, 3))
            log.info("refresh: %s live-promoted as %s/%s (%.2fs "
                     "breach→promoted)", run_name, self.model_name,
                     result["version"], wall)
            return "promoted"
        self.rolled_back += 1
        st.event("refresh", phase="rolled_back", run=run_name,
                 version=result["version"],
                 to=result.get("prev_head") or "?", mode="live",
                 error=result["verdict"].get("reason", "")[:200])
        return "rolled_back"

    # -- phases ------------------------------------------------------------

    def _prepare_challenger(self, run_name: str, window,
                            raw_window=None) -> str:
        """Write the challenger workspace: parent ModelConfig (paths
        absolutized) with isContinuous on, ColumnConfig copied, the
        incumbent's model files seeded into models/ for the warm start,
        and — when a drift window accumulated — its own dataPath holding
        exactly those rows (`raw_window`, an ingest `Window`, is written
        from the log's raw lines unmodified, so the recorded offset
        range IS the training data). A rerun rebuilds from scratch."""
        from shifu_tpu_torch.models import spec as spec_mod

        root = self.ctx.path_finder.root
        clone = os.path.join(root, "tmp", "refresh", run_name)
        if os.path.exists(clone):
            shutil.rmtree(clone)   # rerun recovers: stale attempt gone
        os.makedirs(os.path.join(clone, "tmp"), exist_ok=True)

        with open(os.path.join(root, "ModelConfig.json"),
                  encoding="utf-8") as f:
            raw = json.load(f)
        from shifu_tpu_torch.pipeline.nodes import _absolutize
        raw = _absolutize(raw, root)
        raw.setdefault("train", {})["isContinuous"] = True
        raw.setdefault("basic", {})["name"] = \
            f"{raw.get('basic', {}).get('name', 'model')}:{run_name}"
        if raw_window is not None and raw_window.rows:
            raw["dataSet"]["dataPath"], raw["dataSet"]["headerPath"] = \
                self._write_rows(clone, raw_window.lines,
                                 self.ingest_log.header,
                                 self.ingest_log.delimiter)
            raw["dataSet"]["dataDelimiter"] = self.ingest_log.delimiter
            raw["dataSet"]["headerDelimiter"] = self.ingest_log.delimiter
        elif window is not None and len(window):
            from shifu_tpu_torch.data.ingest import rows_from_frame
            delim = raw["dataSet"].get("dataDelimiter", "|")
            raw["dataSet"]["dataPath"], raw["dataSet"]["headerPath"] = \
                self._write_rows(clone, rows_from_frame(window, delim),
                                 window.columns, delim)
        with fileio.atomic_write(os.path.join(clone, "ModelConfig.json"),
                                 encoding="utf-8") as f:
            json.dump(raw, f, indent=2)

        cc_src = os.path.join(root, "ColumnConfig.json")
        if os.path.exists(cc_src):
            shutil.copyfile(cc_src, os.path.join(clone, "ColumnConfig.json"))
        # seed the warm start: the incumbent's model files become the
        # clone's models/ so the continuous-training path restores them
        dst = os.path.join(clone, "models")
        os.makedirs(dst, exist_ok=True)
        for src in spec_mod.list_models(self.incumbent_models_dir()):
            shutil.copy2(src, os.path.join(dst, os.path.basename(src)))
        return clone

    @staticmethod
    def _write_rows(clone: str, lines, header, delim: str):
        """Rows as a private raw table (delimited text with a
        .pig_header, the layout the parent reads). From an ingest window
        the lines are the log's, unmodified — `sha256(part-00000)`
        equals the hash of `RowLog.read_range` over the recorded
        range."""
        wdir = os.path.join(clone, "window")
        os.makedirs(wdir, exist_ok=True)
        header_path = os.path.join(wdir, ".pig_header")
        with fileio.atomic_write(header_path, encoding="utf-8") as f:
            f.write(delim.join(str(c) for c in header) + "\n")
        with fileio.atomic_write(os.path.join(wdir, "part-00000"),
                                 encoding="utf-8") as f:
            for line in lines:
                f.write(line + "\n")
        return wdir, header_path

    def _train_challenger(self, clone: str) -> None:
        """`norm` + `train` inside the clone, in process. Norm re-bins
        the window rows with the PARENT's frozen ColumnConfig stats (the
        clone copied it), so the challenger sees the drifted data
        through the feature space the incumbent was trained on."""
        from shifu_tpu_torch.processor import norm as norm_proc
        from shifu_tpu_torch.processor import train as train_proc
        from shifu_tpu_torch.processor.base import ProcessorContext
        rc = norm_proc.run(ProcessorContext.load(clone), device=self.device)
        if rc:
            raise RuntimeError(f"refresh: challenger norm failed (rc={rc})")
        # re-read the post-norm configs
        rc = train_proc.run(ProcessorContext.load(clone), device=self.device)
        if rc:
            raise RuntimeError(f"refresh: challenger train failed (rc={rc})")

    def guardrail(self, challenger_dir: str) -> Dict[str, Any]:
        """Score incumbent vs challenger over the SAME held-out eval set
        and decide. The eval dataset is built ONCE; both scorers run
        through eval's `_score_dataset` (normalization, selector) on the
        controller's device, so the comparison is apples to apples. A
        fault in here propagates — a broken eval NEVER promotes."""
        from shifu_tpu_torch.eval.scorer import Scorer
        from shifu_tpu_torch.ops import metrics as ops_metrics
        from shifu_tpu_torch.processor.eval import (_build_eval_dataset,
                                                    _eval_by_name,
                                                    _score_dataset)

        resilience.fault_point("refresh.guardrail")
        ec = _eval_by_name(self.ctx, self.eval_name)[0]
        dset, cols = _build_eval_dataset(self.ctx, ec)
        mc = self.ctx.model_config
        labels = np.asarray(dset.tags, dtype=np.float32)
        weights = np.asarray(dset.weights, dtype=np.float32)
        scores = {}
        for side, mdir in (("incumbent", self.incumbent_models_dir()),
                           ("challenger", challenger_dir)):
            scorer = Scorer.from_dir(
                mdir, score_selector=ec.performanceScoreSelector,
                gbt_convert=ec.gbtScoreConvertStrategy, device=self.device)
            out = _score_dataset(mc, scorer, dset, cols)
            scores[side] = float(ops_metrics.weighted_auc(
                np.asarray(out["final"], dtype=np.float32), labels, weights,
                device=self.device))
        decision, reason = self.decide(scores["incumbent"],
                                       scores["challenger"], self.tolerance)
        return {"decision": decision, "reason": reason,
                "incumbent": scores["incumbent"],
                "challenger": scores["challenger"],
                "delta": scores["challenger"] - scores["incumbent"]}

    @staticmethod
    def decide(incumbent: float, challenger: float, tolerance: float):
        """The promotion rule, bare: promote when the challenger
        improved or regressed no more than `tolerance` on the guardrail
        metric; hold otherwise."""
        delta = challenger - incumbent
        if delta >= 0:
            return "promote", "challenger improved"
        if -delta <= tolerance:
            return "promote", "within tolerance"
        return "hold", "regressed beyond tolerance"

    def _rollback(self, version: str, prev_head: Optional[str],
                  err: Exception) -> None:
        """Instant rollback after a failed swap: HEAD back to the
        incumbent, then a re-swap so the fleet is provably pinned to it
        (absorbed — the failed forward swap never mutated the fleet, so
        even a failed re-swap leaves the incumbent serving)."""
        from shifu_tpu_torch import registry
        log.warning("refresh: swap of %s failed (%s) — rolling back HEAD "
                    "to %s", version, err, prev_head)
        registry.rollback(self.registry_root, self.model_name, to=prev_head)
        if self.fleet is not None:
            try:
                self.fleet.swap_in_place(self.model_name)
            except Exception as e:  # noqa: BLE001 — absorbed, see above
                log.warning("refresh: re-swap after rollback failed "
                            "(incumbent still resident): %s", e)

    # -- observability ------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {"runs": self.runs, "promoted": self.promoted,
                "held": self.held, "rolled_back": self.rolled_back,
                "coalesced": self.coalesced,
                "window_rows_pending": self._window_len,
                "last_outcome": self.last_outcome}
