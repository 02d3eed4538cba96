"""Persistent scorer service: warmed, micro-batched, in-process —
counterpart of `shifu_tpu/serve/service.py`.

`ScorerService` owns one `eval.scorer.Scorer` ensemble on `device`
(default the card; raises when there is none) and a `MicroBatcher`.
Every micro-batch is padded up the shape-bucket ladder. On the card,
`start` captures one CUDA graph per (model, bucket) for the nn/lr and
gbt/rf models (`aot.ServingGraphs`, the counterpart of the JAX
package's AOT executables) and checks each on the warm batch; a batch
then copies its padded blocks into the bucket's static inputs, replays
the graphs and copies the scores out. The models no graph scores
(wdl/mtl) are warmed and checked eagerly at `start` and score through
`score_matrix`, the path batch scoring uses. On the CPU every batch
takes `Scorer.score`.

Per-request latency splits into queue / pad / h2d / device / d2h: queue
is measured by the batcher, pad is host-side batch assembly, h2d copies
the padded blocks the card reads through pinned host buffers, one per
(bucket, block) and kept for the service's life (the graphs' static
inputs, then the blocks the eager models read; synchronized on the
current stream), device is the replays with the copy of the scores back
(and the eager models' `score_matrix` calls), and d2h is the
per-request slicing of the result. On the CPU the h2d stage is empty.
The splits also accrue to the ``serve_{pad,h2d,device,d2h}_s`` stage
timers (``serve_warm_s`` at warm-up), and under a trace run each
request leaves a ``serve.request`` span with ``serve.queue``/``pad``/
``h2d``/``device``/``d2h`` children cut from the same timestamps as
its `timing` splits, on both routes; none of them synchronizes the
card beyond what the route already does.

`swap_params` hot-swaps a same-shaped ensemble into the running service
(the JAX package's structural gate, an in-place copy into the storage
the graphs read, a self-check through the live graphs, the incumbent
restored on a failed check), serialized with the batcher thread so a
batch reads wholly old or wholly new params. With a `workspace_root`
and SHIFU_TPU_METRICS=1 a flusher thread writes `stats()` into the
workspace's metrics store every SHIFU_TPU_METRICS_FLUSH_S seconds, and
`health_state` answers `/healthz` with the workspace's SLO state.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from shifu_tpu_torch import weights
from shifu_tpu_torch.config import environment as env
from shifu_tpu_torch.data import pipeline
from shifu_tpu_torch.eval.scorer import Scorer, score_matrix
from shifu_tpu_torch.obs import trace as obs_trace
from shifu_tpu_torch.ops import fused_score
from shifu_tpu_torch.resilience import make_lock
from shifu_tpu_torch.serve import aot
from shifu_tpu_torch.serve.batcher import MicroBatcher, Request

log = logging.getLogger("shifu_tpu_torch")


class ScorerService:
    """In-process serving front end; `submit` is thread-safe."""

    def __init__(self, models_dir: Optional[str] = None,
                 model_paths: Optional[List[str]] = None,
                 score_selector: str = "mean",
                 gbt_convert: str = "RAW",
                 norm: Optional[Dict[str, Any]] = None,
                 ladder: Optional[Tuple[int, ...]] = None,
                 max_delay: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 device: "str | torch.device" = "cuda",
                 graphs: bool = True,
                 workspace_root: Optional[str] = None,
                 priority: str = "high",
                 metrics_tags: Optional[Dict[str, str]] = None):
        if priority not in ("high", "low"):
            raise ValueError(
                f"priority must be high|low, got {priority!r}")
        self.priority = priority
        self._score_selector = score_selector
        self._gbt_convert = gbt_convert
        # fleet mode labels this service's metric points (model=...)
        self._metrics_tags = dict(metrics_tags or {})
        self._workspace_root = workspace_root
        if models_dir is not None:
            self.scorer = Scorer.from_dir(models_dir, model_paths,
                                          score_selector=score_selector,
                                          gbt_convert=gbt_convert,
                                          device=device)
        else:
            self.scorer = Scorer(model_paths or [],
                                 score_selector=score_selector,
                                 gbt_convert=gbt_convert, device=device)
        self.device = self.scorer.device
        self.norm = None
        if norm is not None:
            mean = torch.as_tensor(norm["mean"], dtype=torch.float32,
                                   device=self.device)
            std = torch.as_tensor(norm["std"], dtype=torch.float32,
                                  device=self.device)
            cutoff = float(norm["cutoff"])
            # on the device once, and packed once for the K1 kernel
            self.norm = {"mean": mean, "std": std, "cutoff": cutoff,
                         "packed": fused_score.pack_norm(mean, std, cutoff)}
        self.ladder = tuple(ladder) if ladder else aot.bucket_ladder()
        self._graphs_enabled = graphs and self.device.type == "cuda"
        self._graphs: Optional[aot.ServingGraphs] = None
        self._proto: Optional[Dict[str, np.ndarray]] = None
        self.swaps = 0
        # the batcher calls back through a weak reference, so a dropped
        # service (a fleet eviction) frees its models and graphs at once
        # rather than at the next garbage collection
        score_batch = weakref.WeakMethod(self._score_batch)
        self._batcher = MicroBatcher(lambda batch: score_batch()(batch),
                                     max_rows=self.ladder[-1],
                                     max_delay=max_delay,
                                     depth=queue_depth)
        self._schema: Optional[frozenset] = None
        self._schema_lock = make_lock("service.schema")
        # held by the batcher thread for a whole batch and by a swap
        self._device_lock = make_lock("service.device")
        self._started = False
        self._warm_s = 0.0
        self._warmed_buckets = 0
        # consumer-thread-appended; stats() reads racily (monitoring)
        self._latencies: collections.deque = collections.deque(maxlen=8192)
        # 429s by the rejected request's priority class (the fleet's
        # admission shed bumps "low" here too via note_rejected)
        self.rejected_by_class: Dict[str, int] = {"high": 0, "low": 0}
        # (block, padded shape) → pinned host staging buffer of the
        # eager card route; filled by the warm-up, then read and written
        # by the batcher thread only
        self._pinned: Dict[Tuple[str, Tuple[int, ...]], torch.Tensor] = {}
        self._flush_stop = threading.Event()
        self._flush_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------
    def start(self, proto: Optional[Dict[str, np.ndarray]] = None
              ) -> "ScorerService":
        """Warm every shape bucket, then open the admission queue. On
        the card this captures and checks the graphs; every model's
        eager route is warmed and checked against the plain path as
        well. `proto` is one representative request (row blocks);
        without one, an all-NN ensemble warms from a zeros row and
        anything else warms on its first batch."""
        if self._started:
            return self
        if proto is None:
            proto = self._default_proto()
        if proto:
            self._warm(proto)
        self._batcher.start()
        self._started = True
        self._start_metrics_flusher()
        return self

    def _warm(self, proto: Dict[str, np.ndarray]) -> None:
        t0 = time.monotonic()
        proto = {k: np.asarray(v) for k, v in proto.items()
                 if v is not None}
        with self._schema_lock:
            if self._schema is None:
                self._schema = frozenset(proto)
        self._proto = proto
        graphs = None
        if self._graphs_enabled:
            # the capture warms each body and the graph check covers it
            graphs = aot.ServingGraphs(self.scorer, proto, self.ladder,
                                       norm=self.norm)
            graphs.capture_all()
            graphs.selfcheck()
        eager = self._eager(graphs)
        if eager:
            # through the request path's own h2d staging, so the pinned
            # host buffer of every bucket and block is allocated before
            # traffic
            aot.warm_scores(self.scorer, proto, self.ladder,
                            norm=self.norm,
                            stage=lambda b: self._stage(b, eager),
                            models=eager)
            aot.selfcheck(self.scorer, proto, self.ladder, norm=self.norm,
                          models=eager)
        self._graphs = graphs
        self._warmed_buckets = len(self.ladder)
        self._warm_s = time.monotonic() - t0
        pipeline.add_stage_time("serve_warm_s", self._warm_s)

    def _eager(self, graphs: Optional[aot.ServingGraphs]) -> List[int]:
        """The models no graph scores, by index."""
        return [i for i in range(len(self.scorer.models))
                if graphs is None or i not in graphs.routes]

    def close(self) -> None:
        self._flush_stop.set()
        if self._flush_thread is not None:
            self._flush_thread.join(timeout=5.0)
            self._flush_thread = None
        self._flush_metrics()   # final snapshot before teardown
        self._batcher.close()
        self._started = False
        with self._device_lock:
            if self._graphs is not None:
                self._graphs.close()
                self._graphs = None

    def __enter__(self) -> "ScorerService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _default_proto(self) -> Optional[Dict[str, np.ndarray]]:
        for kind, meta, _ in self.scorer.models:
            if kind in ("nn", "lr", "mtl"):
                dim = int(meta["spec"]["input_dim"])
                return {"dense": np.zeros((1, dim), np.float32)}
            if kind == "wdl":
                spec = meta["spec"]
                proto = {"dense": np.zeros((1, int(spec["dense_dim"])),
                                           np.float32)}
                if int(spec["n_cat"]):
                    proto["index"] = np.zeros((1, int(spec["n_cat"])),
                                              np.int32)
                return proto
        return None

    # -- request path --------------------------------------------------
    def submit_async(self, dense: Optional[np.ndarray] = None,
                     index: Optional[np.ndarray] = None,
                     raw_dense: Optional[np.ndarray] = None,
                     raw_codes: Optional[np.ndarray] = None) -> Request:
        blocks = {"dense": dense, "index": index,
                  "raw_dense": raw_dense, "raw_codes": raw_codes}
        blocks = {k: np.asarray(v) for k, v in blocks.items()
                  if v is not None}
        if not blocks:
            raise ValueError("request carries no feature blocks")
        schema = frozenset(blocks)
        with self._schema_lock:
            if self._schema is None:
                self._schema = schema
            elif schema != self._schema:
                raise ValueError(
                    f"request blocks {sorted(schema)} do not match the "
                    f"service schema {sorted(self._schema)}")
        n = next(iter(blocks.values())).shape[0]
        if any(v.shape[0] != n for v in blocks.values()):
            raise ValueError("feature blocks disagree on row count")
        try:
            return self._batcher.submit(blocks, n)
        except queue.Full:
            self.note_rejected()   # the 429 the front end answers with
            raise

    def note_rejected(self, priority: Optional[str] = None) -> None:
        """Count one 429 against a priority class (default: this
        service's own class)."""
        with self._schema_lock:
            self.rejected_by_class[priority or self.priority] += 1

    @property
    def _rejected(self) -> int:
        return sum(self.rejected_by_class.values())

    def submit(self, dense: Optional[np.ndarray] = None,
               index: Optional[np.ndarray] = None,
               raw_dense: Optional[np.ndarray] = None,
               raw_codes: Optional[np.ndarray] = None,
               timeout: Optional[float] = 30.0) -> Dict[str, np.ndarray]:
        """Score one request (blocking) → the `Scorer.score` dict sliced
        to this request's rows."""
        return self.submit_async(dense, index, raw_dense,
                                 raw_codes).wait(timeout)

    def submit_timed(self, timeout: Optional[float] = 30.0, **blocks
                     ) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
        req = self.submit_async(**blocks)
        return req.wait(timeout), dict(req.timing)

    # -- hot refresh ---------------------------------------------------
    def swap_params(self, models_dir: str,
                    model_paths: Optional[List[str]] = None) -> bool:
        """In-place hot swap: load the challenger ensemble from
        `models_dir` and copy its params into the storage the live
        graphs read — no recapture, no restart, no dropped request.

        Structural gate first: same model count, same kinds, same
        NN-family spec, and per-model param trees with identical
        structure, leaf shapes and dtypes, and for a graphed tree
        ensemble the statics its graphs bake in. Any mismatch returns
        False and mutates NOTHING. A candidate that passes is copied into
        the graphed models' tensors and packs (`weights.refresh_`), then
        the live graphs are checked on the warm batch against the plain
        path of the challenger's own params (what a cold start would
        score); a failed copy or check restores the incumbent and
        raises. The whole swap holds the lock the batcher thread holds
        for a batch, so a batch reads wholly old or wholly new params."""
        challenger = Scorer.from_dir(models_dir, model_paths,
                                     score_selector=self._score_selector,
                                     gbt_convert=self._gbt_convert,
                                     device=self.device)
        old, new = self.scorer.models, challenger.models
        if not _same_structure(old, new):
            return False
        with self._device_lock:
            graphs = self._graphs
            graphed = set(graphs.routes) if graphs is not None else set()
            # a graph bakes in a tree ensemble's depth, bins, loss and
            # rate: a challenger that differs there cannot be copied in
            if any(getattr(old[i][2], "statics", None)
                   != getattr(new[i][2], "statics", None)
                   for i in graphed):
                return False
            incumbents = {i: weights.to_torch(old[i][0], old[i][1],
                                              weights.from_torch(old[i][2]),
                                              self.device)
                          for i in graphed}
            try:
                for i in graphed:
                    weights.refresh_(old[i][2], new[i][2])
                if graphs is not None:
                    graphs.selfcheck(models=new)
            except BaseException:
                for i, snap in incumbents.items():
                    weights.refresh_(old[i][2], snap)
                raise
            self.scorer.models = [
                (kind, meta, old[i][2] if i in graphed else model)
                for i, (kind, meta, model) in enumerate(new)]
            if graphs is not None:
                graphs.models = self.scorer.models
            self.swaps += 1
        return True

    # -- device consumer (batcher thread) ------------------------------
    def _device_keys(self, keys, models: List[int]) -> Set[str]:
        """The float blocks one of `models` reads on the device."""
        out = set()
        for i in models:
            kind = self.scorer.models[i][0]
            if "raw_dense" in keys and (kind in ("gbt", "rf")
                                        or self.norm is not None):
                out.add("raw_dense")
            elif "dense" in keys:
                out.add("dense")
        return out

    def _stage(self, padded: Dict[str, Any],
               models: List[int]) -> Dict[str, Any]:
        """The h2d stage of the eager route: the float blocks one of
        `models` reads on the card, copied through this bucket's pinned
        host buffer, then the current stream synchronized (so the
        buffers, and the graphs' static inputs loaded before, are free
        for the next batch). A no-op on the CPU."""
        if self.device.type != "cuda":
            return padded
        out = dict(padded)
        for k in self._device_keys(padded, models):
            src = np.asarray(padded[k], np.float32)
            host = self._pinned.get((k, src.shape))
            if host is None:
                host = torch.empty(src.shape, dtype=torch.float32,
                                   pin_memory=True)
                self._pinned[(k, src.shape)] = host
            host.numpy()[...] = src
            out[k] = host.to(self.device, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return out

    def _score_batch(self, batch: List[Request]) -> None:
        t0 = time.monotonic()
        n = sum(r.n for r in batch)
        keys = sorted(batch[0].blocks)
        concat = {k: (batch[0].blocks[k] if len(batch) == 1
                      else np.concatenate([r.blocks[k] for r in batch]))
                  for k in keys}
        with self._device_lock:
            if self._proto is None:
                # no prototype at start: the first batch warms (and, on
                # the card, captures) every bucket
                self._warm({k: v[:1] for k, v in concat.items()})
            bucket = aot.bucket_for(n, self.ladder)
            padded = aot.pad_blocks(concat, bucket)
            t_pad = time.monotonic()
            graphs = self._graphs
            if graphs is not None and graphs.covers(bucket):
                graphs.load(bucket, padded)
                eager = self._eager(graphs)
                kw = aot._score_kwargs(self._stage(padded, eager))
                t_h2d = time.monotonic()
                scores = graphs.run(bucket)
                per_model = [
                    scores[i] if i in scores else
                    score_matrix(kind, meta, model, **kw, norm=self.norm)
                    for i, (kind, meta, model)
                    in enumerate(self.scorer.models)]
                out = self.scorer.combine(per_model)
            else:
                padded = self._stage(padded, self._eager(None))
                t_h2d = time.monotonic()
                out = self.scorer.score(**aot._score_kwargs(padded),
                                        norm=self.norm)
            t_dev = time.monotonic()

        off, t_prev = 0, t_dev
        for r in batch:
            r.timing.update(pad_s=t_pad - t0, h2d_s=t_h2d - t_pad,
                            device_s=t_dev - t_h2d)
            sliced = {k: np.ascontiguousarray(v[off:off + r.n])
                      for k, v in out.items()}
            off += r.n
            t_done = time.monotonic()
            r.timing["d2h_s"] = t_done - t_prev
            r.timing["total_s"] = t_done - r.t_submit
            self._latencies.append(r.timing["total_s"])
            if obs_trace.active():
                # one span a request, children cut from the exact
                # timestamps the timing splits are computed from
                rid = obs_trace.record_span(
                    "serve.request", r.t_submit, t_done,
                    track="serve", rows=r.n)
                obs_trace.record_span("serve.queue", r.t_submit,
                                      r.t_batched, parent=rid,
                                      track="serve")
                obs_trace.record_span("serve.pad", t0, t_pad,
                                      parent=rid, track="serve")
                obs_trace.record_span("serve.h2d", t_pad, t_h2d,
                                      parent=rid, track="serve")
                obs_trace.record_span("serve.device", t_h2d, t_dev,
                                      parent=rid, track="serve")
                obs_trace.record_span("serve.d2h", t_prev, t_done,
                                      parent=rid, track="serve")
            t_prev = t_done
            r.resolve(sliced)
        t_d2h = time.monotonic()

        pipeline.add_stage_time("serve_pad_s", t_pad - t0)
        pipeline.add_stage_time("serve_h2d_s", t_h2d - t_pad)
        pipeline.add_stage_time("serve_device_s", t_dev - t_h2d)
        pipeline.add_stage_time("serve_d2h_s", t_d2h - t_dev)

    # -- monitoring ----------------------------------------------------
    @property
    def graph_captures(self) -> int:
        """CUDA graphs captured over the service's life: one per (model,
        bucket) at warm-up, and no more under steady traffic."""
        g = self._graphs
        return g.captures if g is not None else 0

    def stats(self) -> Dict[str, Any]:
        lat = np.asarray(self._latencies, np.float64)
        pct = {}
        if lat.size:
            p50, p95, p99 = np.percentile(lat, [50, 95, 99])
            pct = {"p50_ms": p50 * 1e3, "p95_ms": p95 * 1e3,
                   "p99_ms": p99 * 1e3}
        g = self._graphs
        return {
            "models": [kind for kind, _, _ in self.scorer.models],
            "device": str(self.device),
            "ladder": list(self.ladder),
            "priority": self.priority,
            "warm_s": self._warm_s,
            "warmed_buckets": self._warmed_buckets,
            "graphs": len(g.graphs) if g is not None else 0,
            "graph_captures": self.graph_captures,
            "swaps": self.swaps,
            "rejected": self._rejected,
            "rejected_by_class": dict(self.rejected_by_class),
            "latency": pct,
            "batcher": self._batcher.stats(),
        }

    # -- health plane --------------------------------------------------
    def _start_metrics_flusher(self) -> None:
        """Background thread: snapshot stats() into the persistent
        metrics store every SHIFU_TPU_METRICS_FLUSH_S seconds. No-op
        unless SHIFU_TPU_METRICS=1 and the service knows its
        workspace."""
        from shifu_tpu_torch.obs.health import store as health_store
        if self._workspace_root is None or \
                not health_store.metrics_enabled() or \
                self._flush_thread is not None:
            return
        period = float(env.knob_float("SHIFU_TPU_METRICS_FLUSH_S"))
        self._flush_stop.clear()

        def loop() -> None:
            while not self._flush_stop.wait(period):
                self._flush_metrics()

        self._flush_thread = threading.Thread(
            target=loop, name="serve-metrics-flush", daemon=True)
        self._flush_thread.start()

    def _flush_metrics(self) -> None:
        """One stats() snapshot → serve.* gauges; absorbed — a metrics
        failure can never degrade serving."""
        try:
            from shifu_tpu_torch.obs.health import store as health_store
            if self._workspace_root is None or \
                    not health_store.metrics_enabled():
                return
            st = health_store.store(self._workspace_root)
            snap = self.stats()
            tags = self._metrics_tags
            for k, v in snap["latency"].items():
                st.emit(f"serve.{k}", round(float(v), 4), **tags)
            b = snap["batcher"]
            for k in ("requests", "batches", "rows", "queued_now",
                      "occupancy_mean", "rows_per_batch"):
                if isinstance(b.get(k), (int, float)):
                    st.emit(f"serve.{k}", b[k], **tags)
            st.emit("serve.rejected", self._rejected, kind="counter",
                    **tags)
            for cls, n in self.rejected_by_class.items():
                st.emit("serve.rejected_by_class", n, kind="counter",
                        priority=cls, **tags)
            admitted = b.get("requests", 0) or 0
            denom = admitted + self._rejected
            st.emit("serve.reject_rate",
                    round(self._rejected / denom, 6) if denom else 0.0,
                    **tags)
            st.flush()
        except Exception as e:  # noqa: BLE001 — absorbed by design
            log.warning("serve metrics flush failed (absorbed): %s", e)

    def health_state(self) -> Optional[Dict[str, Any]]:
        """The workspace's SLO state (obs.health.slo.health_state), or
        None when the service has no workspace or the read fails —
        /healthz stays a liveness check either way."""
        if self._workspace_root is None:
            return None
        try:
            from shifu_tpu_torch.obs.health import slo as slo_mod
            return slo_mod.health_state(self._workspace_root)
        except Exception:  # noqa: BLE001 — liveness must not break
            return None


def _same_structure(old, new) -> bool:
    """The JAX package's swap gate: same model count and kinds, same
    NN-family spec, and per-model param trees of one structure with
    equal leaf shapes and dtypes."""
    if len(old) != len(new):
        return False
    for (ok_, om, op), (nk, nm, np_) in zip(old, new):
        if ok_ != nk:
            return False
        if ok_ in ("nn", "lr") and om.get("spec") != nm.get("spec"):
            return False
        try:
            ol = weights.leaves(weights.from_torch(op))
            nl = weights.leaves(weights.from_torch(np_))
        except TypeError:
            return False
        if [p for p, _ in ol] != [p for p, _ in nl]:
            return False
        for (_, a), (_, b) in zip(ol, nl):
            if a.shape != b.shape or a.dtype != b.dtype:
                return False
    return True
