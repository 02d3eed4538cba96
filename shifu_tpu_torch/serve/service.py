"""Persistent scorer service: warmed, micro-batched, in-process —
counterpart of `shifu_tpu/serve/service.py`.

`ScorerService` owns one `eval.scorer.Scorer` ensemble on `device`
(default the card; raises when there is none) and a `MicroBatcher`.
Every micro-batch is padded up the shape-bucket ladder and scored
through `Scorer.score` → `score_matrix`, the path batch scoring uses,
so the fused kernels serve it.

Per-request latency splits into queue / pad / h2d / device / d2h: queue
is measured by the batcher, pad is host-side batch assembly, h2d copies
the padded feature blocks the models read on the card through pinned
host buffers, one per (bucket, block) and kept for the service's life
(``.to(device, non_blocking=True)`` then a synchronize of the current
stream), device
is the `Scorer.score` call (kernels, the later layers, and the copy of
the per-model scores back), and d2h is the per-request slicing of the
result. On the CPU the h2d stage is empty.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from shifu_tpu_torch.eval.scorer import Scorer
from shifu_tpu_torch.ops import fused_score
from shifu_tpu_torch.serve import aot
from shifu_tpu_torch.serve.batcher import MicroBatcher, Request


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
                 device: "str | torch.device" = "cuda"):
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
        self._batcher = MicroBatcher(self._score_batch,
                                     max_rows=self.ladder[-1],
                                     max_delay=max_delay,
                                     depth=queue_depth)
        self._schema: Optional[frozenset] = None
        self._schema_lock = threading.Lock()
        self._started = False
        self._warm_s = 0.0
        self._warmed_buckets = 0
        # consumer-thread-appended; stats() reads racily (monitoring)
        self._latencies: collections.deque = collections.deque(maxlen=8192)
        self._rejected = 0
        # (block, padded shape) → pinned host staging buffer; filled by
        # the warm-up, then read and written by the batcher thread only
        self._pinned: Dict[Tuple[str, Tuple[int, ...]], torch.Tensor] = {}

    # -- lifecycle -----------------------------------------------------
    def start(self, proto: Optional[Dict[str, np.ndarray]] = None
              ) -> "ScorerService":
        """Warm every shape bucket, check each model's served scores on
        the warm batch against the plain path, then open the admission
        queue. `proto` is one representative request (row blocks);
        without one, an all-NN ensemble warms from a zeros row and
        anything else warms on first traffic."""
        if self._started:
            return self
        if proto is None:
            proto = self._default_proto()
        if proto:
            t0 = time.monotonic()
            proto = {k: np.asarray(v) for k, v in proto.items()
                     if v is not None}
            self._schema = frozenset(proto)
            # through the request path's own h2d staging, so the pinned
            # host buffer of every bucket and block is allocated before
            # traffic
            self._warmed_buckets = aot.warm_scores(
                self.scorer, proto, self.ladder, norm=self.norm,
                stage=self._stage)
            aot.selfcheck(self.scorer, proto, self.ladder, norm=self.norm)
            self._warm_s = time.monotonic() - t0
        self._batcher.start()
        self._started = True
        return self

    def close(self) -> None:
        self._batcher.close()
        self._started = False

    def __enter__(self) -> "ScorerService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _default_proto(self) -> Optional[Dict[str, np.ndarray]]:
        for kind, meta, _ in self.scorer.models:
            if kind in ("nn", "lr"):
                dim = int(meta["spec"]["input_dim"])
                return {"dense": np.zeros((1, dim), np.float32)}
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
            with self._schema_lock:
                self._rejected += 1   # the 429 the front end answers
            raise

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

    # -- device consumer (batcher thread) ------------------------------
    def _device_keys(self, keys) -> Set[str]:
        """The float blocks some model reads on the device."""
        out = set()
        for kind, _, _ in self.scorer.models:
            if "raw_dense" in keys and (kind in ("gbt", "rf")
                                        or self.norm is not None):
                out.add("raw_dense")
            elif "dense" in keys:
                out.add("dense")
        return out

    def _stage(self, padded: Dict[str, Any]) -> Dict[str, Any]:
        """The h2d stage: the float blocks some model reads on the card,
        copied through this bucket's pinned host buffer and synchronized
        on the current stream (so the buffer is free for the next batch).
        A no-op on the CPU."""
        if self.device.type != "cuda":
            return padded
        out = dict(padded)
        for k in self._device_keys(padded):
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
        bucket = aot.bucket_for(n, self.ladder)
        padded = aot.pad_blocks(concat, bucket)
        t_pad = time.monotonic()
        padded = self._stage(padded)
        t_h2d = time.monotonic()

        out = self.scorer.score(
            dense=padded.get("dense", padded.get("raw_dense")),
            index=padded.get("index"),
            raw_dense=padded.get("raw_dense"),
            raw_codes=padded.get("raw_codes"),
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
            t_prev = t_done
            r.resolve(sliced)

    # -- monitoring ----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        lat = np.asarray(self._latencies, np.float64)
        pct = {}
        if lat.size:
            p50, p95, p99 = np.percentile(lat, [50, 95, 99])
            pct = {"p50_ms": p50 * 1e3, "p95_ms": p95 * 1e3,
                   "p99_ms": p99 * 1e3}
        return {
            "models": [kind for kind, _, _ in self.scorer.models],
            "device": str(self.device),
            "ladder": list(self.ladder),
            "warm_s": self._warm_s,
            "warmed_buckets": self._warmed_buckets,
            "rejected": self._rejected,
            "latency": pct,
            "batcher": self._batcher.stats(),
        }
