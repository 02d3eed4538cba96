"""Shape-bucket padding and start-up warm-up for the serving plane —
counterpart of `shifu_tpu/serve/aot.py`.

Scoring rounds the row count up a small ladder
(``SHIFU_TPU_SERVE_BUCKETS``, default ``1,8,64,512``), so the kernels
see a fixed set of shapes. Padded rows REPEAT THE LAST REAL ROW rather
than zero-fill: a duplicated row can never move a batch-global min or
max (MAXMIN tree-score conversion), and every per-row model is
row-independent, so padding is invisible to the real rows.

On the card, `ServingGraphs` is the counterpart of the JAX package's
per-(model, bucket) AOT executables (`aot_compile`, `aot_selfcheck`):
one `torch.cuda.CUDAGraph` per (model, bucket) for the kinds the JAX
package compiles — nn/lr (K1 over the raw block with `norm`, then the
MLP's later layers; or the MLP over the dense block) and gbt/rf (the
transpose of the raw block and K2) — captured from static device input
buffers into static outputs (both allocated outside the graphs' memory
pool, which one service's graphs share), then checked on the warm batch
against the plain path (`selfcheck`, the tolerances of the chip smoke's
serving phase: 1e-5 NN, 1e-6 trees). A graph's kernel arguments,
weight and pack pointers included, are fixed at capture, so a hot swap
copies new params into the same storage (`weights.refresh_`). wdl, mtl
and the host-mapped categorical step of trees stay eager, as they stay
uncompiled in the JAX package. Each replay adds its graph's captured
kernels to their wrappers' `launches`.

`warm_scores` drives one padded batch per bucket through the real
scoring path of the models no graph scores (every model on the CPU;
wdl/mtl and the rest of the eager route on the card), and `selfcheck`
holds their served scores on the warm batch against the plain PyTorch
path; a captured graph is warmed by its capture and checked by
`ServingGraphs.selfcheck`.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from shifu_tpu_torch import _build
from shifu_tpu_torch.config import environment as env
from shifu_tpu_torch.ops import fused_score, fused_trees

DEFAULT_LADDER = (1, 8, 64, 512)


def bucket_ladder() -> Tuple[int, ...]:
    """Parse SHIFU_TPU_SERVE_BUCKETS → ascending unique positive ints;
    a malformed value falls back to the default ladder."""
    raw = env.knob_str("SHIFU_TPU_SERVE_BUCKETS")
    try:
        vals = sorted({int(tok) for tok in raw.split(",") if tok.strip()})
        if not vals or vals[0] <= 0:
            raise ValueError(raw)
        return tuple(vals)
    except ValueError:
        return DEFAULT_LADDER


def bucket_for(n: int, ladder: Optional[Tuple[int, ...]] = None) -> int:
    """Smallest bucket ≥ n; past the top rung, keep doubling the top
    bucket."""
    if n <= 0:
        raise ValueError(f"cannot bucket {n} rows")
    ladder = ladder or bucket_ladder()
    for b in ladder:
        if n <= b:
            return b
    b = ladder[-1]
    while b < n:
        b *= 2
    return b


def pad_rows(block: np.ndarray, bucket: int) -> np.ndarray:
    """Pad axis 0 to `bucket` rows by repeating the last row."""
    n = block.shape[0]
    if n == bucket:
        return block
    if n > bucket:
        raise ValueError(f"{n} rows exceed bucket {bucket}")
    reps = np.repeat(block[-1:], bucket - n, axis=0)
    return np.concatenate([np.asarray(block), reps], axis=0)


def pad_blocks(blocks: Dict[str, Optional[np.ndarray]],
               bucket: int) -> Dict[str, Optional[np.ndarray]]:
    return {k: (pad_rows(v, bucket) if v is not None else None)
            for k, v in blocks.items()}


def _slice_tree(out: Any, n: int) -> Any:
    if isinstance(out, dict):
        return {k: _slice_tree(v, n) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_slice_tree(v, n) for v in out)
    a = np.asarray(out)
    return a[:n] if a.ndim >= 1 else a


def padded_call(score_fn: Callable[..., Any], n: int,
                blocks: Dict[str, Optional[np.ndarray]],
                ladder: Optional[Tuple[int, ...]] = None,
                **kw: Any) -> Any:
    """Pad every row block up to `n`'s bucket, score through `score_fn`
    (row blocks as keyword args, plus passthrough kwargs like `norm`),
    and slice the result back to `n` rows."""
    bucket = bucket_for(n, ladder)
    out = score_fn(**pad_blocks(blocks, bucket), **kw)
    return _slice_tree(out, n)


def _score_kwargs(padded: Dict[str, Optional[np.ndarray]]) -> Dict:
    # tree-only blocks carry raw_dense but no dense; any row-aligned
    # block satisfies the positional dense argument
    return dict(dense=padded.get("dense", padded.get("raw_dense")),
                index=padded.get("index"),
                raw_dense=padded.get("raw_dense"),
                raw_codes=padded.get("raw_codes"))


def warm_scores(scorer: Any, proto: Dict[str, Optional[np.ndarray]],
                ladder: Tuple[int, ...],
                norm: Optional[Dict[str, Any]] = None,
                stage: Callable[[Dict], Dict] = lambda blocks: blocks,
                models: Optional[List[int]] = None) -> int:
    """One real scoring call per bucket with rows tiled from the
    prototype and passed through `stage` (the caller's h2d step), so
    kernels are built and loaded before traffic: `scorer.score`, or
    `score_matrix` of each model in `models` (indices). Returns the
    number of buckets warmed."""
    from shifu_tpu_torch.eval.scorer import score_matrix
    for bucket in ladder:
        kw = _score_kwargs(stage(pad_blocks(proto, bucket)))
        if models is None:
            scorer.score(**kw, norm=norm)
            continue
        for i in models:
            kind, meta, model = scorer.models[i]
            score_matrix(kind, meta, model, **kw, norm=norm)
    return len(ladder)


def plain_scores(kind: str, meta: Dict[str, Any], model: Any,
                 blocks: Dict[str, Optional[np.ndarray]],
                 norm: Optional[Dict[str, Any]] = None) -> np.ndarray:
    """One model's scores through the plain PyTorch path: the z-score
    then the MLP on the model's device for NN-family models, the
    per-level walk over `bin_dataset` bins on the host for trees."""
    from shifu_tpu_torch.eval.scorer import score_matrix
    from shifu_tpu_torch.models import gbdt
    from shifu_tpu_torch.ops import fused_trees
    from shifu_tpu_torch.ops.normalize import zscore
    kw = _score_kwargs(blocks)
    if kind in ("gbt", "rf"):
        cfg = model.cfg
        bins = gbdt.bin_dataset(model.tables, kw["raw_dense"],
                                kw["raw_codes"], cfg.n_bins)
        binsT = torch.as_tensor(np.ascontiguousarray(bins.T))
        with torch.inference_mode():
            per_tree = gbdt.predict_trees(model.trees, binsT,
                                          cfg.max_depth, cfg.n_bins)
            return fused_trees.convert(per_tree, kind, cfg.loss,
                                       cfg.learning_rate).numpy()
    dense = kw["dense"]
    raw = kw["raw_dense"]
    if norm is not None and raw is not None \
            and raw.shape[1] == model.spec.input_dim:
        dev = next(model.parameters()).device
        dense = zscore(torch.as_tensor(raw, dtype=torch.float32, device=dev),
                       torch.as_tensor(norm["mean"], dtype=torch.float32,
                                       device=dev),
                       torch.as_tensor(norm["std"], dtype=torch.float32,
                                       device=dev),
                       float(norm["cutoff"]))
    return score_matrix(kind, meta, model, dense, kw["index"])


# the serving tolerances (rtol, atol) a graph, or a served score, is held
# to against the plain path
TOLERANCES = {"nn": (1e-5, 1e-5), "lr": (1e-5, 1e-5), "gbt": (1e-6, 1e-6),
              "rf": (1e-6, 1e-6)}


def selfcheck(scorer: Any, proto: Dict[str, Optional[np.ndarray]],
              ladder: Tuple[int, ...],
              norm: Optional[Dict[str, Any]] = None,
              models: Optional[List[int]] = None) -> None:
    """At start, on the warm batch of the top bucket: each model's (or
    each of `models`') served scores (kernel route on a card) must
    agree with the plain path — the check the JAX package's
    `aot_selfcheck` made of its compiled executables."""
    from shifu_tpu_torch.eval.scorer import score_matrix
    blocks = pad_blocks(proto, ladder[-1])
    for i in (range(len(scorer.models)) if models is None else models):
        kind, meta, model = scorer.models[i]
        got = score_matrix(kind, meta, model, **_score_kwargs(blocks),
                           norm=norm).reshape(-1)
        want = plain_scores(kind, meta, model, blocks, norm).reshape(-1)
        if not np.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(
                f"model{i} ({kind}) served scores deviate from the plain "
                f"path on the warm batch: max |diff| "
                f"{float(np.max(np.abs(got - want))):.3g}")


# ---------------------------------------------------------------------------
# CUDA graphs per (model, bucket)
# ---------------------------------------------------------------------------

GRAPH_KINDS = ("nn", "lr", "gbt", "rf")
_COUNTERS = {"fused_score": fused_score, "fused_trees": fused_trees}

# captures of every service in the process run one at a time: entering
# `torch.cuda.graph` synchronizes the card and empties the cache, which
# must not meet another thread's capture; scoring threads are not held
_capture_lock = threading.Lock()


class _Route:
    """How a graph reads its model's inputs: the float blocks copied into
    static buffers (`keys`), the categorical block mapped on the host
    into a static (Cc, bucket) buffer (`cat_key`), and the body that
    scores them."""

    def __init__(self, keys: Tuple[str, ...], cat_key: Optional[str],
                 body: Callable[[Dict[str, torch.Tensor]], torch.Tensor]):
        self.keys = keys
        self.cat_key = cat_key
        self.body = body


def _graph_route(i: int, kind: str, meta: Dict[str, Any], model: Any,
                 proto: Dict[str, np.ndarray],
                 norm: Optional[Dict[str, Any]]) -> Optional[_Route]:
    """The route `score_matrix` takes for model i on blocks shaped like
    `proto`, as a graph body; None for a model that stays eager."""
    kw = _score_kwargs(proto)
    if kind in ("nn", "lr"):
        raw = kw["raw_dense"]
        if norm is not None and raw is not None \
                and raw.shape[1] == model.spec.input_dim:
            def nn_raw(s, _m=model):
                return fused_score.score_nn(
                    _m, s["raw_dense"], norm["mean"], norm["std"],
                    float(norm["cutoff"]), norm.get("packed"))
            return _Route(("raw_dense",), None, nn_raw)
        key = "dense" if "dense" in proto else "raw_dense"
        if key not in proto or kw["dense"].ndim != 2 \
                or kw["dense"].shape[1] != model.spec.input_dim:
            return None
        return _Route((key,), None, lambda s, _m=model, _k=key: _m(s[_k]))
    if kind in ("gbt", "rf"):
        rd = kw["raw_dense"] if kw["raw_dense"] is not None else kw["dense"]
        rc = kw["raw_codes"] if kw["raw_codes"] is not None else kw["index"]
        n_num = rd.shape[1] if rd is not None else 0
        n_cat = rc.shape[1] if rc is not None else 0
        if (n_num, n_cat) != (model.n_num, model.n_cat) or n_num + n_cat == 0:
            return None
        key = "raw_dense" if kw["raw_dense"] is not None else "dense"
        cat_key = f"cat{i}" if n_cat else None

        def trees(s, _m=model):
            parts = ([s[key].T] if n_num else []) + \
                ([s[cat_key]] if n_cat else [])
            valuesT = torch.cat(parts).contiguous()
            return fused_trees.predict_ensemble(
                _m.nodes, valuesT, _m.cuts, **_m.statics,
                node_pack=_m.node_pack)
        return _Route((key,) if n_num else (), cat_key, trees)
    return None


class BucketGraph:
    """One captured graph: model `index`'s scores at `bucket` rows into
    the static `out`; `kernels` counts the K1/K2 launches it holds."""

    def __init__(self, index: int, bucket: int, graph: "torch.cuda.CUDAGraph",
                 out: torch.Tensor, kernels: Dict[str, int]):
        self.index = index
        self.bucket = bucket
        self.graph = graph
        self.out = out
        self.kernels = kernels

    def replay(self) -> None:
        self.graph.replay()
        for name, k in self.kernels.items():
            _COUNTERS[name].launches += k


class ServingGraphs:
    """The graphs of one service on one card, one per (model, bucket)
    of `GRAPH_KINDS` whose route the prototype request fixes, sharing
    one memory pool. Not thread-safe: the service calls it from its
    batcher thread, or under the lock that thread holds for a batch."""

    def __init__(self, scorer: Any, proto: Dict[str, np.ndarray],
                 ladder: Tuple[int, ...],
                 norm: Optional[Dict[str, Any]] = None):
        self.device = scorer.device
        if self.device.type != "cuda":
            raise ValueError("CUDA graphs need a card")
        self.ladder = tuple(ladder)
        self.proto = proto
        self.norm = norm
        self.routes: Dict[int, _Route] = {}
        for i, (kind, meta, model) in enumerate(scorer.models):
            route = _graph_route(i, kind, meta, model, proto, norm)
            if route is not None:
                self.routes[i] = route
        self.models = scorer.models
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        # bucket → static input buffers; (model, bucket) → graph
        self.inputs: Dict[int, Dict[str, torch.Tensor]] = {}
        self.graphs: Dict[Tuple[int, int], BucketGraph] = {}
        self.captures = 0
        # (name, shape) → pinned host staging buffer
        self._pinned: Dict[Tuple[str, Tuple[int, ...]], torch.Tensor] = {}

    # -- capture -------------------------------------------------------
    def capture_all(self) -> int:
        """Capture every (model, bucket) graph of the ladder from the
        prototype tiled to each bucket; returns the graphs captured. A
        capture that fails raises."""
        for bucket in self.ladder:
            padded = pad_blocks(self.proto, bucket)
            self._alloc_inputs(bucket, padded)
            self.load(bucket, padded)
            for i in self.routes:
                self._capture(i, bucket)
        return len(self.graphs)

    def _alloc_inputs(self, bucket: int, padded: Dict[str, np.ndarray]
                      ) -> None:
        if bucket in self.inputs:
            return
        bufs: Dict[str, torch.Tensor] = {}
        for i, route in self.routes.items():
            for k in route.keys:
                if k not in bufs:
                    bufs[k] = torch.empty(padded[k].shape,
                                          dtype=torch.float32,
                                          device=self.device)
            if route.cat_key is not None:
                model = self.models[i][2]
                bufs[route.cat_key] = torch.empty(
                    (model.n_cat, bucket), dtype=torch.float32,
                    device=self.device)
        self.inputs[bucket] = bufs

    def _capture(self, i: int, bucket: int) -> None:
        route = self.routes[i]
        statics = self.inputs[bucket]
        cur = torch.cuda.current_stream(self.device)
        with _capture_lock:
            # the eager warm-up on the capture stream fills the kernel
            # wrappers' launch caches and cuBLAS's workspace there, so
            # the captured region makes no host call but the launches
            self.stream.wait_stream(cur)
            with torch.no_grad(), torch.cuda.stream(self.stream):
                warm = route.body(statics)
            out = torch.empty(warm.shape, dtype=warm.dtype,
                              device=self.device)
            graph = torch.cuda.CUDAGraph()
            with torch.no_grad(), _build.capturing() as counts, \
                    torch.cuda.graph(graph, pool=self.pool,
                                     stream=self.stream,
                                     capture_error_mode="thread_local"):
                out.copy_(route.body(statics))
            cur.wait_stream(self.stream)
        self.graphs[(i, bucket)] = BucketGraph(i, bucket, graph, out,
                                               dict(counts))
        self.captures += 1

    # -- request path --------------------------------------------------
    def covers(self, bucket: int) -> bool:
        return bucket in self.inputs

    def _host(self, name: str, shape: Tuple[int, ...]) -> torch.Tensor:
        buf = self._pinned.get((name, shape))
        if buf is None:
            buf = torch.empty(shape, dtype=torch.float32, pin_memory=True)
            self._pinned[(name, shape)] = buf
        return buf

    def load(self, bucket: int, padded: Dict[str, np.ndarray]) -> None:
        """The h2d stage: each static input of `bucket` filled from the
        padded blocks through a pinned host buffer, on the current
        stream (the categorical rows mapped on the host first)."""
        from shifu_tpu_torch.models import gbdt
        statics = self.inputs[bucket]
        kw = _score_kwargs(padded)
        for i, route in self.routes.items():
            if route.cat_key is not None:
                model = self.models[i][2]
                rc = kw["raw_codes"] if kw["raw_codes"] is not None \
                    else kw["index"]
                self._put(route.cat_key, statics[route.cat_key],
                          gbdt.cat_values(model.tables, rc,
                                          model.cfg.n_bins))
        for k in {k for r in self.routes.values() for k in r.keys}:
            self._put(k, statics[k], np.asarray(padded[k], np.float32))

    def _put(self, name: str, dst: torch.Tensor, src: np.ndarray) -> None:
        host = self._host(name, tuple(src.shape))
        host.numpy()[...] = src
        dst.copy_(host, non_blocking=True)

    def run(self, bucket: int) -> Dict[int, np.ndarray]:
        """Replay every model's graph of `bucket` on the current stream,
        copy the outputs out through pinned buffers and wait for them:
        model index → (bucket,) scores (owned copies)."""
        stream = torch.cuda.current_stream(self.device)
        hosts = {}
        for i in self.routes:
            g = self.graphs[(i, bucket)]
            g.replay()
            host = self._host(f"out{i}", tuple(g.out.shape))
            host.copy_(g.out, non_blocking=True)
            hosts[i] = host
        stream.synchronize()
        return {i: h.numpy().copy() for i, h in hosts.items()}

    def selfcheck(self, models: Optional[List[Tuple[str, Dict, Any]]] = None
                  ) -> None:
        """Every graph on the warm batch (the prototype tiled to its
        bucket) against the plain path of `models` (default the
        captured ones; a hot swap passes the challenger's, so the check
        is 'the live graphs score the new params as a cold start
        would'), within `TOLERANCES`."""
        models = models or self.models
        for bucket in self.ladder:
            padded = pad_blocks(self.proto, bucket)
            self.load(bucket, padded)
            got = self.run(bucket)
            for i in self.routes:
                kind, meta, model = models[i]
                want = plain_scores(kind, meta, model, padded,
                                    self.norm).reshape(-1)
                g = got[i].reshape(-1)
                rtol, atol = TOLERANCES[kind]
                if not np.allclose(g, want, rtol=rtol, atol=atol):
                    raise AssertionError(
                        f"model{i} ({kind}) graph at bucket {bucket} "
                        "deviates from the plain path on the warm batch: "
                        f"max |diff| {float(np.max(np.abs(g - want))):.3g}")

    def close(self) -> None:
        """Drop every graph and static buffer, returning the pool."""
        torch.cuda.current_stream(self.device).synchronize()
        self.graphs.clear()
        self.inputs.clear()
        self._pinned.clear()
        self.pool = None
