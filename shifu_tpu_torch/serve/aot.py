"""Shape-bucket padding and start-up warm-up for the serving plane —
counterpart of `shifu_tpu/serve/aot.py`.

Scoring rounds the row count up a small ladder
(``SHIFU_TPU_SERVE_BUCKETS``, default ``1,8,64,512``), so the kernels
see a fixed set of shapes. Padded rows REPEAT THE LAST REAL ROW rather
than zero-fill: a duplicated row can never move a batch-global min or
max (MAXMIN tree-score conversion), and every per-row model is
row-independent, so padding is invisible to the real rows.

PyTorch runs eagerly, so the JAX package's per-bucket AOT executables
have no counterpart yet (CUDA graphs per bucket are a later step).
`warm_scores` drives one padded batch per bucket through the real
`Scorer.score` (it builds and loads the kernels), and `selfcheck`
holds each model's served scores on the warm batch against the plain
PyTorch path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from shifu_tpu_torch.config import environment as env

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
                stage: Callable[[Dict], Dict] = lambda blocks: blocks
                ) -> int:
    """One real `scorer.score` call per bucket with rows tiled from the
    prototype and passed through `stage` (the caller's h2d step), so
    kernels are built and loaded before traffic. Returns the number of
    buckets warmed."""
    for bucket in ladder:
        padded = stage(pad_blocks(proto, bucket))
        scorer.score(**_score_kwargs(padded), norm=norm)
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
    return score_matrix(kind, meta, model, dense)


def selfcheck(scorer: Any, proto: Dict[str, Optional[np.ndarray]],
              ladder: Tuple[int, ...],
              norm: Optional[Dict[str, Any]] = None) -> None:
    """At start, on the warm batch of the top bucket: every model's
    served scores (kernel route on a card) must agree with the plain
    path — the check the JAX package's `aot_selfcheck` made of its
    compiled executables."""
    from shifu_tpu_torch.eval.scorer import score_matrix
    blocks = pad_blocks(proto, ladder[-1])
    for i, (kind, meta, model) in enumerate(scorer.models):
        got = score_matrix(kind, meta, model, **_score_kwargs(blocks),
                           norm=norm).reshape(-1)
        want = plain_scores(kind, meta, model, blocks, norm).reshape(-1)
        if not np.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(
                f"model{i} ({kind}) served scores deviate from the plain "
                f"path on the warm batch: max |diff| "
                f"{float(np.max(np.abs(got - want))):.3g}")
