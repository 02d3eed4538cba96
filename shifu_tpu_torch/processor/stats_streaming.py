"""Streaming (>RAM) column stats — a chunked two-pass sketch, the port of
`shifu_tpu/processor/stats_streaming.py`.

The resident stats (`processor/stats.py`) hold the whole table; here
the raw set is read twice in chunks (`data/reader.iter_raw_table`
behind `data/pipeline.prefetch`), so host memory holds one chunk:

- **Pass A**: per numeric column, float64 power sums s1..s4, min/max
  and missing counts (exact moments), summed on `device`; per
  categorical column, a value → (posCount, negCount, posWeight,
  negWeight) dict merged on the host (the reference's
  `BinningDataMergeUDF` merge).
- **Pass B**: per numeric column, a fixed-width 8,192-bin float64
  histogram over [min, max] for the four weight kinds, accumulated on
  `device` (`index_add_`). Every BinningMethod's cuts come from the
  matching weight's cumulative histogram, boundaries land on fine-bin
  edges, and the per-bin counts aggregate exactly from the fine
  histogram, so KS/IV/WOE are exact for the chosen boundaries, which lie
  within 1/8,192 of the range of the exact quantiles.

Every sum is associative, so row order biases nothing (the float64
sums on the card differ from the JAX package's host sums only in
rounding). Sampling keys on the global raw row index, so any chunking
samples the rows the resident read does. Segment expansion needs the
resident path (it re-filters the table a segment) and is refused when
streaming was asked for explicitly; DateStats is skipped with a
warning. The JAX package's multi-host merge (`iter_raw_table_keyed`,
`dist.merge_keyed_striped` and the sparse pass-B exchange) is ROADMAP
A8.3.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from shifu_tpu_torch.config.environment import knob_raw
from shifu_tpu_torch.config.inspector import ModelStep
from shifu_tpu_torch.config.model_config import BinningMethod
from shifu_tpu_torch.data.dataset import build_columnar, valid_tag_mask
from shifu_tpu_torch.data.pipeline import prefetch
from shifu_tpu_torch.data.purifier import DataPurifier
from shifu_tpu_torch.data.reader import iter_raw_table
from shifu_tpu_torch.processor.base import ProcessorContext

log = logging.getLogger("shifu_tpu_torch")

FINE_BINS = 8192
_SUMS = ("n", "miss", "s1", "s2", "s3", "s4", "miss_pos_n", "miss_neg_n",
         "miss_pos_w", "miss_neg_w")


def explicitly_requested() -> bool:
    """True when streaming was forced through the environment (an
    automatic size trigger falls back to resident for what streaming
    cannot serve: segments, DateStats)."""
    return bool(os.environ.get("shifu.stats.chunkRows")
                or knob_raw("SHIFU_TPU_STATS_CHUNK_ROWS"))


def stats_chunk_rows(ctx: ProcessorContext) -> int:
    """0 = resident; the shared trigger of `processor/chunking.py`."""
    from shifu_tpu_torch.processor.chunking import chunk_rows_for
    return chunk_rows_for(ctx, ("shifu.stats.chunkRows",
                                "SHIFU_TPU_STATS_CHUNK_ROWS"),
                          "SHIFU_TPU_STATS_STREAM_BYTES",
                          ctx.model_config.dataSet.dataPath, "stats")


def _chunk_datasets(ctx: ProcessorContext, ccs, chunk_rows: int,
                    seed: int, report: Optional[Dict] = None):
    """Yield a ColumnarDataset a chunk, with the filter and the sampling
    applied (build_columnar drops invalid-tag rows itself); the read
    time goes to ``report["read_s"]``."""
    from shifu_tpu_torch.data.sampling import positive_tag_mask, \
        sample_flags
    mc = ctx.model_config
    purifier = DataPurifier(mc.dataSet.filterExpressions) \
        if mc.dataSet.filterExpressions else None
    start = 0
    frames = iter(prefetch(iter_raw_table(mc, chunk_rows=chunk_rows)))
    while True:
        t0 = time.perf_counter()
        df = next(frames, None)
        if report is not None:
            report["read_s"] = report.get("read_s", 0.0) \
                + time.perf_counter() - t0
        if df is None:
            return
        # sample on the raw global row index before the filter, so the
        # sampled set is the same for any chunking
        keep = np.ones(len(df), bool)
        if mc.stats.sampleRate < 1.0:
            keep_pos = positive_tag_mask(mc, df) \
                if mc.stats.sampleNegOnly else None
            keep &= sample_flags(mc.stats.sampleRate, seed, start, len(df),
                                 purpose="stats-sample", keep_pos=keep_pos)
        start += len(df)
        if purifier is not None:
            keep &= purifier.apply(df)
        df = df.select(keep)
        # a chunk with no valid-tag row is skipped; any other build error
        # raises rather than truncating the stats
        if not len(df) or not valid_tag_mask(mc, df).any():
            continue
        dset = build_columnar(mc, [c for c in ccs if not c.is_segment], df)
        if dset.num_rows:
            yield dset


def _contrib_a(dset, dev: torch.device) -> Dict[str, object]:
    """One chunk's Pass-A increments: float64 sums on `dev` for the
    numeric columns, host dicts for the categorical ones."""
    v = torch.as_tensor(np.ascontiguousarray(dset.numeric),
                        device=dev).double()
    ok = ~torch.isnan(v)
    pos_rows = torch.as_tensor(dset.tags > 0.5, device=dev)[:, None]
    wcol = torch.as_tensor(dset.weights, device=dev).double()[:, None]
    vz = torch.where(ok, v, 0.0)
    miss = ~ok
    c: Dict[str, object] = {
        "n_rows": dset.num_rows,
        "n": ok.sum(0).double(),
        "miss": miss.sum(0).double(),
        "miss_pos_n": (miss & pos_rows).sum(0).double(),
        "miss_neg_n": (miss & ~pos_rows).sum(0).double(),
        "miss_pos_w": torch.where(miss & pos_rows, wcol, 0.0).sum(0),
        "miss_neg_w": torch.where(miss & ~pos_rows, wcol, 0.0).sum(0),
        "s1": vz.sum(0),
        "s2": (vz ** 2).sum(0),
        "s3": (vz ** 3).sum(0),
        "s4": (vz ** 4).sum(0),
        "min": torch.where(ok, v, float("inf")).amin(0),
        "max": torch.where(ok, v, -float("inf")).amax(0),
    }
    pos = dset.tags > 0.5
    w = dset.weights.astype(np.float64)
    cat_miss = np.zeros((len(dset.cat_names), 4))
    cat_rows: List[Dict[str, np.ndarray]] = []
    for j in range(len(dset.cat_names)):
        codes = dset.cat_codes[:, j]
        vocab = dset.vocabs[j]
        m = codes < 0
        cat_miss[j] = (float((pos & m).sum()), float((~pos & m).sum()),
                       float(w[pos & m].sum()), float(w[~pos & m].sum()))
        d: Dict[str, np.ndarray] = {}
        for arr, k in ((pos & ~m, 0), (~pos & ~m, 1)):
            if not arr.any():
                continue
            cnt = np.bincount(codes[arr], minlength=len(vocab))
            wcnt = np.bincount(codes[arr], weights=w[arr],
                               minlength=len(vocab))
            for ci in np.nonzero(cnt)[0]:
                row = d.get(vocab[ci])
                if row is None:
                    row = d[vocab[ci]] = np.zeros(4)
                row[k] += cnt[ci]
                row[2 + k] += wcnt[ci]
        cat_rows.append(d)
    c["cat_missing"] = cat_miss
    c["cat"] = cat_rows
    return c


def _fold_a(state, meta, c, dev: torch.device):
    """Add one chunk's contribution to the running Pass-A state (zeros
    from the column layout `meta` at the first chunk)."""
    num_names, _num_nums, cat_names, _cat_nums = meta
    if state is None:
        cn = len(num_names)
        A = {k: torch.zeros(cn, dtype=torch.float64, device=dev)
             for k in _SUMS}
        A["min"] = torch.full((cn,), float("inf"), dtype=torch.float64,
                              device=dev)
        A["max"] = torch.full((cn,), -float("inf"), dtype=torch.float64,
                              device=dev)
        state = (A, [dict() for _ in cat_names],
                 np.zeros((len(cat_names), 4), np.float64))
    A, cat_counts, cat_missing = state
    for k in _SUMS:
        A[k] += c[k]
    A["min"] = torch.minimum(A["min"], c["min"])
    A["max"] = torch.maximum(A["max"], c["max"])
    cat_missing += c["cat_missing"]
    for j, d in enumerate(c["cat"]):
        tgt = cat_counts[j]
        for val, row in d.items():
            acc = tgt.get(val)
            if acc is None:
                acc = tgt[val] = np.zeros(4)
            acc += row
    return state


def _contrib_b(fine: torch.Tensor, dset, fmin: torch.Tensor,
               span: torch.Tensor) -> None:
    """Add one chunk's Pass-B counts into the (4, C, K) float64 fine
    histogram `fine` (pos count, neg count, pos weight, neg weight)."""
    dev = fine.device
    cn = fine.shape[1]
    v = torch.as_tensor(np.ascontiguousarray(dset.numeric),
                        device=dev).double()
    ok = ~torch.isnan(v)
    vq = torch.where(ok, v, fmin[None, :])
    idx = ((vq - fmin[None, :]) / span[None, :] * FINE_BINS).long() \
        .clamp(0, FINE_BINS - 1)
    pos = torch.as_tensor(dset.tags > 0.5, device=dev)[:, None]
    w = torch.as_tensor(dset.weights, device=dev).double()[:, None] \
        .expand_as(v)
    flat = idx + torch.arange(cn, device=dev)[None, :] * FINE_BINS
    out = fine.view(4, -1)
    for k, (rows, wv) in enumerate(((pos, None), (~pos, None), (pos, w),
                                    (~pos, w))):
        sel = ok & rows
        out[k].index_add_(0, flat[sel], torch.ones_like(v)[sel]
                          if wv is None else wv[sel])


def run_streaming(ctx: ProcessorContext, chunk_rows: int,
                  seed: int = 12306, device: "str | torch.device" = "cuda",
                  report: Optional[Dict] = None) -> int:
    """Fill ColumnConfig.json from two chunked passes over the raw set.
    `report`, when given, receives the seconds waiting for raw chunks
    (``read_s``) and writing ColumnConfig.json (``write_s``), and
    ``rows``."""
    from shifu_tpu_torch import resolve_device
    from shifu_tpu_torch.data import segment
    from shifu_tpu_torch.processor import datestat
    dev = resolve_device(device)
    t0 = time.time()
    mc = ctx.model_config
    ctx.validate(ModelStep.STATS)
    ctx.require_columns()
    ccs = ctx.column_configs
    if segment.segment_expressions(mc):
        raise ValueError(
            "segment expansion needs the resident stats path — drop "
            "shifu.stats.chunkRows / SHIFU_TPU_STATS_CHUNK_ROWS or raise "
            "SHIFU_TPU_STATS_STREAM_BYTES for this model set")

    # ---- Pass A: moments + categorical value counts -------------------
    meta = None
    state = None        # (A, cat_counts, cat_missing)
    n_rows = 0
    for dset in _chunk_datasets(ctx, ccs, chunk_rows, seed, report):
        if meta is None:
            meta = (dset.num_names, dset.num_column_nums,
                    dset.cat_names, dset.cat_column_nums)
        c = _contrib_a(dset, dev)
        state = _fold_a(state, meta, c, dev)
        n_rows += c["n_rows"]
    if n_rows == 0 or meta is None:
        raise ValueError(
            f"no row's {mc.dataSet.targetColumnName!r} value matches "
            f"posTags {mc.pos_tags} / negTags {mc.neg_tags} in any chunk")
    num_names, num_nums, cat_names, cat_nums = meta
    A, cat_counts, cat_missing = state
    cn = len(num_names)
    # an all-missing column keeps min = +inf: a finite base keeps inf -
    # inf out of the bin index (its rows are masked out anyway)
    fmin = torch.where(torch.isfinite(A["min"]), A["min"], 0.0)
    span = torch.where(A["max"] > A["min"], A["max"] - A["min"], 1.0)

    # ---- Pass B: fine histograms of the numeric columns ----------------
    fine = torch.zeros((4, cn, FINE_BINS), dtype=torch.float64, device=dev)
    if cn:
        for dset in _chunk_datasets(ctx, ccs, chunk_rows, seed, report):
            _contrib_b(fine, dset, fmin, span)

    A_host = {k: v.cpu().numpy() for k, v in A.items()}
    _fill_from_sketch(ctx, mc, num_names, num_nums, A_host,
                      fine.cpu().numpy(), n_rows)
    _fill_cats_from_dicts(ctx, mc, cat_names, cat_nums, cat_counts,
                          cat_missing, n_rows)
    t = time.perf_counter()
    ctx.save_column_configs()
    if report is not None:
        report["write_s"] = time.perf_counter() - t
    if datestat.date_column_name(mc):
        log.warning("streaming stats: per-date stats need the resident "
                    "path; DateStats skipped")
    if report is not None:
        report["rows"] = n_rows
    log.info("streaming stats: %d rows in 2 chunked passes, %d num + "
             "%d cat columns in %.2fs", n_rows, cn, len(cat_names),
             time.time() - t0)
    return 0


def _quantile_weights_hist(method: BinningMethod, fine: np.ndarray):
    """(C, K) quantile mass a fine bin for the BinningMethod
    (`ops/binning.quantile_weights_for_method` over the histogram)."""
    pos_n, neg_n, pos_w, neg_w = fine
    if method == BinningMethod.EqualPositive:
        return pos_n
    if method == BinningMethod.EqualNegative:
        return neg_n
    if method == BinningMethod.WeightEqualPositive:
        return pos_w
    if method == BinningMethod.WeightEqualNegative:
        return neg_w
    if method == BinningMethod.WeightEqualTotal:
        return pos_w + neg_w
    return pos_n + neg_n    # EqualTotal default


def _fill_from_sketch(ctx, mc, num_names, num_nums, A, fine,
                      n_rows: int) -> None:
    """Moments from the power sums, quartiles and boundaries from the
    fine histogram, per-bin counts aggregated from it; written through
    the resident step's `_fill_numeric`."""
    from shifu_tpu_torch.processor.stats import _fill_numeric
    cc_by_num = {c.columnNum: c for c in ctx.column_configs}
    max_bins = mc.stats.maxNumBin
    cn = len(num_names)
    if cn == 0:
        return
    K = FINE_BINS
    edges = A["min"][:, None] + (np.arange(K + 1)[None, :] / K) \
        * (np.where(A["max"] > A["min"], A["max"] - A["min"], 1.0))[:, None]

    n = np.maximum(A["n"], 1.0)
    mean = A["s1"] / n
    var = np.maximum(A["s2"] / n - mean ** 2, 0.0)
    std = np.sqrt(var * n / np.maximum(n - 1, 1.0))
    m3 = A["s3"] / n - 3 * mean * A["s2"] / n + 2 * mean ** 3
    m4 = A["s4"] / n - 4 * mean * A["s3"] / n + 6 * mean ** 2 \
        * A["s2"] / n - 3 * mean ** 4
    with np.errstate(all="ignore"):
        skew = np.where(var > 0, m3 / var ** 1.5, 0.0)
        kurt = np.where(var > 0, m4 / var ** 2 - 3.0, 0.0)
    moments = {"mean": mean, "std": std, "min": A["min"], "max": A["max"],
               "missing": A["miss"], "skewness": skew, "kurtosis": kurt}

    # quartiles from the unit-count fine histogram
    cum = np.cumsum(fine[0] + fine[1], axis=1)
    quartiles = np.zeros((3, cn))
    for qi, q in enumerate((0.25, 0.5, 0.75)):
        tgt = q * np.maximum(cum[:, -1], 1e-12)
        pos_idx = np.minimum((cum < tgt[:, None]).sum(axis=1), K - 1)
        quartiles[qi] = edges[np.arange(cn), pos_idx + 1]

    interval = mc.stats.binningMethod in (BinningMethod.EqualInterval,
                                          BinningMethod.WeightEqualInterval)
    if interval:
        # the counts split on the fine edge at or below each exact
        # interval boundary; the boundaries written are exact (below)
        cut_edges = [np.maximum(
            np.arange(1, max_bins) * K // max_bins - 1, 0)
            for _ in range(cn)]
    else:
        qcum = np.cumsum(_quantile_weights_hist(mc.stats.binningMethod,
                                                fine), axis=1)
        cut_edges = []
        for j in range(cn):
            tot = qcum[j, -1]
            if tot <= 0:
                cut_edges.append(np.asarray([], np.int64))
                continue
            tgts = np.arange(1, max_bins) / max_bins * tot
            # the fine bin whose right edge is the cut
            ce = np.searchsorted(qcum[j], tgts, side="left")
            cut_edges.append(np.unique(np.clip(ce, 0, K - 2)))

    keys = ("count_pos", "count_neg", "weight_pos", "weight_neg")
    counts = {k: np.zeros((cn, max_bins + 1)) for k in keys}
    for j in range(cn):
        ce = cut_edges[j]
        if interval:
            span = A["max"][j] - A["min"][j]
            span = span if span > 0 else 1.0
            bounds = np.concatenate(
                ([-np.inf],
                 A["min"][j] + np.arange(1, max_bins) * span / max_bins))
        else:
            bounds = np.concatenate(([-np.inf], edges[j, ce + 1]))
        # fine bin f falls in final bin #cuts with a fine index below f
        assign = np.searchsorted(ce, np.arange(K), side="left")
        for k in range(4):
            binned = np.bincount(assign, weights=fine[k, j],
                                 minlength=max_bins)[:max_bins]
            counts[keys[k]][j, :len(binned)] = binned
        # the missing slot, by class as in the resident step
        counts["count_pos"][j, max_bins] = A["miss_pos_n"][j]
        counts["count_neg"][j, max_bins] = A["miss_neg_n"][j]
        counts["weight_pos"][j, max_bins] = A["miss_pos_w"][j]
        counts["weight_neg"][j, max_bins] = A["miss_neg_w"][j]
        cc = cc_by_num[int(num_nums[j])]
        _fill_numeric(cc, bounds, len(bounds), j, counts, moments,
                      quartiles, max_bins, n_rows)


def _fill_cats_from_dicts(ctx, mc, cat_names, cat_nums, cat_counts,
                          cat_missing, n_rows: int) -> None:
    """The categorical columns from the merged value dicts (vocabulary in
    sorted order, the cateMaxNumBin cap as in the resident step)."""
    from shifu_tpu_torch.ops.binning import cap_categories
    from shifu_tpu_torch.processor.stats import _fill_categorical
    if not cat_names:
        return
    cc_by_num = {c.columnNum: c for c in ctx.column_configs}
    keys = ("count_pos", "count_neg", "weight_pos", "weight_neg")
    for j in range(len(cat_names)):
        d = cat_counts[j]
        vocab = sorted(d.keys())
        vl = len(vocab)
        counts = {k: np.zeros((1, vl + 1)) for k in keys}
        for ci, val in enumerate(vocab):
            for k, key in enumerate(keys):
                counts[key][0, ci] = d[val][k]
        for k, key in enumerate(keys):
            counts[key][0, vl] = cat_missing[j, k]
        kept = vocab
        cap = mc.stats.cateMaxNumBin
        if cap > 0 and vl > cap:
            tot = counts["count_pos"][0, :vl] + counts["count_neg"][0, :vl]
            kept = cap_categories(vocab, tot, cap)
        cc = cc_by_num[int(cat_nums[j])]
        _fill_categorical(cc, vocab, kept, 0, counts, vl, n_rows)
