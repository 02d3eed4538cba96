"""`shifu stats` — per-column binning + statistics on one device.

The port of the resident path of `shifu_tpu/processor/stats.py`: the
raw table becomes columnar matrices, which go to the device once
(`stats --device cuda`, the default); binning, bin counts, moments and
quartiles run there as the plain PyTorch of `ops/stats.py`, and the
O(cols × bins) KS/IV/WOE math runs on the host in float64. Segment
expansion (`dataSet#segExpressionFile`) and `stats.sampleRate` /
`sampleNegOnly` run inline, as in the JAX package. No mesh: one device.

When `dataSet#dateColumnName` is set, the same filtered and sampled
rows feed DateStats (`processor/datestat.py`) on the same device.
`run_rebin` is `stats -rebin`: it merges the recorded bins of each
column on the host (`ops/rebin.py`), with no data pass. The
`-correlation` and `-psi` variants are `processor/correlation.py` and
`processor/psi.py`.

`run(..., base_only=True)` (`stats -base-only`), `run_segment`
(`stats -seg K`) and `run_segment_merge` (`stats -seg-merge`) split
the segment expansion into the pipeline DAG's siblings: the base
columns, one partial a segment expression under ``tmp/stats_seg/``,
and the merge that commits ColumnConfig.json equal to the inline
expansion's, byte for byte.

Past the size trigger (SHIFU_TPU_STATS_CHUNK_ROWS or -Dshifu.stats.
chunkRows, or raw files over SHIFU_TPU_STATS_STREAM_BYTES) `run` hands
the step to the chunked two-pass sketch of
`processor/stats_streaming.py`, except that an automatic trigger stays
resident for segment expansion and DateStats, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from shifu_tpu_torch.config.column_config import ColumnConfig
from shifu_tpu_torch.config.inspector import ModelStep
from shifu_tpu_torch.data import segment
from shifu_tpu_torch.data.dataset import ColumnarDataset, build_columnar
from shifu_tpu_torch.data.purifier import DataPurifier
from shifu_tpu_torch.data.reader import Table, read_raw_table
from shifu_tpu_torch.ops import stats as stats_ops
from shifu_tpu_torch.ops.binning import cap_categories, \
    compute_numeric_binning
from shifu_tpu_torch.processor.base import ProcessorContext, step_guard
from shifu_tpu_torch.processor import datestat

log = logging.getLogger("shifu_tpu_torch")


def run(ctx: ProcessorContext, dataset: Optional[ColumnarDataset] = None,
        seed: int = 12306, device: "str | torch.device" = "cuda",
        report: Optional[Dict[str, float]] = None,
        base_only: bool = False) -> int:
    """Fill ColumnConfig.json with binning and stats, resident or
    streaming, under the ``stats`` manifest (`step_guard`). `report`,
    when given, receives the seconds spent reading the raw table
    (``read_s``) and the rows the step computed over (``rows``). With
    `base_only` the segment copies are left to `run_segment`."""
    with step_guard(ctx, "stats", outputs=[
            ctx.path_finder.column_config_path()]) as go:
        if not go:
            return 0
        return _run(ctx, dataset, seed, device, report, base_only)


def _run(ctx: ProcessorContext, dataset: Optional[ColumnarDataset],
         seed: int, device: "str | torch.device",
         report: Optional[Dict[str, float]], base_only: bool) -> int:
    from shifu_tpu_torch import resolve_device
    dev = resolve_device(device)
    t0 = time.time()
    mc = ctx.model_config
    ctx.validate(ModelStep.STATS)
    ctx.require_columns()
    ccs = ctx.column_configs
    df = None
    exprs = segment.segment_expressions(mc)
    if dataset is None:
        from shifu_tpu_torch.processor import stats_streaming
        chunk = stats_streaming.stats_chunk_rows(ctx)
        if chunk and not stats_streaming.explicitly_requested() and \
                (exprs or datestat.date_column_name(mc)):
            log.warning("stats: dataset exceeds the streaming threshold "
                        "but segment expansion / DateStats need the "
                        "resident path — running resident")
            chunk = 0
        if chunk:
            return stats_streaming.run_streaming(ctx, chunk, seed, dev,
                                                 report)
        t_read = time.perf_counter()
        df = _resident_frame(ctx, seed)
        if report is not None:
            report["read_s"] = time.perf_counter() - t_read
        dataset = build_columnar(mc, [c for c in ccs if not c.is_segment],
                                 df)

    compute_stats(ctx, dataset, device=dev)

    if df is not None and not exprs and any(c.is_segment for c in ccs):
        # expressions removed since the last run: drop orphaned copies
        ccs = [c for c in ccs if not c.is_segment]
        ctx.column_configs = ccs
    if base_only and exprs:
        # the DAG's `stats -seg K` siblings own the segment blocks: this
        # run commits the base columns only
        ccs = [c for c in ccs if not c.is_segment]
        ctx.column_configs = ccs
        exprs = []
    if exprs and df is not None:
        base = [c for c in ccs if not c.is_segment]
        ccs = base + segment.expand_column_configs(base, exprs)
        ctx.column_configs = ccs
        n_base = len(base)
        by_num = {c.columnNum: c for c in ccs}
        for k, expr in enumerate(exprs, start=1):
            mask = DataPurifier(expr).apply(df)
            dset_k = build_columnar(mc, base, df.select(mask))
            cc_map = {c.columnNum: by_num[k * n_base + c.columnNum]
                      for c in base}
            compute_stats(ctx, dset_k, cc_map=cc_map, device=dev)
            log.info("segment %d (%s): %d/%d rows", k, expr,
                     int(mask.sum()), len(df))
    ctx.save_column_configs()
    # the per-date stats job (MapReducerStatsWorker.java:296-321) over
    # this run's filtered + sampled rows
    if datestat.date_column_name(mc):
        datestat.run(ctx, df=df, dataset=dataset if df is not None else None,
                     device=dev)
    if report is not None:
        report["rows"] = dataset.num_rows
    log.info("stats: %d rows, %d num + %d cat columns in %.2fs",
             dataset.num_rows, len(dataset.num_names),
             len(dataset.cat_names), time.time() - t0)
    return 0


def _resident_frame(ctx: ProcessorContext, seed: int) -> Table:
    """The filtered + sampled raw table the base and segment stats
    compute over."""
    mc = ctx.model_config
    ccs = ctx.column_configs
    df = read_raw_table(mc, numeric_columns=[
        c.columnName for c in ccs
        if c.is_candidate and not c.is_categorical and not c.is_segment])
    keep = DataPurifier(mc.dataSet.filterExpressions).apply(df)
    if mc.stats.sampleRate < 1.0:
        from shifu_tpu_torch.data.sampling import (positive_tag_mask,
                                                   sample_flags)
        keep_pos = positive_tag_mask(mc, df) \
            if mc.stats.sampleNegOnly else None
        keep &= sample_flags(mc.stats.sampleRate, seed, 0, len(df),
                             purpose="stats-sample", keep_pos=keep_pos)
    return df.select(keep)


def compute_stats(ctx: ProcessorContext, dset: ColumnarDataset,
                  cc_map=None, device: "str | torch.device" = "cuda"
                  ) -> None:
    """Fill stats into ColumnConfigs; `cc_map` redirects a dataset
    column's number to another target config (segment copies)."""
    dev = torch.device(device)
    mc = ctx.model_config
    cc_by_num = cc_map or {c.columnNum: c for c in ctx.column_configs}
    tags = torch.as_tensor(dset.tags, device=dev)
    weights = torch.as_tensor(dset.weights, device=dev)
    max_bins = mc.stats.maxNumBin

    if dset.numeric.shape[1] > 0:
        values = torch.as_tensor(np.ascontiguousarray(dset.numeric),
                                 device=dev)
        binning = compute_numeric_binning(values, tags, weights,
                                          mc.stats.binningMethod, max_bins)
        bin_idx = stats_ops.bin_index_numeric(
            values, torch.as_tensor(binning.cuts_padded, device=dev))
        counts = _host(stats_ops.bin_accumulate(bin_idx, tags, weights,
                                                max_bins + 1))
        del bin_idx
        moments = _host(stats_ops.moment_stats(values))
        quartiles = stats_ops.weighted_quantiles(
            values, torch.ones_like(values), 3).cpu().numpy()
        del values
        for j, col_num in enumerate(dset.num_column_nums):
            cc = cc_by_num[int(col_num)]
            bounds = binning.boundaries[j]
            _fill_numeric(cc, bounds, len(bounds), j, counts, moments,
                          quartiles, max_bins, dset.num_rows)

    if dset.cat_codes.shape[1] > 0:
        vocab_lens = np.asarray([len(v) for v in dset.vocabs], np.int32)
        slots = int(vocab_lens.max()) + 1 if len(vocab_lens) else 1
        codes = torch.as_tensor(np.ascontiguousarray(dset.cat_codes),
                                device=dev)
        ccounts = _host(stats_ops.cat_bin_accumulate(
            codes, tags, weights, torch.as_tensor(vocab_lens, device=dev),
            slots))
        for j, col_num in enumerate(dset.cat_column_nums):
            cc = cc_by_num[int(col_num)]
            vocab = dset.vocabs[j]
            cap = mc.stats.cateMaxNumBin
            kept = vocab
            if cap > 0 and len(vocab) > cap:
                tot = ccounts["count_pos"][j] + ccounts["count_neg"][j]
                kept = cap_categories(vocab, tot[:len(vocab)], cap)
            _fill_categorical(cc, vocab, kept, j, ccounts,
                              int(vocab_lens[j]), dset.num_rows)


def _host(d: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in d.items()}


def _fill_numeric(cc: ColumnConfig, bounds: np.ndarray, k: int, j: int,
                  counts, moments, quartiles, max_bins: int,
                  n_rows: int) -> None:
    """Write numeric binning + stats into one ColumnConfig: count arrays
    are [real bins..., missing] of length k+1 (the reference's
    binSize+1 layout, UpdateBinningInfoReducer.java:200)."""
    def squeeze(arr):
        row = arr[j]
        return np.concatenate([row[:k], [row[max_bins]]])

    pos = squeeze(counts["count_pos"])
    neg = squeeze(counts["count_neg"])
    wpos = squeeze(counts["weight_pos"])
    wneg = squeeze(counts["weight_neg"])
    ks, iv, woe, bin_woe = stats_ops.column_metrics(pos, neg)
    wks, wiv, wwoe, wbin_woe = stats_ops.column_metrics(wpos, wneg)

    bn = cc.columnBinning
    bn.length = k
    bn.binBoundary = [float(b) for b in bounds]
    bn.binCategory = None
    bn.binCountPos = [int(x) for x in pos]
    bn.binCountNeg = [int(x) for x in neg]
    bn.binWeightedPos = [float(x) for x in wpos]
    bn.binWeightedNeg = [float(x) for x in wneg]
    tot = pos + neg
    bn.binPosRate = [float(p / t) if t > 0 else 0.0
                     for p, t in zip(pos, tot)]
    bn.binCountWoe = [float(x) for x in bin_woe]
    bn.binWeightedWoe = [float(x) for x in wbin_woe]

    st = cc.columnStats
    st.totalCount = int(n_rows)
    st.missingCount = int(moments["missing"][j])
    st.missingPercentage = float(st.missingCount / max(n_rows, 1))
    st.mean = float(moments["mean"][j])
    st.stdDev = float(moments["std"][j])
    st.min = float(moments["min"][j])
    st.max = float(moments["max"][j])
    st.skewness = float(moments["skewness"][j])
    st.kurtosis = float(moments["kurtosis"][j])
    st.p25th = float(quartiles[0, j])
    st.median = float(quartiles[1, j])
    st.p75th = float(quartiles[2, j])
    st.validNumCount = int(n_rows - st.missingCount)
    st.ks, st.iv, st.woe = ks, iv, woe
    st.weightedKs, st.weightedIv, st.weightedWoe = wks, wiv, wwoe


def _fill_categorical(cc: ColumnConfig, orig_vocab, vocab, j: int, counts,
                      vocab_len: int, n_rows: int) -> None:
    """Write categorical binning + stats into one ColumnConfig; when the
    cateMaxNumBin cap dropped categories, their counts fold into the
    missing bin on the host (UpdateBinningInfoReducer.java:357-399)."""
    row_p = counts["count_pos"][j]
    row_n = counts["count_neg"][j]
    row_wp = counts["weight_pos"][j]
    row_wn = counts["weight_neg"][j]
    if len(vocab) == vocab_len:
        def squeeze(row):
            return np.concatenate([row[:vocab_len], [row[vocab_len]]])
        pos, neg = squeeze(row_p), squeeze(row_n)
        wpos, wneg = squeeze(row_wp), squeeze(row_wn)
    else:
        orig_index = {v: i for i, v in enumerate(orig_vocab)}
        kept_of_orig = {orig_index[v]: i for i, v in enumerate(vocab)}
        k = len(vocab)
        pos, neg = np.zeros(k + 1), np.zeros(k + 1)
        wpos, wneg = np.zeros(k + 1), np.zeros(k + 1)
        for oi in range(vocab_len + 1):
            ki = kept_of_orig.get(oi, k) if oi < vocab_len else k
            pos[ki] += row_p[oi]
            neg[ki] += row_n[oi]
            wpos[ki] += row_wp[oi]
            wneg[ki] += row_wn[oi]

    ks, iv, woe, bin_woe = stats_ops.column_metrics(pos, neg)
    wks, wiv, wwoe, wbin_woe = stats_ops.column_metrics(wpos, wneg)

    bn = cc.columnBinning
    bn.length = len(vocab)
    bn.binBoundary = None
    bn.binCategory = list(vocab)
    bn.binCountPos = [int(x) for x in pos]
    bn.binCountNeg = [int(x) for x in neg]
    bn.binWeightedPos = [float(x) for x in wpos]
    bn.binWeightedNeg = [float(x) for x in wneg]
    tot = pos + neg
    bn.binPosRate = [float(p / t) if t > 0 else 0.0
                     for p, t in zip(pos, tot)]
    bn.binCountWoe = [float(x) for x in bin_woe]
    bn.binWeightedWoe = [float(x) for x in wbin_woe]

    st = cc.columnStats
    st.totalCount = int(n_rows)
    st.missingCount = int(round(row_p[vocab_len] + row_n[vocab_len]))
    st.missingPercentage = float(st.missingCount / max(n_rows, 1))
    st.distinctCount = len(vocab)
    pr = np.asarray(bn.binPosRate)
    tot_all = tot.sum()
    if tot_all > 0:
        mean = float(np.sum(pr * tot) / tot_all)
        var = float(np.sum(tot * (pr - mean) ** 2) / max(tot_all - 1, 1))
        st.mean, st.stdDev = mean, float(np.sqrt(var))
    else:
        st.mean, st.stdDev = 0.0, 0.0
    st.ks, st.iv, st.woe = ks, iv, woe
    st.weightedKs, st.weightedIv, st.weightedWoe = wks, wiv, wwoe


def run_rebin(ctx: ProcessorContext, request_vars: Optional[str] = None,
              expect_bin_num: int = -1, iv_keep_ratio: float = 1.0,
              min_inst_cnt: int = 0) -> int:
    """`stats -rebin [-vars a,b] [-n N] [-ivr r] [-bic c]` — merge each
    column's recorded bins into fewer, higher-IV bins, with no data
    pass (StatsModelProcessor.java:173-218, doReBin:712)."""
    from shifu_tpu_torch.ops.rebin import rebin_column
    ctx.require_columns()
    wanted = {v.strip() for v in (request_vars or "").split(",")
              if v.strip()}
    n_done = 0
    for cc in ctx.column_configs:
        if wanted and cc.columnName not in wanted:
            continue
        if not cc.is_candidate:
            if wanted:
                log.warning("column %s is not a good candidate, skip",
                            cc.columnName)
            continue
        if rebin_column(cc, expect_bin_num=expect_bin_num,
                        iv_keep_ratio=iv_keep_ratio,
                        min_inst_cnt=min_inst_cnt):
            n_done += 1
    ctx.save_column_configs()
    log.info("rebin: %d column(s) re-binned", n_done)
    return 0


# ---------------------------------------------------------------------------
# per-segment stats as DAG siblings (`stats -seg K` / `stats -seg-merge`)
# ---------------------------------------------------------------------------

def _seg_partial_path(ctx: ProcessorContext, k: int) -> str:
    return os.path.join(ctx.path_finder.root, "tmp", "stats_seg",
                        f"seg_{k}.json")


def run_segment(ctx: ProcessorContext, k: int, seed: int = 12306,
                device: "str | torch.device" = "cuda",
                report: Optional[Dict[str, float]] = None) -> int:
    """`stats -seg K`: the stats of segment block K alone, on `device`,
    written to a partial under ``tmp/stats_seg/`` (the
    ``stats.seg.<k>`` manifest); `run_segment_merge` folds the partials
    back into ColumnConfig.json."""
    from shifu_tpu_torch import resolve_device
    from shifu_tpu_torch.config.column_config import save_column_configs
    dev = resolve_device(device)
    t0 = time.time()
    mc = ctx.model_config
    ctx.validate(ModelStep.STATS)
    ctx.require_columns()
    exprs = segment.segment_expressions(mc)
    if not 1 <= k <= len(exprs):
        raise ValueError(
            f"stats -seg {k}: segment index out of range (the "
            f"segExpressionFile defines {len(exprs)} expression(s))")
    out = _seg_partial_path(ctx, k)
    with step_guard(ctx, f"stats.seg.{k}", outputs=[out]) as go:
        if not go:
            return 0
        t_read = time.perf_counter()
        df = _resident_frame(ctx, seed)
        if report is not None:
            report["read_s"] = time.perf_counter() - t_read
        base = [c for c in ctx.column_configs if not c.is_segment]
        n_base = len(base)
        block = [c for c in segment.expand_column_configs(base, exprs)
                 if k * n_base <= c.columnNum < (k + 1) * n_base]
        expr = exprs[k - 1]
        mask = DataPurifier(expr).apply(df)
        dset_k = build_columnar(mc, base, df.select(mask))
        by_num = {c.columnNum: c for c in block}
        cc_map = {c.columnNum: by_num[k * n_base + c.columnNum]
                  for c in base}
        compute_stats(ctx, dset_k, cc_map=cc_map, device=dev)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        save_column_configs(block, out)
        if report is not None:
            report["rows"] = dset_k.num_rows
        log.info("stats -seg %d (%s): %d/%d rows in %.2fs", k, expr,
                 int(mask.sum()), len(df), time.time() - t0)
    return 0


def run_segment_merge(ctx: ProcessorContext) -> int:
    """`stats -seg-merge`: re-attach every segment block's partial
    ColumnConfigs (written by the `stats -seg K` siblings) to the base
    configs and commit ColumnConfig.json (host only)."""
    from shifu_tpu_torch.config.column_config import load_column_configs
    mc = ctx.model_config
    ctx.require_columns()
    exprs = segment.segment_expressions(mc)
    with step_guard(ctx, "stats.segmerge", outputs=[
            ctx.path_finder.column_config_path()]) as go:
        if not go:
            return 0
        merged = [c for c in ctx.column_configs if not c.is_segment]
        for k in range(1, len(exprs) + 1):
            p = _seg_partial_path(ctx, k)
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"segment partial {p} missing — run "
                    f"`stats -seg {k}` first")
            merged.extend(load_column_configs(p))
        ctx.column_configs = merged
        ctx.save_column_configs()
        log.info("stats -seg-merge: %d base + %d segment configs",
                 len([c for c in merged if not c.is_segment]),
                 len([c for c in merged if c.is_segment]))
    return 0
