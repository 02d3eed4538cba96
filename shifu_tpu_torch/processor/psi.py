"""`shifu stats -psi` — population stability index per column, the
resident path of `shifu_tpu/processor/psi.py` (`pig/PSI.pig`,
`udf/PSICalculatorUDF`).

Rows are grouped by the `stats#psiColumnName` cohort column; each
column's per-cohort bin distribution is compared with its distribution
over all rows: psi = Σ (p_all − p_cohort)·ln(p_all / p_cohort),
averaged over cohorts, written to `columnStats.psi` and `unitStats`
(per-cohort values) and to psi.csv. The numeric columns are binned by
the stats step's boundaries (`ops/stats.bin_index_numeric`) and every
(cohort, column, bin) count is one `torch.bincount` on `device`; the
metric (`ops/stats.psi_metric`) runs on the host in float64. Past the
analysis trigger (SHIFU_TPU_ANALYSIS_CHUNK_ROWS, or the raw size) the
raw set is read in chunks and each chunk's integer counts add into a
cohort's (C, S) block: the counts, and so every psi, equal the resident
run's exactly.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from shifu_tpu_torch.fileio import atomic_write
from shifu_tpu_torch.ops import stats as stats_ops
from shifu_tpu_torch.processor import norm as norm_proc
from shifu_tpu_torch.processor.base import ProcessorContext
from shifu_tpu_torch.processor.chunking import analysis_chunk_rows

log = logging.getLogger("shifu_tpu_torch")


def cohort_bin_counts(bin_idx: torch.Tensor, cohort: torch.Tensor,
                      n_cohorts: int, n_slots: int) -> np.ndarray:
    """(U, C, S) int64 counts of each (cohort, column, bin) from (R, C)
    bin indices in [0, S) and (R,) cohort ids in [0, U)."""
    r, c = bin_idx.shape
    col = torch.arange(c, device=bin_idx.device)
    key = (cohort[:, None].long() * c + col[None, :]) * n_slots \
        + bin_idx.long()
    counts = torch.bincount(key.reshape(-1),
                            minlength=n_cohorts * c * n_slots)
    return counts.reshape(n_cohorts, c, n_slots).cpu().numpy()


def run(ctx: ProcessorContext, device: "str | torch.device" = "cuda",
        report=None) -> int:
    """Write psi.csv and each column's psi. `report`, when given,
    receives the rows (``rows``) and the cohorts (``cohorts``)."""
    from shifu_tpu_torch import resolve_device
    from shifu_tpu_torch.data.dataset import build_columnar, parse_tags
    from shifu_tpu_torch.data.purifier import DataPurifier
    from shifu_tpu_torch.data.reader import (read_raw_table,
                                             simple_column_name,
                                             string_column)
    from shifu_tpu_torch.ops.normalize import build_numeric_table
    dev = resolve_device(device)
    t0 = time.time()
    mc = ctx.model_config
    ctx.require_columns()
    psi_col = simple_column_name(mc.stats.psiColumnName)
    if not psi_col:
        raise ValueError("stats#psiColumnName is empty — set it to the "
                         "cohort column (e.g. a month field) to compute PSI")
    chunk_rows = analysis_chunk_rows(ctx)
    if chunk_rows:
        from shifu_tpu_torch.data.pipeline import prefetch
        from shifu_tpu_torch.data.reader import iter_raw_table
        log.info("psi: dataset exceeds the resident threshold — exact "
                 "streaming accumulation in %d-row chunks", chunk_rows)
        frames = prefetch(iter_raw_table(mc, chunk_rows=chunk_rows))
    else:
        frames = [read_raw_table(mc)]

    cols = norm_proc.selected_candidates(ctx.column_configs)
    vocabs = {c.columnNum: (c.columnBinning.binCategory or [])
              for c in cols if c.is_categorical}
    num_by = {c.columnNum: c for c in cols if c.is_numerical}
    tgt = simple_column_name(mc.dataSet.targetColumnName.split("|")[0])
    purifier = DataPurifier(mc.dataSet.filterExpressions) \
        if mc.dataSet.filterExpressions else None
    # cohort → [numeric (C_num, S_num) counts, categorical (C_cat, S_cat)
    # counts]: integer sums, so chunks merge exactly
    counts: Dict[str, List[Optional[np.ndarray]]] = {}
    cuts = None
    num_slots = cat_slots = 0
    num_column_nums = cat_column_nums = None
    n_rows = 0
    for df in frames:
        if purifier is not None:
            df = df.select(purifier.apply(df))
        if psi_col not in df:
            raise ValueError(f"psiColumnName {psi_col!r} not in data "
                             "header")
        dset = build_columnar(mc, norm_proc._restrict(ctx.column_configs,
                                                      cols),
                              df, vocabs=vocabs)
        # build_columnar drops invalid-tag rows: align the cohorts
        tags_all = parse_tags(string_column(df[tgt]), mc.pos_tags,
                              mc.neg_tags)
        cohorts = string_column(df[psi_col])[~np.isnan(tags_all)]
        if not len(cohorts):
            continue
        n_rows += len(cohorts)
        uniq, cohort_ids = np.unique(cohorts, return_inverse=True)
        cohort_t = torch.as_tensor(cohort_ids.reshape(-1), device=dev)
        blocks = []
        if dset.numeric.shape[1]:
            if cuts is None:
                ordered = [num_by[int(n)] for n in dset.num_column_nums
                           if int(n) in num_by]
                cuts = build_numeric_table(ordered, mc.stats.maxNumBin).cuts
                num_slots = cuts.shape[0] + 2
                num_column_nums = dset.num_column_nums
            bi = stats_ops.bin_index_numeric(
                torch.as_tensor(np.ascontiguousarray(dset.numeric,
                                                     np.float32),
                                device=dev), torch.as_tensor(cuts,
                                                             device=dev))
            blocks.append((0, bi, num_slots))
        if dset.cat_codes.shape[1]:
            if not cat_slots:
                cat_slots = max(len(v) for v in dset.vocabs) + 2
                cat_column_nums = dset.cat_column_nums
            blocks.append((1, torch.as_tensor(dset.cleaned_codes(),
                                              device=dev), cat_slots))
        for which, bin_idx, n_slots in blocks:
            per = cohort_bin_counts(bin_idx, cohort_t, len(uniq), n_slots)
            for ui, u in enumerate(uniq.tolist()):
                slot = counts.setdefault(str(u), [None, None])
                slot[which] = per[ui] if slot[which] is None \
                    else slot[which] + per[ui]

    uniq = sorted(counts)
    cc_by_num = {c.columnNum: c for c in ctx.column_configs}
    rows: List[str] = []

    def finalize(which: int, col_nums) -> None:
        per_cohort = [counts[u][which] for u in uniq]     # (C, S) each
        if not per_cohort or per_cohort[0] is None:
            return
        # every kept row has a cohort: the all-rows distribution is the
        # sum over cohorts
        glob = np.sum(per_cohort, axis=0)
        for j, cn in enumerate(col_nums):
            cc = cc_by_num[int(cn)]
            g = glob[j] / max(glob[j].sum(), 1)
            unit = []
            for ui in range(len(uniq)):
                c_counts = per_cohort[ui][j]
                c_dist = c_counts / max(c_counts.sum(), 1)
                unit.append(stats_ops.psi_metric(c_dist, g))
            cc.columnStats.psi = float(np.mean(unit)) if unit else 0.0
            cc.columnStats.unitStats = [f"{u}:{v:.6f}"
                                        for u, v in zip(uniq, unit)]
            rows.append(f"{cc.columnName},{cc.columnStats.psi:.6f}," +
                        ",".join(f"{v:.6f}" for v in unit))

    if num_column_nums is not None:
        finalize(0, num_column_nums)
    if cat_column_nums is not None:
        finalize(1, cat_column_nums)

    out = ctx.path_finder.psi_path()
    ctx.path_finder.ensure(out)
    with atomic_write(out) as f:
        f.write("column,psi," + ",".join(uniq) + "\n")
        f.write("\n".join(rows) + "\n")
    ctx.save_column_configs()
    if report is not None:
        report.update(rows=n_rows, cohorts=len(uniq))
    log.info("psi: %d cohorts × %d columns → %s in %.2fs", len(uniq),
             len(rows), out, time.time() - t0)
    return 0
