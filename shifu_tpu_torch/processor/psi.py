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
metric (`ops/stats.psi_metric`) runs on the host in float64. A raw set
past the analysis trigger, which the JAX package streams in exact
chunks, raises (ROADMAP A6).
"""

from __future__ import annotations

import logging
import time
from typing import List

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
        raise NotImplementedError(
            "psi: the dataset is past the analysis trigger (chunk rows "
            f"{chunk_rows}); the exact chunked accumulation is not ported "
            "yet (ROADMAP A6) — set SHIFU_TPU_ANALYSIS_CHUNK_ROWS=0 to "
            "read it whole")

    cols = norm_proc.selected_candidates(ctx.column_configs)
    df = read_raw_table(mc)
    if mc.dataSet.filterExpressions:
        df = df.select(DataPurifier(mc.dataSet.filterExpressions).apply(df))
    if psi_col not in df:
        raise ValueError(f"psiColumnName {psi_col!r} not in data header")
    vocabs = {c.columnNum: (c.columnBinning.binCategory or [])
              for c in cols if c.is_categorical}
    dset = build_columnar(mc, norm_proc._restrict(ctx.column_configs, cols),
                          df, vocabs=vocabs)
    # build_columnar drops invalid-tag rows: align the cohorts with it
    tgt = simple_column_name(mc.dataSet.targetColumnName.split("|")[0])
    tags_all = parse_tags(string_column(df[tgt]), mc.pos_tags, mc.neg_tags)
    cohorts = string_column(df[psi_col])[~np.isnan(tags_all)]
    uniq, cohort_ids = np.unique(cohorts, return_inverse=True)
    uniq = [str(u) for u in uniq]
    cohort_t = torch.as_tensor(cohort_ids.reshape(-1), device=dev)

    cc_by_num = {c.columnNum: c for c in ctx.column_configs}
    rows: List[str] = []

    def finalize(per_cohort: np.ndarray, col_nums) -> None:
        # every kept row has a cohort: the all-rows distribution is the
        # sum over cohorts
        glob = per_cohort.sum(axis=0)
        for j, cn in enumerate(col_nums):
            cc = cc_by_num[int(cn)]
            g = glob[j] / max(glob[j].sum(), 1)
            unit = []
            for ui in range(len(uniq)):
                c_counts = per_cohort[ui, j]
                c_dist = c_counts / max(c_counts.sum(), 1)
                unit.append(stats_ops.psi_metric(c_dist, g))
            cc.columnStats.psi = float(np.mean(unit)) if unit else 0.0
            cc.columnStats.unitStats = [f"{u}:{v:.6f}"
                                        for u, v in zip(uniq, unit)]
            rows.append(f"{cc.columnName},{cc.columnStats.psi:.6f}," +
                        ",".join(f"{v:.6f}" for v in unit))

    if len(cohorts) and dset.numeric.shape[1]:
        num_by = {c.columnNum: c for c in cols if c.is_numerical}
        ordered = [num_by[int(n)] for n in dset.num_column_nums
                   if int(n) in num_by]
        cuts = build_numeric_table(ordered, mc.stats.maxNumBin).cuts
        bi = stats_ops.bin_index_numeric(
            torch.as_tensor(np.ascontiguousarray(dset.numeric, np.float32),
                            device=dev), torch.as_tensor(cuts, device=dev))
        finalize(cohort_bin_counts(bi, cohort_t, len(uniq),
                                   cuts.shape[0] + 2), dset.num_column_nums)
    if len(cohorts) and dset.cat_codes.shape[1]:
        vlen = max(len(v) for v in dset.vocabs)
        finalize(cohort_bin_counts(torch.as_tensor(dset.cleaned_codes(),
                                                   device=dev),
                                   cohort_t, len(uniq), vlen + 2),
                 dset.cat_column_nums)

    out = ctx.path_finder.psi_path()
    ctx.path_finder.ensure(out)
    with atomic_write(out) as f:
        f.write("column,psi," + ",".join(uniq) + "\n")
        f.write("\n".join(rows) + "\n")
    ctx.save_column_configs()
    if report is not None:
        report.update(rows=len(cohorts), cohorts=len(uniq))
    log.info("psi: %d cohorts × %d columns → %s in %.2fs", len(uniq),
             len(rows), out, time.time() - t0)
    return 0
