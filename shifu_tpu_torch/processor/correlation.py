"""`shifu stats -correlation` — Pearson correlation across columns, the
resident path of `shifu_tpu/processor/correlation.py`
(`core/correlation/CorrelationMapper.java:52`, `CorrelationReducer`).

The C×C matrix comes from four f32 GEMMs over the co-valid masks
(`pearson_moments`: pairwise counts, sums, sums of squares and cross
products), plain `torch.matmul` on `device` with TF32 off (the JAX
package computes them in XLA, outside any Pallas kernel); the matrix is
finished in float64 on the host (`pearson_from_moments`). The port
centres each column by its mean before the GEMMs, which Pearson does
not see but the f32 sums do: the JAX package's raw moments cancel on a
column whose mean² dwarfs its variance. Categorical
columns enter as their `posRate` encoding through the port's own
`ops/normalize` tables. A raw set past the analysis trigger, which the
JAX package streams in exact chunks, raises (ROADMAP A6).
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from shifu_tpu_torch.fileio import atomic_write
from shifu_tpu_torch.processor import norm as norm_proc
from shifu_tpu_torch.processor.base import ProcessorContext
from shifu_tpu_torch.processor.chunking import analysis_chunk_rows

log = logging.getLogger("shifu_tpu_torch")


def pearson_moments(x: torch.Tensor, shift: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """(R, C) with NaN missing → the four (C, C) pairwise co-valid
    moment matrices (n, s, ss, p) of ``x - shift`` (shift (C,), default
    none); pure sums. Pearson is the same for any per-column shift, and
    a shift near each column's mean keeps `p/n - mean_i·mean_j` from
    cancelling in f32."""
    valid = ~torch.isnan(x)
    xv = torch.where(valid, x if shift is None else x - shift, 0.0)
    v = valid.to(xv.dtype)
    n = v.T @ v                           # pairwise co-valid counts
    s = xv.T @ v                          # pairwise sums of x over co-valid
    ss = (xv * xv).T @ v                  # pairwise sums of x^2
    p = xv.T @ xv                         # pairwise cross products
    return n, s, ss, p


def pearson_from_moments(n, s, ss, p) -> np.ndarray:
    """Finish the Pearson matrix from (summed) co-valid moments."""
    n = np.maximum(np.asarray(n, np.float64), 1.0)
    s = np.asarray(s, np.float64)
    ss = np.asarray(ss, np.float64)
    p = np.asarray(p, np.float64)
    mean_i = s / n
    mean_j = s.T / n
    cov = p / n - mean_i * mean_j
    var_i = ss / n - mean_i ** 2
    var_j = ss.T / n - mean_j ** 2
    denom = np.sqrt(np.maximum(var_i, 1e-12) * np.maximum(var_j, 1e-12))
    return np.clip(cov / denom, -1.0, 1.0)


def _feature_block(ctx: ProcessorContext, cols, dev: torch.device
                   ) -> Tuple[torch.Tensor, List[str]]:
    """(x, names): numeric raw values + categorical posRate encodings
    (like NormPearson mode correlating normalized values), x on
    `dev`."""
    from shifu_tpu_torch.ops.normalize import (build_categorical_table,
                                               gather_cat_lut)
    mc = ctx.model_config
    dset = norm_proc.load_dataset_for_columns(mc, ctx.column_configs, cols)
    blocks, names = [], []
    if dset.numeric.shape[1]:
        blocks.append(torch.as_tensor(
            np.ascontiguousarray(dset.numeric, np.float32), device=dev))
        names.extend(dset.num_names)
    if dset.cat_codes.shape[1]:
        cat_by_num = {c.columnNum: c for c in cols if c.is_categorical}
        ordered = [cat_by_num[int(n)] for n in dset.cat_column_nums
                   if int(n) in cat_by_num]
        tbl = build_categorical_table(ordered)
        blocks.append(gather_cat_lut(
            torch.as_tensor(np.ascontiguousarray(dset.cat_codes),
                            device=dev),
            torch.as_tensor(tbl.pos_rate, device=dev),
            torch.as_tensor(tbl.vocab_len, device=dev)).to(torch.float32))
        names.extend(dset.cat_names)
    return torch.cat(blocks, dim=1), names


def run(ctx: ProcessorContext, device: "str | torch.device" = "cuda",
        report=None) -> int:
    """Write correlation.csv. `report`, when given, receives the rows
    (``rows``) and the columns (``columns``) of the matrix."""
    from shifu_tpu_torch import resolve_device
    dev = resolve_device(device)
    t0 = time.time()
    ctx.require_columns()
    cols = norm_proc.selected_candidates(ctx.column_configs)
    chunk_rows = analysis_chunk_rows(ctx)
    if chunk_rows:
        raise NotImplementedError(
            "correlation: the dataset is past the analysis trigger "
            f"(chunk rows {chunk_rows}); the exact chunked accumulation is "
            "not ported yet (ROADMAP A6) — set "
            "SHIFU_TPU_ANALYSIS_CHUNK_ROWS=0 to read it whole")
    x, names = _feature_block(ctx, cols, dev)
    if not x.shape[0]:
        raise ValueError(
            "correlation: no valid rows — check filterExpressions / "
            "pos+neg tags against the data")
    # f32 GEMMs over the columns centred by their f32 means, finished in
    # f64 on the host: the JAX package's raw moments lose ~1e-5 of a
    # Pearson value to cancellation on a posRate column (mean² ≫
    # variance) at 262,144 rows
    shift = torch.nan_to_num(torch.nanmean(x, dim=0))
    acc = [m.cpu().numpy().astype(np.float64)
           for m in pearson_moments(x, shift)]
    corr = pearson_from_moments(*acc)
    if report is not None:
        report.update(rows=int(x.shape[0]), columns=len(names))

    out = ctx.path_finder.correlation_path()
    ctx.path_finder.ensure(out)
    with atomic_write(out) as f:
        f.write("column," + ",".join(names) + "\n")
        for i, n in enumerate(names):
            f.write(n + "," + ",".join(f"{v:.6f}" for v in corr[i]) + "\n")
    log.info("correlation: %dx%d matrix → %s in %.2fs", len(names),
             len(names), out, time.time() - t0)
    return 0
