"""Per-date per-column stats — the port of
`shifu_tpu/processor/datestat.py` (`core/datestat/DateStatCompute*`,
wired in `MapReducerStatsWorker.java:296-321`): when
`dataSet#dateColumnName` is set, `stats` gives every numeric column its
count / missing / mean / stdDev / min / max / sum and positive count per
distinct date value, written to `DateStats.csv`.

The date column becomes segment ids and every metric is one
`index_add_` (sums, f32 as in the JAX package) or `scatter_reduce`
(amin / amax) over the (rows × columns) matrix on `device`.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from shifu_tpu_torch.data.dataset import ColumnarDataset
from shifu_tpu_torch.fileio import atomic_write
from shifu_tpu_torch.processor.base import ProcessorContext

log = logging.getLogger("shifu_tpu_torch")

METRICS = ["count", "missing", "mean", "stdDev", "min", "max", "sum",
           "posCount"]


def date_column_name(mc) -> str:
    return str(mc.dataSet._extras.get("dateColumnName") or "").strip()


def compute_date_stats(values: np.ndarray, tags: np.ndarray,
                       date_ids: np.ndarray, n_dates: int,
                       device: "str | torch.device" = "cuda"
                       ) -> Dict[str, np.ndarray]:
    """(R, C) values (NaN missing) + (R,) date segment ids → dict of
    (D, C) arrays."""
    dev = torch.device(device)
    v = torch.as_tensor(np.ascontiguousarray(values, np.float32),
                        device=dev)
    ids = torch.as_tensor(np.asarray(date_ids, np.int64), device=dev)
    miss = torch.isnan(v)
    valid = (~miss).to(torch.float32)
    filled = torch.where(miss, 0.0, v)
    pos = torch.as_tensor((np.asarray(tags) > 0.5).astype(np.float32),
                          device=dev)[:, None]

    def seg_sum(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((n_dates, x.shape[1]), dtype=torch.float32,
                          device=dev)
        return out.index_add_(0, ids, x)

    def seg_ext(x: torch.Tensor, how: str, fill: float) -> torch.Tensor:
        out = torch.full((n_dates, x.shape[1]), fill, dtype=torch.float32,
                         device=dev)
        idx = ids[:, None].expand_as(x)
        return out.scatter_reduce_(0, idx, x, reduce=how, include_self=True)

    cnt = seg_sum(valid)
    s = seg_sum(filled)
    s2 = seg_sum(torch.square(filled))
    missing = seg_sum(miss.to(torch.float32))
    pos_cnt = seg_sum(pos.expand_as(v) * valid)
    vmin = seg_ext(torch.where(miss, torch.inf, v), "amin", torch.inf)
    vmax = seg_ext(torch.where(miss, -torch.inf, v), "amax", -torch.inf)
    mean = s / torch.clamp_min(cnt, 1.0)
    var = s2 / torch.clamp_min(cnt, 1.0) - torch.square(mean)
    out = {"count": cnt, "missing": missing, "sum": s, "mean": mean,
           "stdDev": torch.sqrt(torch.clamp_min(var, 0.0)), "min": vmin,
           "max": vmax, "posCount": pos_cnt}
    return {k: a.cpu().numpy() for k, a in out.items()}


def run(ctx: ProcessorContext, df=None,
        dataset: Optional[ColumnarDataset] = None,
        device: "str | torch.device" = "cuda") -> int:
    """Compute + write DateStats.csv. `df` (the already-read, filtered
    raw table) avoids a second read when called from stats; the built
    dataset drops invalid-tag rows, so the date column is aligned
    through the same valid-tag mask."""
    from shifu_tpu_torch.data.dataset import build_columnar, valid_tag_mask
    from shifu_tpu_torch.data.reader import string_column
    t0 = time.time()
    mc = ctx.model_config
    date_col = date_column_name(mc)
    if not date_col:
        log.warning("dataSet#dateColumnName not set; skipping date stats")
        return 0
    ctx.require_columns()
    if df is None:
        from shifu_tpu_torch.data.purifier import DataPurifier
        from shifu_tpu_torch.data.reader import read_raw_table
        df = read_raw_table(mc)
        df = df.select(DataPurifier(mc.dataSet.filterExpressions).apply(df))
    if date_col not in df:
        raise ValueError(f"dateColumnName {date_col!r} not in data "
                         f"header {list(df.columns)[:8]}...")
    dates_raw = string_column(df[date_col])[valid_tag_mask(mc, df)]
    if dataset is None:
        dataset = build_columnar(
            mc, [c for c in ctx.column_configs if not c.is_segment], df)
    if len(dates_raw) != dataset.num_rows:
        raise ValueError("date column misaligned with the built dataset")

    uniq, date_ids = np.unique(dates_raw, return_inverse=True)
    stats = compute_date_stats(dataset.numeric, dataset.tags,
                               date_ids.reshape(-1), len(uniq), device)

    out = ctx.path_finder.date_stats_path()
    ctx.path_finder.ensure(out)
    with atomic_write(out, "w") as f:
        f.write("date,column," + ",".join(METRICS) + "\n")
        for d in range(len(uniq)):
            for j, name in enumerate(dataset.num_names):
                f.write(f"{uniq[d]},{name},"
                        + ",".join(f"{stats[m][d, j]:.6g}"
                                   for m in METRICS) + "\n")
    log.info("date stats: %d dates × %d columns → %s in %.2fs",
             len(uniq), len(dataset.num_names), out, time.time() - t0)
    return 0
