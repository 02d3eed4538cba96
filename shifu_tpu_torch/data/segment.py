"""Segment (column) expansion — per-segment variable copies.

The port's copy of `shifu_tpu/data/segment.py` over the reader's
`Table`. With K filter expressions in `dataSet#segExpressionFile` and
N base columns, every column i gains K copies named `<name>_seg<k>`
with columnNum = k*N + i, marked `segment: true`; a copy's value is the
base value on rows passing filter k and missing elsewhere
(`MapReducerStatsWorker.java:655-672`, `BasicUpdater.java:231-249`).
Target and Weight flags both become Meta on the copies.
"""

from __future__ import annotations

import logging
import os
import re
from typing import List, Optional

import numpy as np

from shifu_tpu_torch.config.column_config import ColumnConfig, ColumnFlag
from shifu_tpu_torch.data.purifier import DataPurifier
from shifu_tpu_torch.data.reader import Table

log = logging.getLogger("shifu_tpu_torch")

_SEG_SUFFIX = re.compile(r"_seg[0-9]+$")


def seg_name(name: str, k: int) -> str:
    return f"{name}_seg{k}"


def base_name(name: str) -> str:
    """Strip the `_seg<k>` suffix (`CommonUtils.getSimpleColumnName`)."""
    return _SEG_SUFFIX.sub("", name)


def segment_expressions(mc) -> List[str]:
    """Filter expressions from dataSet#segExpressionFile, one per line;
    blank lines and #-comments skipped. Missing file → warn + empty."""
    f = str(mc.dataSet._extras.get("segExpressionFile") or "").strip()
    if not f:
        return []
    path = mc.resolve_path(f)
    if not os.path.exists(path):
        log.warning("segExpressionFile %s does not exist; segment "
                    "expansion disabled", path)
        return []
    with open(path) as fh:
        return [ln.strip() for ln in fh
                if ln.strip() and not ln.strip().startswith("#")]


def expand_column_configs(base: List[ColumnConfig],
                          exprs: List[str]) -> List[ColumnConfig]:
    """Segment ColumnConfigs for K expressions: copy k of column i gets
    columnNum = k*N + i and name `<name>_seg<k>`."""
    n = len(base)
    out: List[ColumnConfig] = []
    for k in range(1, len(exprs) + 1):
        for cc in base:
            flag = cc.columnFlag
            if flag in (ColumnFlag.Target, ColumnFlag.Weight):
                flag = ColumnFlag.Meta
            seg = ColumnConfig(
                columnNum=k * n + cc.columnNum,
                columnName=seg_name(cc.columnName, k),
                version=cc.version, columnType=cc.columnType,
                columnFlag=flag)
            seg._extras["segment"] = True
            out.append(seg)
    return out


def expand_raw_frame(df: Table, mc, exprs: List[str],
                     only_bases: Optional[set] = None) -> Table:
    """Append `<col>_seg<k>` columns: the base value where filter k
    passes, the missing token elsewhere (NaN for float columns).
    `only_bases` limits the copies to those base columns."""
    if not exprs:
        return df
    missing_token = (mc.dataSet.missingOrInvalidValues or [""])[0]
    wanted = [c for c in df.columns
              if only_bases is None or c in only_bases]
    extra = {}
    for k, expr in enumerate(exprs, start=1):
        mask = DataPurifier(expr).apply(df)
        for col in wanted:
            v = df[col]
            other = np.nan if v.dtype.kind == "f" else missing_token
            extra[seg_name(col, k)] = np.where(mask, v, other).astype(
                v.dtype if v.dtype.kind == "f" else str)
    return df.with_columns(extra)
