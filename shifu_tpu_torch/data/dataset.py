"""ColumnarDataset — the device-ready columnar view of a tabular dataset.

The port's copy of `shifu_tpu/data/dataset.py` over the reader's
`Table`: the whole table becomes float32 numeric values (NaN = missing)
and int32 categorical codes (-1 = missing), plus tag/weight vectors.
The numeric parse of string columns follows pandas' `to_numeric`
(`reader.to_numeric`), and `expand_group_vocab` is copied from
`shifu_tpu/ops/rebin.py`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from shifu_tpu_torch.config.column_config import ColumnConfig
from shifu_tpu_torch.data.reader import (Table, simple_column_name,
                                         string_column, to_numeric)

log = logging.getLogger("shifu_tpu_torch")

MISSING_CODE = -1  # categorical missing sentinel
GROUP_DELIM = "@^"  # rebin's category-group separator (ops/rebin.py)


@dataclass
class ColumnarDataset:
    """Columnar matrices for the *candidate* columns of a model set."""
    num_names: List[str]
    num_column_nums: np.ndarray        # (Cn,) int32 — ColumnConfig columnNum
    numeric: np.ndarray                # (R, Cn) float32, NaN = missing
    cat_names: List[str]
    cat_column_nums: np.ndarray        # (Cc,) int32
    cat_codes: np.ndarray              # (R, Cc) int32, -1 = missing
    vocabs: List[List[str]]            # per categorical column
    tags: np.ndarray                   # (R,) float32
    weights: np.ndarray                # (R,) float32
    meta: Dict[str, np.ndarray] = field(default_factory=dict)  # as strings
    task_tags: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), np.float32))

    @property
    def num_rows(self) -> int:
        return len(self.tags)

    def cleaned_codes(self) -> np.ndarray:
        """Category codes with missing → the vocab_len slot: the cleaned
        form tree models train on and score."""
        if not self.cat_codes.shape[1]:
            return self.cat_codes
        vlen = np.asarray([len(v) for v in self.vocabs], np.int32)
        return np.where(self.cat_codes < 0, vlen[None, :],
                        self.cat_codes).astype(np.int32)

    def select(self, row_mask: np.ndarray) -> "ColumnarDataset":
        return ColumnarDataset(
            num_names=self.num_names, num_column_nums=self.num_column_nums,
            numeric=self.numeric[row_mask],
            cat_names=self.cat_names, cat_column_nums=self.cat_column_nums,
            cat_codes=self.cat_codes[row_mask],
            vocabs=self.vocabs, tags=self.tags[row_mask],
            weights=self.weights[row_mask],
            meta={k: v[row_mask] for k, v in self.meta.items()},
            task_tags=(self.task_tags[row_mask] if self.task_tags.size
                       else self.task_tags))


def expand_group_vocab(vocab: List[str]) -> dict:
    """binCategory entries may be "@^"-joined groups after a rebin; map
    every member value to its group's bin index."""
    lut = {}
    for i, entry in enumerate(vocab):
        for v in str(entry).split(GROUP_DELIM):
            lut.setdefault(v, i)
    return lut


def _map_codes(sv: np.ndarray, lut: dict) -> np.ndarray:
    """`sv.map(lut).fillna(-1)` over the column's distinct values."""
    uniq, inv = np.unique(sv, return_inverse=True)
    codes = np.asarray([lut.get(v, MISSING_CODE) for v in uniq.tolist()],
                       np.int32)
    return codes[inv.reshape(-1)] if len(sv) else np.zeros(0, np.int32)


def parse_tags(raw: np.ndarray, pos_tags: Sequence[str],
               neg_tags: Sequence[str],
               classes: Optional[Sequence[str]] = None) -> np.ndarray:
    """tag string → 1.0 (pos) / 0.0 (neg) / NaN (unknown → row dropped);
    with `classes` (multi-class) the tag maps to its class index."""
    raw = np.char.strip(np.asarray(raw).astype(str))
    out = np.full(len(raw), np.nan, np.float32)
    if classes:
        for i, c in enumerate(classes):
            out[raw == str(c).strip()] = float(i)
        return out
    if pos_tags:
        out[np.isin(raw, list(pos_tags))] = 1.0
    if neg_tags:
        out[np.isin(raw, list(neg_tags))] = 0.0
    if not pos_tags and not neg_tags:
        out = to_numeric(raw).astype(np.float32)
    return out


def valid_tag_mask(mc, df: Table) -> np.ndarray:
    """The keep-mask build_columnar applies (invalid-tag rows dropped)."""
    names = [simple_column_name(t)
             for t in mc.dataSet.targetColumnName.split("|") if t.strip()]
    tgt = names[0] if names else None
    if not tgt or tgt not in df:
        return np.ones(len(df), bool)
    classes = mc.class_tags if mc.is_multi_classification else None
    tags = parse_tags(string_column(df[tgt]), mc.pos_tags, mc.neg_tags,
                      classes)
    return ~np.isnan(tags)


def build_columnar(mc, column_configs: List[ColumnConfig], df: Table,
                   vocabs: Optional[Dict[int, List[str]]] = None
                   ) -> ColumnarDataset:
    """Convert a raw table into columnar matrices using column
    types/flags from ColumnConfig. `vocabs` pins the categorical
    vocabulary (a previous stats run's binCategory)."""
    missing = [str(m) for m in mc.dataSet.missingOrInvalidValues]

    def _as_float(tok):
        try:
            return np.float32(tok)
        except ValueError:
            return None
    numeric_sentinels = np.asarray(
        [v for v in (_as_float(t) for t in missing) if v is not None],
        np.float32)
    cc_by_name = {c.columnName: c for c in column_configs}
    task_names = [simple_column_name(t)
                  for t in mc.dataSet.targetColumnName.split("|") if t.strip()]
    primary_target = task_names[0] if task_names else ""

    tag_col = weight_col = None
    task_cols: Dict[str, np.ndarray] = {}
    num_names, num_cols, cat_names, cat_cols = [], [], [], []
    num_mats, cat_mats, out_vocabs = [], [], []

    for col in df.columns:
        cc = cc_by_name.get(col)
        if cc is None:
            continue
        if df[col].dtype.kind == "f" and not cc.is_categorical \
                and not (cc.is_target or cc.is_weight or cc.is_meta
                         or cc.is_force_remove):
            # parsed by the C route: unparseable tokens are NaN already;
            # numeric missing sentinels still need masking
            vals = np.asarray(df[col], np.float32)
            if numeric_sentinels.size:
                vals = np.where(np.isin(vals, numeric_sentinels),
                                np.nan, vals)
            num_names.append(col)
            num_cols.append(cc.columnNum)
            num_mats.append(vals)
            continue
        sv = string_column(df[col])
        if cc.is_target:
            if tag_col is None or col == primary_target:
                tag_col = sv
            if col in task_names:
                task_cols[col] = sv
            continue
        if cc.is_weight:
            w = to_numeric(sv)
            weight_col = np.where(np.isnan(w), 1.0, w).astype(np.float32)
            continue
        if cc.is_meta or cc.is_force_remove:
            continue
        miss_mask = np.isin(sv, missing)
        if cc.is_categorical:
            if vocabs is not None and cc.columnNum in vocabs:
                vocab = list(vocabs[cc.columnNum])
                lut = expand_group_vocab(vocab)
            else:
                vocab = sorted(set(np.unique(sv[~miss_mask]).tolist()))
                lut = {v: i for i, v in enumerate(vocab)}
            codes = _map_codes(sv, lut)
            codes[miss_mask] = MISSING_CODE
            cat_names.append(col)
            cat_cols.append(cc.columnNum)
            cat_mats.append(codes)
            out_vocabs.append(vocab)
        else:
            vals = to_numeric(sv).astype(np.float32)
            vals[miss_mask] = np.nan
            num_names.append(col)
            num_cols.append(cc.columnNum)
            num_mats.append(vals)

    n_rows = len(df)
    classes = mc.class_tags if mc.is_multi_classification else None
    tags = parse_tags(tag_col, mc.pos_tags, mc.neg_tags, classes) \
        if tag_col is not None else np.full(n_rows, np.nan, np.float32)
    weights = weight_col if weight_col is not None \
        else np.ones(n_rows, np.float32)
    if len(task_names) > 1 and task_cols:
        task_tags = np.stack(
            [parse_tags(task_cols[t], mc.pos_tags, mc.neg_tags)
             if t in task_cols else np.full(n_rows, np.nan, np.float32)
             for t in task_names], axis=1)
    else:
        task_tags = np.zeros((n_rows, 0), np.float32)

    dset = ColumnarDataset(
        num_names=num_names,
        num_column_nums=np.asarray(num_cols, np.int32),
        numeric=(np.stack(num_mats, axis=1) if num_mats
                 else np.zeros((n_rows, 0), np.float32)),
        cat_names=cat_names,
        cat_column_nums=np.asarray(cat_cols, np.int32),
        cat_codes=(np.stack(cat_mats, axis=1) if cat_mats
                   else np.zeros((n_rows, 0), np.int32)),
        vocabs=out_vocabs, tags=tags, weights=weights, task_tags=task_tags)

    # drop rows with unknown tags (reference skips invalid-tag records)
    valid = ~np.isnan(tags)
    if not valid.all():
        if not valid.any() and tag_col is not None:
            observed = sorted(set(np.asarray(tag_col, str)))[:10]
            raise ValueError(
                f"no row's {mc.dataSet.targetColumnName!r} value matches "
                f"posTags {mc.pos_tags} / negTags {mc.neg_tags}; observed "
                f"tag values include {observed} — fix dataSet#posTags/"
                "negTags (or configure >2 tags for multi-class)")
        log.warning("dropping %d/%d rows whose tag matches neither "
                    "posTags nor negTags", int((~valid).sum()), n_rows)
        dset = dset.select(valid)
    return dset
