"""Normalization — all 29 NormType families over whole column blocks.

The port of `shifu_tpu/ops/normalize.py`: the per-column parameter
tables (`build_numeric_table`, `build_categorical_table`) are built on
the host exactly as there; each family is plain PyTorch elementwise or
gather work over the (rows × cols) block on the caller's device (the
card for `norm --device cuda`). Reference semantics
(`core/Normalizer.java:124-380`):

- z-score clamps to mean ± cutoff·std and yields 0 when std < 1e-5
  (`Normalizer.computeZScore`); missing numerics default to the mean;
- categorical values map to their bin's posRate for z-score families;
- WOE families read binCountWoe/binWeightedWoe with the trailing
  missing bin; WOE_ZSCORE standardizes WOE by its count-weighted
  mean/std;
- ONEHOT, INDEX and the *_APPEND_INDEX families expand or add an index
  block.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from shifu_tpu_torch.config.column_config import ColumnConfig
from shifu_tpu_torch.config.model_config import NormType
from shifu_tpu_torch.ops.stats import bin_index_numeric

STD_EPS = 1e-5  # Normalizer.computeZScore stdDev > 0.00001 guard


# ---------------------------------------------------------------------------
# Per-column parameter tables (host-built, device-consumed)
# ---------------------------------------------------------------------------

@dataclass
class NumericNormTable:
    """Stacked per-column parameters for the numeric block."""
    mean: np.ndarray          # (C,)
    std: np.ndarray           # (C,)
    vmin: np.ndarray          # (C,)
    vmax: np.ndarray          # (C,)
    cuts: np.ndarray          # (B-1, C) interior boundaries, +inf padded
    woe: np.ndarray           # (C, B+1) bin woe incl. trailing missing bin
    weighted_woe: np.ndarray  # (C, B+1)
    woe_mean: np.ndarray      # (C,) count-weighted woe mean
    woe_std: np.ndarray       # (C,)
    w_woe_mean: np.ndarray
    w_woe_std: np.ndarray
    bin_lower: np.ndarray     # (C, B+1) discrete-zscore value per bin
    n_bins: np.ndarray        # (C,) real bin count per column


@dataclass
class CategoricalNormTable:
    """Stacked per-column parameters for the categorical block."""
    pos_rate: np.ndarray      # (C, V+1) bin posRate, trailing missing slot
    woe: np.ndarray           # (C, V+1)
    weighted_woe: np.ndarray  # (C, V+1)
    woe_mean: np.ndarray      # (C,)
    woe_std: np.ndarray
    w_woe_mean: np.ndarray
    w_woe_std: np.ndarray
    mean: np.ndarray          # (C,) column mean (of posrate-encoded values)
    std: np.ndarray
    vocab_len: np.ndarray     # (C,) int32


def _woe_mean_std(woe: np.ndarray, pos: np.ndarray, neg: np.ndarray) -> Tuple[float, float]:
    """Count-weighted WOE mean/std (`Normalizer.calculateWoeMeanAndStdDev`)."""
    cnt = np.asarray(pos, np.float64) + np.asarray(neg, np.float64)
    total = cnt.sum()
    if total <= 1:
        return 0.0, 0.0
    w = np.asarray(woe, np.float64)
    s = float(np.sum(w * cnt))
    sq = float(np.sum(w * w * cnt))
    mean = s / total
    std = float(np.sqrt(abs((sq - s * s / total) / (total - 1))))
    return mean, std


def _padded(rows: List[np.ndarray], width: int, fill: float) -> np.ndarray:
    out = np.full((len(rows), width), fill, np.float32)
    for i, r in enumerate(rows):
        out[i, :min(len(r), width)] = r[:width]
    return out


def build_numeric_table(ccs: List[ColumnConfig], max_bins: int) -> NumericNormTable:
    """Stack ColumnConfig binning/stats of numeric columns into LUTs.
    `ccs` must be the numeric candidate columns in matrix order."""
    c = len(ccs)
    mean = np.zeros(c, np.float32)
    std = np.ones(c, np.float32)
    vmin = np.zeros(c, np.float32)
    vmax = np.ones(c, np.float32)
    cuts = np.full((max(max_bins - 1, 1), c), np.inf, np.float32)
    woe_rows, wwoe_rows, lower_rows = [], [], []
    n_bins = np.zeros(c, np.int32)
    wm = np.zeros((4, c), np.float32)  # woe_mean, woe_std, w_woe_mean, w_woe_std
    for j, cc in enumerate(ccs):
        st, bn = cc.columnStats, cc.columnBinning
        mean[j] = st.mean if st.mean is not None else 0.0
        std[j] = st.stdDev if st.stdDev is not None else 1.0
        vmin[j] = st.min if st.min is not None else 0.0
        vmax[j] = st.max if st.max is not None else 1.0
        bb = np.asarray(bn.binBoundary or [-np.inf], np.float64)
        interior = bb[1:]
        interior = interior[np.isfinite(interior)]
        cuts[:len(interior), j] = interior
        k = len(interior) + 1
        n_bins[j] = k
        woe = np.asarray(bn.binCountWoe or np.zeros(k + 1), np.float64)
        wwoe = np.asarray(bn.binWeightedWoe if bn.binWeightedWoe is not None
                          else woe, np.float64)
        woe_rows.append(woe)
        wwoe_rows.append(wwoe)
        pos = np.asarray(bn.binCountPos or np.zeros(len(woe)), np.float64)
        neg = np.asarray(bn.binCountNeg or np.zeros(len(woe)), np.float64)
        wm[0, j], wm[1, j] = _woe_mean_std(woe, pos, neg)
        wm[2, j], wm[3, j] = _woe_mean_std(wwoe, pos, neg)
        # discrete-zscore values: bin0 → min, bin i → boundary i, missing → mean
        lower = np.concatenate(([vmin[j]], interior, [mean[j]]))
        lower_rows.append(lower)
    width = max_bins + 1
    return NumericNormTable(
        mean=mean, std=std, vmin=vmin, vmax=vmax, cuts=cuts,
        woe=_padded(woe_rows, width, 0.0),
        weighted_woe=_padded(wwoe_rows, width, 0.0),
        woe_mean=wm[0], woe_std=wm[1], w_woe_mean=wm[2], w_woe_std=wm[3],
        bin_lower=_padded(lower_rows, width, 0.0), n_bins=n_bins)


def build_categorical_table(ccs: List[ColumnConfig]) -> CategoricalNormTable:
    """Stack categorical ColumnConfigs; slot layout matches the codes
    produced by `build_columnar` with the column's binCategory as vocab
    (missing/unseen = trailing slot)."""
    c = len(ccs)
    vlen = np.asarray([len(cc.columnBinning.binCategory or []) for cc in ccs],
                      np.int32)
    width = int(vlen.max()) + 1 if c else 1
    pr_rows, woe_rows, wwoe_rows = [], [], []
    wm = np.zeros((4, c), np.float32)
    mean = np.zeros(c, np.float32)
    std = np.ones(c, np.float32)
    for j, cc in enumerate(ccs):
        bn, st = cc.columnBinning, cc.columnStats
        k = vlen[j]
        pr = np.asarray(bn.binPosRate or np.zeros(k + 1), np.float64)
        woe = np.asarray(bn.binCountWoe or np.zeros(k + 1), np.float64)
        wwoe = np.asarray(bn.binWeightedWoe if bn.binWeightedWoe is not None
                          else woe, np.float64)
        pr_rows.append(pr)
        woe_rows.append(woe)
        wwoe_rows.append(wwoe)
        pos = np.asarray(bn.binCountPos or np.zeros(len(woe)), np.float64)
        neg = np.asarray(bn.binCountNeg or np.zeros(len(woe)), np.float64)
        wm[0, j], wm[1, j] = _woe_mean_std(woe, pos, neg)
        wm[2, j], wm[3, j] = _woe_mean_std(wwoe, pos, neg)
        mean[j] = st.mean if st.mean is not None else 0.0
        std[j] = st.stdDev if st.stdDev is not None else 1.0
    return CategoricalNormTable(
        pos_rate=_padded(pr_rows, width, 0.0),
        woe=_padded(woe_rows, width, 0.0),
        weighted_woe=_padded(wwoe_rows, width, 0.0),
        woe_mean=wm[0], woe_std=wm[1], w_woe_mean=wm[2], w_woe_std=wm[3],
        mean=mean, std=std, vocab_len=vlen)


# ---------------------------------------------------------------------------
# Device transforms (plain PyTorch on the block's device)
# ---------------------------------------------------------------------------

def zscore(values: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
           cutoff: float) -> torch.Tensor:
    """`Normalizer.computeZScore` over an (N, C) block: NaN (missing) →
    mean, clamp to mean ± cutoff·std, divide by std; exactly 0 where
    std < STD_EPS."""
    tiny = std < STD_EPS
    v = torch.where(torch.isnan(values), mean[None, :], values)
    v = torch.clamp(v, (mean - cutoff * std)[None, :],
                    (mean + cutoff * std)[None, :])
    z = (v - mean[None, :]) / torch.where(tiny, 1.0, std)[None, :]
    return torch.where(tiny[None, :], 0.0, z)


def maxmin(values: torch.Tensor, vmin: torch.Tensor,
           vmax: torch.Tensor) -> torch.Tensor:
    rng = vmax - vmin
    ok = rng > 1e-7
    v = torch.where(torch.isnan(values), vmin[None, :], values)
    out = (v - vmin[None, :]) / torch.where(ok, rng, 1.0)[None, :]
    return torch.where(ok[None, :], out, 0.0)


def gather_bin_lut(bin_idx: torch.Tensor, lut: torch.Tensor,
                   n_bins: torch.Tensor) -> torch.Tensor:
    """out[r,c] = lut[c, min(bin_idx[r,c], n_bins[c])] — the clamp routes
    the fixed missing slot onto each column's real missing bin."""
    idx = torch.minimum(bin_idx.long(), n_bins.long()[None, :])
    return torch.gather(lut, 1, idx.T.contiguous()).T


def gather_cat_lut(codes: torch.Tensor, lut: torch.Tensor,
                   vocab_len: torch.Tensor) -> torch.Tensor:
    """Categorical value lookup; code −1 (missing/unseen) → the trailing
    missing slot at vocab_len[c]."""
    idx = torch.where(codes < 0, vocab_len.to(codes.dtype)[None, :], codes)
    idx = torch.clamp(idx.long(), max=lut.shape[1] - 1)
    return torch.gather(lut, 1, idx.T.contiguous()).T


# ---------------------------------------------------------------------------
# Family dispatch
# ---------------------------------------------------------------------------

@dataclass
class NormResult:
    """Normalized output blocks (host numpy).

    dense: (R, F) float32 model inputs (NN/LR/GBT consume this).
    index: (R, K) int32 embedding indices (WDL/MTL; missing = vocab_len).
    dense_names / index_names: per-output column names.
    index_vocab_sizes: embedding table sizes (vocab_len + 1 missing slot).
    zscore_params: (mean, std) per dense column when `dense` is exactly
    zscore(raw numeric) — a ZSCORE/ZSCALE run with no categorical block.
    """
    dense: np.ndarray
    dense_names: List[str]
    index: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), np.int32))
    index_names: List[str] = field(default_factory=list)
    index_vocab_sizes: List[int] = field(default_factory=list)
    zscore_params: Optional[Tuple[np.ndarray, np.ndarray]] = None


def _t(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


def _num_family_value(norm_type: NormType, values: torch.Tensor,
                      tbl: NumericNormTable, cutoff: float) -> torch.Tensor:
    """Dense transform of the numeric block for a given family."""
    dev = values.device
    cuts = _t(tbl.cuts, dev)
    n_bins = _t(tbl.n_bins, dev)

    def lut(a):
        return gather_bin_lut(bin_index_numeric(values, cuts), _t(a, dev),
                              n_bins)

    if norm_type in (NormType.WOE, NormType.WOE_INDEX,
                     NormType.WOE_APPEND_INDEX, NormType.ASIS_WOE):
        return lut(tbl.woe)
    if norm_type is NormType.WEIGHT_WOE:
        return lut(tbl.weighted_woe)
    if norm_type in (NormType.WOE_ZSCORE, NormType.WOE_ZSCALE,
                     NormType.WOE_ZSCALE_INDEX,
                     NormType.WOE_ZSCALE_APPEND_INDEX):
        return zscore(lut(tbl.woe), _t(tbl.woe_mean, dev),
                      _t(tbl.woe_std, dev), cutoff)
    if norm_type in (NormType.WEIGHT_WOE_ZSCORE, NormType.WEIGHT_WOE_ZSCALE):
        return zscore(lut(tbl.weighted_woe), _t(tbl.w_woe_mean, dev),
                      _t(tbl.w_woe_std, dev), cutoff)
    if norm_type in (NormType.DISCRETE_ZSCORE, NormType.DISCRETE_ZSCALE):
        return zscore(lut(tbl.bin_lower), _t(tbl.mean, dev),
                      _t(tbl.std, dev), cutoff)
    if norm_type is NormType.MAXMIN_INDEX:
        return maxmin(values, _t(tbl.vmin, dev), _t(tbl.vmax, dev))
    if norm_type is NormType.ASIS_PR:
        return torch.where(torch.isnan(values), _t(tbl.mean, dev)[None, :],
                           values)
    # default: the z-score families (ZSCORE/ZSCALE/OLD_*/ZSCALE_ORDINAL/
    # ZSCALE_ONEHOT numeric side/*_INDEX zscale / APPEND_INDEX)
    return zscore(values, _t(tbl.mean, dev), _t(tbl.std, dev), cutoff)


def _cat_family_value(norm_type: NormType, codes: torch.Tensor,
                      tbl: CategoricalNormTable,
                      cutoff: float) -> torch.Tensor:
    """Dense transform of the categorical block (families that keep
    categoricals dense)."""
    dev = codes.device
    vl = _t(tbl.vocab_len, dev)

    def lut(a):
        return gather_cat_lut(codes, _t(a, dev), vl)

    if norm_type.is_woe or norm_type is NormType.ASIS_WOE or \
            norm_type in (NormType.HYBRID,):
        woe = lut(tbl.weighted_woe if norm_type.is_weighted else tbl.woe)
        if norm_type in (NormType.WOE_ZSCORE, NormType.WOE_ZSCALE):
            return zscore(woe, _t(tbl.woe_mean, dev), _t(tbl.woe_std, dev),
                          cutoff)
        if norm_type in (NormType.WEIGHT_WOE_ZSCORE,
                         NormType.WEIGHT_WOE_ZSCALE):
            return zscore(woe, _t(tbl.w_woe_mean, dev),
                          _t(tbl.w_woe_std, dev), cutoff)
        return woe
    if norm_type is NormType.WEIGHT_HYBRID:
        return lut(tbl.weighted_woe)
    if norm_type in (NormType.ZSCALE_ORDINAL,):
        return torch.where(codes < 0, vl.to(codes.dtype)[None, :],
                           codes).float()
    if norm_type in (NormType.OLD_ZSCORE, NormType.OLD_ZSCALE,
                     NormType.ASIS_PR):
        # posRate value, not z-scored (Normalizer.java:545-547)
        return lut(tbl.pos_rate)
    # default z-score families: posRate then z-score (parseRawValue)
    return zscore(lut(tbl.pos_rate), _t(tbl.mean, dev), _t(tbl.std, dev),
                  cutoff)


def _onehot_block(idx: torch.Tensor, widths: np.ndarray, names: List[str]):
    """Expand int bin/cat indices (R, C) to concatenated one-hot columns
    (missing gets its own slot, matching OneHotNormalize)."""
    cols, out_names = [], []
    for j, w in enumerate(widths):
        w = int(w) + 1
        eye = torch.eye(w, dtype=torch.float32, device=idx.device)
        cols.append(eye[torch.clamp(idx[:, j].long(), 0, w - 1)])
        out_names.extend(f"{names[j]}_{k}" for k in range(w))
    if not cols:
        return torch.zeros((idx.shape[0], 0), device=idx.device), []
    return torch.cat(cols, dim=1), out_names


def normalize_dataset(norm_type: NormType, cutoff: float,
                      numeric: np.ndarray, num_names: List[str],
                      num_tbl: Optional[NumericNormTable],
                      cat_codes: np.ndarray, cat_names: List[str],
                      cat_tbl: Optional[CategoricalNormTable],
                      device: "str | torch.device" = "cuda") -> NormResult:
    """Full-dataset normalization: raw columnar blocks → model inputs,
    computed on `device` and returned on the host. Numeric block first,
    categorical block second; ONEHOT and APPEND_INDEX expand in place
    (`Normalizer.normalize`/`fullNormalize` dispatch)."""
    dev = torch.device(device)
    r = numeric.shape[0] if numeric.size else cat_codes.shape[0]
    dense_parts: List[torch.Tensor] = []
    dense_names: List[str] = []
    index_parts: List[torch.Tensor] = []
    index_names: List[str] = []
    index_vocabs: List[int] = []

    has_num = num_tbl is not None and numeric.shape[1] > 0
    has_cat = cat_tbl is not None and cat_codes.shape[1] > 0

    if has_num:
        jv = _t(np.asarray(numeric, np.float32), dev)

        def bins():
            bi = bin_index_numeric(jv, _t(num_tbl.cuts, dev))
            return torch.minimum(bi, _t(num_tbl.n_bins, dev)[None, :])

        if norm_type is NormType.ONEHOT:
            block, names = _onehot_block(bins(), num_tbl.n_bins, num_names)
            dense_parts.append(block)
            dense_names.extend(names)
        elif norm_type is NormType.INDEX:
            index_parts.append(bins().to(torch.int32))
            index_names.extend(num_names)
            index_vocabs.extend((num_tbl.n_bins + 1).tolist())
        else:
            dense_parts.append(_num_family_value(norm_type, jv, num_tbl,
                                                 cutoff))
            dense_names.extend(num_names)
            if norm_type in (NormType.ZSCALE_APPEND_INDEX,
                             NormType.ZSCORE_APPEND_INDEX,
                             NormType.WOE_APPEND_INDEX,
                             NormType.WOE_ZSCALE_APPEND_INDEX):
                index_parts.append(bins().to(torch.int32))
                index_names.extend(num_names)
                index_vocabs.extend((num_tbl.n_bins + 1).tolist())

    if has_cat:
        jc = _t(np.asarray(cat_codes, np.int32), dev)
        vl = _t(cat_tbl.vocab_len, dev)
        filled = torch.where(jc < 0, vl[None, :], jc)
        if norm_type in (NormType.ONEHOT, NormType.ZSCALE_ONEHOT):
            block, names = _onehot_block(filled, cat_tbl.vocab_len,
                                         cat_names)
            dense_parts.append(block)
            dense_names.extend(names)
        elif norm_type.is_index:
            index_parts.append(filled.to(torch.int32))
            index_names.extend(cat_names)
            index_vocabs.extend((cat_tbl.vocab_len + 1).tolist())
        else:
            dense_parts.append(_cat_family_value(norm_type, jc, cat_tbl,
                                                 cutoff))
            dense_names.extend(cat_names)

    dense = (torch.cat(dense_parts, dim=1).float().cpu().numpy()
             if dense_parts else np.zeros((r, 0), np.float32))
    index = (torch.cat(index_parts, dim=1).cpu().numpy() if index_parts
             else np.zeros((r, 0), np.int32))
    zs = ((num_tbl.mean, num_tbl.std)
          if (norm_type in (NormType.ZSCORE, NormType.ZSCALE)
              and has_num and not has_cat) else None)
    return NormResult(dense=dense, dense_names=dense_names, index=index,
                      index_names=index_names,
                      index_vocab_sizes=index_vocabs, zscore_params=zs)
