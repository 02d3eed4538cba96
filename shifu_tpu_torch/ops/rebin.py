"""Dynamic re-binning — `shifu stats -rebin`; a copy of the JAX
package's `shifu_tpu/ops/rebin.py` (pure numpy).

Merges a column's existing bins (from ColumnConfig.json, no data pass)
into fewer, higher-IV bins, mirroring
`core/binning/ColumnConfigDynamicBinning.java` +
`core/binning/AutoDynamicBinning.java` +
`core/processor/StatsModelProcessor.doReBin` (:712-790):

1. (categorical) sort bins by positive rate so adjacent merges group
   similar-risk categories;
2. merge down to `expect_bin_num` by repeatedly fusing the adjacent
   pair with the smallest entropy increase (AutoDynamicBinning);
3. fold bins under `min_inst_cnt` into the neighbor with the closer
   positive rate (ColumnConfigDynamicBinning.mergeSmallBinInfos);
4. keep shrinking one bin at a time while IV stays ≥
   iv_keep_ratio × original IV.

Merged categorical groups join their raw values with "@^"
(Constants.CATEGORICAL_GROUP_VAL_DELIMITER); the group becomes ONE
binCategory entry whose members all map to that bin.

This is deliberately host-side numpy: it operates on per-column bin
arrays (≤ maxNumBin entries), far below what a launch on the card would
pay for.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from shifu_tpu_torch.config.column_config import ColumnConfig
from shifu_tpu_torch.data.dataset import GROUP_DELIM
from shifu_tpu_torch.ops import stats as stats_ops

_EPS = 1e-10


@dataclass
class _Bin:
    pos: float
    neg: float
    wpos: float
    wneg: float
    # numeric: left boundary; categorical: list of raw values
    left: Optional[float] = None
    values: List[str] = field(default_factory=list)

    @property
    def total(self) -> float:
        return self.pos + self.neg

    @property
    def pos_rate(self) -> float:
        return self.pos / self.total if self.total > 0 else 0.0

    def merge_right(self, other: "_Bin") -> None:
        self.pos += other.pos
        self.neg += other.neg
        self.wpos += other.wpos
        self.wneg += other.wneg
        self.values += other.values


def _info_value(b: _Bin, total_all: float) -> float:
    if b.total <= 0 or total_all <= 0:
        return 0.0
    percent = b.total / total_all
    pr = (b.pos + _EPS) / b.total
    nr = (b.neg + _EPS) / b.total
    return -percent * (pr * math.log2(pr) + nr * math.log2(nr))


def _best_merge_pos(bins: List[_Bin], total_all: float) -> int:
    """Index i>0 such that merging bins[i-1] and bins[i] changes total
    entropy least (AutoDynamicBinning.getBestMergeNode)."""
    best_pos, best_delta = 0, float("inf")
    for i in range(1, len(bins)):
        a, b = bins[i - 1], bins[i]
        merged = _Bin(a.pos + b.pos, a.neg + b.neg, 0, 0)
        delta = _info_value(merged, total_all) \
            - _info_value(a, total_all) - _info_value(b, total_all)
        if delta < best_delta:
            best_delta, best_pos = delta, i
    return best_pos


def auto_merge(bins: List[_Bin], expect_num: int) -> List[_Bin]:
    total_all = sum(b.total for b in bins)
    while len(bins) > expect_num:
        i = _best_merge_pos(bins, total_all)
        if i <= 0:
            break
        bins[i - 1].merge_right(bins[i])
        del bins[i]
    return bins


def merge_small(bins: List[_Bin], min_cnt: float) -> List[_Bin]:
    i = 0
    while i < len(bins):
        b = bins[i]
        if b.total < min_cnt and len(bins) > 1:
            if i == 0:
                b.merge_right(bins[1])
                del bins[1]
            elif i == len(bins) - 1:
                bins[i - 1].merge_right(b)
                del bins[i]
            else:
                d_left = abs(bins[i - 1].pos_rate - b.pos_rate)
                d_right = abs(b.pos_rate - bins[i + 1].pos_rate)
                if d_left < d_right:
                    bins[i - 1].merge_right(b)
                    del bins[i]
                else:
                    b.merge_right(bins[i + 1])
                    del bins[i + 1]
        else:
            i += 1
    return bins


def _iv(bins: List[_Bin], miss_pos: float, miss_neg: float) -> float:
    pos = np.asarray([b.pos for b in bins] + [miss_pos])
    neg = np.asarray([b.neg for b in bins] + [miss_neg])
    _, iv, _, _ = stats_ops.column_metrics(pos, neg)
    return float(iv) if iv is not None else 0.0


def rebin_column(cc: ColumnConfig, expect_bin_num: int = -1,
                 iv_keep_ratio: float = 1.0, min_inst_cnt: int = 0) -> bool:
    """Re-bin one column in place from its recorded bin arrays. Returns
    False when the column has no usable binning."""
    bn = cc.columnBinning
    pos = list(bn.binCountPos or [])
    neg = list(bn.binCountNeg or [])
    wpos = list(bn.binWeightedPos or pos)
    wneg = list(bn.binWeightedNeg or neg)
    if len(pos) < 2:
        return False
    miss_pos, miss_neg = float(pos[-1]), float(neg[-1])
    miss_wpos, miss_wneg = float(wpos[-1]), float(wneg[-1])

    is_cat = cc.is_categorical
    if is_cat:
        cats = list(bn.binCategory or [])
        if len(cats) != len(pos) - 1:
            return False
        bins = [_Bin(float(p), float(n), float(wp), float(wn),
                     values=[c])
                for p, n, wp, wn, c in zip(pos[:-1], neg[:-1], wpos[:-1],
                                           wneg[:-1], cats)]
        # adjacency for categoricals = similar risk: sort by pos rate
        bins.sort(key=lambda b: b.pos_rate)
    else:
        bounds = [float(b) for b in (bn.binBoundary or [])]
        if len(bounds) != len(pos) - 1:
            return False
        bins = [_Bin(float(p), float(n), float(wp), float(wn), left=b)
                for p, n, wp, wn, b in zip(pos[:-1], neg[:-1], wpos[:-1],
                                           wneg[:-1], bounds)]

    if expect_bin_num and expect_bin_num > 0:
        bins = auto_merge(bins, expect_bin_num)
    if min_inst_cnt and min_inst_cnt > 0:
        bins = merge_small(bins, min_inst_cnt)

    max_iv = _iv(bins, miss_pos, miss_neg)
    while len(bins) > 1:
        candidate = [_Bin(b.pos, b.neg, b.wpos, b.wneg, left=b.left,
                          values=list(b.values)) for b in bins]
        candidate = auto_merge(candidate, len(bins) - 1)
        if len(candidate) == len(bins) or \
                _iv(candidate, miss_pos, miss_neg) < max_iv * iv_keep_ratio:
            break
        bins = candidate

    # ---- write back (StatsModelProcessor.doReBin:722-790) ----
    new_pos = np.asarray([b.pos for b in bins] + [miss_pos])
    new_neg = np.asarray([b.neg for b in bins] + [miss_neg])
    new_wpos = np.asarray([b.wpos for b in bins] + [miss_wpos])
    new_wneg = np.asarray([b.wneg for b in bins] + [miss_wneg])
    ks, iv, woe, bin_woe = stats_ops.column_metrics(new_pos, new_neg)
    wks, wiv, wwoe, wbin_woe = stats_ops.column_metrics(new_wpos, new_wneg)

    # this framework's convention: length = real bins, excluding the
    # missing slot (stats._fill_numeric writes k for k boundaries)
    bn.length = len(bins)
    if is_cat:
        bn.binCategory = [GROUP_DELIM.join(b.values) for b in bins]
        bn.binBoundary = None
    else:
        bn.binBoundary = [b.left for b in bins]
        bn.binCategory = None
    bn.binCountPos = [int(x) for x in new_pos]
    bn.binCountNeg = [int(x) for x in new_neg]
    bn.binWeightedPos = [float(x) for x in new_wpos]
    bn.binWeightedNeg = [float(x) for x in new_wneg]
    tot = new_pos + new_neg
    rates = [float(p / t) if t > 0 else 0.0 for p, t in zip(new_pos, tot)]
    bn.binPosRate = rates
    bn.binCountWoe = [float(x) for x in bin_woe]
    bn.binWeightedWoe = [float(x) for x in wbin_woe]

    st = cc.columnStats
    if ks is not None:
        st.ks, st.iv, st.woe = float(ks), float(iv), float(woe)
    if wks is not None:
        st.weightedKs, st.weightedIv = float(wks), float(wiv)
        st.weightedWoe = float(wwoe)
    return True
