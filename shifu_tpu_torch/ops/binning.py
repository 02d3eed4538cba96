"""Binning drivers: columnar values → per-column boundaries/categories.

The port of `shifu_tpu/ops/binning.py`. Every `stats#binningMethod`
maps to the exact kernels of `ops/stats.py`, run on the values'
device; the O(bins × cols) dedup and padding stay on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from shifu_tpu_torch.config.model_config import BinningMethod
from shifu_tpu_torch.ops import stats as stats_ops


@dataclass
class NumericBinning:
    """Per-column numeric binning output (host side)."""
    boundaries: List[np.ndarray]   # per column: [-inf, c1, ...] deduped
    cuts_padded: np.ndarray        # (max_bins-1, C) +inf padded


def quantile_weights_for_method(method: BinningMethod, tags: torch.Tensor,
                                weights: torch.Tensor) -> torch.Tensor:
    """(R,) f32 row weights of the population that equal-population
    binning equalizes over: EqualPositive → positives only,
    EqualNegative → negatives only, EqualTotal → all rows, Weight*
    variants the weight column."""
    pos = tags > 0.5
    w = weights.float()
    base = {
        BinningMethod.EqualPositive: lambda: pos.float(),
        BinningMethod.WeightEqualPositive: lambda: pos * w,
        BinningMethod.EqualNegative: lambda: (~pos).float(),
        BinningMethod.WeightEqualNegative: lambda: (~pos) * w,
        BinningMethod.EqualTotal: lambda: torch.ones_like(w),
        BinningMethod.WeightEqualTotal: lambda: w,
        BinningMethod.EqualInterval: lambda: torch.ones_like(w),
        BinningMethod.WeightEqualInterval: lambda: w,
    }[method]()
    return base.float()


def compute_numeric_binning(values: torch.Tensor, tags: torch.Tensor,
                            weights: torch.Tensor, method: BinningMethod,
                            max_bins: int) -> NumericBinning:
    """values (R, C) f32 NaN-missing on any device → ≤ max_bins
    left-closed bins per column with binBoundary[0] = -inf."""
    r, c = values.shape
    n_cuts = max(max_bins - 1, 1)
    if c == 0:
        return NumericBinning([], np.zeros((n_cuts, 0), np.float32))

    if method in (BinningMethod.EqualInterval,
                  BinningMethod.WeightEqualInterval):
        # min/max on the device (exact); the f32 step arithmetic on the
        # host, exactly as the JAX package does it
        mom = stats_ops.moment_stats(values)
        vmin = mom["min"].cpu().numpy()
        vmax = mom["max"].cpu().numpy()
        steps = (np.arange(1, max_bins, dtype=np.float32)[:, None]
                 / max_bins)
        cuts = vmin[None, :] + steps * (vmax - vmin)[None, :]
    else:
        qw = quantile_weights_for_method(method, tags, weights)
        cuts = stats_ops.weighted_quantiles(
            values, qw[:, None].expand(r, c), n_cuts).cpu().numpy()

    boundaries: List[np.ndarray] = []
    padded = np.full((n_cuts, c), np.inf, np.float32)
    for j in range(c):
        col = cuts[:, j]
        col = col[~np.isnan(col) & ~np.isinf(col)]
        uniq = np.unique(col)  # discrete columns collapse duplicates
        boundaries.append(np.concatenate(([-np.inf], uniq)))
        padded[:len(uniq), j] = uniq
    return NumericBinning(boundaries, padded)


def cap_categories(vocab: List[str], counts: Optional[np.ndarray],
                   cate_max_bins: int) -> List[str]:
    """Keep the most frequent `cate_max_bins` categories; the rest fold
    into the missing bin (UpdateBinningInfoReducer.java:357-399)."""
    if cate_max_bins <= 0 or len(vocab) <= cate_max_bins:
        return vocab
    if counts is None:
        return vocab[:cate_max_bins]
    order = np.argsort(-np.asarray(counts))[:cate_max_bins]
    return [vocab[i] for i in sorted(order)]
