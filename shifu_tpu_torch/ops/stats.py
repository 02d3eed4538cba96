"""Column statistics — the port of `shifu_tpu/ops/stats.py`.

Plain PyTorch over (rows × cols) tensors on the caller's device (the
card for `stats --device cuda`); no hand-written kernel, as the JAX
package has none here either:

1. `weighted_quantiles` — exact weighted quantile boundaries for every
   column at once: one stable sort per column, a float32 cumulative
   weight, and a left `searchsorted` of float32 targets into it.
   Boundaries are sample values, so the index must be exact: with 0/1
   weights (the EqualPositive/Negative/Total methods and the quartiles)
   the float32 running sums are exact integers below 2^24 rows on any
   device. Under the Weight* methods the sums round, and the card's
   scan rounds otherwise than the CPU's (which accumulates in double),
   so a boundary may land one row over.
2. `bin_index_numeric` — `#cuts <= v` by `torch.searchsorted(right=True)`
   over each column's ascending (+inf padded) cuts: no (R, B-1, C)
   comparison tensor; NaN → the missing bin.
3. `bin_accumulate` / `cat_bin_accumulate` — one scatter-add over
   ``col * slots + bin``, accumulated in float64 and rounded to float32
   once: counts stay exact past 2^24, and a weighted sum no longer
   depends on the order of the card's atomics, so the card and the CPU
   agree to one f32 rounding (the JAX package adds f32 over its mesh
   shards, which sits within rtol 1e-5 of either).
4. `moment_stats` — mean/std/min/max/skewness/kurtosis, NaN-aware,
   summed in float64 and returned as float32 for the same reason (a
   column mean near 0 otherwise moves by 2.5e-5 relative between the
   card's and the CPU's f32 reductions at 262,144 rows).

`column_metrics` and `psi_metric` are host float64 math, copied as
they are (`core/ColumnStatsCalculator.java:26-99`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

EPS = 1e-10  # ColumnStatsCalculator.java:31


def weighted_quantiles(values: torch.Tensor, weights: torch.Tensor,
                       num_quantiles: int) -> torch.Tensor:
    """values (R, C) f32, NaN = excluded; weights (R, C) f32 (0 =
    excluded) → (num_quantiles, C): row q is the (q+1)/(Q+1) weighted
    quantile of each column; NaN for a column with no weight."""
    r = values.shape[0]
    nan = torch.isnan(values)
    w = torch.where(nan, 0.0, weights)
    v = torch.where(nan, torch.inf, values)        # NaN sorts to the end
    sv, order = torch.sort(v, dim=0, stable=True)
    sw = torch.gather(w, 0, order)
    cw = torch.cumsum(sw, dim=0)
    total = cw[-1]
    # XLA lowers the JAX package's `arange / (Q+1)` to a product with
    # the f32 reciprocal, which rounds otherwise than a true division
    # for 30 of 62 quantiles at Q = 62: take the same product
    qs = torch.arange(1, num_quantiles + 1, dtype=torch.float32,
                      device=values.device) * float(
                          np.float32(1.0 / (num_quantiles + 1)))
    targets = qs[:, None] * total[None, :]          # (Q, C)
    idx = torch.searchsorted(cw.T.contiguous(), targets.T.contiguous(),
                             side="left").clamp_(0, r - 1)   # (C, Q)
    out = torch.gather(sv.T, 1, idx).T
    return torch.where(torch.isinf(out), torch.nan, out)


def bin_index_numeric(values: torch.Tensor,
                      cuts: torch.Tensor) -> torch.Tensor:
    """values (R, C), cuts (B-1, C) ascending interior boundaries
    (+inf padded) → (R, C) int32 in [0, B]: `#cuts <= v` (left-closed
    bins), and B for a NaN value (the missing bin)."""
    idx = torch.searchsorted(cuts.T.contiguous(), values.T.contiguous(),
                             right=True, out_int32=True).T
    n_bins = cuts.shape[0] + 1
    return torch.where(torch.isnan(values), n_bins, idx).to(torch.int32)


def bin_accumulate(bin_idx: torch.Tensor, tags: torch.Tensor,
                   weights: torch.Tensor, num_slots: int,
                   row_mask: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """bin_idx (R, C) in [0, num_slots); tags (R,) 1/0; weights (R,) →
    pos/neg/weighted counts, each (C, num_slots) f32 (summed in f64).
    Rows with row_mask 0 count nowhere."""
    r, c = bin_idx.shape
    dev = bin_idx.device
    flat = (torch.arange(c, device=dev, dtype=torch.int64)[None, :]
            * num_slots + bin_idx.long()).reshape(-1)
    pos = (tags > 0.5).float()
    m = row_mask.float() if row_mask is not None else torch.ones_like(pos)
    w = weights.float()

    def scatter(row_vals: torch.Tensor) -> torch.Tensor:
        z = torch.zeros(c * num_slots, dtype=torch.float64, device=dev)
        z.index_add_(0, flat,
                     row_vals.double()[:, None].expand(r, c).reshape(-1))
        return z.view(c, num_slots).float()

    return {"count_pos": scatter(pos * m),
            "count_neg": scatter((1.0 - pos) * m),
            "weight_pos": scatter(pos * w * m),
            "weight_neg": scatter((1.0 - pos) * w * m)}


def moment_stats(values: torch.Tensor,
                 row_mask: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """Per-column count/mean/std/min/max/missing/skewness/kurtosis,
    NaN-aware (missing excluded), all (C,) f32; a column with no value
    gives NaN moments, as jnp.nanmean/nanmin do."""
    nan = torch.isnan(values)
    if row_mask is not None:
        missing = (nan.float() * row_mask.float()[:, None]).sum(0)
    else:
        missing = nan.sum(0).float()
    n = (~nan).sum(0).double()
    v = values.double()
    mean = torch.nanmean(v, dim=0)
    centered = v - mean[None, :]
    m2 = torch.nansum(centered ** 2, dim=0)
    m3 = torch.nansum(centered ** 3, dim=0)
    m4 = torch.nansum(centered ** 4, dim=0)
    var = m2 / torch.clamp(n - 1.0, min=1.0)
    std = torch.sqrt(var)
    # population skewness/kurtosis like commons-math used by the reference
    n1 = torch.clamp(n, min=1.0)
    std_pop = torch.sqrt(m2 / n1)
    skew = (m3 / n1) / torch.clamp(std_pop ** 3, min=EPS)
    kurt = (m4 / n1) / torch.clamp(std_pop ** 4, min=EPS) - 3.0
    empty = n == 0
    vmin = torch.where(nan, torch.inf, values).amin(0)
    vmax = torch.where(nan, -torch.inf, values).amax(0)
    return {"count": n.float(), "mean": mean.float(), "std": std.float(),
            "min": torch.where(empty, torch.nan, vmin),
            "max": torch.where(empty, torch.nan, vmax),
            "missing": missing, "skewness": skew.float(),
            "kurtosis": kurt.float()}


def cat_bin_accumulate(codes: torch.Tensor, tags: torch.Tensor,
                       weights: torch.Tensor, vocab_lens: torch.Tensor,
                       num_slots: int,
                       row_mask: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    """Categorical counts: codes (R, C) int32 with -1 = missing; the
    missing bin of column c is slot vocab_lens[c]."""
    idx = torch.where(codes < 0, vocab_lens[None, :].to(codes.dtype), codes)
    idx = torch.clamp(idx, 0, num_slots - 1)
    return bin_accumulate(idx, tags, weights, num_slots, row_mask)


# ---------------------------------------------------------------------------
# Host-side per-column metrics (float64; O(C×B))
# ---------------------------------------------------------------------------

def column_metrics(count_pos: np.ndarray, count_neg: np.ndarray):
    """KS / IV / column WOE / per-bin WOE from pos/neg counts (including
    the trailing missing bin), matching ColumnStatsCalculator.java:

      bin_woe_i = ln((p_i/sumP + EPS) / (n_i/sumN + EPS))
      iv        = Σ (p_rate_i − n_rate_i) · bin_woe_i
      ks        = 100 · max_i |cum p_rate − cum n_rate|
      woe       = ln((sumP + EPS) / (sumN + EPS))

    Returns (ks, iv, woe, bin_woe[B]) — or (None, None, None, zeros)
    when a class is absent (the reference returns null)."""
    p = np.asarray(count_pos, np.float64)
    n = np.asarray(count_neg, np.float64)
    sum_p, sum_n = p.sum(), n.sum()
    if sum_p == 0 or sum_n == 0:
        return None, None, None, np.zeros_like(p)
    pr = p / sum_p
    nr = n / sum_n
    bin_woe = np.log((pr + EPS) / (nr + EPS))
    iv = float(np.sum((pr - nr) * bin_woe))
    ks = float(100.0 * np.max(np.abs(np.cumsum(pr) - np.cumsum(nr))))
    woe = float(np.log((sum_p + EPS) / (sum_n + EPS)))
    return ks, iv, woe, bin_woe


def psi_metric(expected_rate: np.ndarray, actual_rate: np.ndarray) -> float:
    """Population stability index between two bin distributions
    (`udf/PSICalculatorUDF` semantics)."""
    e = np.asarray(expected_rate, np.float64) + EPS
    a = np.asarray(actual_rate, np.float64) + EPS
    return float(np.sum((e - a) * np.log(e / a)))
