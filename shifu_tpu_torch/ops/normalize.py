"""Z-score normalization — the part of `shifu_tpu/ops/normalize.py`
that scoring reads (`STD_EPS`, `zscore`)."""

from __future__ import annotations

import torch

STD_EPS = 1e-5  # Normalizer.computeZScore stdDev > 0.00001 guard


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
