"""Bin lookup — the `bin_index_numeric` semantics of
`shifu_tpu/ops/stats.py` that `models/gbdt.bin_dataset` reads."""

from __future__ import annotations

import torch


def bin_index_numeric(values: torch.Tensor,
                      cuts: torch.Tensor) -> torch.Tensor:
    """values (R, C), cuts (B-1, C) ascending interior boundaries
    (+inf padded) → (R, C) int32 in [0, B]: `#cuts <= v` (left-closed
    bins), and B for a NaN value (the missing bin)."""
    idx = (values[:, None, :] >= cuts[None, :, :]).sum(dim=1)
    n_bins = cuts.shape[0] + 1
    return torch.where(torch.isnan(values), n_bins, idx).to(torch.int32)
