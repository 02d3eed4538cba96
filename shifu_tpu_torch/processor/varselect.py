"""Variable selection — the port holds only the sensitivity pass of
`shifu_tpu/processor/varselect.py` (`_sensitivity_kernel`), which NN/LR
posttrain uses for feature importance. The selection steps (filters,
SE/ST wrappers, the recursive mode) are ROADMAP A4.
"""

from __future__ import annotations

from typing import Optional

import torch

# bytes of the wiped inputs of one chunk of column ablations
SENSITIVITY_CHUNK_BYTES = 2 * 1024 ** 3


@torch.inference_mode()
def _sensitivity_kernel(model, x: torch.Tensor, base_score: torch.Tensor,
                        n_real: Optional[int] = None,
                        chunk_bytes: int = SENSITIVITY_CHUNK_BYTES
                        ) -> torch.Tensor:
    """(C,) mean squared score delta when column c of the normalized
    inputs `x` (N, C) is wiped to 0 (the mean / missing value), the
    `VarSelectMapper` MSE delta: `_sensitivity_kernel` of the JAX
    package, which `vmap`s every ablation at once, a (C, N, C) tensor.
    The port runs the ablations a chunk of columns at a time, a chunk's
    wiped inputs (k, N, C) held under `chunk_bytes`, and each through
    the model's own forward. `n_real` divides in place of N (1 gives
    the per-column sums)."""
    n, c = x.shape
    div = float(n_real if n_real is not None else n)
    k = max(1, min(c, chunk_bytes // max(1, n * c * x.element_size())))
    out = torch.empty(c, dtype=torch.float32, device=x.device)
    for c0 in range(0, c, k):
        cols = torch.arange(c0, min(c0 + k, c), device=x.device)
        wiped = x.unsqueeze(0).repeat(len(cols), 1, 1)
        wiped[torch.arange(len(cols), device=x.device), :, cols] = 0.0
        s = model(wiped.reshape(-1, c)).reshape(len(cols), n)
        out[c0:c0 + len(cols)] = torch.sum(
            torch.square(s - base_score[None, :]), dim=1) / div
    return out
