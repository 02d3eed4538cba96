"""Scorer — ensemble scoring over model specs, counterpart of
`shifu_tpu/eval/scorer.py` for the nn / lr / gbt / rf kinds.

`score_matrix` keeps the JAX package's contract: NN-family models read
the NORMALIZED dense block, or — when the caller passes `norm` and the
raw numeric block matches the input width — the RAW block through the
fused normalize + first-layer kernel; tree models read the cleaned raw
blocks through the fused ensemble kernel. The wdl / mtl / tf kinds
raise NotImplementedError until their slices are ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from shifu_tpu_torch import resolve_device, weights
from shifu_tpu_torch.models import gbdt
from shifu_tpu_torch.models.spec import list_models, load_model
from shifu_tpu_torch.ops import fused_score

_LATER = {"wdl": "the WDL/MTL slice", "mtl": "the WDL/MTL slice",
          "tf": "the eval-processor slice"}


def _as_f32(block, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(block, dtype=torch.float32, device=device)


@torch.inference_mode()
def score_matrix(kind: str, meta: Dict[str, Any], model: Any, dense,
                 index=None, raw_dense=None, raw_codes=None,
                 norm: Optional[Dict[str, Any]] = None) -> np.ndarray:
    """Score one model (a `weights.to_torch` object) → (N,) scores as
    numpy. `norm` ({"mean", "std", "cutoff"}, optionally the kernel's
    "packed" block) asserts that `dense` is exactly zscore(raw_dense);
    the NN path then reads raw_dense through the fused kernel instead of
    the materialized dense matrix."""
    if kind in ("nn", "lr"):
        dev = next(model.parameters()).device
        if norm is not None and raw_dense is not None \
                and raw_dense.shape[1] == model.spec.input_dim:
            out = fused_score.score_nn(
                model, _as_f32(raw_dense, dev).contiguous(),
                _as_f32(norm["mean"], dev), _as_f32(norm["std"], dev),
                float(norm["cutoff"]), norm.get("packed"))
        else:
            out = model(_as_f32(dense, dev))
    elif kind in ("gbt", "rf"):
        rd = raw_dense if raw_dense is not None else dense
        rc = raw_codes if raw_codes is not None else index
        out = gbdt.predict(meta, model, rd, rc)
    elif kind in _LATER:
        raise NotImplementedError(
            f"model kind {kind!r} is not ported yet ({_LATER[kind]})")
    else:
        raise ValueError(f"unknown model kind {kind!r}")
    return out.cpu().numpy()


def convert_tree_score(raw: np.ndarray, strategy: str) -> np.ndarray:
    """`Scorer` GBT score conversion: RAW passes margins through,
    SIGMOID squashes, MAXMIN_SCALE rescales to [0,1], CUTOFF clips."""
    s = (strategy or "RAW").upper()
    if s == "SIGMOID":
        return 1.0 / (1.0 + np.exp(-np.clip(raw, -30, 30)))
    if s in ("MAXMIN", "MAXMIN_SCALE"):
        lo, hi = raw.min(), raw.max()
        return (raw - lo) / (hi - lo) if hi > lo else np.zeros_like(raw)
    if s == "CUTOFF":
        return np.clip(raw, 0.0, 1.0)
    return raw


class Scorer:
    """Ensemble of the model specs under models/, held on `device`
    (default the card; raises when there is none)."""

    def __init__(self, model_paths: List[str],
                 score_selector: str = "mean",
                 gbt_convert: str = "RAW",
                 device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)
        self.models = []
        for p in model_paths:
            kind, meta, params = load_model(p)
            self.models.append(
                (kind, meta, weights.to_torch(kind, meta, params,
                                              self.device)))
        self.selector = (score_selector or "mean").lower()
        self.gbt_convert = gbt_convert
        if not self.models:
            raise FileNotFoundError("no model specs to score with")

    @classmethod
    def from_dir(cls, models_dir: str,
                 extra_paths: Optional[List[str]] = None,
                 **kw) -> "Scorer":
        return cls(list_models(models_dir) + list(extra_paths or []), **kw)

    def score(self, dense, index=None, raw_dense=None, raw_codes=None,
              norm: Optional[Dict[str, Any]] = None
              ) -> Dict[str, np.ndarray]:
        """→ {"mean","max","min","median","final","model0".."modelN"}
        like the reference EvalScore output columns."""
        per_model = []
        for kind, meta, model in self.models:
            s = score_matrix(kind, meta, model, dense, index,
                             raw_dense=raw_dense, raw_codes=raw_codes,
                             norm=norm)
            if kind in ("gbt",):
                s = convert_tree_score(s, self.gbt_convert)
            per_model.append(s)
        stack = np.stack(per_model, axis=0)  # (M, N)
        out = {f"model{i}": per_model[i] for i in range(len(per_model))}
        out["mean"] = stack.mean(axis=0)
        out["max"] = stack.max(axis=0)
        out["min"] = stack.min(axis=0)
        out["median"] = np.median(stack, axis=0)
        out["final"] = out.get(self.selector, out["mean"])
        return out
