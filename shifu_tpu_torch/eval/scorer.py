"""Scorer — ensemble scoring over model specs, counterpart of
`shifu_tpu/eval/scorer.py` for the nn / lr / gbt / rf / wdl / mtl
kinds.

`score_matrix` keeps the JAX package's contract: NN-family models read
the NORMALIZED dense block, or — when the caller passes `norm` and the
raw numeric block matches the input width — the RAW block through the
fused normalize + first-layer kernel; tree models read the cleaned raw
blocks through the fused ensemble kernel; WDL reads the normalized
dense and index blocks, MTL the dense block (the mean over its
tasks). `Scorer.score_multiclass`
scores a multi-class ensemble (NATIVE softmax models and ONEVSALL
binary models) over the normalized block. The tf kind (a SavedModel)
raises: it needs tensorflow.
`resolve_generic_models` expands an eval set's `customPaths` entry into
model paths.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from shifu_tpu_torch import resolve_device, weights
from shifu_tpu_torch.models import gbdt
from shifu_tpu_torch.models.spec import list_models, load_model
from shifu_tpu_torch.ops import fused_score

log = logging.getLogger("shifu_tpu_torch")



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
    elif kind in ("wdl", "mtl"):
        out = model(dense, index)
    elif kind == "tf":
        raise NotImplementedError(weights.TF_REFUSAL)
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


def resolve_generic_models(path: str) -> List[str]:
    """An eval `customPaths` modelsPath / genericModelsPath entry →
    concrete model paths: a SavedModel dir is one model; a directory is
    scanned for spec files and SavedModel subdirectories; a file is a
    spec. SavedModels then raise when loaded (the `tf` kind needs
    tensorflow)."""
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "saved_model.pb")):
            return [path]
        out = list(list_models(path))
        for name in sorted(os.listdir(path)):
            sub = os.path.join(path, name)
            if os.path.isdir(sub) and sub not in out and \
                    os.path.exists(os.path.join(sub, "saved_model.pb")):
                out.append(sub)
        return out
    return [path] if os.path.exists(path) else []


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

    def score_multiclass(self, dense, index=None, raw_dense=None,
                         raw_codes=None) -> Tuple[np.ndarray, np.ndarray]:
        """Multi-class ensemble → ((N, C) class scores, (N,) argmax
        predicted class). NATIVE models contribute their softmax rows;
        ONEVSALL models (meta `ovaClass`) fill their class's column —
        `Scorer`'s per-tag max-score pick for classification."""
        native, ova = [], {}
        n_classes = 0
        for kind, meta, model in self.models:
            s = score_matrix(kind, meta, model, dense, index,
                             raw_dense=raw_dense, raw_codes=raw_codes)
            if "ovaClass" in meta:
                c = int(meta["ovaClass"])
                ova.setdefault(c, []).append(np.asarray(s).reshape(-1))
                n_classes = max(n_classes, c + 1,
                                len(meta.get("classes") or []))
            else:
                if s.ndim == 1:
                    raise ValueError(
                        "binary model in a multi-class eval — retrain "
                        "with multi-class tags")
                native.append(s)
                n_classes = max(n_classes, s.shape[1])
        if not native and not ova:
            raise ValueError(
                "no models loaded for multi-class scoring — check the "
                "models directory and that training completed")
        parts = []
        if native:
            if any(s.shape[1] < n_classes for s in native):
                # models trained against different tag sets: pad with
                # zero columns so the matrices stack
                log.warning(
                    "multi-class models disagree on class count "
                    "(%s vs %d); padding narrower score matrices with "
                    "zeros", sorted({s.shape[1] for s in native}), n_classes)
                native = [np.pad(s, ((0, 0), (0, n_classes - s.shape[1])))
                          if s.shape[1] < n_classes else s for s in native]
            parts.append(np.mean(np.stack(native, axis=0), axis=0))
        if ova:
            n_rows = len(next(iter(ova.values()))[0])
            probs = np.zeros((n_rows, n_classes), np.float32)
            for c, ss in ova.items():
                probs[:, c] = np.mean(np.stack(ss, axis=0), axis=0)
            parts.append(probs)
        scores = np.mean(np.stack(parts, axis=0), axis=0)
        return scores, np.argmax(scores, axis=1).astype(np.int32)
