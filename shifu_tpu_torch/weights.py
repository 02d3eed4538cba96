"""Carry a model's weights from the JAX package's form to the port's.

`to_torch(kind, meta, params, device)` takes what `models/spec.load_model`
returns (or ``jax.tree.map(np.asarray, ...)`` of live params: any nested
lists/dicts of numpy arrays) and builds the port's scoring object:

- nn / lr → `models.nn.MLP` with the same ``w`` / ``b`` on `device`;
- gbt / rf → `TreeEnsemble`: the packed node block and fused cuts of the
  tree kernel on `device`, the host binning tables, the tree arrays on
  the host for the start-up check's plain walk, and the statics.

`from_torch` goes back to the numpy params, so a converted model saves
with `save_model` unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from shifu_tpu_torch.models import gbdt
from shifu_tpu_torch.models import nn as nn_mod
from shifu_tpu_torch.ops import fused_trees

TREE_KEYS = ("feature", "bin", "default_left", "is_leaf", "leaf_value")


@dataclass
class TreeEnsemble:
    """A GBT/RF model in the port's form."""
    kind: str
    cfg: gbdt.TreeConfig              # max_depth, n_bins, lr, loss
    nodes: torch.Tensor               # (8, T·N_pad) packed, on device
    cuts: torch.Tensor                # (Cn+Cc, K) fused cuts, on device
    trees: Dict[str, torch.Tensor]    # (T, n_nodes) arrays, on the host
    tables: Dict[str, np.ndarray]     # num_cuts, cat_map (host)
    n_trees: int
    n_num: int
    n_cat: int
    device: torch.device
    extra: Dict[str, np.ndarray]      # tree arrays the port does not read

    @property
    def statics(self) -> Dict[str, Any]:
        """The static arguments of `fused_trees.predict_ensemble`."""
        return dict(n_trees=self.n_trees, kind=self.kind,
                    loss=self.cfg.loss,
                    learning_rate=self.cfg.learning_rate,
                    max_depth=self.cfg.max_depth, n_bins=self.cfg.n_bins)


def _ensemble(kind: str, meta: Dict[str, Any], params: Any,
              device: torch.device) -> TreeEnsemble:
    tc = meta["treeConfig"]
    cfg = gbdt.TreeConfig(max_depth=int(tc["max_depth"]),
                          n_bins=int(tc["n_bins"]),
                          learning_rate=float(tc["learning_rate"]),
                          loss=str(tc.get("loss", "squared")))
    tables = {"num_cuts": np.asarray(params["tables"]["num_cuts"],
                                     np.float32),
              "cat_map": np.asarray(params["tables"]["cat_map"], np.int32)}
    trees_np = {k: np.asarray(v) for k, v in params["trees"].items()}
    n_num = tables["num_cuts"].shape[1]
    n_cat = tables["cat_map"].shape[0]
    feat = trees_np["feature"]
    split = ~(np.asarray(trees_np["is_leaf"], bool) | (feat < 0))
    if split.any() and int(feat[split].max()) >= n_num + n_cat:
        raise ValueError(f"a split reads feature {int(feat[split].max())} "
                         f"of {n_num + n_cat}")
    packed, _ = fused_trees.pack_ensemble(trees_np)
    return TreeEnsemble(
        kind=kind, cfg=cfg,
        nodes=torch.as_tensor(packed, device=device),
        cuts=torch.as_tensor(gbdt.fused_cuts(tables, n_num, n_cat,
                                             cfg.n_bins), device=device),
        trees={k: torch.tensor(trees_np[k])
               for k in TREE_KEYS},
        tables=tables, n_trees=int(feat.shape[0]), n_num=n_num,
        n_cat=n_cat, device=device,
        extra={k: v for k, v in trees_np.items() if k not in TREE_KEYS})


def to_torch(kind: str, meta: Dict[str, Any], params: Any,
             device: "str | torch.device"):
    """(kind, meta, numpy params) → the port's model object on
    `device`."""
    dev = torch.device(device)
    if kind in ("nn", "lr"):
        spec = nn_mod.MLPSpec.from_meta(meta["spec"])
        return nn_mod.MLP(spec, params).to(dev).eval()
    if kind in ("gbt", "rf"):
        return _ensemble(kind, meta, params, dev)
    if kind in ("wdl", "mtl"):
        raise NotImplementedError(
            f"model kind {kind!r} is not ported yet (the WDL/MTL slice)")
    if kind == "tf":
        raise NotImplementedError(
            "the `tf` SavedModel kind is not ported yet (the "
            "eval-processor slice)")
    raise ValueError(f"unknown model kind {kind!r}")


def from_torch(model) -> Any:
    """The port's model object → numpy params in the spec layout."""
    if isinstance(model, nn_mod.MLP):
        return [{"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()}
                for w, b in zip(model.w, model.b)]
    if isinstance(model, TreeEnsemble):
        trees = {k: v.cpu().numpy() for k, v in model.trees.items()}
        trees.update(model.extra)
        return {"trees": trees, "tables": dict(model.tables)}
    raise TypeError(f"not a port model: {type(model).__name__}")
