"""Carry a model's weights from the JAX package's form to the port's.

`to_torch(kind, meta, params, device)` takes what `models/spec.load_model`
returns (or ``jax.tree.map(np.asarray, ...)`` of live params: any nested
lists/dicts of numpy arrays) and builds the port's scoring object:

- nn / lr → `models.nn.MLP` with the same ``w`` / ``b`` on `device`,
  and the first layer's `fused_score.pack_weights` (the tensor-core B
  operand of kernel K1) built once as its ``w0_pack`` buffer;
- gbt / rf → `TreeEnsemble`: the packed node block, its split-word and
  leaf planes (`fused_trees.pack_nodes`, built once) and fused cuts of the
  tree kernel on `device`, the host binning tables, the tree arrays on
  the host for the start-up check's plain walk, and the statics;
- wdl / mtl → `models.wdl.WDLModel` / `models.mtl.MTLModel`, the spec
  and the params as tensors on `device`;
- tf (an external SavedModel) → its directory: `eval/scorer.py` loads
  and scores it on the host.

`from_torch` goes back to the numpy params, so a converted model saves
with `save_model` unchanged; `refresh_` copies a same-shaped model's
weights and packs into a model's storage (a hot swap under captured
CUDA graphs, which point at that storage), and `leaves` flattens numpy
params for the swap's structural gate. `stack_nn_params` carries NN params (the
JAX package's numpy layout: one network, a list of networks, or
bag-stacked arrays) into the trainer's bag-stacked tensors, and
`unstack_nn_params` goes back to one numpy network per bag.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from shifu_tpu_torch.models import gbdt, mtl, wdl
from shifu_tpu_torch.models import nn as nn_mod
from shifu_tpu_torch.ops import fused_score, fused_trees

TREE_KEYS = ("feature", "bin", "default_left", "is_leaf", "leaf_value")


@dataclass
class TreeEnsemble:
    """A GBT/RF model in the port's form."""
    kind: str
    cfg: gbdt.TreeConfig              # max_depth, n_bins, lr, loss
    nodes: torch.Tensor               # (8, T·N_pad) packed, on device
    node_pack: torch.Tensor           # pack_nodes(nodes): K2's node planes
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
    nodes = torch.as_tensor(packed, device=device)
    return TreeEnsemble(
        kind=kind, cfg=cfg, nodes=nodes,
        node_pack=fused_trees.pack_nodes(nodes, int(feat.shape[0])),
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
        mlp = nn_mod.MLP(spec, params).to(dev).eval()
        mlp.register_buffer("w0_pack", fused_score.pack_weights(
            mlp.w[0].detach()), persistent=False)
        return mlp
    if kind in ("gbt", "rf"):
        return _ensemble(kind, meta, params, dev)
    if kind == "wdl":
        return wdl.WDLModel(meta, params, dev)
    if kind == "mtl":
        return mtl.MTLModel(meta, params, dev)
    if kind == "tf":
        return meta["path"]
    raise ValueError(f"unknown model kind {kind!r}")


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32)
    return torch.as_tensor(np.array(a, np.float32))


def stack_nn_params(params: Any, n_bags: Optional[int] = None
                    ) -> List[Dict[str, torch.Tensor]]:
    """NN params → the trainer's layout: one dict a layer whose ``w`` is
    (B, in, out) and ``b`` (B, out), f32. `params` is one network
    (``[{"w": (in, out), "b": (out,)}, ...]``, repeated to `n_bags`
    bags), a list of networks (stacked in order), or already
    bag-stacked; numpy arrays or tensors (which keep their device)."""
    if params and isinstance(params[0], (list, tuple)):
        return [{k: torch.stack([_tensor(net[i][k]) for net in params])
                 for k in params[0][i]} for i in range(len(params[0]))]
    layers = [{k: _tensor(v) for k, v in layer.items()} for layer in params]
    if layers[0]["w"].dim() == 3:
        if n_bags is not None and layers[0]["w"].shape[0] != n_bags:
            raise ValueError(f"params stack {layers[0]['w'].shape[0]} bags, "
                             f"want {n_bags}")
        return layers
    if n_bags is None:
        raise ValueError("one network's params need n_bags to stack")
    return [{k: v.unsqueeze(0).repeat((n_bags,) + (1,) * v.dim())
             for k, v in layer.items()} for layer in layers]


def unstack_nn_params(stacked: List[Dict[str, torch.Tensor]]
                      ) -> List[List[Dict[str, np.ndarray]]]:
    """The trainer's bag-stacked params → one numpy network a bag, the
    layout `save_model` writes and the JAX package's `load_model`
    reads."""
    host = [{k: v.detach().cpu().numpy() for k, v in layer.items()}
            for layer in stacked]
    n_bags = host[0]["w"].shape[0]
    return [[{k: v[b] for k, v in layer.items()} for layer in host]
            for b in range(n_bags)]


def from_torch(model) -> Any:
    """The port's model object → numpy params in the spec layout."""
    if isinstance(model, nn_mod.MLP):
        return [{"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()}
                for w, b in zip(model.w, model.b)]
    if isinstance(model, TreeEnsemble):
        trees = {k: v.cpu().numpy() for k, v in model.trees.items()}
        trees.update(model.extra)
        # copies: `refresh_` writes the model's host tables in place
        return {"trees": trees,
                "tables": {k: v.copy() for k, v in model.tables.items()}}
    if isinstance(model, (wdl.WDLModel, mtl.MTLModel)):
        from shifu_tpu_torch.train.trainer import tree_map
        return tree_map(lambda v: v.detach().cpu().numpy(), model.params)
    raise TypeError(f"not a port model: {type(model).__name__}")


def leaves(params: Any, path: Tuple = ()) -> List[Tuple[Tuple, np.ndarray]]:
    """Nested lists/dicts of arrays → [(path, array)] in a fixed order:
    the paths are the tree's structure, the arrays its leaves."""
    if isinstance(params, dict):
        out = []
        for k in sorted(params, key=str):
            out += leaves(params[k], path + (str(k),))
        return out
    if isinstance(params, (list, tuple)):
        out = []
        for i, v in enumerate(params):
            out += leaves(v, path + (i,))
        return out
    return [(path, np.asarray(params))]


def _refresh_pairs(model, fresh) -> List[Tuple[Any, Any]]:
    """Every (destination, source) pair `refresh_` copies, after
    checking them all: same shape and dtype each, and for a tree
    ensemble the same statics."""
    if isinstance(model, nn_mod.MLP) and isinstance(fresh, nn_mod.MLP):
        pairs = list(zip([*model.w, *model.b], [*fresh.w, *fresh.b]))
        if len(model.w) != len(fresh.w):
            raise ValueError(f"in-place refresh of {len(model.w)} layers "
                             f"with {len(fresh.w)}")
    elif isinstance(model, TreeEnsemble) and isinstance(fresh, TreeEnsemble):
        if model.statics != fresh.statics or \
                (model.n_num, model.n_cat) != (fresh.n_num, fresh.n_cat):
            raise ValueError(f"in-place refresh of a {model.statics} "
                             f"ensemble with a {fresh.statics} one")
        if set(model.trees) != set(fresh.trees) or \
                set(model.tables) != set(fresh.tables):
            raise ValueError("in-place refresh of trees or tables with "
                             "other keys")
        pairs = [(model.nodes, fresh.nodes), (model.cuts, fresh.cuts)]
        pairs += [(model.trees[k], fresh.trees[k]) for k in model.trees]
        pairs += [(model.tables[k], fresh.tables[k]) for k in model.tables]
    else:
        raise TypeError(f"no in-place refresh of {type(model).__name__} "
                        f"with {type(fresh).__name__}")
    for dst, src in pairs:
        if tuple(dst.shape) != tuple(src.shape) or dst.dtype != src.dtype:
            raise ValueError(f"in-place refresh of {tuple(dst.shape)} "
                             f"{dst.dtype} with {tuple(src.shape)} "
                             f"{src.dtype}")
    return pairs


@torch.no_grad()
def refresh_(model, fresh) -> None:
    """Copy `fresh`'s weights (a same-kind, same-shaped model on the same
    device) into `model`'s tensors and packs in place, never rebinding
    them: MLP `w`, `b` and `w0_pack` (`fused_score.pack_weights(...,
    out=)`); a tree ensemble's packed nodes, node planes
    (`fused_trees.pack_nodes(..., out=)`), fused cuts and host arrays.
    Every pair is checked before the first copy, so a refused refresh
    (ValueError, TypeError) leaves `model` as it was. The statics a
    graph bakes in (a tree ensemble's depth, bins, loss and rate) must
    be equal."""
    pairs = _refresh_pairs(model, fresh)
    for dst, src in pairs:
        if isinstance(dst, np.ndarray):
            np.copyto(dst, src, casting="no")
        else:
            dst.copy_(src)
    if isinstance(model, nn_mod.MLP):
        fused_score.pack_weights(model.w[0].detach(), out=model.w0_pack)
    else:
        fused_trees.pack_nodes(model.nodes, model.n_trees,
                               out=model.node_pack)
        model.extra = dict(fresh.extra)
