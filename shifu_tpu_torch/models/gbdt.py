"""GBT / RF scoring — counterpart of the inference half of
`shifu_tpu/models/gbdt.py` (`TreeConfig`, `FusedBins`,
`make_bin_tables`, `make_fused_inputs`, `bin_dataset`, `_walk_trees`,
`predict_trees`, `predict`).

Trees keep the JAX layout: dicts of (T, n_nodes) arrays in a perfect
binary tree (children of node i at 2i+1 / 2i+2). `predict` serves
through the fused ensemble kernel (`ops/fused_trees`); `_walk_trees` /
`predict_trees` are the plain per-level walk over a pre-binned matrix,
kept as the reference the service checks the kernel against at start.
The builders come with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from shifu_tpu_torch.ops import fused_trees
from shifu_tpu_torch.ops.stats import bin_index_numeric


@dataclass(frozen=True)
class TreeConfig:
    """Static hyper-parameters of a tree ensemble that scoring reads
    (the split-search ones come with the training slice)."""
    max_depth: int = 6
    n_bins: int = 64              # histogram width incl. the missing slot
    learning_rate: float = 0.1    # GBT shrinkage
    loss: str = "squared"         # squared | log


class FusedBins(NamedTuple):
    """Raw feature values + per-column cut boundaries, the inputs of the
    fused tree kernel. valuesT: (C, R) f32, NaN = missing, numeric
    columns then categorical ones (host-mapped bin ids as floats, with
    identity cuts 0.5, 1.5, …). cuts: (C, K) f32 ascending, +inf
    padded."""
    valuesT: Any
    cuts: Any


def make_bin_tables(num_cuts: np.ndarray, cat_posrate_order: List[np.ndarray],
                    n_bins: int) -> Dict[str, np.ndarray]:
    """Pack the per-column binning tables shipped inside the model spec:
    num_cuts (B-1, Cn) +inf padded; per categorical column the raw code
    → posRate-ordered bin id map."""
    cc = len(cat_posrate_order)
    vmax = max([len(m) for m in cat_posrate_order], default=0) + 1
    cat_map = np.full((cc, vmax), n_bins - 1, np.int32)
    for j, m in enumerate(cat_posrate_order):
        cat_map[j, :len(m)] = m
    return {"num_cuts": num_cuts.astype(np.float32), "cat_map": cat_map}


def _map_codes(cat_map: np.ndarray, codes: np.ndarray,
               n_bins: int) -> np.ndarray:
    """Raw categorical codes (R, Cc) → bin ids through cat_map: clip into
    the map, map, then negative codes → the missing bin."""
    cc = codes.shape[1]
    safe = np.clip(codes, 0, cat_map.shape[1] - 1)
    mapped = cat_map[np.arange(cc)[None, :], safe]
    return np.where(codes < 0, n_bins - 1, mapped)


def fused_cuts(tables: Dict[str, np.ndarray], n_num: int, n_cat: int,
               n_bins: int) -> np.ndarray:
    """(C, K) cuts of the fused kernel: numeric columns' stats cuts,
    then identity cuts for categorical columns, +inf padded to one K."""
    parts = []
    if n_num:
        parts.append(np.ascontiguousarray(
            np.asarray(tables["num_cuts"], np.float32).T))
    if n_cat:
        ident = 0.5 + np.arange(n_bins - 2, dtype=np.float32)
        parts.append(np.broadcast_to(ident, (n_cat, n_bins - 2)))
    if not parts:
        raise ValueError("no features to bin")
    k = max(p.shape[1] for p in parts)
    parts = [np.pad(p, ((0, 0), (0, k - p.shape[1])),
                    constant_values=np.inf) for p in parts]
    return np.ascontiguousarray(np.concatenate(parts), np.float32)


def fused_values(tables: Dict[str, np.ndarray], dense, codes,
                 n_bins: int, device: torch.device) -> torch.Tensor:
    """(C, R) f32 valuesT on `device`. The numeric block may already lie
    there (the service's timed h2d stage) and is transposed in place;
    categorical codes are mapped on the host and become NaN where
    missing, so the kernel's NaN rule lands them in the missing bin."""
    parts = []
    if dense is not None and dense.shape[1]:
        d = torch.as_tensor(dense, dtype=torch.float32, device=device)
        parts.append(d.T)
    if codes is not None and codes.shape[1]:
        v = _map_codes(tables["cat_map"], np.asarray(codes),
                       n_bins).T.astype(np.float32)
        v[v == (n_bins - 1)] = np.nan
        parts.append(torch.as_tensor(v, device=device))
    if not parts:
        raise ValueError("no features to bin")
    return torch.cat(parts).contiguous()


def make_fused_inputs(tables: Dict[str, np.ndarray],
                      dense, codes, n_bins: int,
                      device: "str | torch.device" = "cpu") -> FusedBins:
    """Host-side packing for the fused kernel — same column order and
    missing semantics as `bin_dataset`."""
    dev = torch.device(device)
    n_num = dense.shape[1] if dense is not None else 0
    n_cat = codes.shape[1] if codes is not None else 0
    return FusedBins(
        fused_values(tables, dense, codes, n_bins, dev),
        torch.as_tensor(fused_cuts(tables, n_num, n_cat, n_bins),
                        device=dev))


def bin_dataset(tables: Dict[str, np.ndarray], dense, codes,
                n_bins: int) -> np.ndarray:
    """Raw cleaned data → (R, Cn+Cc) int32 bin matrix, missing =
    n_bins-1."""
    parts = []
    if dense is not None and dense.shape[1]:
        cuts = torch.as_tensor(np.asarray(tables["num_cuts"], np.float32))
        idx = bin_index_numeric(
            torch.as_tensor(np.asarray(dense, np.float32)), cuts).numpy()
        n_cut_slots = tables["num_cuts"].shape[0] + 1  # missing slot id
        idx = np.where(idx >= n_cut_slots, n_bins - 1,
                       np.minimum(idx, n_bins - 2))
        parts.append(idx.astype(np.int32))
    if codes is not None and codes.shape[1]:
        parts.append(_map_codes(tables["cat_map"], np.asarray(codes),
                                n_bins).astype(np.int32))
    if not parts:
        raise ValueError("no features to bin")
    return np.concatenate(parts, axis=1)


def _walk_trees(trees: Dict[str, torch.Tensor], binsT: torch.Tensor,
                max_depth: int, n_bins: int) -> torch.Tensor:
    """(T, R) landing node of every row in every tree. binsT: (C, R)."""
    t = trees["feature"].shape[0]
    r = binsT.shape[1]
    node = torch.zeros((t, r), dtype=torch.long, device=binsT.device)
    stop_tab = trees["is_leaf"].bool() | (trees["feature"] < 0)
    for _ in range(max_depth):
        feat = torch.gather(trees["feature"].long(), 1, node)
        sbin = torch.gather(trees["bin"].long(), 1, node)
        dl = torch.gather(trees["default_left"].long(), 1, node) != 0
        stop = torch.gather(stop_tab, 1, node)
        row_bin = torch.gather(binsT.long(), 0, feat.clamp(min=0))
        go_left = torch.where(row_bin == n_bins - 1, dl, row_bin <= sbin)
        nxt = 2 * node + torch.where(go_left, 1, 2)
        node = torch.where(stop, node, nxt)
    return node


def predict_trees(trees: Dict[str, torch.Tensor], binsT: torch.Tensor,
                  max_depth: int, n_bins: int) -> torch.Tensor:
    """(T, R) per-tree leaf values (the caller averages for RF,
    shrinks for GBT)."""
    nodes = _walk_trees(trees, binsT, max_depth, n_bins)
    return torch.gather(trees["leaf_value"].to(torch.float32), 1, nodes)


def predict(meta: Dict[str, Any], ensemble, dense,
            codes: Optional[np.ndarray]) -> torch.Tensor:
    """Score a GBT/RF ensemble (`weights.TreeEnsemble`) on raw cleaned
    features through the fused ensemble kernel → (R,) on the
    ensemble's device."""
    n_num = dense.shape[1] if dense is not None else 0
    n_cat = codes.shape[1] if codes is not None else 0
    if (n_num, n_cat) != (ensemble.n_num, ensemble.n_cat):
        raise ValueError(
            f"{meta.get('kind')} model wants {ensemble.n_num} numeric + "
            f"{ensemble.n_cat} categorical columns, got {n_num} + {n_cat}")
    valuesT = fused_values(ensemble.tables, dense, codes,
                           ensemble.cfg.n_bins, ensemble.device)
    return fused_trees.predict_ensemble(ensemble.nodes, valuesT,
                                        ensemble.cuts, **ensemble.statics)
