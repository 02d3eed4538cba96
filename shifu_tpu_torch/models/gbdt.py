"""GBT / RF / DT tree ensembles — counterpart of the resident half of
`shifu_tpu/models/gbdt.py`: inference (`TreeConfig`, `FusedBins`,
`make_bin_tables`, `make_fused_inputs`, `bin_dataset`, `_walk_trees`,
`predict_trees`, `predict`) and the level-wise builders (`build_tree`,
`build_forest`, `build_gbt`, `build_gbt_bagged`, `build_rf`).

Trees keep the JAX layout: dicts of (T, n_nodes) arrays in a perfect
binary tree (children of node i at 2i+1 / 2i+2). `predict` serves
through the fused ensemble kernel (`ops/fused_trees`, K2); `_walk_trees`
/ `predict_trees` are the plain per-level walk over a pre-binned matrix,
kept as the reference the service checks the kernel against at start,
and the walk the builders use for validation and resume.

The builders grow every node of a level at once. Per level: the G/H
histograms (`ops/level_hist`, K3, or K4 for `FusedBins` inputs), with
sibling subtraction from depth 1 on, then the split search
(`ops/best_splits`, K5) over every node of the level — of every tree
for the lockstep forest (RF, bagged GBT) — then the fold into the tree
arrays and one routing step of every row. The tensors' device picks the
route: CUDA launches the kernels, CPU runs their plain versions. Only
the JAX package's per-level builder is ported; its single-dispatch
`fori_loop` variant (`SHIFU_TPU_TREE_SCAN`) exists to save XLA
dispatches and is pinned bitwise to the per-level one.

The JAX package shards rows over its mesh, pads them with zero weight
and reduces with `psum`; the port has one device and no padding, so
only the order of float sums differs from it. Tree arrays update in
place (one dict of tensors per build) where JAX rebuilt them; nothing
inside the level loop copies to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from shifu_tpu_torch import resolve_device
from shifu_tpu_torch.config.environment import knob_bool
from shifu_tpu_torch.ops import best_splits as split_op
from shifu_tpu_torch.ops import fused_trees, level_hist
from shifu_tpu_torch.ops.stats import bin_index_numeric


@dataclass(frozen=True)
class TreeConfig:
    """Static hyper-parameters (train#params for RF/GBT:
    `ModelTrainConf.createParamsByAlg:551-569`)."""
    max_depth: int = 6
    n_bins: int = 64              # histogram width incl. the missing slot
    min_instances_per_node: int = 1
    min_info_gain: float = 0.0
    reg_lambda: float = 1.0
    learning_rate: float = 0.1    # GBT shrinkage
    loss: str = "squared"         # squared | log (dt/Loss.java)

    @property
    def n_nodes(self) -> int:
        return 2 ** (self.max_depth + 1) - 1

    @property
    def n_internal(self) -> int:
        return 2 ** self.max_depth - 1


def feature_subset_count(strategy: str, n_features: int) -> int:
    """`core/dtrain/FeatureSubsetStrategy.java` ALL/HALF/ONETHIRD/
    TWOTHIRDS/SQRT/LOG2/AUTO."""
    s = (strategy or "ALL").upper()
    if s in ("ALL", "AUTO"):
        return n_features
    if s == "HALF":
        return max(1, n_features // 2)
    if s == "ONETHIRD":
        return max(1, n_features // 3)
    if s == "TWOTHIRDS":
        return max(1, (2 * n_features) // 3)
    if s == "SQRT":
        return max(1, int(math.sqrt(n_features)))
    if s == "LOG2":
        return max(1, int(math.log2(max(n_features, 2))))
    try:
        return max(1, min(n_features, int(s)))
    except ValueError:
        return n_features


class FusedBins(NamedTuple):
    """Raw feature values + per-column cut boundaries, the inputs of the
    fused kernels (K2 for scoring, K4 for the level histograms when
    SHIFU_TPU_HIST_FUSED=1). valuesT: (C, R) f32, NaN = missing,
    numeric columns then categorical ones (host-mapped bin ids as
    floats, with identity cuts 0.5, 1.5, …). cuts: (C, K) f32
    ascending, +inf padded."""
    valuesT: Any
    cuts: Any

    @property
    def shape(self):
        return self.valuesT.shape


def hist_fused_enabled() -> bool:
    """SHIFU_TPU_HIST_FUSED=1 routes the resident GBT build through
    FusedBins instead of the pre-binned int32 matrix."""
    return knob_bool("SHIFU_TPU_HIST_FUSED")


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
                      device: "str | torch.device" = "cuda") -> FusedBins:
    """Host-side packing for the fused kernels — same column order and
    missing semantics as `bin_dataset`. Defaults to the card, like every
    entry point, and raises when there is none."""
    dev = resolve_device(device)
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


# ---------------------------------------------------------------------------
# Level histograms with sibling subtraction
# ---------------------------------------------------------------------------

def _use_hist_subtract() -> bool:
    return knob_bool("SHIFU_TPU_HIST_SUBTRACT")


def _local_level_histograms(binsT, slot, grad, hess, n_level_nodes: int,
                            n_bins: int):
    """Histogram kernel over precomputed slots (int32, the dump slot for
    inactive rows). A FusedBins binsT routes to K4 by type, anything
    else to K3."""
    if isinstance(binsT, FusedBins):
        return level_hist.level_histograms_fused(
            binsT.valuesT, binsT.cuts, slot, grad, hess, n_level_nodes,
            n_bins)
    return level_hist.level_histograms(binsT, slot, grad, hess,
                                       n_level_nodes, n_bins)


def _level_histograms(binsT, node_of_row, grad, hess, level_offset: int,
                      n_level_nodes: int, n_bins: int):
    """Per-level G/H histograms — `_level_histograms` and, with a
    leading tree axis on node_of_row/grad/hess, `_forest_level_
    histograms` of the JAX package. node_of_row holds global node ids
    (rows at inactive or finished nodes carry -1 and go to the dump
    slot). Returns (..., n_level_nodes, C, n_bins) G and H."""
    local = node_of_row - level_offset
    valid = (local >= 0) & (local < n_level_nodes)
    slot = torch.where(valid, local, n_level_nodes).to(torch.int32)
    return _local_level_histograms(binsT, slot, grad, hess, n_level_nodes,
                                   n_bins)


def _child_level_histograms(cfg: TreeConfig, binsT, node_of_row, grad,
                            hess, depth: int, prev_g, prev_h, is_leaf,
                            feature, subtract: Optional[bool] = None):
    """Level histograms with the sibling-subtraction trick: at depth
    d ≥ 1 only LEFT children (even level-local slots) go through the
    histogram kernel, and right = parent − left from the previous
    level's histograms; children of leaf parents are zeroed.
    SHIFU_TPU_HIST_SUBTRACT=0 builds every slot."""
    level_offset = 2 ** depth - 1
    n_level = 2 ** depth
    use = _use_hist_subtract() if subtract is None else subtract
    if depth == 0 or prev_g is None or not use:
        return _level_histograms(binsT, node_of_row, grad, hess,
                                 level_offset, n_level, cfg.n_bins)
    half_node = _left_half_nodes(node_of_row, level_offset, n_level)
    gl, hl = _level_histograms(binsT, half_node, grad, hess, level_offset,
                               n_level // 2, cfg.n_bins)
    split = _parent_split_mask(is_leaf, feature, depth)
    return _subtract_siblings(prev_g, prev_h, gl, hl, split, n_level)


def _left_half_nodes(node, level_offset: int, n_level: int):
    """Map rows at LEFT children (even level-local slots) to their
    parent's slot id for the half-width kernel; everything else → -1
    (dumped)."""
    local = node - level_offset
    left = (local >= 0) & (local < n_level) & (local % 2 == 0)
    return torch.where(left, level_offset + local // 2, -1)


def _parent_split_mask(is_leaf, feature, depth: int):
    """(..., P) bool: which previous-level parents split (their children
    exist). is_leaf/feature: node arrays with an optional leading tree
    axis."""
    first = 2 ** (depth - 1) - 1
    parents = slice(first, first + 2 ** (depth - 1))
    return (~is_leaf[..., parents]) & (feature[..., parents] >= 0)


def _subtract_siblings(prev_g, prev_h, gl, hl, split, n_level: int):
    """Mask leaf parents, derive right = parent − left, interleave
    (left0, right0, left1, ...) back into a full level. Works for one
    tree (P, C, B) or the lockstep forest (T, P, C, B)."""
    m = split[..., None, None]
    gl = torch.where(m, gl, 0.0)
    hl = torch.where(m, hl, 0.0)
    gr = torch.where(m, prev_g - gl, 0.0)
    hr = torch.where(m, prev_h - hl, 0.0)
    lead = tuple(gl.shape[:-3])
    c, b = gl.shape[-2], gl.shape[-1]
    g = torch.stack([gl, gr], dim=-3).reshape(lead + (n_level, c, b))
    h = torch.stack([hl, hr], dim=-3).reshape(lead + (n_level, c, b))
    return g, h


# ---------------------------------------------------------------------------
# Split search, fold and routing
# ---------------------------------------------------------------------------

def _empty_trees(cfg: TreeConfig, n_trees: int, device) -> Dict[str, Any]:
    shape = (n_trees, cfg.n_nodes)
    return {"feature": torch.full(shape, -1, dtype=torch.int32,
                                  device=device),
            "bin": torch.zeros(shape, dtype=torch.int32, device=device),
            "default_left": torch.zeros(shape, dtype=torch.bool,
                                        device=device),
            "is_leaf": torch.zeros(shape, dtype=torch.bool, device=device),
            "leaf_value": torch.zeros(shape, dtype=torch.float32,
                                      device=device),
            "gain": torch.zeros(shape, dtype=torch.float32, device=device)}


def _apply_level(cfg: TreeConfig, trees, g, h, feature_masks, depth: int):
    """One split search for every node of a level of every tree: the
    (T, P, C, B) histograms flatten to T·P nodes, each tree's feature
    mask riding along per node (`_apply_level` / `_forest_apply_level`
    of the JAX package), then the fold into the tree arrays."""
    t, p, c, b = g.shape
    mask2 = torch.repeat_interleave(feature_masks, p, dim=0)  # (T·P, C)
    s = split_op.best_splits(g.reshape(t * p, c, b), h.reshape(t * p, c, b),
                             mask2, float(cfg.reg_lambda),
                             float(cfg.min_instances_per_node))
    _fold_splits(cfg, trees, {k: v.reshape(t, p) for k, v in s.items()},
                 depth)


def _fold_splits(cfg: TreeConfig, trees, s, depth: int) -> None:
    """Write one level's chosen splits ((T, P) arrays of a `best_splits`
    dict) into the (T, n_nodes) tree arrays, in place. Nodes without a
    positive finite gain become leaves with value -G/(H+λ); their `bin`
    and `default_left` are written all the same, as the JAX package
    writes them."""
    first = 2 ** depth - 1
    ids = slice(first, first + 2 ** depth)
    can_split = (s["gain"] > cfg.min_info_gain) & torch.isfinite(s["gain"])
    trees["feature"][:, ids] = torch.where(can_split, s["feature"], -1)
    trees["bin"][:, ids] = s["bin"]
    trees["default_left"][:, ids] = s["default_left"]
    trees["gain"][:, ids] = torch.where(can_split, s["gain"], 0.0)
    val = -s["g_tot"] / (s["h_tot"] + cfg.reg_lambda)
    trees["is_leaf"][:, ids] = ~can_split
    trees["leaf_value"][:, ids] = torch.where(can_split, 0.0, val)


def _final_leaves(cfg: TreeConfig, trees, g_hist, h_hist) -> None:
    """Everything alive at the last level becomes a leaf (column 0's
    plain sum over all bins, as the JAX package takes it)."""
    first = 2 ** cfg.max_depth - 1
    ids = slice(first, first + 2 ** cfg.max_depth)
    g_tot = g_hist[..., 0, :].sum(dim=-1)
    h_tot = h_hist[..., 0, :].sum(dim=-1)
    trees["is_leaf"][:, ids] = True
    trees["leaf_value"][:, ids] = -g_tot / (h_tot + cfg.reg_lambda)


def _route_level(cfg: TreeConfig, trees, binsT, node_of_row, depth: int):
    """Advance rows one level: bin <= split bin → left child (2i+1);
    missing uses the node's default direction."""
    return _route_level_at(cfg, trees, binsT, node_of_row, 2 ** depth - 1,
                           2 ** depth)


def _route_level_at(cfg: TreeConfig, trees, binsT, node_of_row,
                    level_offset: int, n_level: int):
    """trees: (T, n_nodes) arrays, node_of_row: (T, R) int64. The gather
    route over (C, R) bins, or, for FusedBins, the routed feature's raw
    value binned on the fly (no (C, R) bin matrix exists there)."""
    node_feat = torch.gather(trees["feature"], 1, node_of_row)    # (T, R)
    node_bin = torch.gather(trees["bin"], 1, node_of_row)
    node_dl = torch.gather(trees["default_left"], 1, node_of_row)
    feat_idx = node_feat.clamp(min=0).long()
    if isinstance(binsT, FusedBins):
        vals = torch.gather(binsT.valuesT, 0, feat_idx)           # (T, R)
        cuts = binsT.cuts[feat_idx]                               # (T, R, K)
        row_bin = (vals[..., None] >= cuts).sum(dim=-1)
        row_bin = torch.clamp(row_bin, max=cfg.n_bins - 2)
        row_bin = torch.where(torch.isnan(vals), cfg.n_bins - 1, row_bin)
    else:
        row_bin = torch.gather(binsT, 0, feat_idx)
    miss = row_bin == (cfg.n_bins - 1)
    go_left = torch.where(miss, node_dl, row_bin <= node_bin)
    active = (node_feat >= 0) & (node_of_row >= level_offset) & \
             (node_of_row < level_offset + n_level)
    return torch.where(active,
                       2 * node_of_row + torch.where(go_left, 1, 2),
                       node_of_row)


def _grow(cfg: TreeConfig, binsT, grad_T, hess_T, feature_masks,
          subtract: Optional[bool] = None):
    """Grow T trees level by level in lockstep (T = 1 for `build_tree`):
    per level one histogram launch and one split search cover every
    tree. Returns the (T, n_nodes) tree arrays and the (T, R) landing
    node of every row (growth routes rows to their final nodes: leaves
    park them)."""
    t, r = grad_T.shape
    trees = _empty_trees(cfg, t, grad_T.device)
    node = torch.zeros((t, r), dtype=torch.long, device=grad_T.device)
    prev_g = prev_h = None
    for depth in range(cfg.max_depth):
        g, h = _child_level_histograms(cfg, binsT, node, grad_T, hess_T,
                                       depth, prev_g, prev_h,
                                       trees["is_leaf"], trees["feature"],
                                       subtract)
        _apply_level(cfg, trees, g, h, feature_masks, depth)
        node = _route_level(cfg, trees, binsT, node, depth)
        prev_g, prev_h = g, h
    g, h = _child_level_histograms(cfg, binsT, node, grad_T, hess_T,
                                   cfg.max_depth, prev_g, prev_h,
                                   trees["is_leaf"], trees["feature"],
                                   subtract)
    _final_leaves(cfg, trees, g, h)
    return trees, node


def build_tree(cfg: TreeConfig, binsT, grad, hess, feature_mask,
               subtract: Optional[bool] = None, return_nodes: bool = False):
    """Grow one tree level by level (all nodes of a level at once).
    binsT: (C, R) int32 bins (missing = n_bins-1) or FusedBins; grad,
    hess: (R,) f32; feature_mask: (C,) f32. Returns flat (n_nodes,)
    arrays feature, bin, default_left, is_leaf, leaf_value, gain, and
    with return_nodes=True also the (R,) landing node of every row."""
    trees, node = _grow(cfg, binsT, grad[None], hess[None],
                        feature_mask[None], subtract)
    tree = {k: v[0] for k, v in trees.items()}
    return (tree, node[0]) if return_nodes else tree


def build_forest(cfg: TreeConfig, binsT, grad_T, hess_T, feature_masks,
                 subtract: Optional[bool] = None,
                 return_nodes: bool = False):
    """Grow T independent trees in lockstep: grad_T/hess_T (T, R),
    feature_masks (T, C). Returns (T, n_nodes) tree arrays and, with
    return_nodes=True, the (T, R) landing nodes."""
    trees, node = _grow(cfg, binsT, grad_T, hess_T, feature_masks,
                        subtract)
    return (trees, node) if return_nodes else trees


# ---------------------------------------------------------------------------
# Ensemble builders
# ---------------------------------------------------------------------------

def gbt_gradients(y, pred_raw, weights, loss: str):
    """First/second-order gradients (dt/Loss.java squared/log).
    Elementwise, so y (R,) or (1, R) broadcasts against (T, R)
    predictions/weights for the lockstep bagged build."""
    if loss.startswith("log"):
        p = torch.sigmoid(pred_raw)
        return (p - y) * weights, p * (1 - p) * weights
    return (pred_raw - y) * weights, torch.ones_like(y) * weights


def _val_error(vraw, vy, vw, loss: str):
    """The early-stop validation metric — weighted mean squared error on
    (sigmoid-squashed, for log loss) raw scores; (T, R) → (T,)."""
    vp = torch.sigmoid(vraw) if loss.startswith("log") else vraw
    return (torch.sum((vp - vy) ** 2 * vw, dim=-1)
            / torch.clamp(torch.sum(vw), min=1e-12))


def _f32(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev, torch.float32).contiguous()
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a, np.float32)),
                           device=dev)


def _device_bins(bins, dev: torch.device):
    """A builder's bin input on `dev`: a torch.Tensor is taken as the
    already transposed (C, R) int32 matrix; FusedBins keep their layout
    with f32 values and cuts; a numpy (R, C) matrix is transposed."""
    if isinstance(bins, torch.Tensor):
        return bins.to(dev, torch.int32).contiguous()
    if isinstance(bins, FusedBins):
        return FusedBins(_f32(bins.valuesT, dev), _f32(bins.cuts, dev))
    return torch.as_tensor(np.ascontiguousarray(np.asarray(bins, np.int32).T),
                           device=dev)


def _walk_bins(binsT, n_bins: int):
    """The (C, R) bin matrix a walk reads: FusedBins are binned once here
    (prediction re-walks every feature per level; the fused path saves
    the bin matrix in the level build only)."""
    if isinstance(binsT, FusedBins):
        return level_hist.bins_from_values_plain(binsT.valuesT, binsT.cuts,
                                                 n_bins)
    return binsT


def _trees_on(trees: Dict[str, Any], dev: torch.device) -> Dict[str, Any]:
    """(T, n_nodes) tree arrays (numpy, as `load_model` gives them, or
    tensors) on `dev`, dtypes kept."""
    return {k: torch.as_tensor(v).to(dev) for k, v in trees.items()}


def _to_numpy(trees: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in trees.items()}


def _gbt_round(cfg: TreeConfig, binsT, y, weights, pred_raw, feature_mask,
               subtract: bool):
    grad, hess = gbt_gradients(y, pred_raw, weights, cfg.loss)
    # growth already landed every row on its leaf: one (R,) gather of
    # leaf_value replaces a re-walk of the tree for the boosting update
    tree, node_of_row = build_tree(cfg, binsT, grad, hess, feature_mask,
                                   subtract=subtract, return_nodes=True)
    contrib = tree["leaf_value"][node_of_row]
    return tree, pred_raw + cfg.learning_rate * contrib


def build_gbt(cfg: TreeConfig, bins, y, weights, n_trees: int,
              feature_mask: Optional[np.ndarray] = None,
              init_trees: Optional[Dict[str, Any]] = None,
              val_data: Optional[Tuple] = None,
              early_stop_window: int = 0,
              device: "str | torch.device" = "cuda"):
    """Sequential boosting on `device`. bins: numpy (R, C) int bins, a
    (C, R) int32 tensor already placed, or FusedBins. Returns (stacked
    numpy trees, per-round val errors). init_trees (numpy or tensors,
    (T, n_nodes)) resumes a previous ensemble: GBT continuous training
    appends trees (TrainModelProcessor.java:1064-1073). The per-round
    validation error (for early stop) is the one host sync per round."""
    dev = resolve_device(device)
    jb = _device_bins(bins, dev)
    jy, jw = _f32(y, dev), _f32(weights, dev)
    c, r = jb.shape
    fm = _f32(feature_mask if feature_mask is not None
              else np.ones(c, np.float32), dev)
    subtract = _use_hist_subtract()
    trees: List[Dict[str, torch.Tensor]] = []
    pred = torch.zeros(r, dtype=torch.float32, device=dev)
    init = None
    if init_trees is not None:
        init = _trees_on(init_trees, dev)
        trees = [{k: v[i] for k, v in init.items()}
                 for i in range(init["feature"].shape[0])]
        pred = cfg.learning_rate * torch.sum(predict_trees(
            init, _walk_bins(jb, cfg.n_bins), cfg.max_depth, cfg.n_bins),
            dim=0)
    val_errs: List[float] = []
    best_val, bad = np.inf, 0
    if val_data is not None:
        vb = _device_bins(val_data[0], dev)
        vy = _f32(val_data[1], dev)
        vw = torch.ones(vb.shape[1], dtype=torch.float32, device=dev)
        vraw = torch.zeros(vb.shape[1], dtype=torch.float32, device=dev)
        if init is not None:
            vraw = cfg.learning_rate * torch.sum(predict_trees(
                init, vb, cfg.max_depth, cfg.n_bins), dim=0)
    for _ in range(n_trees):
        tree, pred = _gbt_round(cfg, jb, jy, jw, pred, fm, subtract)
        trees.append(tree)
        if val_data is not None:
            vraw = vraw + cfg.learning_rate * predict_trees(
                {k: v[None] for k, v in tree.items()}, vb, cfg.max_depth,
                cfg.n_bins)[0]
            # the early-stop decision is a per-round host branch: this
            # sync is deliberate
            err = float(_val_error(vraw, vy, vw, cfg.loss))
            val_errs.append(err)
            if err < best_val - 1e-9:
                best_val, bad = err, 0
            else:
                bad += 1
                if early_stop_window and bad >= early_stop_window:
                    break
    if not trees:
        raise ValueError("build_gbt: no trees to build and none to resume")
    stacked = {k: torch.stack([t[k] for t in trees]) for k in trees[0]}
    return _to_numpy(stacked), val_errs


def _gbt_bagged_round(cfg: TreeConfig, binsT, y, w_T, pred_T, fm_T,
                      subtract: bool):
    grad_T, hess_T = gbt_gradients(y[None, :], pred_T, w_T, cfg.loss)
    trees_T, node_T = build_forest(cfg, binsT, grad_T, hess_T, fm_T,
                                   subtract=subtract, return_nodes=True)
    contrib_T = torch.gather(trees_T["leaf_value"], 1, node_T)
    return trees_T, pred_T + cfg.learning_rate * contrib_T


def build_gbt_bagged(cfg: TreeConfig, bins, y, weights_T, n_trees: int,
                     feature_mask: Optional[np.ndarray] = None,
                     val_data: Optional[Tuple] = None,
                     early_stop_window: int = 0,
                     device: "str | torch.device" = "cuda"):
    """Lockstep bagged boosting: the round-t tree of ALL n_bags sibling
    ensembles grows at once through the forest path (one histogram
    launch and one split search per level cover every bag). Bags stay
    independent — each sees only its own weight row of `weights_T`
    (T, R). Early stop is per bag: a stopped bag keeps building in
    lockstep and its ensemble is cut to its own stop round afterwards.
    Returns a list of (stacked numpy trees, val_errs) per bag."""
    dev = resolve_device(device)
    n_bags = int(weights_T.shape[0])
    jb = _device_bins(bins, dev)
    jy, jw_T = _f32(y, dev), _f32(weights_T, dev)
    c, r = jb.shape
    fm = np.asarray(feature_mask if feature_mask is not None
                    else np.ones(c, np.float32), np.float32)
    fm_T = _f32(np.broadcast_to(fm[None, :], (n_bags, fm.size)), dev)
    subtract = _use_hist_subtract()
    pred_T = torch.zeros((n_bags, r), dtype=torch.float32, device=dev)

    round_trees: List[Dict[str, torch.Tensor]] = []
    if val_data is None and n_trees > 0:
        for _ in range(n_trees):
            trees_T, pred_T = _gbt_bagged_round(cfg, jb, jy, jw_T, pred_T,
                                                fm_T, subtract)
            round_trees.append(trees_T)
        rounds_np = _to_numpy({k: torch.stack([t[k] for t in round_trees])
                               for k in round_trees[0]})  # (rounds, T, n)
        return [({k: a[:, b] for k, a in rounds_np.items()}, [])
                for b in range(n_bags)]

    vb = _device_bins(val_data[0], dev)
    vy = _f32(val_data[1], dev)
    vw = torch.ones(vb.shape[1], dtype=torch.float32, device=dev)
    vraw_T = torch.zeros((n_bags, vb.shape[1]), dtype=torch.float32,
                         device=dev)
    val_errs: List[List[float]] = [[] for _ in range(n_bags)]
    best_val = np.full(n_bags, np.inf)
    bad = np.zeros(n_bags, np.int64)
    stop_round = np.full(n_bags, 0)
    for t in range(n_trees):
        trees_T, pred_T = _gbt_bagged_round(cfg, jb, jy, jw_T, pred_T,
                                            fm_T, subtract)
        round_trees.append(trees_T)
        vraw_T = vraw_T + cfg.learning_rate * predict_trees(
            trees_T, vb, cfg.max_depth, cfg.n_bins)
        # ONE deliberate fetch decides every bag's round: (T,) errors
        errs = _val_error(vraw_T, vy, vw, cfg.loss).cpu().numpy()
        for b in range(n_bags):
            if stop_round[b]:
                continue
            err = float(errs[b])
            val_errs[b].append(err)
            if err < best_val[b] - 1e-9:
                best_val[b], bad[b] = err, 0
            else:
                bad[b] += 1
                if early_stop_window and bad[b] >= early_stop_window:
                    stop_round[b] = t + 1
        if early_stop_window and stop_round.all():
            break
    stop_round[stop_round == 0] = len(round_trees)
    stacked = _to_numpy({k: torch.stack([t[k] for t in round_trees])
                         for k in round_trees[0]})      # (rounds, T, n)
    return [({k: a[:stop_round[b], b] for k, a in stacked.items()},
             val_errs[b]) for b in range(n_bags)]


def build_rf(cfg: TreeConfig, bins, y, weights, n_trees: int,
             subset_strategy: str, bagging_rate: float, seed: int,
             stratified: bool = False, neg_only: bool = False,
             device: "str | torch.device" = "cuda"):
    """Random forest: all trees independent → ONE lockstep build with
    per-tree Poisson instance weights and feature-subset masks, drawn
    from one `np.random.default_rng(seed)` in the JAX package's order
    (weights, then one mask per tree). `stratified`/`neg_only` shape the
    per-tree draws through `bagging_weights`. bins: numpy (R, C) or a
    placed (C, R) int32 tensor. Returns numpy (T, n_nodes) trees."""
    from shifu_tpu_torch.train.trainer import bagging_weights
    rng = np.random.default_rng(seed)
    if isinstance(bins, torch.Tensor):
        c, r = bins.shape
    else:
        r, c = bins.shape
    if stratified or neg_only:
        inst_w = bagging_weights(r, n_trees, bagging_rate,
                                 with_replacement=True, seed=seed,
                                 labels=np.asarray(y, np.float32),
                                 stratified=stratified, neg_only=neg_only)
    else:
        inst_w = rng.poisson(max(bagging_rate, 1e-6),
                             size=(n_trees, r)).astype(np.float32)
    inst_w[inst_w.sum(axis=1) == 0] = 1.0
    k = feature_subset_count(subset_strategy, c)
    masks = np.zeros((n_trees, c), np.float32)
    for t in range(n_trees):
        masks[t, rng.choice(c, size=k, replace=False)] = 1.0

    dev = resolve_device(device)
    jb = _device_bins(bins, dev)
    jy, jw = _f32(y, dev), _f32(weights, dev)
    d_inst_w = _f32(inst_w, dev)
    # leaf value = weighted mean label: grad = -y·w·iw, hess = w·iw
    grad_T = -(jy * jw * d_inst_w)
    hess_T = jw * d_inst_w
    trees = build_forest(cfg, jb, grad_T, hess_T, _f32(masks, dev),
                         subtract=_use_hist_subtract())
    return _to_numpy(trees)
