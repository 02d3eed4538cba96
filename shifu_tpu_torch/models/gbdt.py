"""GBT / RF / DT tree ensembles — counterpart of the resident half of
`shifu_tpu/models/gbdt.py`: inference (`TreeConfig`, `FusedBins`,
`make_bin_tables`, `make_fused_inputs`, `bin_dataset`, `_walk_trees`,
`predict_trees`, `predict`), the level-wise builders (`build_tree`,
`build_forest`, `build_gbt`, `build_gbt_bagged`, `build_rf`) and the
streaming ones (`build_gbt_streaming`, `build_rf_streaming`).

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
dispatches and is pinned bitwise to the per-level one (the streaming
builder's one-chunk case, which the JAX package runs through that
variant, runs the per-level builder here).

The streaming builders (`train#trainOnDisk`) read a memory-mapped (R,
C) bin matrix a chunk at a time: per level each chunk is routed and its
partial histograms (K3) are summed over the chunks, then the sibling
subtraction, then K5 once a level — K3 (max_depth + 1) times a chunk
and K5 max_depth times a tree. The row state lives on the host (the
routed nodes come back after every chunk) or, when it fits, on the
device (`gbt_resident_state_mode`; no host read inside a level).

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
from shifu_tpu_torch.config.environment import knob_bool, knob_int, knob_str
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
                n_bins: int, device: "str | torch.device" = "cpu"
                ) -> np.ndarray:
    """Raw cleaned data → (R, Cn+Cc) int32 bin matrix, missing =
    n_bins-1; the numeric columns are binned on `device`."""
    parts = []
    if dense is not None and dense.shape[1]:
        cuts = torch.as_tensor(np.asarray(tables["num_cuts"], np.float32),
                               device=device)
        idx = bin_index_numeric(
            torch.as_tensor(np.asarray(dense, np.float32), device=device),
            cuts).cpu().numpy()
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


def leaf_indices(trees: Dict[str, torch.Tensor], binsT: torch.Tensor,
                 max_depth: int, n_bins: int) -> torch.Tensor:
    """(T, R) int32 landing leaf id of every row in every tree — the
    tree-path encoding of `udf/EncodeDataUDF.java` (each record becomes
    one categorical value per tree). binsT: (C, R). Plain PyTorch on the
    tensors' device: the JAX walk is XLA, not a Pallas kernel."""
    return _walk_trees(trees, binsT, max_depth, n_bins).to(torch.int32)


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
                                        ensemble.cuts, **ensemble.statics,
                                        node_pack=ensemble.node_pack)


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
    of the JAX package), then the fold into the tree arrays. The (T, C)
    masks go to the search as they are: node i reads row i // P."""
    t, p, c, b = g.shape
    s = split_op.best_splits(g.reshape(t * p, c, b), h.reshape(t * p, c, b),
                             feature_masks, float(cfg.reg_lambda),
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


def _bin_routed(vals: torch.Tensor, cuts: torch.Tensor,
                feat_idx: torch.Tensor) -> torch.Tensor:
    """Σ(v >= cut) of each routed value against its own column's
    ascending (C, K) cuts, by binary lifting (the rule of
    `csrc/binning.cuh`): ⌈log2(K+1)⌉ steps of one (T, R) gather each,
    taking a step when the cut it lands on is <= v. Each column's cuts
    are padded with NaN to the span the steps can reach, and a NaN cut
    is <= no value, so no step needs a bound check. No (T, R, K) tensor
    of cuts is formed."""
    c, k = cuts.shape
    step = 1
    while 2 * step <= k:
        step *= 2
    span = 2 * step - 1 if k else 0
    padded = torch.full((c, span), torch.nan, dtype=cuts.dtype,
                        device=cuts.device)
    padded[:, :k] = cuts
    flat = padded.reshape(-1)
    pos = feat_idx * span        # column start + the cuts counted so far
    while k and step > 0:
        take = flat[step - 1:][pos] <= vals
        pos.add_(take, alpha=step)
        step //= 2
    return pos - feat_idx * span


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
        row_bin = _bin_routed(vals, binsT.cuts, feat_idx)
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
    binsT: (C, R) uint8 or int32 bins (missing = n_bins-1) or
    FusedBins; grad, hess: (R,) f32; feature_mask: (C,) f32. Returns
    flat (n_nodes,) arrays feature, bin, default_left, is_leaf,
    leaf_value, gain, and with return_nodes=True also the (R,) landing
    node of every row."""
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


def bin_dtype(n_bins: int) -> torch.dtype:
    """The dtype of a builder's (C, R) bin matrix: one byte a bin when
    every bin, the missing one (n_bins - 1) included, fits (every model
    set Shifu writes), else int32."""
    return torch.uint8 if n_bins <= 256 else torch.int32


def _device_bins(bins, dev: torch.device, n_bins: int):
    """A builder's bin input on `dev`: a torch.Tensor is taken as the
    already transposed (C, R) matrix; FusedBins keep their layout with
    f32 values and cuts; a numpy (R, C) matrix is transposed (and
    narrowed on the host, before the copy). Bins are `bin_dtype`, except
    that a matrix holding a bin below 0 or above 255 stays int32: the
    histograms drop bins outside [0, n_bins), and a narrowing would wrap
    such a bin into that range."""
    dtype = bin_dtype(n_bins)
    if isinstance(bins, FusedBins):
        return FusedBins(_f32(bins.valuesT, dev), _f32(bins.cuts, dev))
    if isinstance(bins, torch.Tensor):
        if dtype == torch.uint8 and bins.dtype != torch.uint8 and \
                bins.numel() and not _byte_range(*torch.aminmax(bins)):
            dtype = torch.int32
        return bins.to(dev, dtype).contiguous()
    bins = np.asarray(bins)
    if dtype == torch.uint8 and bins.size and \
            not _byte_range(bins.min(), bins.max()):
        dtype = torch.int32
    np_dtype = np.uint8 if dtype == torch.uint8 else np.int32
    return torch.as_tensor(np.ascontiguousarray(bins.T, dtype=np_dtype),
                           device=dev)


def _byte_range(lo, hi) -> bool:
    return 0 <= int(lo) and int(hi) <= 255


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
    (C, R) tensor already placed, or FusedBins. Returns (stacked
    numpy trees, per-round val errors). init_trees (numpy or tensors,
    (T, n_nodes)) resumes a previous ensemble: GBT continuous training
    appends trees (TrainModelProcessor.java:1064-1073). The per-round
    validation error (for early stop) is the one host sync per round."""
    dev = resolve_device(device)
    jb = _device_bins(bins, dev, cfg.n_bins)
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
        vb = _device_bins(val_data[0], dev, cfg.n_bins)
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
    jb = _device_bins(bins, dev, cfg.n_bins)
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

    vb = _device_bins(val_data[0], dev, cfg.n_bins)
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
    placed (C, R) tensor. Returns numpy (T, n_nodes) trees."""
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
    jb = _device_bins(bins, dev, cfg.n_bins)
    jy, jw = _f32(y, dev), _f32(weights, dev)
    d_inst_w = _f32(inst_w, dev)
    # leaf value = weighted mean label: grad = -y·w·iw, hess = w·iw
    grad_T = -(jy * jw * d_inst_w)
    hess_T = jw * d_inst_w
    trees = build_forest(cfg, jb, grad_T, hess_T, _f32(masks, dev),
                         subtract=_use_hist_subtract())
    return _to_numpy(trees)


# ---------------------------------------------------------------------------
# Out-of-core (streaming) builders — chunked histogram accumulation
# ---------------------------------------------------------------------------

def gbt_resident_state_mode(n_train: int, n_val: int = 0) -> bool:
    """Row-state tier of the streaming GBT builder.
    SHIFU_TPU_GBT_RESIDENT_STATE = 1 keeps the row state on the device,
    0 on the host, auto (default) on the device when it fits
    SHIFU_TPU_GBT_STATE_BUDGET_MB: ≈ 24 B a training row (node, pred,
    grad, hess and the y/w copies the gradients read) + 12 B a
    validation row. The bin matrix streams from disk either way."""
    mode = knob_str("SHIFU_TPU_GBT_RESIDENT_STATE").lower()
    if mode in ("0", "off", "false"):
        return False
    if mode in ("1", "on", "true"):
        return True
    budget = knob_int("SHIFU_TPU_GBT_STATE_BUDGET_MB") << 20
    return n_train * 24 + n_val * 12 <= budget


def _chunk_bins(bins_mm, a: int, b: int) -> np.ndarray:
    """Rows [a, b) of the (R, C) bin matrix as the (C, rows) block the
    histogram kernel reads: uint8 stays one byte, wider bins go int32."""
    blk = np.ascontiguousarray(np.asarray(bins_mm[a:b]).T)
    return blk if blk.dtype == np.uint8 else blk.astype(np.int32)


def _stream_level_chunk(cfg: TreeConfig, trees, binsT_c, node_c, grad_c,
                        hess_c, depth: int, half: bool):
    """One chunk's work for one level: route the chunk's rows through
    the previous level's splits, then this level's partial histograms
    (K3) — histograms add over row chunks, so the level's G/H are the
    sum of these partials. node_c, grad_c, hess_c: (1, rows). With
    `half`, only the left children go through the kernel, at their
    parents' slots (sibling subtraction)."""
    if depth > 0:
        node_c = _route_level(cfg, trees, binsT_c, node_c, depth - 1)
    level_offset = 2 ** depth - 1
    n_level = 2 ** depth
    hist_node = node_c
    if half:
        hist_node = _left_half_nodes(node_c, level_offset, n_level)
        n_level //= 2
    g, h = _level_histograms(binsT_c, hist_node, grad_c, hess_c,
                             level_offset, n_level, cfg.n_bins)
    return node_c, g, h


def _grow_streaming(cfg: TreeConfig, level_chunks, fm):
    """The level loop shared by both row-state tiers: per level,
    `level_chunks(trees, depth, half)` runs `_stream_level_chunk` over
    every chunk and returns the summed partial histograms; then the
    sibling subtraction, then the split search (K5) once a level, or
    the final leaves. Returns the (1, n_nodes) tree arrays."""
    trees = _empty_trees(cfg, 1, fm.device)
    prev_g = prev_h = None
    subtract = _use_hist_subtract()
    for depth in range(cfg.max_depth + 1):
        half = subtract and depth > 0 and prev_g is not None
        g, h = level_chunks(trees, depth, half)
        if half:
            split = _parent_split_mask(trees["is_leaf"], trees["feature"],
                                       depth)
            g, h = _subtract_siblings(prev_g, prev_h, g, h, split,
                                      2 ** depth)
        prev_g, prev_h = (g, h) if subtract else (None, None)
        if depth < cfg.max_depth:
            _apply_level(cfg, trees, g, h, fm, depth)
        else:
            _final_leaves(cfg, trees, g, h)
    return trees


def _build_tree_streaming(cfg: TreeConfig, bins_mm, grad_of_chunk,
                          node_host: np.ndarray, chunk_rows: int, fm,
                          stager):
    """Grow one tree over a bin matrix that never enters the device
    whole, the row state on the host. bins_mm: (R, C) memory-mapped;
    grad_of_chunk(a, b) → host (grad, hess); node_host: (R,) int32
    scratch (zero at the start), left at every row's landing node. One
    bins pass a level; each chunk's copy is issued before the previous
    chunk's routed nodes come back."""
    r = bins_mm.shape[0]
    bounds = [(s, min(s + chunk_rows, r)) for s in range(0, r, chunk_rows)]

    def put(bnd):
        a, b = bnd
        grad, hess = grad_of_chunk(a, b)
        return (stager.put("bins", _chunk_bins(bins_mm, a, b)),
                stager.put("node", node_host[None, a:b]).long(),
                stager.put("grad", np.asarray(grad, np.float32)[None]),
                stager.put("hess", np.asarray(hess, np.float32)[None]))

    def level_chunks(trees, depth, half):
        g_acc = h_acc = None
        cur = put(bounds[0])
        for ci, (a, b) in enumerate(bounds):
            node_c, g, h = _stream_level_chunk(cfg, trees, *cur, depth,
                                               half)
            if ci + 1 < len(bounds):
                cur = put(bounds[ci + 1])
            node_host[a:b] = node_c[0].cpu().numpy()
            g_acc = g if g_acc is None else g_acc + g
            h_acc = h if h_acc is None else h_acc + h
        return g_acc, h_acc
    return _grow_streaming(cfg, level_chunks, fm)


def _build_tree_streaming_device(cfg: TreeConfig, bins_put, n_chunks: int,
                                 node_state, grad_state, hess_state, fm):
    """The resident-state twin of `_build_tree_streaming`: node, grad
    and hess stay on the device as one (1, rows) tensor a chunk, only
    the bins stream in, and nothing inside a level is read on the host.
    node_state is updated in place with each chunk's routed nodes."""
    def level_chunks(trees, depth, half):
        g_acc = h_acc = None
        cur = bins_put(0)
        for ci in range(n_chunks):
            node_c, g, h = _stream_level_chunk(
                cfg, trees, cur, node_state[ci], grad_state[ci],
                hess_state[ci], depth, half)
            if ci + 1 < n_chunks:
                cur = bins_put(ci + 1)   # the copy overlaps the compute
            node_state[ci] = node_c
            g_acc = g if g_acc is None else g_acc + g
            h_acc = h if h_acc is None else h_acc + h
        return g_acc, h_acc
    return _grow_streaming(cfg, level_chunks, fm)


def _one(trees) -> Dict[str, torch.Tensor]:
    return {k: v[0] for k, v in trees.items()}


def _stack_host(trees: List[Dict[str, torch.Tensor]]):
    return _to_numpy({k: torch.stack([t[k] for t in trees])
                      for k in trees[0]})


def _build_gbt_streaming_resident(cfg: TreeConfig, bins_mm, y_mm, w_mm,
                                  n_trees: int, chunk_rows: int, fm,
                                  init_trees, early_stop_window: int,
                                  n_train: int, n_val: int, dev, stager):
    """The device-resident row-state tier of `build_gbt_streaming`:
    node/pred/grad/hess and the y/w the gradients read live on the
    device, a tensor a chunk, for the whole build; the bins stream from
    disk a chunk at a time (one chunk stays on the device across rounds
    when the data is one chunk). Gradients and the log-loss sigmoid run
    on the device, the boosting update is a gather of leaf values at
    the routed nodes, and the round's validation error is summed on the
    device and read once a round: no host read inside a level."""
    r = n_train + n_val
    bounds = [(s, min(s + chunk_rows, n_train))
              for s in range(0, n_train, chunk_rows)]
    vbounds = [(s, min(s + chunk_rows, r))
               for s in range(n_train, r, chunk_rows)]
    n_chunks = len(bounds)

    def put_bins(a, b):
        return stager.put("bins", _chunk_bins(bins_mm, a, b))

    def col(src, a, b, key):
        return stager.put(key, np.asarray(src[a:b], np.float32)[None])

    y_dev = [col(y_mm, a, b, "y") for a, b in bounds]
    w_dev = [col(w_mm, a, b, "w") for a, b in bounds]
    pred_dev = [torch.zeros_like(t) for t in y_dev]
    node_init = [torch.zeros(t.shape, dtype=torch.long, device=dev)
                 for t in y_dev]
    vy_dev = [col(y_mm, a, b, "vy") for a, b in vbounds]
    vw_dev = [torch.ones_like(t) for t in vy_dev]   # unit val weights
    vraw_dev = [torch.zeros_like(t) for t in vy_dev]
    bins_resident = put_bins(*bounds[0]) if n_chunks == 1 else None

    def bins_put(ci):
        if bins_resident is not None:
            return bins_resident
        return put_bins(*bounds[ci])

    def add_predict(tree1, binsT, raw):
        return raw + cfg.learning_rate * predict_trees(
            tree1, binsT, cfg.max_depth, cfg.n_bins)

    trees: List[Dict[str, torch.Tensor]] = []
    if init_trees is not None:
        init = _trees_on(init_trees, dev)
        for i in range(init["feature"].shape[0]):
            tree1 = {k: v[i:i + 1] for k, v in init.items()}
            trees.append(_one(tree1))
            for ci in range(n_chunks):
                pred_dev[ci] = add_predict(tree1, bins_put(ci), pred_dev[ci])
            for vi, (a, b) in enumerate(vbounds):
                vraw_dev[vi] = add_predict(tree1, put_bins(a, b),
                                           vraw_dev[vi])
    grad_state: List[Any] = [None] * n_chunks
    hess_state: List[Any] = [None] * n_chunks
    val_errs: List[float] = []
    best_val, bad = np.inf, 0
    for _ in range(n_trees):
        node_state = list(node_init)
        for ci in range(n_chunks):
            grad_state[ci], hess_state[ci] = gbt_gradients(
                y_dev[ci], pred_dev[ci], w_dev[ci], cfg.loss)
        tree1 = _build_tree_streaming_device(
            cfg, bins_put, n_chunks, node_state, grad_state, hess_state, fm)
        trees.append(_one(tree1))
        for ci in range(n_chunks):   # a leaf gather: no IO, no host read
            pred_dev[ci] = pred_dev[ci] + cfg.learning_rate * torch.gather(
                tree1["leaf_value"], 1, node_state[ci])
        if n_val:
            num = den = None
            for vi, (a, b) in enumerate(vbounds):
                vraw_dev[vi] = add_predict(tree1, put_bins(a, b),
                                           vraw_dev[vi])
                vp = torch.sigmoid(vraw_dev[vi]) \
                    if cfg.loss.startswith("log") else vraw_dev[vi]
                nm = torch.sum((vp - vy_dev[vi]) ** 2 * vw_dev[vi])
                dn = torch.sum(vw_dev[vi])
                num = nm if num is None else num + nm
                den = dn if den is None else den + dn
            # the round's one host read: early stop is a host decision
            err = float(num / torch.clamp(den, min=1e-12))
            val_errs.append(err)
            if err < best_val - 1e-9:
                best_val, bad = err, 0
            else:
                bad += 1
                if early_stop_window and bad >= early_stop_window:
                    break
    return _stack_host(trees), val_errs


def build_gbt_streaming(cfg: TreeConfig, bins_mm, y_mm, w_mm, n_trees: int,
                        valid_rate: float = 0.0, chunk_rows: int = 1 << 20,
                        feature_mask: Optional[np.ndarray] = None,
                        init_trees: Optional[Any] = None,
                        early_stop_window: int = 0,
                        n_val: Optional[int] = None,
                        device: "str | torch.device" = "cuda"):
    """Out-of-core boosting on `device`: the (R, C) bin matrix (a
    memmap) streams a chunk at a time, max_depth + 1 passes a tree. The
    row state lives on the device when it fits
    (`gbt_resident_state_mode`), else on the host at 8 bytes a row.
    Validation is the trailing `n_val` rows (default valid_rate of
    them), with unit weights. Returns (stacked numpy trees, per-round
    val errors)."""
    from shifu_tpu_torch.data.pipeline import Stager
    dev = resolve_device(device)
    r, c = bins_mm.shape
    if n_val is None:
        n_val = int(r * max(valid_rate, 0.0))
    n_train = r - n_val
    if n_train <= 0:
        raise ValueError("streaming GBT needs at least one training row")
    fm = _f32(feature_mask if feature_mask is not None
              else np.ones(c, np.float32), dev)[None]
    stager = Stager(dev)
    if gbt_resident_state_mode(n_train, n_val):
        return _build_gbt_streaming_resident(
            cfg, bins_mm, y_mm, w_mm, n_trees, chunk_rows, fm, init_trees,
            early_stop_window, n_train, n_val, dev, stager)

    pred = np.zeros(n_train, np.float32)
    vraw = np.zeros(n_val, np.float32)
    node_host = np.zeros(n_train, np.int32)
    trees: List[Dict[str, torch.Tensor]] = []
    if init_trees is not None:
        init = _trees_on(init_trees, dev)
        for i in range(init["feature"].shape[0]):
            tree1 = {k: v[i:i + 1] for k, v in init.items()}
            trees.append(_one(tree1))
            _accumulate_pred(cfg, tree1, bins_mm, pred, vraw, n_train,
                             chunk_rows, stager)

    def grad_of_chunk(a, b):
        y_c = np.asarray(y_mm[a:b], np.float32)
        w_c = np.asarray(w_mm[a:b], np.float32)
        if cfg.loss.startswith("log"):
            p = 1.0 / (1.0 + np.exp(-pred[a:b]))
            return (p - y_c) * w_c, p * (1 - p) * w_c
        return (pred[a:b] - y_c) * w_c, np.ones_like(y_c) * w_c

    val_errs: List[float] = []
    best_val, bad = np.inf, 0
    for _ in range(n_trees):
        node_host[:] = 0
        tree1 = _build_tree_streaming(cfg, bins_mm[:n_train], grad_of_chunk,
                                      node_host, chunk_rows, fm, stager)
        trees.append(_one(tree1))
        leaf = tree1["leaf_value"][0].cpu().numpy()
        pred += cfg.learning_rate * leaf[node_host]
        if n_val:
            for a in range(n_train, r, chunk_rows):
                b = min(a + chunk_rows, r)
                contrib = predict_trees(
                    tree1, stager.put("vbins", _chunk_bins(bins_mm, a, b)),
                    cfg.max_depth, cfg.n_bins)[0].cpu().numpy()
                vraw[a - n_train:b - n_train] += cfg.learning_rate * contrib
            vy = np.asarray(y_mm[n_train:r], np.float32)
            err = float(_val_error(torch.as_tensor(vraw),
                                   torch.as_tensor(vy),
                                   torch.ones(len(vy)), cfg.loss))
            val_errs.append(err)
            if err < best_val - 1e-9:
                best_val, bad = err, 0
            else:
                bad += 1
                if early_stop_window and bad >= early_stop_window:
                    break
    return _stack_host(trees), val_errs


def _accumulate_pred(cfg: TreeConfig, tree1, bins_mm, pred, vraw,
                     n_train: int, chunk_rows: int, stager) -> None:
    """Add one tree's shrunk scores to the host train and val raw scores
    by streaming the bin matrix (resuming from init_trees)."""
    r = bins_mm.shape[0]
    for a in range(0, r, chunk_rows):
        b = min(a + chunk_rows, r)
        contrib = cfg.learning_rate * predict_trees(
            tree1, stager.put("vbins", _chunk_bins(bins_mm, a, b)),
            cfg.max_depth, cfg.n_bins)[0].cpu().numpy()
        if a < n_train:
            hi = min(b, n_train)
            pred[a:hi] += contrib[:hi - a]
        if b > n_train:
            lo = max(a, n_train)
            vraw[lo - n_train:b - n_train] += contrib[lo - a:]


def build_rf_streaming(cfg: TreeConfig, bins_mm, y_mm, w_mm, n_trees: int,
                       subset_strategy: str, bagging_rate: float,
                       seed: int, chunk_rows: int = 1 << 20,
                       device: "str | torch.device" = "cuda"):
    """Out-of-core random forest on `device`: trees build one after
    another (the resident build grows them in lockstep over the whole
    matrix), each with counter-based Poisson instance weights (numpy
    Philox keyed ``seed + 104729·t`` at the chunk's first row) and a
    feature subset from ``default_rng(seed)``."""
    from shifu_tpu_torch.data.pipeline import Stager
    dev = resolve_device(device)
    r, c = bins_mm.shape
    rng = np.random.default_rng(seed)
    k = feature_subset_count(subset_strategy, c)
    stager = Stager(dev)
    node_host = np.zeros(r, np.int32)
    trees = []
    for t in range(n_trees):
        mask = np.zeros(c, np.float32)
        mask[rng.choice(c, size=k, replace=False)] = 1.0

        def grad_of_chunk(a, b, t=t):
            y_c = np.asarray(y_mm[a:b], np.float32)
            w_c = np.asarray(w_mm[a:b], np.float32)
            gen = np.random.Generator(np.random.Philox(
                key=seed + 104729 * t, counter=a))
            iw = gen.poisson(max(bagging_rate, 1e-6),
                             b - a).astype(np.float32)
            return -(y_c * w_c * iw), w_c * iw

        node_host[:] = 0
        trees.append(_one(_build_tree_streaming(
            cfg, bins_mm, grad_of_chunk, node_host, chunk_rows,
            _f32(mask, dev)[None], stager)))
    return _stack_host(trees)
