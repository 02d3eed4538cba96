"""Fused GBT/RF ensemble inference (kernel K2).

Counterpart of `shifu_tpu/ops/pallas_trees.py`: raw (C, R) values,
(C, K) +inf-padded cuts and the (8, T·N_pad) packed node block
(`pack_ensemble`) → (R,) final scores with `gbdt.predict`'s convert,
binning and walk included, in one launch.

Kernel: `csrc/fused_trees.cu`, CUDA C++ for sm_90a. It replaces the TPU
kernel `_tree_kernel` via `_predict_ensemble_pallas`
(shifu_tpu/ops/pallas_trees.py:118,203). The kernel bins each value by
a binary search over the ascending cuts, keeps cuts and 4-byte split
words (`pack_nodes`, built once per model) in shared memory, and
walks by direct index instead of the TPU's one-hot routing. `_k2_plan`
picks its layout: one thread per row for large batches, one warp per
row for the serving buckets, so that a 512-row batch spreads over the
card. Shared-memory sizes and the kernel attributes are set once per
shape, not per launch.

Routing has no knob: CUDA tensors launch the kernel (a failed build or
launch raises), CPU tensors take `predict_ensemble_plain`, the plain
PyTorch version of the same function. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from shifu_tpu_torch import _build

__all__ = ["pack_ensemble", "pack_nodes", "predict_ensemble",
           "predict_ensemble_plain", "convert", "launches"]

launches = 0  # kernel launches of this process (plain calls not counted)

# Shared-memory budget of one block (of the 227 KB an H100 block may
# use): ensembles whose nodes do not fit are walked in chunks of trees.
SMEM_BUDGET = 96 * 1024

# Layouts of csrc/fused_trees.cu and the constants that size them.
LAYOUT_ROWS, LAYOUT_WARPS = 0, 1
ROW_THREADS = 256       # rows layout: threads (rows) per block
WARPS = 4               # warps layout: warps (rows) per block
SMALL_R_MAX = 2048      # batches up to this many rows take the warps layout


class K2Plan(NamedTuple):
    layout: int         # LAYOUT_ROWS or LAYOUT_WARPS
    chunk: int          # trees whose nodes sit in shared memory at once
    smem: int           # dynamic shared-memory bytes of one block


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def search_span(k: int) -> int:
    """`search_span` of csrc/binning.cuh: the slots a column's cuts take
    in shared memory, 2·top - 1 for top the largest power of two <= K
    (the pads past K hold NaN, which the search never counts)."""
    return 2 * (1 << (k.bit_length() - 1)) - 1 if k > 0 else 0


def smem_bytes(layout: int, c: int, k: int, n_pad: int, chunk: int) -> int:
    """`smem_bytes` of csrc/fused_trees.cu (the launcher checks it): a
    chunk of split words and leaves, the cuts at `search_span(K)` slots a
    column, and the bins (rows layout) or the bins and per-tree leaf
    values (warps layout)."""
    b = chunk * n_pad * 8 + _round_up(c * search_span(k) * 4, 8)
    if layout == LAYOUT_ROWS:
        return b + c * ROW_THREADS
    return b + WARPS * chunk * 4 + WARPS * _round_up(c, 4)


@functools.lru_cache(maxsize=64)
def _chunked(layout: int, c: int, k: int, t: int, n_pad: int,
             budget: int) -> K2Plan:
    fixed = smem_bytes(layout, c, k, n_pad, 0)
    per_tree = smem_bytes(layout, 0, 0, n_pad, 1) - \
        smem_bytes(layout, 0, 0, n_pad, 0)
    chunk = min(t, (budget - fixed) // per_tree)
    if chunk < 1:
        raise ValueError(f"{c} columns × {k} cuts and {n_pad}-node trees "
                         f"exceed the tree kernel's shared memory budget")
    return K2Plan(layout, chunk, smem_bytes(layout, c, k, n_pad, chunk))


def _k2_plan(r: int, c: int, k: int, t: int, n_pad: int) -> K2Plan:
    """Layout, tree chunk and shared-memory bytes for R rows of C
    columns, K cuts and T trees of N_pad nodes: one warp per row up to
    SMALL_R_MAX rows (a serving batch then spreads over R/4 blocks),
    one thread per row above (a warp would read a row's C values with
    stride R). Sizes are computed once per shape and budget."""
    layout = LAYOUT_WARPS if r <= SMALL_R_MAX else LAYOUT_ROWS
    return _chunked(layout, c, k, t, n_pad, SMEM_BUDGET)


def pack_nodes(nodes: torch.Tensor, n_trees: int) -> torch.Tensor:
    """(8, T·N_pad) f32 block of `pack_ensemble` → the kernel's (2,
    T·N_pad) int32 planes, on the block's device: row 0 the split words
    (bits 0-7 the split bin, at most 254, bit 8 default_left, bit 9
    stop, bits 16-30 the feature, 0 on stop nodes), row 1 the leaf
    values' bits. A walk step reads one 4-byte word; the leaf only at
    the end."""
    stop = nodes[3] > 0
    feat = torch.where(stop, 0, nodes[0].to(torch.int32))
    # <= 254: the kernel's missing bin (255) lies above every split bin
    sbin = nodes[1].to(torch.int32).clamp(0, 254)
    word = sbin | ((nodes[2] > 0).to(torch.int32) << 8) | \
        (stop.to(torch.int32) << 9) | (feat << 16)
    return torch.stack([word, nodes[4].contiguous().view(torch.int32)])


def pack_ensemble(trees: Dict[str, Any]) -> Tuple[np.ndarray, int]:
    """Flatten a (T, n_nodes) tree dict into the packed node block
    (8, T·N_pad) f32 with N_pad a multiple of 8 — the layout of
    `pallas_trees.pack_ensemble`. Rows: 0 feature (-1 on leaves/pad),
    1 split bin, 2 default_left, 3 stop (is_leaf | feature < 0; pad
    nodes stop too), 4 leaf_value. Returns (packed, N_pad)."""
    feat = np.asarray(trees["feature"], np.float32)
    t, n = feat.shape
    n_pad = max(8, -(-n // 8) * 8)

    def lane(a, fill):
        return np.pad(np.asarray(a, np.float32),
                      ((0, 0), (0, n_pad - n)), constant_values=fill)

    stop = (np.asarray(trees["is_leaf"], bool) |
            (np.asarray(trees["feature"]) < 0))
    packed = np.zeros((8, t * n_pad), np.float32)
    packed[0] = lane(feat, -1.0).reshape(-1)
    packed[1] = lane(trees["bin"], 0.0).reshape(-1)
    packed[2] = lane(trees["default_left"], 0.0).reshape(-1)
    packed[3] = lane(stop, 1.0).reshape(-1)
    packed[4] = lane(trees["leaf_value"], 0.0).reshape(-1)
    return packed, n_pad


def convert(per_tree: torch.Tensor, kind: str, loss: str,
            learning_rate: float) -> torch.Tensor:
    """`gbdt.predict`'s convert over (T, R) leaf values, the leaf sum
    taken in tree order as the kernel takes it: RF mean, GBT lr·Σ with
    the ±30-clipped sigmoid for log loss."""
    total = torch.zeros_like(per_tree[0])
    for leaf in per_tree:
        total = total + leaf
    if kind == "rf":
        return total / float(per_tree.shape[0])
    raw = float(learning_rate) * total
    if str(loss).startswith("log"):
        return 1.0 / (1.0 + torch.exp(-torch.clamp(raw, -30.0, 30.0)))
    return raw


def predict_ensemble_plain(nodes: torch.Tensor, valuesT: torch.Tensor,
                           cuts: torch.Tensor, *, n_trees: int, kind: str,
                           loss: str = "squared",
                           learning_rate: float = 0.1, max_depth: int,
                           n_bins: int, return_leaves: bool = False
                           ) -> Union[torch.Tensor,
                                      Tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version of the kernel: Σ(v ≥ cut) binning clamped
    to n_bins-2 (NaN → n_bins-1), a gather walk over every tree at once,
    and the convert with the leaf sum taken in tree order."""
    c, r = valuesT.shape
    s = nodes.shape[1]
    n_pad = s // n_trees
    bins = torch.zeros((c, r), dtype=torch.long, device=valuesT.device)
    for j in range(cuts.shape[1]):
        bins += valuesT >= cuts[:, j:j + 1]
    bins = torch.clamp(bins, max=n_bins - 2)
    bins = torch.where(torch.isnan(valuesT), n_bins - 1, bins)   # (C, R)

    def table(row):
        return nodes[row].reshape(n_trees, n_pad)

    feat, sbin = table(0).long(), table(1).long()
    dl, stop, leaf = table(2) > 0, table(3) > 0, table(4)
    node = torch.zeros((n_trees, r), dtype=torch.long,
                       device=valuesT.device)
    for _ in range(max_depth):
        f = torch.gather(feat, 1, node)
        rb = torch.gather(bins, 0, f.clamp(min=0))
        left = torch.where(rb == n_bins - 1, torch.gather(dl, 1, node),
                           rb <= torch.gather(sbin, 1, node))
        nxt = 2 * node + torch.where(left, 1, 2)
        node = torch.where(torch.gather(stop, 1, node), node, nxt)
    score = convert(torch.gather(leaf, 1, node), kind, loss, learning_rate)
    return (score, node.to(torch.int32)) if return_leaves else score


def _check(nodes, valuesT, cuts, n_trees: int, n_bins: int) -> None:
    if valuesT.dim() != 2 or cuts.dim() != 2 or nodes.dim() != 2:
        raise ValueError("valuesT (C, R), cuts (C, K) and nodes (8, S) "
                         "must be 2-D")
    c = valuesT.shape[0]
    if cuts.shape[0] != c:
        raise ValueError(f"cuts have {cuts.shape[0]} rows for {c} columns")
    if nodes.shape[0] != 8 or nodes.shape[1] % max(n_trees, 1):
        raise ValueError(f"nodes {tuple(nodes.shape)} is not the packed "
                         f"(8, T·N_pad) block of {n_trees} trees")
    if n_trees < 1:
        raise ValueError("an ensemble needs at least one tree")
    if n_bins < 2:
        raise ValueError(f"n_bins {n_bins} < 2")
    if not (nodes.device == valuesT.device == cuts.device):
        devices = {t.device for t in (nodes, valuesT, cuts)}
        raise ValueError(f"inputs lie on several devices: {devices}")
    for name, t in (("nodes", nodes), ("valuesT", valuesT), ("cuts", cuts)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def predict_ensemble(nodes: torch.Tensor, valuesT: torch.Tensor,
                     cuts: torch.Tensor, *, n_trees: int, kind: str,
                     loss: str = "squared", learning_rate: float = 0.1,
                     max_depth: int, n_bins: int,
                     return_leaves: bool = False,
                     node_pack: Optional[torch.Tensor] = None
                     ) -> Union[torch.Tensor,
                                Tuple[torch.Tensor, torch.Tensor]]:
    """Packed ensemble + FusedBins-style raw inputs → (R,) scores (and,
    with `return_leaves`, the (T, R) int32 landing node ids). On a CUDA
    tensor this launches the kernel; on a CPU tensor it runs the plain
    version. `node_pack` is `pack_nodes(nodes, n_trees)` built once by
    the model (`weights.TreeEnsemble.node_pack`); without it the wrapper
    packs per call. Every split node's feature must be < C and each
    column's cuts ascending: `weights.to_torch` checks the features once
    per model, so the kernel does not re-read the node table on the
    host per call."""
    if not valuesT.is_cuda:
        _check(nodes, valuesT, cuts, n_trees, n_bins)
        if valuesT.device.type != "cpu":
            raise ValueError(f"no kernel for device {valuesT.device}")
        return predict_ensemble_plain(
            nodes, valuesT, cuts, n_trees=n_trees, kind=kind, loss=loss,
            learning_rate=learning_rate, max_depth=max_depth,
            n_bins=n_bins, return_leaves=return_leaves)
    r = valuesT.shape[-1]
    key = (id(nodes), id(cuts), id(node_pack), n_trees, kind, loss,
           learning_rate, max_depth, n_bins, r)
    hit = _launches.get(key)
    if hit is None or not (hit[0] is nodes and hit[1] is cuts
                           and hit[2] is node_pack):
        hit = _launcher(key, nodes, valuesT, cuts, node_pack, n_trees, kind,
                        loss, learning_rate, max_depth, n_bins)
    launch, dev, c = hit[3:6]
    if (valuesT.dim() != 2 or valuesT.shape[0] != c
            or valuesT.dtype != torch.float32
            or not valuesT.is_contiguous()
            or valuesT.get_device() != dev.index):
        _check(nodes, valuesT, cuts, n_trees, n_bins)
        raise ValueError(f"valuesT must be a contiguous float32 ({c}, R) "
                         f"block on {dev}")
    global launches
    out = torch.empty(r, dtype=torch.float32, device=dev)
    leaves = (torch.empty((n_trees, r), dtype=torch.int32, device=dev)
              if return_leaves else None)
    rc = _build.call_on(
        dev.index, _LIB.fused_trees_run, launch, valuesT.data_ptr(),
        out.data_ptr(), leaves.data_ptr() if leaves is not None else None,
        _build.raw_stream(dev))
    if rc:
        _build.check(rc, "fused_trees", _LIB.fused_trees_error_string)
    launches += 1
    return (out, leaves) if return_leaves else out


class _Launch(ctypes.Structure):
    """`Launch` of csrc/fused_trees.cu, field for field."""
    _fields_ = ([("cuts", ctypes.c_void_p), ("nodes", ctypes.c_void_p)]
                + [(f, ctypes.c_int) for f in (
                    "layout", "grid", "smem", "r", "c", "k", "t", "n_pad",
                    "max_depth", "n_bins", "chunk", "is_rf", "log_loss")]
                + [("lr", ctypes.c_float)])


# (nodes, cuts, node_pack, statics, R) of the models scored lately →
# (those tensors, launch address, device, C, the launch and the node
# planes it points into); an entry holds its tensors, so an id is never
# another tensor's
_launches: Dict[Tuple[Any, ...], Tuple[Any, ...]] = {}


def _launcher(key, nodes, valuesT, cuts, node_pack, n_trees, kind, loss,
              learning_rate, max_depth, n_bins) -> Tuple[Any, ...]:
    """Check a model on the card and its node planes, and fill its launch
    for R rows (plan, grid, shared memory prepared once per size);
    cached when the caller passes the model's `node_pack`."""
    _check(nodes, valuesT, cuts, n_trees, n_bins)
    # the kernel packs a node's bin into one byte, its feature into two
    c = valuesT.shape[0]
    if n_bins > 256 or c > 32767:
        raise ValueError(f"the tree kernel takes n_bins <= 256 and < 32768 "
                         f"columns, got {n_bins} and {c}")
    s = nodes.shape[1]
    n_pad = s // n_trees
    dev = valuesT.device
    pack = pack_nodes(nodes, n_trees) if node_pack is None else node_pack
    if (tuple(pack.shape) != (2, s) or pack.dtype != torch.int32
            or pack.device != dev or not pack.is_contiguous()
            or pack.data_ptr() % 16 or n_pad % 8):
        raise ValueError(f"node_pack must be pack_nodes(nodes): a "
                         f"contiguous, 16-byte aligned int32 (2, {s}) "
                         f"block on {dev}")
    r, k = valuesT.shape[1], cuts.shape[1]
    plan = _k2_plan(r, c, k, n_trees, n_pad)
    cap = _prepare(_lib(), dev, plan.layout, plan.smem)
    grid = (min(cap, -(-r // ROW_THREADS)) if plan.layout == LAYOUT_ROWS
            else -(-r // WARPS))
    launch = _Launch(cuts.data_ptr(), pack.data_ptr(), plan.layout, grid,
                     plan.smem, r, c, k, n_trees, n_pad, max_depth, n_bins,
                     plan.chunk, kind == "rf", str(loss).startswith("log"),
                     learning_rate)
    entry = (nodes, cuts, node_pack, ctypes.addressof(launch), dev, c,
             launch, pack)
    if node_pack is not None:
        if len(_launches) >= 64:
            _launches.clear()
        _launches[key] = entry
    return entry


# (device, layout, smem) → blocks the card holds at once; (device,
# layout) → the shared-memory limit set there (the largest asked for)
_prepared: Dict[Tuple[int, int, int], int] = {}
_limits: Dict[Tuple[int, int], int] = {}


def _prepare(lib, device: torch.device, layout: int, smem: int) -> int:
    """The kernel attribute for `smem` bytes, set on `device` once per
    (device, layout, bytes) and never lowered there; returns the blocks
    the card holds at once."""
    key = (device.index, layout, smem)
    cap = _prepared.get(key)
    if cap is None:
        limit = max(smem, _limits.get(key[:2], 0))
        out = ctypes.c_int(0)
        rc = _build.call_on(device.index, lib.fused_trees_prepare, layout,
                            limit, smem, ctypes.byref(out))
        _build.check(rc, "fused_trees_prepare",
                     lib.fused_trees_error_string)
        _limits[key[:2]] = limit
        cap = _prepared[key] = max(1, out.value)
    return cap


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = _build.load("fused_trees")
    if lib.fused_trees_run.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_trees_run.argtypes = [p] * 5
        lib.fused_trees_run.restype = i
        lib.fused_trees_prepare.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.fused_trees_prepare.restype = i
        lib.fused_trees_error_string.argtypes = [i]
        lib.fused_trees_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib
