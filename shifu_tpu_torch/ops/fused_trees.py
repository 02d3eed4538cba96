"""Fused GBT/RF ensemble inference (kernel K2).

Counterpart of `shifu_tpu/ops/pallas_trees.py`: raw (C, R) values,
(C, K) +inf-padded cuts and the (8, T·N_pad) packed node block
(`pack_ensemble`) → (R,) final scores with `gbdt.predict`'s convert,
binning and walk included, in one launch.

Kernel: `csrc/fused_trees.cu`, CUDA C++ for sm_90a. It replaces the TPU
kernel `_tree_kernel` via `_predict_ensemble_pallas`
(shifu_tpu/ops/pallas_trees.py:118,203). At the HIGGS serving shape it
sits near the card's balance point (C·K compares per row against C
floats read), so the kernel keeps what a row reads again on chip: one
thread per row, cuts and 8-byte packed nodes in shared memory, each
row's bins computed once into shared memory, and a direct-index walk
instead of the TPU's one-hot routing.

Routing has no knob: CUDA tensors launch the kernel (a failed build or
launch raises), CPU tensors take `predict_ensemble_plain`, the plain
PyTorch version of the same function. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from shifu_tpu_torch import _build

__all__ = ["pack_ensemble", "predict_ensemble", "predict_ensemble_plain",
           "convert", "launches"]

launches = 0  # kernel launches of this process (plain calls not counted)

# Shared-memory budget of one block (of the 227 KB an H100 block may
# use): ensembles whose nodes do not fit are walked in chunks of trees.
SMEM_BUDGET = 96 * 1024


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
    devices = {t.device for t in (nodes, valuesT, cuts)}
    if len(devices) != 1:
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
                     return_leaves: bool = False
                     ) -> Union[torch.Tensor,
                                Tuple[torch.Tensor, torch.Tensor]]:
    """Packed ensemble + FusedBins-style raw inputs → (R,) scores (and,
    with `return_leaves`, the (T, R) int32 landing node ids). On a CUDA
    tensor this launches the kernel; on a CPU tensor it runs the plain
    version. Every split node's feature must be < C: `weights.to_torch`
    checks that once per model, so the kernel does not re-read the node
    table on the host per call."""
    _check(nodes, valuesT, cuts, n_trees, n_bins)
    kw = dict(n_trees=n_trees, kind=kind, loss=loss,
              learning_rate=learning_rate, max_depth=max_depth,
              n_bins=n_bins, return_leaves=return_leaves)
    if valuesT.device.type == "cpu":
        return predict_ensemble_plain(nodes, valuesT, cuts, **kw)
    if valuesT.device.type != "cuda":
        raise ValueError(f"no kernel for device {valuesT.device}")
    # the kernel packs a node into 8 bytes and a bin into one
    if n_bins > 256 or valuesT.shape[0] > 32767:
        raise ValueError(f"the tree kernel takes n_bins <= 256 and < 32768 "
                         f"columns, got {n_bins} and {valuesT.shape[0]}")
    global launches
    lib = _lib()
    c, r = valuesT.shape
    k = cuts.shape[1]
    n_pad = nodes.shape[1] // n_trees
    fixed = lib.fused_trees_smem_bytes(c, k, n_pad, 0)
    per_tree = lib.fused_trees_smem_bytes(0, 0, n_pad, 1)
    chunk = min(n_trees, (SMEM_BUDGET - fixed) // per_tree)
    if chunk < 1:
        raise ValueError(f"{c} columns × {k} cuts and {n_pad}-node trees "
                         f"exceed the tree kernel's shared memory budget")
    out = torch.empty(r, dtype=torch.float32, device=valuesT.device)
    leaves = (torch.empty((n_trees, r), dtype=torch.int32,
                          device=valuesT.device) if return_leaves else None)
    stream = torch.cuda.current_stream(valuesT.device).cuda_stream
    rc = lib.fused_trees_launch(
        valuesT.data_ptr(), cuts.data_ptr(), nodes.data_ptr(),
        out.data_ptr(), leaves.data_ptr() if leaves is not None else None,
        r, c, k, n_trees, n_pad, max_depth, n_bins, chunk,
        int(kind == "rf"), int(str(loss).startswith("log")),
        float(learning_rate), stream)
    _build.check(rc, "fused_trees", lib.fused_trees_error_string)
    launches += 1
    return (out, leaves) if return_leaves else out


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_trees")
    if lib.fused_trees_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_trees_launch.argtypes = [p, p, p, p, p] + [i] * 10 + [
            ctypes.c_float, p]
        lib.fused_trees_launch.restype = i
        lib.fused_trees_smem_bytes.argtypes = [i, i, i, i]
        lib.fused_trees_smem_bytes.restype = i
        lib.fused_trees_error_string.argtypes = [i]
        lib.fused_trees_error_string.restype = ctypes.c_char_p
    return lib
