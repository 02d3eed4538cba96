"""Tree-algorithm training step (GBT / RF / DT) — the port of
`shifu_tpu/processor/train_tree.py`: resident (`run_tree`) and, with
`train#trainOnDisk`, streaming (`_run_tree_streaming`: the cleaned
`.npy` layout binned once into a cached `bins.npy`, then
`gbdt.build_gbt_streaming` / `build_rf_streaming`).

Input is the cleaned (not normalized) data under `tmp/CleanedData`.
Binning tables come straight from the stats phase's ColumnConfig
(binBoundary / binPosRate), so trees split on the same boundaries, and
the saved `models/model<bag>.{gbt,rf}` files are the JAX package's
format: its `load_model` reads them and the port's `serve` serves them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import time
from typing import List, Optional

import numpy as np
import torch

from shifu_tpu_torch import resolve_device
from shifu_tpu_torch.config.column_config import ColumnConfig
from shifu_tpu_torch.config.model_config import Algorithm, ModelConfig
from shifu_tpu_torch.fileio import atomic_write
from shifu_tpu_torch.models import gbdt
from shifu_tpu_torch.models.spec import load_model, save_model
from shifu_tpu_torch.processor import norm as norm_proc
from shifu_tpu_torch.processor.base import ProcessorContext
from shifu_tpu_torch.train.trainer import bagging_weights, split_validation

log = logging.getLogger("shifu_tpu_torch")


def tree_config_from_params(mc: ModelConfig) -> gbdt.TreeConfig:
    t = mc.train
    return gbdt.TreeConfig(
        max_depth=int(t.get_param("MaxDepth", 6) or 6),
        n_bins=0,  # filled by caller once tables are known
        min_instances_per_node=int(t.get_param("MinInstancesPerNode", 1) or 1),
        min_info_gain=float(t.get_param("MinInfoGain", 0.0) or 0.0),
        reg_lambda=float(t.get_param("RegLambda", 1.0) or 1.0),
        learning_rate=float(t.get_param("LearningRate", 0.1) or 0.1),
        loss=str(t.get_param("Loss", "squared") or "squared").lower(),
    )


def build_tables(ccs_num: List[ColumnConfig], ccs_cat: List[ColumnConfig],
                 max_bins: int):
    """Numeric cuts + posRate-ordered categorical maps from stats."""
    n_cuts = max(max_bins - 1, 1)
    cuts = np.full((n_cuts, len(ccs_num)), np.inf, np.float32)
    for j, cc in enumerate(ccs_num):
        bb = np.asarray(cc.columnBinning.binBoundary or [-np.inf], np.float64)
        interior = bb[1:][np.isfinite(bb[1:])]
        cuts[:len(interior), j] = interior
    cat_orders = []
    for cc in ccs_cat:
        pr = np.asarray(cc.columnBinning.binPosRate or [0.0], np.float64)
        v = len(cc.columnBinning.binCategory or [])
        order = np.argsort(np.argsort(pr[:v], kind="stable")).astype(np.int32) \
            if v else np.zeros(0, np.int32)
        cat_orders.append(order)
    return cuts, cat_orders


def _tables_and_cfg(ctx: ProcessorContext, meta):
    """Binning tables + TreeConfig from ColumnConfig stats."""
    mc = ctx.model_config
    cols = norm_proc.selected_candidates(ctx.column_configs)
    by_name = {c.columnName: c for c in cols}
    ccs_num = [by_name[n] for n in meta["denseNames"] if n in by_name]
    ccs_cat = [by_name[n] for n in meta["indexNames"] if n in by_name]

    max_bins = mc.stats.maxNumBin
    cuts, cat_orders = build_tables(ccs_num, ccs_cat, max_bins)
    # histogram width: enough for numeric cut slots, every categorical
    # vocab, plus the shared missing slot (last)
    value_slots = max([cuts.shape[0] + 1]
                      + [len(o) for o in cat_orders]) if (len(ccs_num) or
                                                          len(ccs_cat)) else 2
    n_bins = value_slots + 1
    cfg = dataclasses.replace(tree_config_from_params(mc), n_bins=n_bins)
    return cfg, gbdt.make_bin_tables(cuts, cat_orders, n_bins), n_bins


def run_tree(ctx: ProcessorContext, seed: int = 12306,
             device: "str | torch.device" = "cuda"):
    t0 = time.time()
    dev = resolve_device(device)
    mc = ctx.model_config
    alg = mc.train.algorithm

    clean_path = ctx.path_finder.cleaned_data_path()
    if mc.train.trainOnDisk and not mc.is_multi_classification:
        return _run_tree_streaming(ctx, seed, dev)
    if not os.path.exists(os.path.join(clean_path, "data.npz")):
        raise FileNotFoundError(
            f"cleaned data not found at {clean_path}; run `norm` first")
    data, meta = norm_proc.load_normalized(clean_path)
    dense = data["dense"].astype(np.float32)
    codes = data["index"].astype(np.int32)
    y = data["tags"].astype(np.float32)
    w = data["weights"].astype(np.float32)

    if mc.train.upSampleWeight != 1.0:
        # duplicate-positive rebalance expressed as weight upsampling
        w = w * np.where(y > 0.5, np.float32(mc.train.upSampleWeight), 1.0)

    cfg, tables, n_bins = _tables_and_cfg(ctx, meta)
    bins = gbdt.bin_dataset(tables, dense, codes, n_bins)

    n_trees = int(mc.train.get_param("TreeNum", 10 if alg is Algorithm.RF
                                     else 100) or 10)
    if alg is Algorithm.DT:
        n_trees = 1
    subset = str(mc.train.get_param("FeatureSubsetStrategy", "ALL") or "ALL")

    tr_mask, val_mask = split_validation(len(y), mc.train.validSetRate, seed)

    spec_meta = {
        "kind": alg.value.lower() if alg is not Algorithm.DT else "rf",
        "treeConfig": {"max_depth": cfg.max_depth, "n_bins": cfg.n_bins,
                       "learning_rate": cfg.learning_rate, "loss": cfg.loss},
        "denseNames": meta["denseNames"], "indexNames": meta["indexNames"],
        "modelSetName": mc.model_set_name, "nTrees": n_trees,
    }

    n_bags = max(mc.train.baggingNum, 1) if alg is Algorithm.GBT else 1
    # per-bag instance resampling: single-bag runs train on the full
    # data unless sampleNegOnly/stratifiedSample ask for an explicit
    # rebalance; RF/DT sample per TREE inside build_rf instead
    _neg, _strat = mc.train.sampleNegOnly, mc.train.stratifiedSample
    if _neg:
        # sampleNegOnly applies to binary labels only
        lab = np.asarray(y, np.float32)
        lab = lab[~np.isnan(lab)]
        if lab.size and not np.isin(lab, (0.0, 1.0)).all():
            log.warning("train.sampleNegOnly ignored: continuous-"
                        "target trees have no negative class")
            _neg = False
    explicit = (_neg or _strat) and alg is Algorithm.GBT \
        and (mc.train.baggingSampleRate < 1.0
             or mc.train.baggingWithReplacement)
    bag_w = None if (n_bags == 1 and not explicit) else bagging_weights(
        int(tr_mask.sum()), n_bags, mc.train.baggingSampleRate,
        mc.train.baggingWithReplacement, seed,
        labels=np.asarray(y[tr_mask]),
        stratified=_strat, neg_only=_neg)
    early_stop = int(mc.train.get_param("EnableEarlyStop", 0) and 10)
    val_data = (bins[val_mask], y[val_mask]) if val_mask.any() else None
    lockstep = (alg is Algorithm.GBT and n_bags > 1 and bag_w is not None
                and not mc.train.isContinuous
                and not gbdt.hist_fused_enabled())
    if lockstep:
        # round t of every bag grows as one forest level (one histogram
        # launch + one split search per level cover all bags)
        w_T = np.stack([w[tr_mask] * bag_w[bag] for bag in range(n_bags)])
        bag_results = gbdt.build_gbt_bagged(
            cfg, bins[tr_mask], y[tr_mask], w_T, n_trees,
            val_data=val_data, early_stop_window=early_stop, device=dev)
        for bag, (trees, val_errs) in enumerate(bag_results):
            _save(ctx, bag, "gbt", spec_meta, trees, tables, val_errs)
        log.info("train[GBT]: %d bag(s) × %d trees lockstep, depth %d, "
                 "%d bins in %.2fs", n_bags, n_trees, cfg.max_depth,
                 n_bins, time.time() - t0)
        return None
    for bag in range(n_bags):
        if alg is Algorithm.GBT:
            init_trees = _continuous_trees(ctx, mc, bag)
            w_tr = w[tr_mask] if bag_w is None else w[tr_mask] * bag_w[bag]
            train_bins = bins[tr_mask]
            if gbdt.hist_fused_enabled():
                # SHIFU_TPU_HIST_FUSED: ship raw values + cuts instead of
                # the pre-binned matrix; K4 bins in-register
                train_bins = gbdt.make_fused_inputs(
                    tables, dense[tr_mask], codes[tr_mask], n_bins,
                    device=dev)
            trees, val_errs = gbdt.build_gbt(
                cfg, train_bins, y[tr_mask], w_tr, n_trees,
                init_trees=init_trees, val_data=val_data,
                early_stop_window=early_stop, device=dev)
            kind = "gbt"
        else:
            trees = gbdt.build_rf(cfg, bins[tr_mask], y[tr_mask], w[tr_mask],
                                  n_trees, subset,
                                  mc.train.baggingSampleRate, seed + bag,
                                  stratified=_strat, neg_only=_neg,
                                  device=dev)
            val_errs = []
            kind = "rf"
        _save(ctx, bag, kind, spec_meta, trees, tables, val_errs)
    log.info("train[%s]: %d bag(s) × %d trees, depth %d, %d bins in %.2fs",
             alg.value, n_bags, n_trees, cfg.max_depth, n_bins,
             time.time() - t0)
    return None


def _save(ctx: ProcessorContext, bag: int, kind: str, spec_meta, trees,
          tables, val_errs) -> None:
    path = ctx.path_finder.model_path(bag, kind)
    ctx.path_finder.ensure(path)
    save_model(path, kind, spec_meta, {"trees": trees, "tables": tables})
    if val_errs:
        log.info("tree bag %d: %d trees, final val err %.6f", bag,
                 trees["feature"].shape[0], val_errs[-1])


class _BaggedWeights:
    """Sliceable view multiplying a weight view by counter-based
    Poisson/Bernoulli bag multiplicities (the Philox scheme of
    `train/streaming._chunk_bag_weights`: the global row counter gives
    every pass the same membership). `labels` with `neg_only`
    (train.sampleNegOnly): positives and NaN labels are kept
    (multiplicity ≥ 1 under Poisson bagging), only negatives sample."""

    def __init__(self, base, rate: float, with_replacement: bool, key: int,
                 labels=None, neg_only: bool = False):
        self._base, self._rate = base, rate
        # rate ≥ 1 without replacement would make every bag identical —
        # Poisson, as trainer.bagging_weights; not under neg_only, where
        # it means keep every row
        self._repl = with_replacement or (rate >= 1.0 and not neg_only)
        self._key = key
        self._labels = labels if neg_only else None

    def __getitem__(self, sl):
        w = np.asarray(self._base[sl], np.float32)
        gen = np.random.Generator(np.random.Philox(
            key=self._key, counter=sl.start or 0))
        if self._repl:
            m = gen.poisson(self._rate, len(w)).astype(np.float32)
        else:
            m = (gen.random(len(w)) < self._rate).astype(np.float32)
        if self._labels is not None:
            lab = np.asarray(self._labels[sl], np.float32)
            keep = np.isnan(lab) | (lab > 0.5)
            if self._repl:
                m = np.where(keep, np.maximum(m, 1.0), m)
            else:
                m = np.where(keep, np.float32(1.0), m)
        return w * m


class _UpsampledWeights:
    """Sliceable view applying train#upSampleWeight to a weight memmap
    without materializing the adjusted array."""

    def __init__(self, w_mm, y_mm, up: float):
        self._w, self._y, self._up = w_mm, y_mm, np.float32(up)

    def __getitem__(self, sl):
        w = np.asarray(self._w[sl], np.float32)
        if self._up == 1.0:
            return w
        y = np.asarray(self._y[sl], np.float32)
        return w * np.where(y > 0.5, self._up, np.float32(1.0))


def _recorded_n_val(meta) -> Optional[int]:
    """The exact trailing validation rows a layout records (None: the
    builder takes validSetRate of the rows)."""
    return (meta.get("validSplit") or {}).get("nVal")


def _cached_bins(clean_path: str, tables, n_bins: int, dense, codes,
                 n_rows: int, chunk_rows: int):
    """The (R, C) bin matrix of the streaming layout as `bins.npy`
    (uint8 when the bins fit a byte, else int16), binned a chunk at a
    time and memory-mapped. `bins.meta.json` keeps a hash of the tables,
    the shape and the layout files' sizes and mtimes: a matching hash
    reuses the file, any other replaces it."""
    n_cols = (dense.shape[1] if dense.ndim == 2 else 0) + \
        (codes.shape[1] if codes is not None else 0)
    dtype = np.uint8 if n_bins <= 256 else np.int16
    bins_path = os.path.join(clean_path, "bins.npy")
    meta_path = os.path.join(clean_path, "bins.meta.json")
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(tables["num_cuts"]).tobytes())
    h.update(np.ascontiguousarray(tables["cat_map"]).tobytes())
    h.update(np.asarray([n_rows, n_cols, n_bins]).tobytes())
    h.update(str(np.dtype(dtype)).encode())
    for p in (os.path.join(clean_path, "dense.npy"),
              os.path.join(clean_path, "index.npy")):
        if os.path.exists(p):
            st = os.stat(p)
            h.update(f"{p}:{st.st_size}:{st.st_mtime_ns}".encode())
    key = h.hexdigest()
    cached = None
    if os.path.exists(bins_path) and os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                cached = json.load(f)
        except (OSError, json.JSONDecodeError):
            cached = None
    if cached and cached.get("key") == key:
        log.info("streaming tree: reusing cached bin matrix %s", bins_path)
        return np.load(bins_path, mmap_mode="r")
    for stale in (bins_path, meta_path):
        if os.path.exists(stale):
            os.remove(stale)
    bins_mm = np.lib.format.open_memmap(bins_path, mode="w+", dtype=dtype,
                                        shape=(n_rows, n_cols))
    for a in range(0, n_rows, chunk_rows):
        b = min(a + chunk_rows, n_rows)
        d_c = np.asarray(dense[a:b], np.float32) if dense.ndim == 2 \
            else None
        c_c = np.asarray(codes[a:b], np.int32) if codes is not None \
            else None
        bins_mm[a:b] = gbdt.bin_dataset(tables, d_c, c_c,
                                        n_bins).astype(dtype)
    bins_mm.flush()
    with atomic_write(meta_path) as f:
        json.dump({"key": key, "rows": n_rows, "cols": n_cols,
                   "nBins": n_bins, "dtype": str(np.dtype(dtype))}, f)
    return bins_mm


def _run_tree_streaming(ctx: ProcessorContext, seed: int,
                        dev: torch.device):
    """train#trainOnDisk for GBT/RF/DT: the cleaned `.npy` layout is
    binned once into the cached `bins.npy` and the trees build by
    chunked histogram accumulation (`gbdt.build_gbt_streaming`,
    `gbdt.build_rf_streaming`). Validation is the trailing rows of the
    shuffled layout."""
    t0 = time.time()
    mc = ctx.model_config
    alg = mc.train.algorithm
    clean_path = ctx.path_finder.cleaned_data_path()
    dense_p = os.path.join(clean_path, "dense.npy")
    if not os.path.exists(dense_p):
        raise FileNotFoundError(
            f"streaming layout not found at {clean_path}; run `norm` "
            "with train#trainOnDisk=true so dense/index .npy blocks are "
            "written")
    meta = norm_proc.load_normalized_meta(clean_path)
    dense = np.load(dense_p, mmap_mode="r")
    idx_p = os.path.join(clean_path, "index.npy")
    codes = np.load(idx_p, mmap_mode="r") if os.path.exists(idx_p) else None
    y = np.load(os.path.join(clean_path, "tags.npy"), mmap_mode="r")
    w_raw = np.load(os.path.join(clean_path, "weights.npy"), mmap_mode="r")
    w = _UpsampledWeights(w_raw, y, mc.train.upSampleWeight)

    cfg, tables, n_bins = _tables_and_cfg(ctx, meta)
    n_rows = dense.shape[0] if dense.ndim == 2 and dense.shape[1] \
        else len(y)
    chunk_rows = int(mc.train.get_param("ChunkRows", 1 << 20) or (1 << 20))
    bins_mm = _cached_bins(clean_path, tables, n_bins, dense, codes,
                           n_rows, chunk_rows)

    n_trees = int(mc.train.get_param("TreeNum", 10 if alg is Algorithm.RF
                                     else 100) or 10)
    if alg is Algorithm.DT:
        n_trees = 1
    subset = str(mc.train.get_param("FeatureSubsetStrategy", "ALL") or "ALL")
    spec_meta = {
        "kind": alg.value.lower() if alg is not Algorithm.DT else "rf",
        "treeConfig": {"max_depth": cfg.max_depth, "n_bins": cfg.n_bins,
                       "learning_rate": cfg.learning_rate, "loss": cfg.loss},
        "denseNames": meta["denseNames"], "indexNames": meta["indexNames"],
        "modelSetName": mc.model_set_name, "nTrees": n_trees,
    }
    n_bags = max(mc.train.baggingNum, 1) if alg is Algorithm.GBT else 1
    for bag in range(n_bags):
        if alg is Algorithm.GBT:
            init_trees = _continuous_trees(ctx, mc, bag)
            _neg = mc.train.sampleNegOnly
            if mc.train.stratifiedSample:
                log.info("stratifiedSample on the streaming tree path: "
                         "per-record rate sampling; exact per-class "
                         "counts apply on the resident path only")
            explicit = (_neg or mc.train.stratifiedSample) and (
                mc.train.baggingSampleRate < 1.0
                or mc.train.baggingWithReplacement)
            w_bag = w if (n_bags == 1 and not explicit) else _BaggedWeights(
                w, mc.train.baggingSampleRate,
                mc.train.baggingWithReplacement, seed + 7919 * bag,
                labels=y, neg_only=_neg)
            trees, val_errs = gbdt.build_gbt_streaming(
                cfg, bins_mm, y, w_bag, n_trees,
                valid_rate=mc.train.validSetRate,
                n_val=_recorded_n_val(meta), chunk_rows=chunk_rows,
                init_trees=init_trees,
                early_stop_window=int(mc.train.get_param(
                    "EnableEarlyStop", 0) and 10), device=dev)
            kind = "gbt"
        else:
            trees = gbdt.build_rf_streaming(
                cfg, bins_mm, y, w, n_trees, subset,
                mc.train.baggingSampleRate, seed + bag,
                chunk_rows=chunk_rows, device=dev)
            val_errs = []
            kind = "rf"
        _save(ctx, bag, kind, spec_meta, trees, tables, val_errs)
    log.info("train[%s] streaming: %d bag(s) × %d trees, depth %d, "
             "%d bins, %d rows in %.2fs", alg.value, n_bags, n_trees,
             cfg.max_depth, n_bins, n_rows, time.time() - t0)
    return None


def _continuous_trees(ctx: ProcessorContext, mc: ModelConfig, bag: int):
    """GBT continuous training appends trees to the existing ensemble
    (`TrainModelProcessor.java:1064-1073` tree-count check); returns the
    saved (T, n_nodes) numpy trees or None."""
    if not mc.train.isContinuous:
        return None
    path = ctx.path_finder.model_path(bag, "gbt")
    if not os.path.exists(path):
        return None
    _, _, params = load_model(path)
    trees = dict(params["trees"])
    if "gain" not in trees:
        # checkpoints saved before gain tracking lack the key; backfill
        # zeros so the resumed arrays match fresh trees
        trees["gain"] = np.zeros_like(np.asarray(trees["leaf_value"]))
    return trees
