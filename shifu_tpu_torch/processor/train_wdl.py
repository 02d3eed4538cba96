"""WDL training step — the port of `shifu_tpu/processor/train_wdl.py`
(`TrainModelProcessor.prepareWDLParams:1675-1690`): wide-and-deep over
*_INDEX-normalized data, resident (`run_wdl`) or, with
`train#trainOnDisk`, streamed from the `.npy` layout
(`_run_wdl_streaming`).

`upSampleWeight` becomes a weight factor on positive rows, the
embedding vocabulary is the largest `indexVocabSizes`, and the bags
take `trainer.bagging_weights` (with `sampleNegOnly` / `stratifiedSample`)
times the row weights; every bag trains at once on `device`
(`trainer.train_bags` over the bag-stacked params of `models/wdl`).
The JAX package's mesh sharding of the embedding and wide tables over a
'model' axis (`SHIFU_TPU_MESH_MODEL`, `parallel/mesh.py`) is multi-card
work (ROADMAP A8.3); on one card it has no counterpart, so it is left out.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List

import numpy as np
import torch

from shifu_tpu_torch.models import wdl
from shifu_tpu_torch.models.spec import save_model
from shifu_tpu_torch.processor import norm as norm_proc
from shifu_tpu_torch.processor.base import ProcessorContext
from shifu_tpu_torch.train import streaming
from shifu_tpu_torch.train import trainer as trainer_mod
from shifu_tpu_torch.train.optimizers import optimizer_from_params
from shifu_tpu_torch.train.trainer import (TrainResult, bagging_weights,
                                           split_validation, train_bags,
                                           tree_map, unstack_params)

log = logging.getLogger("shifu_tpu_torch")


def run_wdl(ctx: ProcessorContext, seed: int = 12306,
            device: "str | torch.device" = "cuda") -> List[TrainResult]:
    t0 = time.time()
    mc = ctx.model_config
    if mc.train.trainOnDisk:
        return _run_wdl_streaming(ctx, seed, device)
    path = ctx.path_finder.normalized_data_path()
    if not os.path.exists(os.path.join(path, "data.npz")):
        raise FileNotFoundError(f"normalized data not found at {path}; "
                                "run `norm` first (WDL needs an *_INDEX "
                                "normType)")
    data, meta = norm_proc.load_normalized(path)
    dense = data["dense"].astype(np.float32)
    idx = data["index"].astype(np.int32)
    y = data["tags"].astype(np.float32)
    w = data["weights"].astype(np.float32)
    if mc.train.upSampleWeight != 1.0:
        w = w * np.where(y > 0.5, np.float32(mc.train.upSampleWeight), 1.0)
    if idx.shape[1] == 0:
        log.warning("WDL without categorical index block — deep-only model")

    vocab = max(meta["indexVocabSizes"], default=1)
    spec = wdl.WDLSpec.from_train_params(mc.train.params, dense.shape[1],
                                         idx.shape[1], vocab)
    tr_mask, val_mask = split_validation(len(y), mc.train.validSetRate, seed)
    n_bags = max(mc.train.baggingNum, 1)
    bag_w = bagging_weights(int(tr_mask.sum()), n_bags,
                            mc.train.baggingSampleRate,
                            mc.train.baggingWithReplacement, seed,
                            labels=np.asarray(y[tr_mask]),
                            stratified=mc.train.stratifiedSample,
                            neg_only=mc.train.sampleNegOnly) \
        * w[tr_mask][None, :]
    stacked = trainer_mod.initial_params(
        lambda g: wdl.init_params(spec, g), seed, n_bags)

    def loss(params, inputs, w_, gen):
        d_, i_, y_ = inputs
        return wdl.loss_fn(spec, params, d_, i_, y_, w_)

    def metric(params, inputs, w_):
        d_, i_, y_ = inputs
        return wdl.mse(spec, params, d_, i_, y_, w_)

    res = _train(mc, spec, loss, metric, stacked,
                 (dense[tr_mask], idx[tr_mask], y[tr_mask]), bag_w,
                 (dense[val_mask], idx[val_mask], y[val_mask]), w[val_mask],
                 device, t0)
    _save(ctx, res, _wdl_spec_meta(mc, spec, meta))
    log.info("train[WDL]: %d bag(s), best val %s in %.2fs", n_bags,
             np.round(res.best_val, 6).tolist(), time.time() - t0)
    return [res]


def _train(mc, spec, loss, metric, stacked, train_inputs, bag_w,
           val_inputs, w_val, device, t0: float) -> TrainResult:
    """`train_bags` with the train conf's optimizer and stops (the WDL
    and MTL steps share it)."""
    ew = mc.train.earlyStoppingRounds
    grad_mask = tree_map(lambda v: torch.ones_like(v[0]), stacked)
    best, train_errs, val_errs, best_val, best_epoch = train_bags(
        loss, metric, optimizer_from_params(mc.train.params),
        mc.train.numTrainEpochs, ew if ew and ew > 0 else 0,
        float(mc.train.convergenceThreshold or 0.0), stacked, train_inputs,
        bag_w, val_inputs, w_val, grad_mask, device=device)
    return TrainResult(
        spec=spec, params_per_bag=unstack_params(best),
        train_errors=train_errs, val_errors=val_errs, best_val=best_val,
        best_epoch=best_epoch, wall_seconds=time.time() - t0,
        rows=int(bag_w.shape[1]))


def _save(ctx: ProcessorContext, res: TrainResult,
          spec_meta: Dict[str, Any]) -> None:
    kind = spec_meta["kind"]
    for i, p in enumerate(res.params_per_bag):
        out = ctx.path_finder.model_path(i, kind)
        ctx.path_finder.ensure(out)
        save_model(out, kind, spec_meta, p)


def _wdl_spec_meta(mc, spec, meta):
    return {
        "kind": "wdl",
        "spec": {"dense_dim": spec.dense_dim, "n_cat": spec.n_cat,
                 "vocab_size": spec.vocab_size,
                 "embed_size": spec.embed_size,
                 "hidden_dims": list(spec.hidden_dims),
                 "activations": list(spec.activations), "l2": spec.l2,
                 "wide_enable": spec.wide_enable,
                 "deep_enable": spec.deep_enable},
        "denseNames": meta["denseNames"], "indexNames": meta["indexNames"],
        "indexVocabSizes": meta["indexVocabSizes"],
        "normType": mc.normalize.normType.value,
        "modelSetName": mc.model_set_name,
    }


def _run_wdl_streaming(ctx: ProcessorContext, seed: int,
                       device) -> List[TrainResult]:
    """train#trainOnDisk for WDL: memory-mapped dense and index chunks
    through the streaming core."""
    t0 = time.time()
    mc = ctx.model_config
    path = ctx.path_finder.normalized_data_path()
    if not os.path.exists(os.path.join(path, "dense.npy")):
        raise FileNotFoundError(
            f"streaming layout not found at {path}; run `norm` with "
            "train#trainOnDisk=true so dense/index .npy blocks are "
            "written")
    meta = norm_proc.load_normalized_meta(path)
    dense, idx, tags, weights = streaming.mmap_layout(
        path, "dense", "index", "tags", "weights")
    if idx is None:
        log.warning("WDL without categorical index block — deep-only "
                    "model")

    def get_chunk(a, b):
        y = np.asarray(tags[a:b], np.float32)
        w = streaming.upsampled_weights(
            y, np.asarray(weights[a:b], np.float32), mc.train.upSampleWeight)
        i_blk = (np.asarray(idx[a:b], np.int32) if idx is not None
                 else np.zeros((b - a, 0), np.int32))
        # the stored dtype stays: an f16 block widens on the device
        return np.asarray(dense[a:b]), i_blk, y, w

    vocab = max(meta["indexVocabSizes"], default=1)
    n_cat = idx.shape[1] if idx is not None else 0
    spec = wdl.WDLSpec.from_train_params(mc.train.params, dense.shape[1],
                                         n_cat, vocab)
    chunk_rows, n_val = streaming.streaming_train_args(mc, meta)
    ck_dir, ck_int = streaming.checkpoint_args(mc, ctx, "streaming-wdl")
    res = streaming.train_wdl_streaming(
        mc.train, get_chunk, len(tags), spec, seed=seed,
        chunk_rows=chunk_rows, n_val=n_val,
        bag_labels=lambda a, b: np.asarray(tags[a:b], np.float32),
        device=device, checkpoint_dir=ck_dir, checkpoint_interval=ck_int)
    _save(ctx, res, _wdl_spec_meta(mc, spec, meta))
    streaming.cleanup_checkpoints(ck_dir)
    log.info("train[WDL streaming]: %d bag(s), best val %s in %.2fs",
             len(res.params_per_bag), np.round(res.best_val, 6).tolist(),
             time.time() - t0)
    return [res]
