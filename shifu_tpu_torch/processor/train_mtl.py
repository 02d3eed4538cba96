"""MTL training step — the port of `shifu_tpu/processor/train_mtl.py`
(`TrainModelProcessor.prepareMTLParams:1658-1673`): a '|'-separated
targetColumnName lists the tasks, each a binary tag parsed with the
shared pos/neg tags; a row without a task's tag adds no loss for that
task. Resident (`run_mtl`) or, with `train#trainOnDisk`, streamed from
the `.npy` layout (`_run_mtl_streaming`). Rows without the first task's
tag are dropped by `norm`'s row filter; bagging stratifies and samples
negatives on task 0, the label upSampleWeight keys on. The JAX
package's sharding of the heads over a 'model' mesh axis is multi-card
work (ROADMAP A8.3) and is left out.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List

import numpy as np
import torch

from shifu_tpu_torch.data.dataset import parse_tags
from shifu_tpu_torch.data.purifier import DataPurifier
from shifu_tpu_torch.data.reader import (read_raw_table, simple_column_name,
                                         string_column)
from shifu_tpu_torch.models import mtl
from shifu_tpu_torch.processor import norm as norm_proc
from shifu_tpu_torch.processor.base import ProcessorContext
from shifu_tpu_torch.processor.train_wdl import _save, _train
from shifu_tpu_torch.train import streaming
from shifu_tpu_torch.train import trainer as trainer_mod
from shifu_tpu_torch.train.trainer import (TrainResult, bagging_weights,
                                           split_validation)

log = logging.getLogger("shifu_tpu_torch")


def task_names(mc) -> list:
    return [simple_column_name(t) for t in
            mc.dataSet.targetColumnName.split("|") if t.strip()]


def load_task_targets(ctx: ProcessorContext, data: dict) -> np.ndarray:
    """(R, T) per-task tags: `task_tags` of data.npz (aligned with
    norm's row filter), else re-read from the raw table for a layout
    written without them."""
    if "task_tags" in data and data["task_tags"].size:
        return data["task_tags"].astype(np.float32)
    mc = ctx.model_config
    df = read_raw_table(mc)
    if mc.dataSet.filterExpressions:
        df = df.select(DataPurifier(mc.dataSet.filterExpressions).apply(df))
    y = np.stack([parse_tags(string_column(df[t]), mc.pos_tags,
                             mc.neg_tags) for t in task_names(mc)], axis=1)
    # norm drops the rows whose first task tag is invalid
    return y[~np.isnan(y[:, 0])]


def run_mtl(ctx: ProcessorContext, seed: int = 12306,
            device: "str | torch.device" = "cuda") -> List[TrainResult]:
    t0 = time.time()
    mc = ctx.model_config
    if mc.train.trainOnDisk:
        return _run_mtl_streaming(ctx, seed, device)
    path = ctx.path_finder.normalized_data_path()
    if not os.path.exists(os.path.join(path, "data.npz")):
        raise FileNotFoundError(f"normalized data not found at {path}; "
                                "run `norm` first")
    data, meta = norm_proc.load_normalized(path)
    dense = data["dense"].astype(np.float32)
    w = data["weights"].astype(np.float32)
    y = load_task_targets(ctx, data)
    if mc.train.upSampleWeight != 1.0:
        w = w * np.where(y[:, 0] > 0.5, np.float32(mc.train.upSampleWeight),
                         1.0)
    if len(y) != len(dense):
        raise ValueError(f"MTL target rows {len(y)} != normalized rows "
                         f"{len(dense)}")
    names = task_names(mc)
    spec = mtl.MTLSpec.from_train_params(mc.train.params, dense.shape[1],
                                         len(names))
    tr_mask, val_mask = split_validation(len(y), mc.train.validSetRate, seed)
    n_bags = max(mc.train.baggingNum, 1)
    bag_w = bagging_weights(int(tr_mask.sum()), n_bags,
                            mc.train.baggingSampleRate,
                            mc.train.baggingWithReplacement, seed,
                            labels=np.asarray(y[tr_mask][:, 0]),
                            stratified=mc.train.stratifiedSample,
                            neg_only=mc.train.sampleNegOnly) \
        * w[tr_mask][None, :]
    stacked = trainer_mod.initial_params(
        lambda g: mtl.init_params(spec, g), seed, n_bags)

    def loss(params, inputs, w_, gen):
        x_, y_ = inputs
        return mtl.loss_fn(spec, params, x_, y_, w_)

    def metric(params, inputs, w_):
        x_, y_ = inputs
        return mtl.mse(spec, params, x_, y_, w_)

    res = _train(mc, spec, loss, metric, stacked,
                 (dense[tr_mask], y[tr_mask]), bag_w,
                 (dense[val_mask], y[val_mask]), w[val_mask], device, t0)
    _save(ctx, res, _mtl_spec_meta(mc, spec, names, meta))
    log.info("train[MTL]: %d tasks, %d bag(s), best val %s in %.2fs",
             len(names), n_bags, np.round(res.best_val, 6).tolist(),
             time.time() - t0)
    return [res]


def _mtl_spec_meta(mc, spec, names, meta):
    return {
        "kind": "mtl",
        "spec": {"input_dim": spec.input_dim, "n_tasks": spec.n_tasks,
                 "hidden_dims": list(spec.hidden_dims),
                 "activations": list(spec.activations), "l2": spec.l2},
        "taskNames": names, "denseNames": meta["denseNames"],
        "normType": mc.normalize.normType.value,
        "modelSetName": mc.model_set_name,
    }


def _run_mtl_streaming(ctx: ProcessorContext, seed: int,
                       device) -> List[TrainResult]:
    """train#trainOnDisk for MTL: memory-mapped dense and (R, T)
    task-tag chunks through the streaming core; the epoch metric divides
    by the labelled cells' weight summed over chunks, as the resident
    metric does."""
    t0 = time.time()
    mc = ctx.model_config
    path = ctx.path_finder.normalized_data_path()
    dense, task_tags, weights = streaming.mmap_layout(
        path, "dense", "task_tags", "weights")
    if dense is None:
        raise FileNotFoundError(
            f"streaming layout not found at {path}; run `norm` with "
            "train#trainOnDisk=true")
    if task_tags is None:
        raise FileNotFoundError(
            "MTL needs the task_tags block; re-run `norm` (multi-task "
            "targetColumnName) with train#trainOnDisk=true")
    meta = norm_proc.load_normalized_meta(path)
    names = task_names(mc)
    spec = mtl.MTLSpec.from_train_params(mc.train.params, dense.shape[1],
                                         len(names))

    def get_chunk(a, b):
        y = np.asarray(task_tags[a:b], np.float32)
        w = streaming.upsampled_weights(
            y[:, 0], np.asarray(weights[a:b], np.float32),
            mc.train.upSampleWeight)
        return np.asarray(dense[a:b]), y, w

    def loss_fn(params, inputs, w_, gen):
        x_, y_ = inputs
        return mtl.loss_fn(spec, params, x_, y_, w_)

    def metric_sum_fn(params, inputs, w_):
        x_, y_ = inputs
        return mtl.error_sum(spec, params, x_, y_, w_)

    def metric_mass_fn(inputs, w_):
        return mtl.labelled_mass(inputs[1], w_)

    chunk_rows, n_val = streaming.streaming_train_args(mc, meta)
    ck_dir, ck_int = streaming.checkpoint_args(mc, ctx, "streaming-mtl")
    res = streaming.train_streaming_core(
        mc.train, get_chunk, len(weights), seed=seed, chunk_rows=chunk_rows,
        init_fn=lambda g: mtl.init_params(spec, g), loss_fn=loss_fn,
        metric_sum_fn=metric_sum_fn, n_val=n_val, spec=spec,
        metric_mass_fn=metric_mass_fn,
        bag_labels=lambda a, b: np.asarray(task_tags[a:b, 0], np.float32),
        device=device, checkpoint_dir=ck_dir, checkpoint_interval=ck_int)
    _save(ctx, res, _mtl_spec_meta(mc, spec, names, meta))
    streaming.cleanup_checkpoints(ck_dir)
    log.info("train[MTL streaming]: %d tasks, %d bag(s), best val %s "
             "in %.2fs", len(names), len(res.params_per_bag),
             np.round(res.best_val, 6).tolist(), time.time() - t0)
    return [res]
