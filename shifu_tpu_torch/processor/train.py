"""`shifu train` — the port of `shifu_tpu/processor/train.py`: dispatch
to the tree trainers (`processor/train_tree`) or the dense family.

NN, LR, SVM and TENSORFLOW train here as a dense network
(`train/trainer.train_nn`) on the normalized data under
`tmp/NormalizedData`: LR and SVM as a zero-hidden sigmoid net with log
loss, TENSORFLOW as the NN. Grid search (list-valued train#params or a
`gridConfigFile`), k-fold (`numKFold`), continuous training
(`isContinuous`: resume, or absorb the old model into a larger
structure) and multi-class (NATIVE softmax head, or ONEVSALL: one binary
model a class, meta `ovaClass`) run as in the JAX package, and the saved
`models/model<i>.{nn,lr}` and `tmp/valerr.json` are its files.

WDL and MTL train in `processor/train_wdl` and `processor/train_mtl`.
With `train#trainOnDisk` every family trains from the `.npy` layout
`norm` wrote, a chunk at a time (`train/streaming`, the streaming tree
builders of `models/gbdt`); multi-class ignores it and trains resident,
and `numKFold` with it raises, as in the JAX package.

The step runs under the ``train`` manifest (`step_guard`; the dense
family declares `tmp/valerr.json`), and the family dispatch under
`resilience.supervise`: with ``SHIFU_TPU_MAX_RESTARTS`` > 0 a
preemption or a transient failure re-invokes it, and the trainer
resumes from its checkpoint. `CheckpointInterval` > 0 checkpoints the
resident dense trainer into `checkpoint_path(0)` (not under grid search
or k-fold, as in the JAX package; a finished run's checkpoint stays,
so a rerun restores it and returns at once) and the streaming NN, WDL
and MTL into its `streaming`, `streaming-wdl` and `streaming-mtl`
subdirectories, removed once the models are saved. The resident dense
trainer queues a `roofline` block for the step's ``steps.jsonl`` record
(`_record_train_roofline`: the spec's analytic per-row costs over the
measured row·epochs/s, against the card's peaks in `profiling`).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from shifu_tpu_torch import resilience, resolve_device
from shifu_tpu_torch.config.model_config import Algorithm
from shifu_tpu_torch.fileio import atomic_write
from shifu_tpu_torch.models import nn as nn_mod
from shifu_tpu_torch.models.spec import load_model, save_model
from shifu_tpu_torch.processor import norm as norm_proc
from shifu_tpu_torch.processor.base import ProcessorContext, step_guard
from shifu_tpu_torch.train import grid_search
from shifu_tpu_torch.train.trainer import TrainResult, train_nn

log = logging.getLogger("shifu_tpu_torch")

DENSE = (Algorithm.NN, Algorithm.LR, Algorithm.SVM, Algorithm.TENSORFLOW)


def run(ctx: ProcessorContext, seed: int = 12306,
        device: "str | torch.device" = "cuda",
        report: Optional[Dict[str, Any]] = None) -> int:
    """Train the model set's algorithm on `device`. For the dense
    family, `report` receives the rows, bags, epochs, training seconds,
    and each saved model's best validation error, best epoch and
    per-epoch train and validation errors."""
    t0 = time.time()
    mc = ctx.model_config
    ctx.require_columns()
    alg = mc.train.algorithm

    if mc.is_multi_classification and \
            alg not in (Algorithm.NN, Algorithm.LR, Algorithm.SVM):
        raise ValueError(
            f"multi-class (>2 tags) is supported for NN/LR/SVM, not "
            f"{alg.value}; the reference likewise restricts "
            f"multiClassifyMethod to its NN-family trainers")
    # only the dense family writes val_error_path; the others record a
    # fingerprint-only manifest
    outs = [ctx.path_finder.val_error_path()] if alg in DENSE else []
    with step_guard(ctx, "train", outputs=outs) as go:
        if not go:
            return 0

        def _attempt() -> None:
            if alg.is_tree:
                from shifu_tpu_torch.processor import train_tree
                train_tree.run_tree(ctx, seed, device)
                return
            if alg in DENSE:
                if alg is Algorithm.TENSORFLOW:
                    # the reference's TF bridge spawns distributed-TF
                    # training; here the same network trains natively
                    log.info("TENSORFLOW algorithm: training the network "
                             "natively")
                results = _train_dense(ctx, seed, resolve_device(device))
            elif alg is Algorithm.WDL:
                from shifu_tpu_torch.processor import train_wdl
                results = train_wdl.run_wdl(ctx, seed, resolve_device(device))
            elif alg is Algorithm.MTL:
                from shifu_tpu_torch.processor import train_mtl
                results = train_mtl.run_mtl(ctx, seed, resolve_device(device))
            else:
                raise ValueError(f"unsupported algorithm {alg}")
            if report is not None:
                report.update(_dense_report(results))

        # with SHIFU_TPU_MAX_RESTARTS > 0 a preemption or a transient
        # failure re-invokes the trainer, which resumes from its
        # checkpoint
        resilience.supervise(_attempt, step="train", device=device)
    log.info("train[%s] done in %.2fs", alg.value, time.time() - t0)
    return 0


def _dense_report(results: List[TrainResult]) -> Dict[str, Any]:
    return {"rows": int(results[0].rows),
            "bags": int(sum(len(r.best_val) for r in results)),
            "epochs": int(results[0].train_errors.shape[1]),
            "train_seconds": float(sum(r.wall_seconds for r in results)),
            "best_val_error": [float(v) for r in results
                               for v in r.best_val],
            "best_epoch": [int(e) for r in results for e in r.best_epoch],
            "train_errors": [row.tolist() for r in results
                             for row in r.train_errors],
            "val_errors": [row.tolist() for r in results
                           for row in r.val_errors]}


# ---------------------------------------------------------------------------
# NN / LR / SVM (dense-input gradient models)
# ---------------------------------------------------------------------------

def _load_dense_training_data(ctx: ProcessorContext):
    path = ctx.path_finder.normalized_data_path()
    if not os.path.exists(os.path.join(path, "data.npz")):
        raise FileNotFoundError(
            f"normalized data not found at {path}; run `norm` first")
    return norm_proc.load_normalized(path)


def _lr_spec(params: Dict[str, Any], input_dim: int) -> nn_mod.MLPSpec:
    """LR = zero-hidden-layer sigmoid net with log loss
    (`lr/LogisticRegressionWorker.java:312-332` gradient ≡ ∇ of this)."""
    spec = nn_mod.MLPSpec.from_train_params(params, input_dim)
    return dataclasses.replace(spec, hidden_dims=(), activations=(),
                               loss="log")


def _svm_spec(params: Dict[str, Any], input_dim: int) -> nn_mod.MLPSpec:
    """SVM trains as a linear margin classifier: the LR network (the
    reference's SVMTrainer is an Encog SVM used only in LOCAL mode)."""
    return _lr_spec(params, input_dim)


def _make_spec(alg: Algorithm, params: Dict[str, Any], input_dim: int,
               classes: Optional[List[str]] = None) -> nn_mod.MLPSpec:
    if alg is Algorithm.LR:
        spec = _lr_spec(params, input_dim)
    elif alg is Algorithm.SVM:
        spec = _svm_spec(params, input_dim)
    else:
        spec = nn_mod.MLPSpec.from_train_params(params, input_dim)
    if classes:
        # NATIVE multi-class: softmax head, one unit per tag
        spec = dataclasses.replace(
            spec, output_dim=len(classes), output_activation="softmax",
            loss="log")
    return spec


def _kind(alg: Algorithm) -> str:
    return {"NN": "nn", "LR": "lr", "SVM": "lr"}.get(alg.value, "nn")


def _train_dense(ctx: ProcessorContext, seed: int,
                 device: torch.device) -> List[TrainResult]:
    mc = ctx.model_config
    # streaming first: loading the npz here would read the whole table
    # that trainOnDisk keeps out of memory (multi-class trains resident)
    if mc.train.trainOnDisk and not mc.is_multi_classification:
        if (mc.train.numKFold or 0) > 1:
            raise ValueError(
                "train#numKFold is not supported with trainOnDisk — the "
                "streaming layout carries one fixed validation region; "
                "run k-fold resident (drop trainOnDisk) or use "
                "validSetRate instead")
        return _train_dense_streaming(ctx, seed, device)
    data, _ = _load_dense_training_data(ctx)
    x = data["dense"].astype(np.float32)
    y = data["tags"].astype(np.float32)
    w = data["weights"].astype(np.float32)
    alg = mc.train.algorithm

    classes = mc.class_tags if mc.is_multi_classification else None
    if mc.train.upSampleWeight != 1.0:
        if classes:
            # reference upsampling is positive-vs-negative only; for
            # multi-class y holds class indices
            log.warning("upSampleWeight ignored for multi-class training")
        else:
            w = w * np.where(y > 0.5, np.float32(mc.train.upSampleWeight),
                             1.0)

    if classes and mc.train.multiClassifyMethod.value == "ONEVSALL":
        return _train_dense_ovr(ctx, x, y, w, classes, seed, device)

    combos = grid_search.expand(mc.train.params)
    if mc.train.gridConfigFile:
        merged = dict(mc.train.params)
        merged.update(grid_search.parse_grid_config_file(
            mc.resolve_path(mc.train.gridConfigFile)))
        combos = grid_search.expand(merged)

    is_gs = len(combos) > 1
    kfold = mc.train.numKFold if mc.train.numKFold and \
        mc.train.numKFold > 1 else 0
    # CheckpointInterval epochs a checkpoint of the carry (NNOutput tmp
    # models); grid-search combos and k-fold folds skip it
    ck_int = int(mc.train.get_param("CheckpointInterval", 0) or 0)
    ck_dir = ctx.path_finder.checkpoint_path(0) if ck_int and not is_gs \
        else None

    results: List[Tuple[Dict[str, Any], TrainResult]] = []
    t_train = time.time()
    total_epochs = 0
    for ci, params in enumerate(combos):
        spec = _make_spec(alg, params, x.shape[1], classes)
        conf = _conf_with_params(mc.train, params)
        total_epochs += int(conf.numTrainEpochs or 0) * (kfold or 1)
        if kfold:
            res = _train_kfold(conf, spec, x, y, w, kfold, seed, device)
        else:
            init_params, fixed, gmask = _continuous_init(ctx, spec, seed)
            res = train_nn(conf, x, y, w, seed=seed + ci, spec=spec,
                           init_params=init_params, fixed_layers=fixed,
                           grad_mask=gmask, device=device,
                           checkpoint_dir=ck_dir, checkpoint_interval=ck_int)
        results.append((params, res))
        if is_gs:
            log.info("grid[%d/%d] %s → val %.6f", ci + 1, len(combos),
                     params, float(res.best_val.min()))

    best_params, best = min(results,
                            key=lambda pr: float(pr[1].best_val.min()))
    if is_gs:
        log.info("grid search best params: %s", best_params)
    _record_train_roofline(best.spec, x.shape[0], mc.train.validSetRate,
                           total_epochs, time.time() - t_train)
    _save_dense_models(ctx, best, alg)
    _write_val_errors(ctx, best)
    return [best]


def _record_train_roofline(spec: nn_mod.MLPSpec, n_rows: int,
                           valid_rate: float, total_epochs: int,
                           wall: float) -> None:
    """Queue a `roofline` block for this command's steps.jsonl record:
    analytic per-row costs from the trained spec combined with the
    measured row·epochs/s (`profiling.roofline`). The wall covers the
    whole train loop (the first launches and the host's reads
    included), so the shares are a floor."""
    from shifu_tpu_torch import profiling
    try:
        n_train = max(int(n_rows * (1 - (valid_rate or 0.0))), 1)
        bpe = 2 if spec.compute_dtype == "bfloat16" else 4
        f, b = profiling.mlp_row_costs(spec.input_dim, spec.hidden_dims,
                                       spec.output_dim, dtype_bytes=bpe)
        profiling.set_step_extra("roofline", profiling.roofline(
            "NN", f, b, n_train * total_epochs / max(wall, 1e-9),
            compute_dtype=spec.compute_dtype))
    except Exception as e:  # noqa: BLE001 — metrics must never fail a run
        log.debug("roofline record skipped: %s", e)


def _conf_with_params(tc, params):
    conf = copy.copy(tc)
    conf.params = params
    return conf


def _continuous_init(ctx: ProcessorContext, spec: nn_mod.MLPSpec,
                     seed: int = 12306):
    """Continuous training: resume from models/model0 when the structure
    matches; absorb the old model into a LARGER new structure (old
    weights into the corner, 1-based FixedLayers freezing the absorbed
    indices); a structure that cannot hold the old one is an error
    (`NNMaster.initOrRecoverParams:356-387`, `NNStructureComparator`,
    `TrainModelProcessor.inputOutputModelCheckSuccess:1389-1450`).
    Returns (init_params, fixed_layers, grad_mask); grad_mask is set on
    the growth path only, where frozen indices are element-wise."""
    mc = ctx.model_config
    if not mc.train.isContinuous:
        return None, None, None
    path = ctx.path_finder.model_path(0)
    if not os.path.exists(path):
        log.info("continuous training: no existing model at %s, fresh start",
                 path)
        return None, None, None
    _, meta, params = load_model(path)
    old_spec = meta.get("spec", {})
    old_dims = [old_spec.get("input_dim")] \
        + list(old_spec.get("hidden_dims") or []) \
        + [old_spec.get("output_dim", 1)]
    fixed = mc.train.get_param("FixedLayers") or None
    if fixed is not None:
        fixed = [int(i) for i in fixed]
    cmp = nn_mod.compare_structure(old_dims, spec.layer_dims)
    if cmp == 0:
        return params, fixed, None
    if cmp < 0:
        raise ValueError(
            "continuous training: new network "
            f"{spec.layer_dims} cannot hold the existing model "
            f"{old_dims} (shrunk input/hidden/output). Grow the "
            "structure, or set train#isContinuous=false to retrain "
            "from scratch")
    log.info("continuous training: absorbing existing model %s into "
             "larger structure %s%s", old_dims, spec.layer_dims,
             f" (FixedLayers={fixed})" if fixed else "")
    fresh = nn_mod.init_params(spec, torch.Generator().manual_seed(seed))
    grown, grad_mask = nn_mod.absorb_params(params, fresh,
                                            fixed_layers=fixed)
    # fixed_layers=None: the element-wise grad_mask already encodes the
    # frozen absorbed indices
    return grown, None, grad_mask


def _train_kfold(conf, spec, x, y, w, k: int, seed: int,
                 device: torch.device) -> TrainResult:
    """K-fold CV: average validation error across folds, keep the
    best-fold model (`TrainModelProcessor.postProcess4KFoldCV:929-954`)."""
    fold_of = np.random.default_rng(seed).integers(0, k, len(y))
    fold_results = []
    for f in range(k):
        vmask = fold_of == f
        fold_results.append(train_nn(
            conf, x[~vmask], y[~vmask], w[~vmask], seed=seed + f,
            spec=spec, val_data=(x[vmask], y[vmask], w[vmask]),
            device=device))
    avg_val = float(np.mean([r.best_val.min() for r in fold_results]))
    log.info("k-fold (%d folds) average val error: %.6f", k, avg_val)
    return min(fold_results, key=lambda r: float(r.best_val.min()))


def _dense_spec_meta(ctx: ProcessorContext, spec: nn_mod.MLPSpec,
                     meta: Optional[Dict] = None) -> Dict:
    mc = ctx.model_config
    if meta is None:
        meta = norm_proc.load_normalized_meta(
            ctx.path_finder.normalized_data_path())
    out = {
        "spec": {
            "input_dim": spec.input_dim,
            "hidden_dims": list(spec.hidden_dims),
            "activations": list(spec.activations),
            "output_dim": spec.output_dim,
            "output_activation": spec.output_activation,
            "dropout_rate": 0.0,  # inference never drops
            "l2": spec.l2, "l1": spec.l1,
            "loss": spec.loss, "weight_init": spec.weight_init,
            # a bf16-trained model scores in bf16 too
            "compute_dtype": spec.compute_dtype,
        },
        "inputNames": meta["denseNames"],
        "normType": mc.normalize.normType.value,
        "modelSetName": mc.model_set_name,
    }
    if mc.is_multi_classification:
        out["classes"] = mc.class_tags
    return out


def _save_dense_models(ctx: ProcessorContext, res: TrainResult,
                       alg: Algorithm) -> None:
    kind = _kind(alg)
    spec_meta = _dense_spec_meta(ctx, res.spec)
    for i, params in enumerate(res.params_per_bag):
        path = ctx.path_finder.model_path(i, kind)
        ctx.path_finder.ensure(path)
        save_model(path, kind, spec_meta, params)
    log.info("saved %d %s model(s) under %s", len(res.params_per_bag),
             kind, ctx.path_finder.models_path())


def _train_dense_streaming(ctx: ProcessorContext, seed: int,
                           device: torch.device) -> List[TrainResult]:
    """train#trainOnDisk: the normalized `.npy` layout streams as
    memory-mapped row chunks (`train/streaming.train_nn_streaming`).
    Grid search is a full-batch feature and is not expanded here, as in
    the JAX package; continuous training starts from models/model0."""
    from shifu_tpu_torch.train import streaming
    mc = ctx.model_config
    path = ctx.path_finder.normalized_data_path()
    if not os.path.exists(os.path.join(path, "dense.npy")):
        raise FileNotFoundError(
            f"streaming layout not found at {path}; run `norm` with "
            "train#trainOnDisk=true so dense.npy/tags.npy are written")
    dense, tags, weights = streaming.mmap_layout(path, "dense", "tags",
                                                 "weights")

    def get_chunk(a, b):
        # the stored dtype stays: an f16 layout widens on the device
        y = np.asarray(tags[a:b], np.float32)
        w = streaming.upsampled_weights(
            y, np.asarray(weights[a:b], np.float32), mc.train.upSampleWeight)
        return np.asarray(dense[a:b]), y, w

    alg = mc.train.algorithm
    spec = _make_spec(alg, mc.train.params, dense.shape[1])
    init_params, fixed, gmask = _continuous_init(ctx, spec, seed)
    chunk_rows, n_val = streaming.streaming_train_args(
        mc, norm_proc.load_normalized_meta(path))
    ck_dir, ck_int = streaming.checkpoint_args(mc, ctx, "streaming")
    res = streaming.train_nn_streaming(
        mc.train, get_chunk, len(tags), dense.shape[1], seed=seed,
        spec=spec, chunk_rows=chunk_rows, init_params=init_params,
        fixed_layers=fixed, grad_mask=gmask, n_val=n_val,
        bag_labels=lambda a, b: np.asarray(tags[a:b], np.float32),
        device=device, checkpoint_dir=ck_dir, checkpoint_interval=ck_int)
    _save_dense_models(ctx, res, alg)
    _write_val_errors(ctx, res)
    streaming.cleanup_checkpoints(ck_dir)
    return [res]


def _train_dense_ovr(ctx: ProcessorContext, x: np.ndarray, y: np.ndarray,
                     w: np.ndarray, classes: List[str], seed: int,
                     device: torch.device) -> List[TrainResult]:
    """ONEVSALL multi-class: class c's model is a binary model on y == c,
    one bag each (the reference submits these as parallel one-vs-all
    jobs). Grid search / k-fold are not combined with ONEVSALL: the first
    combination wins."""
    mc = ctx.model_config
    alg = mc.train.algorithm
    kind = _kind(alg)
    combos = grid_search.expand(mc.train.params)
    if len(combos) > 1 or (mc.train.numKFold or 0) > 1:
        log.warning("ONEVSALL: grid search / k-fold ignored; using the "
                    "first parameter combination")
    params0 = combos[0]
    conf = _conf_with_params(mc.train, params0)
    conf.baggingNum = 1  # one model per class, like one job per class
    norm_meta = norm_proc.load_normalized_meta(
        ctx.path_finder.normalized_data_path())
    results: List[TrainResult] = []
    for c in range(len(classes)):
        y_c = (y == c).astype(np.float32)
        res = train_nn(conf, x, y_c, w, seed=seed + c,
                       spec=_make_spec(alg, params0, x.shape[1]),
                       device=device)
        meta = _dense_spec_meta(ctx, res.spec, norm_meta)
        meta["ovaClass"] = c
        path = ctx.path_finder.model_path(c, kind)
        ctx.path_finder.ensure(path)
        save_model(path, kind, meta, res.params_per_bag[0])
        results.append(res)
        log.info("one-vs-all class %d (%s): best val err %.6f", c,
                 classes[c], float(res.best_val.min()))
    vpath = ctx.path_finder.val_error_path()
    ctx.path_finder.ensure(vpath)
    with atomic_write(vpath) as f:
        json.dump({"bestValError": [float(r.best_val.min())
                                    for r in results],
                   "bestEpoch": [int(r.best_epoch[0]) for r in results],
                   "wallSeconds": sum(r.wall_seconds for r in results),
                   "classes": [str(c) for c in classes]}, f, indent=1)
    return results


def _write_val_errors(ctx: ProcessorContext, res: TrainResult) -> None:
    path = ctx.path_finder.val_error_path()
    ctx.path_finder.ensure(path)
    with atomic_write(path) as f:
        json.dump({"bestValError": [float(v) for v in res.best_val],
                   "bestEpoch": [int(e) for e in res.best_epoch],
                   "wallSeconds": res.wall_seconds}, f, indent=1)
