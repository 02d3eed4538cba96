"""Streaming (larger than device memory) training — the port of
`shifu_tpu/train/streaming.py` (`train#trainOnDisk`; the reference's
`MemoryDiskFloatMLDataSet.java:27-99` disk-spill dataset).

`norm` writes the normalized table as raw `.npy` blocks in a seeded row
shuffle (`processor/norm.save_normalized`); the trainers memory-map
them and take fixed-size row chunks, so only the touched rows enter
host memory. `train_streaming_core` is model-agnostic (NN/LR, WDL, MTL
feed it their loss):

- the trailing `n_val` rows are the validation set (sequential reads
  forbid random row masks; the shuffle makes the trailing block a
  random split);
- every epoch takes the training chunks in the order
  ``default_rng((seed ^ 0x5EED) + epoch).permutation``, one optimizer
  step a chunk for every bag at once (bag-stacked params, as in
  `train/trainer.py`);
- bag membership is counter-based (`_chunk_bag_weights`: numpy Philox
  keyed ``seed + 7919·b`` at counter ``start``), so every epoch sees the
  same bags without a (bags, rows) matrix;
- the epoch's train error is each bag's chunk losses weighted by the
  chunk's weight; the validation error is `metric_sum_fn` summed over
  chunks over `metric_mass_fn` summed likewise; both are fetched from
  the device once an epoch and summed on the host in float64;
- window and convergence stops and best tracking as in the JAX core (a
  stopped bag's params are put back at the end of every epoch; `best`
  is a copy, never an alias of the live params).

The host half of a chunk (materializing the mmap slice, bag weights)
runs on `data/pipeline.map_prefetch` threads; the device half is a copy
from pinned memory on a side CUDA stream (`data/pipeline.Stager`),
issued for chunk k+1 while chunk k computes. A chunk stored as f16
(FLOAT16 layouts) is widened on the device. The JAX core pads a tail
chunk to one shape for XLA; here the tail chunk is simply shorter
(zero-weight rows add nothing, and every denominator is clamped).

With `CheckpointInterval` > 0 (`checkpoint_args`: the directory is
``checkpoint_path(0)/<route>``) the state — parameters, optimizer
state, the best tracker, the stop counters, the curves so far and the
dropout generator — is saved every `checkpoint_interval` epochs and
restored on entry (`restore_latest` with a step-shaped `like`); the
chunk order derives from the epoch number, so a resumed run replays the
same schedule and equals a straight one. A preemption saves off the
interval (`save_interrupt`) and raises `resilience.Preempted`. The
caller removes the directory only after the models are saved
(`cleanup_checkpoints`). The JAX core's multi-host row slices and mesh
placement are ROADMAP A8.3.
"""

from __future__ import annotations

import contextlib
import logging
import os
import shutil
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from shifu_tpu_torch import resilience, resolve_device
from shifu_tpu_torch.data import pipeline as pipe
from shifu_tpu_torch.models import nn as nn_mod
from shifu_tpu_torch.train import trainer as trainer_mod
from shifu_tpu_torch.train.optimizers import optimizer_from_params
from shifu_tpu_torch.train.trainer import (TrainResult, _flat, _unflat,
                                           tree_map, unstack_params)

log = logging.getLogger("shifu_tpu_torch")


def _chunk_bag_weights(n_bags: int, sample_rate: float,
                       with_replacement: bool, seed: int,
                       start: int, stop: int,
                       labels: Optional[np.ndarray] = None,
                       neg_only: bool = False) -> np.ndarray:
    """(bags, stop-start) bagging multiplicities for a row range,
    counter-based on the global row index so every epoch sees the same
    bag membership. `neg_only` (train.sampleNegOnly): positives and
    NaN-labelled rows are always kept (multiplicity clamped to ≥ 1
    under Poisson bagging); only negatives sample at the rate."""
    rows = stop - start
    neg_only = neg_only and labels is not None
    if n_bags == 1 and sample_rate >= 1.0 and not with_replacement:
        return np.ones((1, rows), np.float32)
    out = np.empty((n_bags, rows), np.float32)
    for b in range(n_bags):
        bit = np.random.Generator(np.random.Philox(key=seed + 7919 * b,
                                                   counter=start))
        if with_replacement:
            out[b] = bit.poisson(sample_rate, rows).astype(np.float32)
        else:
            out[b] = (bit.random(rows) < sample_rate).astype(np.float32)
        if neg_only:
            lab = np.asarray(labels)
            keep = np.isnan(lab) | (lab > 0.5)
            if with_replacement:
                out[b] = np.where(keep, np.maximum(out[b], 1.0), out[b])
            else:
                out[b] = np.where(keep, np.float32(1.0), out[b])
    return out


def mmap_layout(path: str, *names: str):
    """The streaming layout's `.npy` blocks memory-mapped (None for a
    block that is not there)."""
    out = []
    for name in names:
        fp = os.path.join(path, f"{name}.npy")
        out.append(np.load(fp, mmap_mode="r") if os.path.exists(fp)
                   else None)
    return out


def upsampled_weights(y: np.ndarray, w: np.ndarray, up) -> np.ndarray:
    """train#upSampleWeight as a weight factor on positive rows."""
    up = np.float32(up)
    if up == 1.0:
        return w
    return w * np.where(y > 0.5, up, np.float32(1.0))


def streaming_train_args(mc, meta) -> Tuple[int, Optional[int]]:
    """(chunk_rows, n_val) of a streaming trainer: train#params
    ChunkRows and the layout's recorded `validSplit` (None: the
    trainer takes validSetRate of the rows)."""
    chunk_rows = int(mc.train.get_param("ChunkRows", 262_144) or 262_144)
    n_val = (meta.get("validSplit") or {}).get("nVal")
    return chunk_rows, n_val


def checkpoint_args(mc, ctx, route: str
                    ) -> Tuple[Optional[str], int]:
    """(checkpoint_dir, interval) of a streaming trainer: one rule for
    the NN/WDL/MTL processors, a subdirectory a route; (None, 0)
    without train#params CheckpointInterval."""
    ck_int = int(mc.train.get_param("CheckpointInterval", 0) or 0)
    if not ck_int:
        return None, 0
    return os.path.join(ctx.path_finder.checkpoint_path(0), route), ck_int


def cleanup_checkpoints(checkpoint_dir: Optional[str]) -> None:
    """Remove a streaming run's checkpoints after its models are saved:
    a finished run's state must not resume into the next fresh run, and
    removing it before the models are written would lose the run to a
    crash in between."""
    if checkpoint_dir:
        shutil.rmtree(checkpoint_dir, ignore_errors=True)


def _grad_mask(one_bag: Any, grad_mask, fixed_layers) -> Any:
    """An element-wise mask wins; else 1-based `fixed_layers` zero whole
    layers of a layer list (continuous training); else all ones."""
    if grad_mask is not None:
        return tree_map(lambda v: torch.as_tensor(np.asarray(v, np.float32)),
                        grad_mask)
    if isinstance(one_bag, list) and fixed_layers:
        return [{k: (torch.zeros_like(v) if (i + 1) in fixed_layers
                     else torch.ones_like(v)) for k, v in layer.items()}
                for i, layer in enumerate(one_bag)]
    return tree_map(torch.ones_like, one_bag)


def _broadcast(init_params: Any, n_bags: int) -> Any:
    return tree_map(lambda v: v.unsqueeze(0).repeat(
        (n_bags,) + (1,) * v.dim()), tree_map(
            lambda v: torch.as_tensor(np.asarray(v, np.float32))
            if not isinstance(v, torch.Tensor) else v.to(torch.float32),
            init_params))


def train_streaming_core(train_conf, get_chunk: Callable[[int, int], Tuple],
                         n_rows: int, seed: int, chunk_rows: int,
                         init_fn, loss_fn, metric_sum_fn,
                         init_params=None, fixed_layers=None,
                         grad_mask=None, n_val: Optional[int] = None,
                         spec=None, metric_mass_fn=None,
                         bag_labels: Optional[
                             Callable[[int, int], np.ndarray]] = None,
                         dropout: bool = False,
                         device: "str | torch.device" = "cuda",
                         checkpoint_dir: Optional[str] = None,
                         checkpoint_interval: int = 0
                         ) -> TrainResult:
    """Model-agnostic streaming trainer on `device`.

    get_chunk(a, b) → (*inputs, w): row-aligned numpy blocks, weights
    last. loss_fn(params, inputs, w_bags, generator) → (B,) weighted
    mean losses; metric_sum_fn(params, inputs, w) → (B,) sums of the
    weighted per-row errors, divided at the epoch's end by the sum of
    metric_mass_fn(inputs, w) (default Σw). init_fn(generator) → one
    model's params (bags are drawn by `trainer.initial_params`), or
    `init_params` (one model) for every bag. bag_labels(a, b) → labels
    for train.sampleNegOnly. `dropout` hands the loss a generator on
    the device. `checkpoint_dir` with `checkpoint_interval` > 0 saves
    and restores the state (module docstring)."""
    t0 = time.time()
    dev = resolve_device(device)
    neg_only = bool(getattr(train_conf, "sampleNegOnly", False))
    if neg_only and bag_labels is None:
        log.warning("train.sampleNegOnly is set but this streaming route "
                    "passes no label accessor — the flag is ignored")
        neg_only = False
    if getattr(train_conf, "stratifiedSample", False):
        log.info("train.stratifiedSample on the streaming path: per-row "
                 "rate sampling; exact per-class counts apply on the "
                 "resident path only")
    if n_val is None:
        n_val = int(n_rows * max(train_conf.validSetRate, 0.0))
    n_train = n_rows - n_val
    if n_train <= 0:
        raise ValueError("streaming training needs at least one train row")
    n_bags = max(train_conf.baggingNum, 1)

    optimizer = optimizer_from_params(train_conf.params)
    if init_params is not None:
        stacked = _broadcast(init_params, n_bags)
    else:
        stacked = trainer_mod.initial_params(init_fn, seed, n_bags)
    stacked = tree_map(lambda v: v.to(dev), stacked)
    one_bag = tree_map(lambda v: v[0], stacked)
    mask = [m.to(dev) for m in _flat(_grad_mask(one_bag, grad_mask,
                                                fixed_layers))]
    opt_state = optimizer.init(_flat(stacked))
    gen = torch.Generator(device=dev).manual_seed(int(seed)) \
        if dropout else None
    if metric_mass_fn is None:
        def metric_mass_fn(inputs, w):
            return torch.sum(w)

    def update(params, o_state, inputs, w_bags):
        leaves = [t.detach().requires_grad_(True) for t in _flat(params)]
        loss = loss_fn(_unflat(params, leaves), inputs, w_bags, gen)
        grads = torch.autograd.grad(loss.sum(), leaves)
        with torch.no_grad():
            upd, o2 = optimizer.update([g * m for g, m in zip(grads, mask)],
                                       o_state)
            new = [t.detach() + u for t, u in zip(leaves, upd)]
        return _unflat(params, new), o2, loss.detach(), w_bags.sum(-1)

    def chunk_bounds(lo, hi):
        return [(s, min(s + chunk_rows, hi)) for s in range(lo, hi,
                                                            chunk_rows)]

    train_chunks = chunk_bounds(0, n_train)
    val_chunks = chunk_bounds(n_train, n_rows)

    def host_assemble(bounds, with_bags: bool):
        """The worker-thread half of a chunk: numpy only."""
        a, b = bounds
        *inputs, w = get_chunk(a, b)
        inputs = [np.ascontiguousarray(x) for x in inputs]
        w = np.ascontiguousarray(w, np.float32)
        if not with_bags:
            return inputs, w
        lab = bag_labels(a, b) if neg_only else None
        return inputs, _chunk_bag_weights(
            n_bags, train_conf.baggingSampleRate,
            train_conf.baggingWithReplacement, seed, a, b, labels=lab,
            neg_only=neg_only) * w[None, :]

    stager = pipe.Stager(dev)

    def place(assembled, prefix: str):
        """The consumer-thread half: the chunk's copies to the device,
        f16 blocks widened there."""
        inputs, tail = assembled
        placed = []
        for i, x in enumerate(inputs):
            t = stager.put(f"{prefix}{i}", x)
            placed.append(t.float() if t.dtype == torch.float16 else t)
        return tuple(placed), stager.put(f"{prefix}w", tail)

    with torch.no_grad():
        best = tree_map(torch.clone, stacked)
    best_val = np.full(n_bags, np.inf, np.float32)
    best_epoch = np.zeros(n_bags, np.int64)
    bad = np.zeros(n_bags, np.int32)
    stopped = np.zeros(n_bags, bool)
    window = train_conf.earlyStoppingRounds or 0
    conv = float(train_conf.convergenceThreshold or 0.0)
    train_errs, val_errs = [], []

    def bag_mask(flags):
        return torch.as_tensor(flags).to(dev)

    start_epoch = 0
    checkpointing = bool(checkpoint_dir) and checkpoint_interval > 0
    if checkpointing:
        from shifu_tpu_torch.train import checkpoint as ckpt_mod

        def _like(step):
            # the curves' shapes depend on the resume epoch; steps past
            # numTrainEpochs are filtered by max_step
            return {"stacked": stacked, "opt_state": opt_state,
                    "best": best, "best_val": best_val,
                    "best_epoch": best_epoch, "bad": bad,
                    "stopped": stopped, "gen": gen,
                    "train_errs": np.zeros((step, n_bags), np.float32),
                    "val_errs": np.zeros((step, n_bags), np.float32)}

        restored = ckpt_mod.restore_resharded(
            checkpoint_dir, _like, device=dev,
            max_step=train_conf.numTrainEpochs)
        if restored is not None:
            step, st = restored
            stacked, opt_state, best = st["stacked"], st["opt_state"], \
                st["best"]
            best_val, best_epoch = st["best_val"], st["best_epoch"]
            bad, stopped = st["bad"], st["stopped"]
            if gen is not None:
                gen.set_state(st["gen"].get_state())
            train_errs = list(st["train_errs"])
            val_errs = list(st["val_errs"])
            start_epoch = int(step)
            log.info("streaming train: resumed from checkpoint at "
                     "epoch %d", start_epoch)
            if stopped.all():
                # every bag had already stopped: the restored best is
                # the result, another epoch would only add a curve row
                start_epoch = train_conf.numTrainEpochs

    def _ckpt_state():
        return {"stacked": stacked, "opt_state": opt_state, "best": best,
                "best_val": best_val, "best_epoch": best_epoch, "bad": bad,
                "stopped": stopped, "gen": gen,
                "train_errs": np.stack(train_errs),
                "val_errs": np.stack(val_errs)}

    with contextlib.ExitStack() as unwind:
        if checkpointing:
            # SIGTERM/SIGINT → finish the epoch, save, raise Preempted
            # (rc 75); the writer's last save is made durable on the
            # way out, its error raised only on a clean exit
            unwind.enter_context(
                resilience.graceful_shutdown("streaming train"))
            unwind.push(lambda *exc: ckpt_mod.flush_saves(
                reraise=exc[0] is None))
        for epoch in range(start_epoch, train_conf.numTrainEpochs):
            order = np.random.default_rng(
                (seed ^ 0x5EED) + epoch).permutation(len(train_chunks))
            chunks = pipe.map_prefetch(lambda bnd: host_assemble(bnd, True),
                                       [train_chunks[i] for i in order])
            prev = tree_map(torch.clone, stacked) if stopped.any() else None
            loss_parts, sw_parts = [], []
            nxt = place(next(chunks), "t")
            for ci in range(len(order)):
                inputs, w_bags = nxt
                stacked, opt_state, loss, sw = update(stacked, opt_state,
                                                      inputs, w_bags)
                loss_parts.append(loss)
                sw_parts.append(sw)
                if ci + 1 < len(order):
                    # copies while it computes
                    nxt = place(next(chunks), "t")
            if prev is not None:
                keep = bag_mask(stopped)
                stacked = _unflat(stacked, [
                    trainer_mod._bag_where(keep, old, new)
                    for new, old in zip(_flat(stacked), _flat(prev))])
            # the epoch's one fetch; the sums run on the host in float64
            losses = torch.stack(loss_parts).cpu().numpy().astype(np.float64)
            sws = torch.stack(sw_parts).cpu().numpy().astype(np.float64)
            train_err = np.sum(losses * sws, axis=0) / np.maximum(
                np.sum(sws, axis=0), 1e-12)

            if val_chunks:
                e_parts, m_parts = [], []
                vchunks = pipe.map_prefetch(
                    lambda bnd: host_assemble(bnd, False), val_chunks)
                nxt = place(next(vchunks), "v")
                with torch.no_grad():
                    for ci in range(len(val_chunks)):
                        inputs, w = nxt
                        e_parts.append(metric_sum_fn(stacked, inputs, w))
                        m_parts.append(metric_mass_fn(inputs, w))
                        if ci + 1 < len(val_chunks):
                            nxt = place(next(vchunks), "v")
                es = torch.stack(e_parts).cpu().numpy().astype(np.float64)
                ms = torch.stack(m_parts).cpu().numpy().astype(np.float64)
                val_err = np.sum(es, axis=0) / max(float(np.sum(ms)), 1e-12)
            else:
                val_err = train_err

            train_errs.append(train_err.astype(np.float32))
            val_errs.append(val_err.astype(np.float32))
            improved = (val_err < best_val) & ~stopped
            if improved.any():
                imp = bag_mask(improved)
                with torch.no_grad():
                    best = _unflat(best, [
                        trainer_mod._bag_where(imp, p, b)
                        for b, p in zip(_flat(best), _flat(stacked))])
                best_val = np.where(improved, val_err,
                                    best_val).astype(np.float32)
                best_epoch = np.where(improved, epoch, best_epoch)
            bad = np.where(stopped, bad, np.where(improved, 0, bad + 1))
            stopped |= (window > 0) & (bad >= window)
            stopped |= (conv > 0) & (train_err <= conv)
            saved = False
            if checkpointing and (epoch + 1) % checkpoint_interval == 0:
                ckpt_mod.save_checkpoint(checkpoint_dir, epoch + 1,
                                         _ckpt_state())
                saved = True
            if checkpointing and resilience.preempt_requested():
                # a preemption notice: save off the interval so nothing
                # past the last save is lost, then stop with rc 75
                if saved:
                    ckpt_mod.flush_saves()
                else:
                    ckpt_mod.save_interrupt(checkpoint_dir, epoch + 1,
                                            _ckpt_state())
                raise resilience.Preempted(
                    f"streaming train preempted after epoch {epoch + 1}/"
                    f"{train_conf.numTrainEpochs}; checkpoint saved")
            if stopped.all():
                log.info("streaming train: all bags stopped at epoch %d",
                         epoch)
                break


    res = TrainResult(
        spec=spec, params_per_bag=unstack_params(best),
        train_errors=np.stack(train_errs, axis=1),
        val_errors=np.stack(val_errs, axis=1), best_val=best_val,
        best_epoch=best_epoch, wall_seconds=time.time() - t0, rows=n_train)
    log.info("streaming train: %d rows in %d chunks × %d epochs × %d "
             "bag(s) on %s, best val %s in %.2fs", n_rows,
             len(train_chunks), len(train_errs), n_bags, dev,
             np.round(best_val, 6).tolist(), res.wall_seconds)
    return res


def train_nn_streaming(train_conf, get_chunk, n_rows: int, input_dim: int,
                       seed: int = 12306,
                       spec: Optional[nn_mod.MLPSpec] = None,
                       chunk_rows: int = 262_144, init_params=None,
                       fixed_layers=None, grad_mask=None,
                       n_val: Optional[int] = None, bag_labels=None,
                       device: "str | torch.device" = "cuda",
                       checkpoint_dir: Optional[str] = None,
                       checkpoint_interval: int = 0) -> TrainResult:
    """`baggingNum` NN/LR models trained by streaming row chunks:
    get_chunk(a, b) → (x, y, w)."""
    spec = spec or nn_mod.MLPSpec.from_train_params(train_conf.params,
                                                    input_dim=input_dim)

    def loss_fn(params, inputs, w, gen):
        x, y = inputs
        return nn_mod.loss_fn(spec, params, x, y, w, gen)

    def metric_sum_fn(params, inputs, w):
        x, y = inputs
        pred = nn_mod.forward(spec, params, x)
        if spec.output_dim > 1:
            per = torch.mean(torch.square(nn_mod._onehot(spec, y) - pred),
                             dim=-1)
            return torch.sum(per * w, dim=-1)
        return torch.sum(torch.square(y - pred) * w, dim=-1)

    return train_streaming_core(
        train_conf, get_chunk, n_rows, seed=seed, chunk_rows=chunk_rows,
        init_fn=lambda g: nn_mod.init_params(spec, g), loss_fn=loss_fn,
        metric_sum_fn=metric_sum_fn, init_params=init_params,
        fixed_layers=fixed_layers, grad_mask=grad_mask, n_val=n_val,
        spec=spec, bag_labels=bag_labels,
        dropout=spec.dropout_rate > 0, device=device,
        checkpoint_dir=checkpoint_dir,
        checkpoint_interval=checkpoint_interval)


def train_wdl_streaming(train_conf, get_chunk, n_rows: int, spec,
                        seed: int = 12306, chunk_rows: int = 262_144,
                        n_val: Optional[int] = None, bag_labels=None,
                        device: "str | torch.device" = "cuda",
                        checkpoint_dir: Optional[str] = None,
                        checkpoint_interval: int = 0) -> TrainResult:
    """Streaming wide-and-deep: get_chunk(a, b) → (dense, idx, y, w)."""
    from shifu_tpu_torch.models import wdl as wdl_mod

    def loss_fn(params, inputs, w, gen):
        dense, idx, y = inputs
        return wdl_mod.loss_fn(spec, params, dense, idx, y, w)

    def metric_sum_fn(params, inputs, w):
        dense, idx, y = inputs
        pred = wdl_mod.forward(spec, params, dense, idx)
        return torch.sum(torch.square(y - pred) * w, dim=-1)

    return train_streaming_core(
        train_conf, get_chunk, n_rows, seed=seed, chunk_rows=chunk_rows,
        init_fn=lambda g: wdl_mod.init_params(spec, g), loss_fn=loss_fn,
        metric_sum_fn=metric_sum_fn, n_val=n_val, spec=spec,
        bag_labels=bag_labels, device=device, checkpoint_dir=checkpoint_dir,
        checkpoint_interval=checkpoint_interval)
