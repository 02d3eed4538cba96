"""NN/LR training loop — the port of `shifu_tpu/train/trainer.py`.

The JAX package trains every bag in one jitted program: `vmap` over
bags, `lax.scan` over epochs. Here the bags are the first axis of every
parameter and optimizer tensor (`models/nn` runs their products as one
GEMM over the shared rows, then `bmm`), and the epochs are a Python
loop that issues the same operations with no host sync inside it: the
errors, the early-stop state and the best-validation tracker stay on
the device and are fetched once at the end, as the JAX program's are.

- a bag that has stopped (by window or by convergence,
  `WindowEarlyStop` / `ConvergeAndValidToleranceEarlyStop`) keeps its
  parameters and its whole optimizer state, step count included, while
  the loop runs on (`torch.where(stopped, old, new)`);
- the best-validation parameters are tracked per bag (NNOutput keeps
  the best tmp model), `best_epoch` is the first argmin;
- `MiniBatchRows` splits each epoch into mini-batch updates over rows
  permuted once on the host (`to_batches`, numpy, seeded by
  ``0xB47C4 ^ seed`` as in the JAX package), each bag taking the
  batches in its own order an epoch (`batch_order`).

`split_validation`, `bagging_weights` and `_rescue_empty_bags` are
copied op for op, so the same seed gives the same masks and
multiplicities bit for bit. Initial parameters are drawn from a CPU
generator seeded by the train seed, so a card run and its CPU twin
start from the same weights; `jax.random` and torch generators differ,
so the parity tests inject the JAX package's initial parameters.
Checkpointed chunks (`CheckpointInterval`, orbax) are not ported
(ROADMAP A8).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from shifu_tpu_torch import resolve_device
from shifu_tpu_torch.models import nn as nn_mod
from shifu_tpu_torch.train.optimizers import (Optimizer, freeze,
                                              optimizer_from_params)

log = logging.getLogger("shifu_tpu_torch")


@dataclass
class TrainResult:
    spec: nn_mod.MLPSpec
    params_per_bag: List[Any]          # best-validation params, numpy
    train_errors: np.ndarray           # (bags, epochs)
    val_errors: np.ndarray             # (bags, epochs)
    best_val: np.ndarray               # (bags,)
    best_epoch: np.ndarray             # (bags,)
    wall_seconds: float = 0.0
    rows: int = 0                      # training rows (after the split)


def split_validation(n: int, valid_rate: float, seed: int,
                     cross_over: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Random train/valid split (`AbstractNNWorker.init` validation
    sampling). Returns boolean masks (train, valid)."""
    rng = np.random.default_rng(seed)
    is_val = rng.random(n) < valid_rate
    if valid_rate <= 0.0:
        return np.ones(n, bool), np.zeros(n, bool)
    if is_val.all():
        is_val[0] = False
    if not is_val.any():
        is_val[-1] = True
    return ~is_val, is_val


def bagging_weights(n: int, n_bags: int, sample_rate: float,
                    with_replacement: bool, seed: int,
                    labels: Optional[np.ndarray] = None,
                    stratified: bool = False,
                    neg_only: bool = False) -> np.ndarray:
    """(bags, n) per-row multiplicities: Poisson(rate) for
    with-replacement (AbstractNNWorker Poisson bagging), Bernoulli mask
    otherwise. Bag 0 of a 1-bag run sees the full data (reference runs
    the plain training as bag 0).

    `neg_only` (train.sampleNegOnly, `wdl/WDLWorker.java:431-455`):
    positive records are always kept; only negatives are sampled at
    the bagging rate. `stratified` (train.stratifiedSample,
    `nn/AbstractNNWorker.java:173,216-222` per-class bagging random
    maps): each label class contributes exactly round(rate·n_class)
    rows per bag, removing class-imbalance variance from the bags.
    The reference's fixInitialInput (hash-range sampling so resumed
    runs see identical bags) is always-on here: weights derive from a
    fixed seed, so every resume replays the same bags.
    """
    rng = np.random.default_rng(seed)
    if neg_only and stratified and labels is not None:
        log.warning("sampleNegOnly and stratifiedSample are both set: "
                    "neg-only sampling wins (every positive kept, "
                    "negatives rate-sampled); stratification is subsumed")
    if neg_only and labels is not None:
        lab = np.asarray(labels)
        # NaN labels (MTL primary-task gaps) are kept, like positives
        # (lab < 0.5 is False for NaN) — the streaming counterpart
        # (_chunk_bag_weights) mirrors this
        neg = lab < 0.5
        n_neg = int(neg.sum())
        if with_replacement:
            # Poisson bagging still applies to positives in the
            # reference (sampleNegOnly only DROPS negatives;
            # AbstractNNWorker keeps Poisson multiplicities for kept
            # rows) — force-keep clamps positives to ≥1 rather than
            # pinning them to exactly 1
            w = rng.poisson(sample_rate, size=(n_bags, n)) \
                .astype(np.float32)
            w[:, ~neg] = np.maximum(w[:, ~neg], 1.0)
        else:
            w = np.ones((n_bags, n), np.float32)
            w[:, neg] = rng.random((n_bags, n_neg)) < sample_rate
        return _rescue_empty_bags(w)
    if stratified and labels is not None:
        if sample_rate >= 1.0 and not with_replacement:
            if n_bags == 1:
                # keep-all IS the perfect stratified sample at rate 1.0
                return np.ones((1, n), np.float32)
            # N identical full-data bags are useless (same degrade as
            # the unstratified branch below) — use a BALANCED bootstrap:
            # per-class draws with replacement keep each bag's class mix
            # fixed instead of silently dropping stratification
            log.warning(
                "stratifiedSample with baggingSampleRate >= 1.0 and "
                "%d bags: using per-class balanced bootstrap (draw with "
                "replacement within each class)", n_bags)
            with_replacement = True
        lab = np.asarray(labels)
        w = np.zeros((n_bags, n), np.float32)
        valid = ~np.isnan(lab)
        for cls in np.unique(lab[valid]):
            idx = np.flatnonzero(valid & (lab == cls))
            k = max(1, int(round(sample_rate * len(idx))))
            for b in range(n_bags):
                if with_replacement:
                    np.add.at(w[b], rng.choice(idx, size=k, replace=True),
                              1.0)
                else:
                    w[b, rng.choice(idx, size=min(k, len(idx)),
                                    replace=False)] = 1.0
        nan_idx = np.flatnonzero(~valid)
        if len(nan_idx):
            # NaN labels (MTL primary-task gaps) have no class to
            # stratify into — they sample at the plain rate
            for b in range(n_bags):
                if with_replacement:
                    w[b, nan_idx] = rng.poisson(sample_rate, len(nan_idx))
                else:
                    w[b, nan_idx] = rng.random(len(nan_idx)) < sample_rate
        return _rescue_empty_bags(w)
    if n_bags == 1 and sample_rate >= 1.0 and not with_replacement:
        return np.ones((1, n), np.float32)
    if n_bags > 1 and sample_rate >= 1.0 and not with_replacement:
        # "100% sample without replacement" per bag would give every
        # bag the identical full dataset — N identical models at N×
        # cost. Degrade to Poisson(rate) resampling, which is what the
        # reference's per-bag worker actually does (AbstractNNWorker
        # Poisson bagging runs regardless of the replacement flag).
        with_replacement = True
    if with_replacement:
        w = rng.poisson(sample_rate, size=(n_bags, n)).astype(np.float32)
    else:
        w = (rng.random((n_bags, n)) < sample_rate).astype(np.float32)
    return _rescue_empty_bags(w)


def _rescue_empty_bags(w: np.ndarray) -> np.ndarray:
    """A bag with zero total weight would divide by ~0 — reset it to
    the full data (every bagging branch shares this guard)."""
    empty = w.sum(axis=1) == 0
    w[empty] = 1.0
    return w



def _bag_where(mask: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Per bag: `a` where the (B,) `mask` holds, else `b`."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _flat(params: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict/list of tensors in a fixed order:
    lists in their order, dicts by sorted key (an NN's layer list, WDL's
    ``embed``/``wide_*``/``deep`` dict, MTL's ``trunk``/``heads_*``)."""
    if isinstance(params, dict):
        return [v for k in sorted(params) for v in _flat(params[k])]
    if isinstance(params, (list, tuple)):
        return [v for p in params for v in _flat(p)]
    return [params]


def _unflat(like: Any, leaves: Sequence[torch.Tensor]) -> Any:
    """`like`'s structure over `leaves`, in `_flat`'s order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(p) for p in node]
        return next(it)
    return build(like)


def tree_map(fn, params: Any) -> Any:
    """`fn` over every tensor of a nested dict/list, structure kept."""
    return _unflat(params, [fn(v) for v in _flat(params)])


def unstack_params(stacked: Any) -> List[Any]:
    """Bag-stacked params → one numpy model a bag."""
    host = tree_map(lambda v: v.detach().cpu().numpy(), stacked)
    n_bags = _flat(host)[0].shape[0]
    return [tree_map(lambda v, b=b: v[b], host) for b in range(n_bags)]


def stack_params(models: Sequence[Any]) -> Any:
    """One model's params a bag (numpy or tensors, same structure) →
    bag-stacked f32 tensors."""
    leaves = [_flat(m) for m in models]
    return _unflat(models[0], [
        torch.stack([torch.tensor(np.asarray(v, np.float32))
                     if not isinstance(v, torch.Tensor)
                     else v.to(torch.float32) for v in vs])
        for vs in zip(*leaves)])


def initial_params(init_fn, seed: int, n_bags: int) -> Any:
    """Bag-stacked initial params: `init_fn(generator)` a bag, in bag
    order, from one CPU generator seeded by `seed` — the same numbers
    for a card run and its CPU twin (a CUDA generator would give
    others). The WDL, MTL and streaming trainers draw here, so a parity
    test hands them the JAX package's draw by replacing this
    function."""
    gen = torch.Generator().manual_seed(int(seed))
    return stack_params([init_fn(gen) for _ in range(n_bags)])


def init_train_carry(optimizer: Optimizer, stacked_params: Any,
                     generator: Optional[torch.Generator] = None):
    """Fresh per-bag training carry: (params, optimizer state, best
    tracker, early-stop state, dropout generator); every parameter
    tensor is bag-first."""
    leaves = _flat(stacked_params)
    n_bags, dev = leaves[0].shape[0], leaves[0].device
    return (stacked_params, optimizer.init(leaves),
            {"params": stacked_params,
             "val": torch.full((n_bags,), float("inf"), device=dev)},
            {"bad": torch.zeros(n_bags, dtype=torch.int32, device=dev),
             "stopped": torch.zeros(n_bags, dtype=torch.bool, device=dev)},
            generator)


def train_bags_carry(loss_fn, metric_fn, optimizer: Optimizer, n_epochs: int,
                     early_stop_window: int, convergence_threshold: float,
                     carry, train_inputs, w_train_bags, val_inputs, w_val,
                     grad_mask, batch_order: Optional[torch.Tensor] = None):
    """The bag-stacked trainer: takes and returns the training carry,
    with each epoch's (B,) train and validation errors as lists of
    device tensors (`train_bags_carry` of the JAX package). The params
    are any nested dict/list of bag-first tensors (`_flat`).

    loss_fn(params, inputs, w, generator) → (B,) training losses;
    metric_fn(params, inputs, w) → (B,) validation errors. `grad_mask`
    is one model's {0, 1} params of the same structure (fixed layers,
    continuous training's absorbed indices). With `batch_order` ((epochs, B,
    n_batches) batch indices on the device), every row input arrives as
    (n_batches, rows/batch, ...) and `w_train_bags` as (B, n_batches,
    rows/batch): each epoch is a run of mini-batch updates, bag b taking
    batch ``batch_order[e, b, i]`` at step i.
    """
    params, opt_state, best, stop, gen = carry
    mask = _flat(grad_mask)
    bag_idx = torch.arange(w_train_bags.shape[0], device=w_train_bags.device)

    def step(p, o, inputs, w):
        leaves = [t.detach().requires_grad_(True) for t in _flat(p)]
        loss = loss_fn(_unflat(p, leaves), inputs, w, gen)
        grads = torch.autograd.grad(loss.sum(), leaves)
        with torch.no_grad():
            upd, o2 = optimizer.update([g * m for g, m in zip(grads, mask)],
                                       o)
            new = [t.detach() + u for t, u in zip(leaves, upd)]
        return _unflat(p, new), o2, loss.detach()

    train_errs, val_errs = [], []
    for e in range(n_epochs):
        stopped = stop["stopped"]
        if batch_order is not None:
            new_params, new_state = params, opt_state
            losses, wsums = [], []
            for i in range(batch_order.shape[2]):
                idx = batch_order[e, :, i]
                w_b = w_train_bags[bag_idx, idx]
                new_params, new_state, loss = step(
                    new_params, new_state,
                    tuple(t[idx] for t in train_inputs), w_b)
                losses.append(loss)
                wsums.append(w_b.sum(-1))
            losses, wsums = torch.stack(losses, 1), torch.stack(wsums, 1)
            # per-batch losses are weight-normalized within the batch;
            # weighting by batch mass keeps the zero-weight padded tail
            # from biasing the epoch error
            train_err = torch.sum(losses * wsums, 1) \
                / torch.clamp_min(wsums.sum(1), 1e-12)
        else:
            new_params, new_state, train_err = step(
                params, opt_state, train_inputs, w_train_bags)
        with torch.no_grad():
            # a stopped bag keeps its params and its optimizer state
            params = _unflat(params, [
                _bag_where(stopped, old, new) for new, old in
                zip(_flat(new_params), _flat(params))])
            opt_state = freeze(stopped, new_state, opt_state)
            val_err = metric_fn(params, val_inputs, w_val)
            improved = val_err < best["val"]
            take = improved & ~stopped
            best = {"params": _unflat(params, [
                        _bag_where(take, cur, old) for cur, old in
                        zip(_flat(params), _flat(best["params"]))]),
                    "val": torch.where(take, val_err, best["val"])}
            bad = torch.where(stopped, stop["bad"],
                              torch.where(improved,
                                          torch.zeros_like(stop["bad"]),
                                          stop["bad"] + 1))
            stopped = stopped.clone()
            if early_stop_window > 0:
                stopped |= bad >= early_stop_window
            if convergence_threshold > 0.0:
                stopped |= train_err <= convergence_threshold
            stop = {"bad": bad, "stopped": stopped}
        train_errs.append(train_err)
        val_errs.append(val_err)
    return (params, opt_state, best, stop, gen), train_errs, val_errs


def _to_batches(a, perm: np.ndarray, n_batches: int, batch_rows: int,
                axis_rows: int = 0):
    """Permute rows by `perm`, pad with zeros to n_batches·batch_rows
    (zero weight ⇒ the pad is inert) and reshape to (…, n_batches,
    batch_rows, …), in one host allocation. Tensors (a bf16 x) stay
    tensors."""
    if isinstance(a, torch.Tensor):
        out = torch.zeros((n_batches * batch_rows,) + tuple(a.shape[1:]),
                          dtype=a.dtype)
        out[:a.shape[0]] = a[torch.as_tensor(perm)]
        return out.reshape((n_batches, batch_rows) + tuple(a.shape[1:]))
    a = np.asarray(a)
    padded = a.shape[:axis_rows] + (n_batches * batch_rows,) \
        + a.shape[axis_rows + 1:]
    out = np.zeros(padded, a.dtype)
    sel = [slice(None)] * a.ndim
    sel[axis_rows] = slice(0, a.shape[axis_rows])
    np.take(a, perm, axis=axis_rows, out=out[tuple(sel)], mode="clip")
    return out.reshape(a.shape[:axis_rows] + (n_batches, batch_rows)
                       + a.shape[axis_rows + 1:])


def _on(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(a).to(dev)


def train_bags(loss_fn, metric_fn, optimizer: Optimizer, n_epochs: int,
               early_stop_window: int, convergence_threshold: float,
               stacked_params, train_inputs, w_train_bags,
               val_inputs, w_val, grad_mask,
               device: "str | torch.device" = "cuda",
               dropout_generator: Optional[torch.Generator] = None,
               checkpoint_dir: Optional[str] = None,
               checkpoint_interval: int = 0,
               batch_rows: int = 0, perm_seed: int = 0,
               batch_order: Optional[np.ndarray] = None):
    """Place the inputs on `device` once, run `train_bags_carry` over
    every epoch and fetch the results: (best params per bag as device
    tensors, train errors (B, E), val errors (B, E), best val (B,),
    best epoch (B,)), the last four numpy.

    batch_rows > 0 (and below the row count) enables mini-batch SGD:
    rows permute once on the host (`_to_batches`, seeded by
    ``0xB47C4 ^ perm_seed``) and each bag takes the batches in the
    order `batch_order` gives ((E, B, n_batches)); by default the
    orders are drawn at once from a CPU generator seeded by
    `perm_seed`, so a card run and its CPU twin take the same ones."""
    if checkpoint_dir and checkpoint_interval > 0:
        raise NotImplementedError(
            "train#params CheckpointInterval > 0 (orbax checkpoints of the "
            "training carry) is not ported yet (ROADMAP A8)")
    dev = resolve_device(device)
    n_rows = int(train_inputs[0].shape[0])
    n_bags = int(w_train_bags.shape[0])
    order = None
    if batch_rows and 0 < batch_rows < n_rows:
        n_batches = -(-n_rows // batch_rows)
        perm = np.random.default_rng(
            np.uint64(0xB47C4) ^ np.uint64(perm_seed)).permutation(n_rows)
        train_inputs = tuple(_to_batches(t, perm, n_batches, batch_rows)
                             for t in train_inputs)
        w_train_bags = _to_batches(w_train_bags, perm, n_batches,
                                   batch_rows, axis_rows=1)
        if batch_order is None:
            gen = torch.Generator().manual_seed(int(perm_seed))
            batch_order = torch.argsort(
                torch.rand((n_epochs, n_bags, n_batches), generator=gen),
                dim=2)
        order = _on(batch_order, dev).to(torch.int64)
    train_inputs = tuple(_on(t, dev) for t in train_inputs)
    val_inputs = tuple(_on(t, dev) for t in val_inputs)
    w_train_bags = _on(w_train_bags, dev).to(torch.float32)
    w_val = _on(w_val, dev).to(torch.float32)
    stacked_params = tree_map(lambda v: _on(v, dev), stacked_params)
    grad_mask = tree_map(lambda v: _on(v, dev), grad_mask)

    carry = init_train_carry(optimizer, stacked_params, dropout_generator)
    carry, train_errs, val_errs = train_bags_carry(
        loss_fn, metric_fn, optimizer, n_epochs, early_stop_window,
        convergence_threshold, carry, train_inputs, w_train_bags,
        val_inputs, w_val, grad_mask, order)
    # the one host sync of the run
    train_errs = torch.stack(train_errs, 1).cpu().numpy() if train_errs \
        else np.zeros((n_bags, 0), np.float32)
    val_errs = torch.stack(val_errs, 1).cpu().numpy() if val_errs \
        else np.zeros((n_bags, 0), np.float32)
    best = carry[2]
    best_epoch = np.argmin(val_errs, axis=1)
    return best["params"], train_errs, val_errs, \
        best["val"].cpu().numpy(), best_epoch


def train_nn(train_conf, x: np.ndarray, y: np.ndarray, w: np.ndarray,
             seed: int = 12306, spec: Optional[nn_mod.MLPSpec] = None,
             init_params: Optional[Any] = None,
             fixed_layers: Optional[List[int]] = None,
             grad_mask: Optional[Any] = None,
             val_data: Optional[Tuple[np.ndarray, np.ndarray,
                                      np.ndarray]] = None,
             checkpoint_dir: Optional[str] = None,
             checkpoint_interval: int = 0,
             device: "str | torch.device" = "cuda",
             batch_order: Optional[np.ndarray] = None) -> TrainResult:
    """Train `baggingNum` NN models at once on `device`.

    val_data overrides the random validSetRate split. init_params
    (numpy or tensors, one network's or bag-stacked) enables continuous
    training; fixed_layers freezes those 1-BASED layers (FixedLayers=[1]
    = the input→hidden1 weights); grad_mask overrides with an
    element-wise {0,1} parameter list. Without init_params each bag's
    weights are drawn by `nn.init_params` from a CPU generator seeded by
    `seed`. `batch_order` replaces the mini-batch orders (see
    `train_bags`)."""
    from shifu_tpu_torch import weights
    t0 = time.time()
    dev = resolve_device(device)
    spec = spec or nn_mod.MLPSpec.from_train_params(
        train_conf.params, input_dim=x.shape[1])
    n_bags = max(train_conf.baggingNum, 1)

    if val_data is not None:
        x_tr, y_tr, w_tr = x, y, w
        x_v, y_v, w_v = val_data
    else:
        tr_mask, val_mask = split_validation(len(y), train_conf.validSetRate,
                                             seed)
        x_tr, y_tr, w_tr = x[tr_mask], y[tr_mask], w[tr_mask]
        x_v, y_v, w_v = x[val_mask], y[val_mask], w[val_mask]
    x_tr = torch.as_tensor(np.ascontiguousarray(x_tr, np.float32))
    x_v = torch.as_tensor(np.ascontiguousarray(x_v, np.float32))
    if spec.compute_dtype == "bfloat16":
        # a bf16-resident x halves the bytes every epoch streams
        # (labels and weights stay f32: they feed the f32 loss)
        x_tr, x_v = x_tr.to(torch.bfloat16), x_v.to(torch.bfloat16)

    neg_only = train_conf.sampleNegOnly
    if neg_only and spec.output_dim > 1:
        # native multi-class y holds class indices; sampleNegOnly is a
        # binary/one-vs-all semantics
        log.warning("sampleNegOnly ignored for native multi-class "
                    "training (binary/one-vs-all semantics only)")
        neg_only = False
    bag_w = bagging_weights(len(y_tr), n_bags, train_conf.baggingSampleRate,
                            train_conf.baggingWithReplacement, seed,
                            labels=np.asarray(y_tr),
                            stratified=train_conf.stratifiedSample,
                            neg_only=neg_only) * np.asarray(w_tr)[None, :]

    if init_params is not None:
        stacked = weights.stack_nn_params(init_params, n_bags)
    else:
        gen = torch.Generator().manual_seed(int(seed))
        stacked = weights.stack_nn_params(
            [nn_mod.init_params(spec, gen) for _ in range(n_bags)])
    if grad_mask is None:
        grad_mask = [{k: torch.ones_like(v[0]) for k, v in layer.items()}
                     for layer in stacked]
        if fixed_layers:
            # 1-based like the reference's FixedLayers: 1 freezes the
            # input→hidden1 weight matrix (NNMaster.getFixedWights)
            for i, layer in enumerate(grad_mask):
                if (i + 1) in fixed_layers:
                    for v in layer.values():
                        v.zero_()
    else:
        grad_mask = [{k: torch.as_tensor(np.asarray(v, np.float32))
                      for k, v in layer.items()} for layer in grad_mask]

    optimizer = optimizer_from_params(train_conf.params)
    early_window = train_conf.earlyStoppingRounds
    dropout_gen = torch.Generator(device=dev).manual_seed(int(seed)) \
        if spec.dropout_rate > 0 else None

    def nn_loss(params, inputs, w_, gen_):
        x_, y_ = inputs
        return nn_mod.loss_fn(spec, params, x_, y_, w_, gen_)

    def nn_metric(params, inputs, w_):
        x_, y_ = inputs
        return nn_mod.mse(spec, params, x_, y_, w_)

    # train#params MiniBatchRows: mini-batch SGD (0 = full batch)
    batch_rows = int(train_conf.get_param("MiniBatchRows", 0) or 0)
    best_params, train_errs, val_errs, best_val, best_epoch = train_bags(
        nn_loss, nn_metric, optimizer, train_conf.numTrainEpochs,
        early_window if early_window and early_window > 0 else 0,
        float(train_conf.convergenceThreshold or 0.0),
        stacked, (x_tr, np.asarray(y_tr, np.float32)), bag_w,
        (x_v, np.asarray(y_v, np.float32)), np.asarray(w_v, np.float32),
        grad_mask, device=dev, dropout_generator=dropout_gen,
        checkpoint_dir=checkpoint_dir,
        checkpoint_interval=checkpoint_interval,
        batch_rows=batch_rows, perm_seed=seed, batch_order=batch_order)

    res = TrainResult(
        spec=spec, params_per_bag=weights.unstack_nn_params(best_params),
        train_errors=train_errs, val_errors=val_errs, best_val=best_val,
        best_epoch=best_epoch, wall_seconds=time.time() - t0,
        rows=len(y_tr))
    log.info("train: %d bag(s), %d epochs on %s, best val err %s in %.2fs",
             n_bags, train_conf.numTrainEpochs, dev,
             np.round(res.best_val, 6).tolist(), res.wall_seconds)
    return res
