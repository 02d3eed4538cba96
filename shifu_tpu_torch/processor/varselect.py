"""`shifu varsel` — variable selection, the port of
`shifu_tpu/processor/varselect.py` (`VarSelectModelProcessor.java`).

- `-reset`, `-list` and `-f <file>` edit `finalSelect` by hand;
- forceSelect / forceRemove / missingRateThreshold pick the candidates
  (`_apply_pre_filters`);
- filterBy KS / IV / MIX / PARETO rank candidates by the stats step's
  metrics (`_filter_by_stats`, host only);
- SE / ST / SC train a quick NN on every candidate (half the epochs,
  one bag, the port's `train_nn` on `device`) and rank the columns by
  the mean squared score delta of wiping each one
  (`_sensitivity_kernel`, which posttrain shares); `-r N` re-runs it N
  times on the survivors;
- V is the voted wrapper: a population of column subsets, each scored
  by the validation error of a 16-unit tanh net trained on its columns.
  The JAX package `vmap`s the population; here the P nets are stacked
  on a first axis and train at once (Adam at optax's arithmetic, full
  batch). Selection, crossover and mutation stay on the host with the
  JAX package's `np.random.default_rng(seed)` draws;
- FI trains a tree model into the model set through `norm` and
  `train_tree.run_tree` (kernels K3/K4 and K5 on the card) and ranks
  columns by the gains the trees keep.

The `step_guard` completion manifest is ROADMAP A8; a set past the
analysis trigger raises in `chunking.analysis_frame` (A6).
"""

from __future__ import annotations

import copy
import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from shifu_tpu_torch import resolve_device
from shifu_tpu_torch.config.column_config import ColumnConfig
from shifu_tpu_torch.config.inspector import ModelStep
from shifu_tpu_torch.config.model_config import NormType
from shifu_tpu_torch.fileio import atomic_write
from shifu_tpu_torch.models import nn as nn_mod
from shifu_tpu_torch.processor import norm as norm_proc
from shifu_tpu_torch.processor.base import ProcessorContext
from shifu_tpu_torch.processor.chunking import analysis_frame
from shifu_tpu_torch.train import optimizers
from shifu_tpu_torch.train.trainer import train_nn

log = logging.getLogger("shifu_tpu_torch")

# bytes of the wiped inputs of one chunk of column ablations
SENSITIVITY_CHUNK_BYTES = 2 * 1024 ** 3

# *_INDEX families route categoricals to the embedding-index block, which
# the sensitivity MLP cannot see: SE normalizes with these dense
# equivalents (any other index family → ZSCALE)
_DENSE_EQUIV = {
    NormType.WOE_INDEX: NormType.WOE,
    NormType.WOE_APPEND_INDEX: NormType.WOE,
    NormType.WOE_ZSCALE_INDEX: NormType.WOE_ZSCALE,
    NormType.WOE_ZSCALE_APPEND_INDEX: NormType.WOE_ZSCALE,
}


def run(ctx: ProcessorContext, recursive: int = 0, seed: int = 12306,
        reset: bool = False, list_only: bool = False,
        select_file: Optional[str] = None,
        device: "str | torch.device" = "cuda",
        report: Optional[Dict[str, Any]] = None) -> int:
    """`report`, when given, receives the rows the SE/ST/V/FI filters
    read (``rows``) and, for V, each generation's best validation error
    (``generations``)."""
    t0 = time.time()
    mc = ctx.model_config
    ctx.validate(ModelStep.VARSELECT)
    ctx.require_columns()
    vs = mc.varSelect
    report = report if report is not None else {}

    if reset:
        # VarSelectModelProcessor.resetAllFinalSelect:479
        for cc in ctx.column_configs:
            cc.finalSelect = False
        ctx.save_column_configs()
        log.info("varsel -reset: all %d columns finalSelect=false",
                 len(ctx.column_configs))
        return 0
    if list_only:
        sel = [c.columnName for c in ctx.column_configs if c.finalSelect]
        log.info("varsel -list: %d variables selected", len(sel))
        for name in sel:
            print(name)
        return 0
    if select_file:
        # reset, then select exactly the names in the file
        # (VarSelectModelProcessor:202-220)
        names = set(mc.column_names_from_file(select_file))
        if not names:
            raise ValueError(
                f"varsel -f: {select_file!r} does not exist (relative "
                "paths resolve against the model-set dir) or names no "
                "variables")
        n_sel = 0
        for cc in ctx.column_configs:
            cc.finalSelect = cc.columnName in names
            n_sel += int(cc.finalSelect)
        if n_sel == 0:
            raise ValueError(
                f"varsel -f: none of the {len(names)} name(s) in "
                f"{select_file!r} match a column; selection unchanged")
        ctx.save_column_configs()
        log.info("varsel -f: %d variables selected based on %s", n_sel,
                 select_file)
        return 0

    candidates = _apply_pre_filters(ctx)
    if not vs.filterEnable:
        for cc in candidates:
            cc.finalSelect = True
        ctx.save_column_configs()
        return 0

    by = vs.filterBy.upper()
    if by in ("KS", "IV", "MIX", "PARETO"):
        _filter_by_stats(ctx, candidates, by)
    elif by in ("SE", "ST", "SC"):
        dev = resolve_device(device)
        # SC differs from SE only in the reference's output sort order
        # (VarSelectModelProcessor.java:302-312)
        _filter_by_sensitivity(ctx, candidates,
                               "ST" if by == "ST" else "SE", seed, dev,
                               report)
        for _ in range(recursive):
            survivors = [c for c in candidates if c.finalSelect]
            _filter_by_sensitivity(ctx, survivors, by, seed, dev, report)
    elif by == "V":
        _filter_by_voted_wrapper(ctx, candidates, seed,
                                 resolve_device(device), report)
    elif by == "FI":
        _filter_by_feature_importance(ctx, candidates, seed,
                                      resolve_device(device), report)
    else:
        raise ValueError(f"varSelect#filterBy {vs.filterBy!r} not supported")

    n_sel = sum(1 for c in ctx.column_configs if c.finalSelect)
    ctx.save_column_configs()
    report["selected"] = n_sel
    log.info("varsel[%s]: %d/%d columns selected in %.2fs", by, n_sel,
             len(candidates), time.time() - t0)
    return 0


def _apply_pre_filters(ctx: ProcessorContext) -> List[ColumnConfig]:
    """forceSelect / forceRemove / missingRateThreshold preprocessing
    (`VarSelectModelProcessor` candidate assembly)."""
    mc = ctx.model_config
    vs = mc.varSelect
    force_sel = {n.split("::")[-1].strip() for n in
                 mc.column_names_from_file(vs.forceSelectColumnNameFile)}
    force_rem = {n.split("::")[-1].strip() for n in
                 mc.column_names_from_file(vs.forceRemoveColumnNameFile)}
    candidates = []
    for cc in ctx.column_configs:
        cc.finalSelect = False
        if not cc.is_candidate or cc.columnName in force_rem:
            continue
        if vs.forceEnable and cc.columnName in force_sel:
            cc.finalSelect = True
            continue
        miss = cc.columnStats.missingPercentage or 0.0
        if miss > vs.missingRateThreshold:
            continue
        candidates.append(cc)
    return candidates


def _metric_of(cc: ColumnConfig, by: str) -> float:
    ks = cc.columnStats.ks or 0.0
    iv = cc.columnStats.iv or 0.0
    if by == "KS":
        return ks
    if by == "IV":
        return iv
    return ks + iv  # MIX/PARETO combined ranking


def _filter_by_stats(ctx: ProcessorContext, candidates: List[ColumnConfig],
                     by: str) -> None:
    vs = ctx.model_config.varSelect
    ranked = sorted(candidates, key=lambda c: -_metric_of(c, by))
    thr_iv = vs.minIvThreshold
    thr_ks = vs.minKsThreshold
    for i, cc in enumerate(ranked):
        ok = i < vs.filterNum
        if thr_iv is not None and (cc.columnStats.iv or 0.0) < thr_iv:
            ok = False
        if thr_ks is not None and (cc.columnStats.ks or 0.0) < thr_ks:
            ok = False
        cc.finalSelect = cc.finalSelect or ok


@torch.inference_mode()
def _sensitivity_kernel(model, x: torch.Tensor, base_score: torch.Tensor,
                        n_real: Optional[int] = None,
                        chunk_bytes: int = SENSITIVITY_CHUNK_BYTES
                        ) -> torch.Tensor:
    """(C,) mean squared score delta when column c of the normalized
    inputs `x` (N, C) is wiped to 0 (the mean / missing value), the
    `VarSelectMapper` MSE delta: `_sensitivity_kernel` of the JAX
    package, which `vmap`s every ablation at once, a (C, N, C) tensor.
    The port runs the ablations a chunk of columns at a time, a chunk's
    wiped inputs (k, N, C) held under `chunk_bytes`, and each through
    the model's own forward. `n_real` divides in place of N (1 gives
    the per-column sums)."""
    n, c = x.shape
    div = float(n_real if n_real is not None else n)
    k = max(1, min(c, chunk_bytes // max(1, n * c * x.element_size())))
    out = torch.empty(c, dtype=torch.float32, device=x.device)
    for c0 in range(0, c, k):
        cols = torch.arange(c0, min(c0 + k, c), device=x.device)
        wiped = x.unsqueeze(0).repeat(len(cols), 1, 1)
        wiped[torch.arange(len(cols), device=x.device), :, cols] = 0.0
        s = model(wiped.reshape(-1, c)).reshape(len(cols), n)
        out[c0:c0 + len(cols)] = torch.sum(
            torch.square(s - base_score[None, :]), dim=1) / div
    return out


def _dense_mc(mc, index_equiv: Dict[NormType, NormType]):
    """`mc` with an *_INDEX norm family swapped for its dense
    equivalent (`index_equiv`, else ZSCALE); `mc` itself otherwise."""
    nt = mc.normalize.normType
    if not nt.is_index:
        return mc
    out = copy.copy(mc)
    out.normalize = copy.copy(mc.normalize)
    out.normalize.normType = index_equiv.get(nt, NormType.ZSCALE)
    return out


def _source_names(dense_names: List[str],
                  cols: List[ColumnConfig]) -> List[str]:
    """The source column of each dense output column (onehot families
    expand one source into `<name>_<k>` columns)."""
    names = {c.columnName for c in cols}
    return [n if n in names else n.rsplit("_", 1)[0] for n in dense_names]


def _filter_by_sensitivity(ctx: ProcessorContext,
                           candidates: List[ColumnConfig], by: str,
                           seed: int, dev: torch.device,
                           report: Dict[str, Any]) -> None:
    """SE: train a quick NN on all candidates, ablate each column, rank
    by score MSE delta. ST ranks by relative delta (delta / score var)."""
    mc = ctx.model_config
    vs = mc.varSelect
    for cc in candidates:
        cc.finalSelect = True  # train on the full candidate set
    ctx.save_column_configs()

    cols = list(candidates)
    dset = norm_proc.load_dataset_for_columns(mc, ctx.column_configs, cols,
                                              df=analysis_frame(ctx))
    result = norm_proc.normalize_columns(_dense_mc(mc, _DENSE_EQUIV), cols,
                                         dset, device=dev)
    report["rows"] = dset.num_rows

    # half-epoch quick train (TrainModelProcessor isForVarSelect,
    # TrainModelProcessor.java:1588-1591)
    conf = copy.copy(mc.train)
    conf.numTrainEpochs = max(mc.train.numTrainEpochs // 2, 10)
    conf.baggingNum = 1
    res = train_nn(conf, result.dense.astype(np.float32), dset.tags,
                   dset.weights, seed=seed, device=dev)
    params = [{k: torch.as_tensor(np.asarray(v), device=dev)
               for k, v in layer.items()} for layer in res.params_per_bag[0]]

    def model(t: torch.Tensor) -> torch.Tensor:
        return nn_mod.forward(res.spec, params, t)

    with torch.inference_mode():
        x = torch.as_tensor(result.dense, dtype=torch.float32, device=dev)
        base = model(x)
        deltas = _sensitivity_kernel(model, x, base).cpu().numpy()

    # dense output columns fold back onto their source columns
    per_col: Dict[str, float] = {}
    for src, d in zip(_source_names(result.dense_names, cols), deltas):
        per_col[src] = per_col.get(src, 0.0) + float(d)
    if by == "ST":
        var = float(np.var(base.cpu().numpy())) or 1.0
        per_col = {k: v / var for k, v in per_col.items()}

    se_path = ctx.path_finder.se_path(0)
    ctx.path_finder.ensure(se_path)
    ranked = sorted(per_col.items(), key=lambda kv: -kv[1])
    with atomic_write(se_path) as f:
        for name, d in ranked:
            f.write(f"{name}\t{d:.8g}\n")

    keep = {name for name, _ in ranked[:vs.filterNum]}
    for cc in candidates:
        cc.finalSelect = cc.columnName in keep


def _dense_candidate_matrix(ctx: ProcessorContext,
                            candidates: List[ColumnConfig],
                            dev: torch.device):
    """Normalized dense matrix over ALL candidates (index families
    remapped to ZSCALE), the source column of each dense column, and
    the dataset — what the wrapper filter trains on."""
    mc = ctx.model_config
    for cc in candidates:
        cc.finalSelect = True
    dset = norm_proc.load_dataset_for_columns(mc, ctx.column_configs,
                                              candidates,
                                              df=analysis_frame(ctx))
    result = norm_proc.normalize_columns(_dense_mc(mc, {}), candidates,
                                         dset, device=dev)
    return (result.dense.astype(np.float32),
            _source_names(result.dense_names, candidates), dset)


def voted_init_params(spec: nn_mod.MLPSpec, pop_size: int,
                      seed: int) -> List[Dict[str, torch.Tensor]]:
    """The wrapper population's initial nets, stacked on a first axis of
    `pop_size`: `nn.init_params` drawn one net after another from a CPU
    generator seeded by `seed`, so a card run and its CPU twin start
    alike (the JAX package splits `PRNGKey(seed)` a net; parity tests
    put its draws in this function's place)."""
    from shifu_tpu_torch import weights
    gen = torch.Generator().manual_seed(int(seed))
    return weights.stack_nn_params([nn_mod.init_params(spec, gen)
                                    for _ in range(pop_size)])


def _population_fitness(spec: nn_mod.MLPSpec, init, masks: torch.Tensor,
                        train, val, epochs: int) -> torch.Tensor:
    """(P,) validation MSE of P masked nets, each trained `epochs` full
    batch Adam(0.05) steps from its own initial weights on its own
    columns. Net p sees ``x * masks[p]``; the masks multiply the first
    layer's weight rows instead, the same products and the same zero
    gradients on the masked rows, so the P nets share one read of x."""
    xt, yt, wt = train
    xv, yv, wv = val
    p_size = masks.shape[0]
    opt = optimizers.adam(0.05)
    leaves = [v.clone() for layer in init for v in layer.values()]
    keys = [list(layer) for layer in init]

    def net(ls):
        it = iter(ls)
        layers = [{k: next(it) for k in ks} for ks in keys]
        layers[0] = dict(layers[0], w=layers[0]["w"] * masks[:, :, None])
        return layers

    state = opt.init(leaves)
    w_tr = wt.expand(p_size, -1)
    for _ in range(epochs):
        ls = [t.detach().requires_grad_(True) for t in leaves]
        loss = nn_mod.loss_fn(spec, net(ls), xt, yt, w_tr)
        grads = torch.autograd.grad(loss.sum(), ls)
        with torch.no_grad():
            upd, state = opt.update(list(grads), state)
            leaves = [t.detach() + u for t, u in zip(ls, upd)]
    with torch.no_grad():
        return nn_mod.mse(spec, net(leaves), xv, yv, wv.expand(p_size, -1))


def _filter_by_voted_wrapper(ctx: ProcessorContext,
                             candidates: List[ColumnConfig], seed: int,
                             dev: torch.device,
                             report: Dict[str, Any]) -> None:
    """filterBy=V — the genetic/voted wrapper (`core/dvarsel/*`): a
    population of candidate feature subsets (`CandidateGenerator`), each
    validated by training a small net on just those features
    (`ValidationConductor`), evolved for several rounds; the final
    selection is the vote among the fittest half.

    Population knobs come from varSelect#params (population_live_size /
    population_multiply_cnt / expect_variable_cnt), defaulting to a
    20-seed, 5-generation run targeting wrapperNum variables."""
    mc = ctx.model_config
    vs = mc.varSelect
    params = vs.params or {}
    x, src_of, dset = _dense_candidate_matrix(ctx, candidates, dev)
    y, w = dset.tags, dset.weights
    report["rows"] = dset.num_rows
    n_dense = x.shape[1]
    srcs = sorted(set(src_of))
    src_ix = {s: i for i, s in enumerate(srcs)}
    n_src = len(srcs)
    # dense-column → source-column expansion matrix
    expand = np.zeros((n_src, n_dense), np.float32)
    for j, s in enumerate(src_of):
        expand[src_ix[s], j] = 1.0

    expect = int(params.get("expect_variable_cnt", 0) or vs.wrapperNum
                 or max(n_src // 2, 1))
    expect = min(expect, n_src)
    pop_size = int(params.get("population_live_size", 20) or 20)
    generations = int(params.get("population_multiply_cnt", 5) or 5)
    epochs = max(int(mc.train.numTrainEpochs) // 4, 10)

    rng = np.random.default_rng(seed)
    pop = np.zeros((pop_size, n_src), np.float32)
    for i in range(pop_size):
        pop[i, rng.choice(n_src, expect, replace=False)] = 1.0

    tr_mask = rng.random(len(y)) >= 0.2

    def on(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)

    train = (on(x[tr_mask]), on(y[tr_mask]), on(w[tr_mask]))
    val = (on(x[~tr_mask]), on(y[~tr_mask]), on(w[~tr_mask]))
    spec = nn_mod.MLPSpec(input_dim=n_dense, hidden_dims=(16,),
                          activations=("tanh",), loss="log")
    init = [{k: v.to(dev) for k, v in layer.items()}
            for layer in voted_init_params(spec, pop_size, seed)]
    expand_t = on(expand)

    def fitness(masks_src: np.ndarray) -> np.ndarray:
        masks = on(masks_src) @ expand_t        # (P, n_dense), exact 0/1
        return _population_fitness(spec, init, masks, train, val,
                                   epochs).cpu().numpy()

    best = []
    for gen in range(generations):
        errs = fitness(pop)
        order = np.argsort(errs)
        best.append(float(errs[order[0]]))
        n_keep = max(pop_size // 2, 2)
        survivors = pop[order[:n_keep]]
        children = []
        while len(children) < pop_size - n_keep:
            a, b = survivors[rng.integers(n_keep)], \
                survivors[rng.integers(n_keep)]
            union = np.flatnonzero((a + b) > 0)
            pick = rng.choice(union, min(expect, len(union)), replace=False)
            child = np.zeros(n_src, np.float32)
            child[pick] = 1.0
            # mutation: swap one selected column for an unselected one
            if rng.random() < 0.3 and child.sum() > 0 and \
                    (child == 0).sum() > 0:
                off = rng.choice(np.flatnonzero(child > 0))
                on_ = rng.choice(np.flatnonzero(child == 0))
                child[off], child[on_] = 0.0, 1.0
            children.append(child)
        pop = np.concatenate([survivors, np.stack(children)], axis=0)
        log.info("voted wrapper gen %d/%d: best val err %.6f", gen + 1,
                 generations, best[-1])

    # final vote among the fittest half (VarSelMaster vote count)
    errs = fitness(pop)
    order = np.argsort(errs)
    votes = pop[order[:max(pop_size // 2, 2)]].sum(axis=0)
    top = np.argsort(-votes)[:expect]
    report["generations"] = best
    report["final_errors"] = errs.tolist()
    keep = {srcs[i] for i in top}
    for cc in candidates:
        cc.finalSelect = cc.columnName in keep


def _filter_by_feature_importance(ctx: ProcessorContext,
                                  candidates: List[ColumnConfig], seed: int,
                                  dev: torch.device,
                                  report: Dict[str, Any]) -> None:
    """filterBy=FI — rank by gain-weighted tree feature importance
    (VarSelectModelProcessor.selectByFeatureImportance:422-429; GBT/RF
    only). With -Dshifu.varsel.reuse.model=true, existing trained
    models are ranked as they are; otherwise a fresh all-candidate tree
    model is trained INTO the model set first, as the reference's FI
    path overwrites the model set's models."""
    from shifu_tpu_torch.models.spec import list_models, load_model
    mc = ctx.model_config
    vs = mc.varSelect
    if not mc.train.algorithm.is_tree:
        raise ValueError("filterBy=FI only works with GBT/RF "
                         "(train#algorithm)")
    if vs.filterNum <= 0:
        raise ValueError("filterBy=FI needs a positive varSelect#filterNum")
    reuse = os.environ.get("shifu.varsel.reuse.model", "").lower() == "true"
    models = list_models(ctx.path_finder.models_path())
    if not (reuse and models):
        for cc in candidates:
            cc.finalSelect = True
        ctx.save_column_configs()
        from shifu_tpu_torch.processor import train_tree
        norm_report: Dict[str, Any] = {}
        norm_proc.run(ctx, device=dev, report=norm_report)
        report["rows"] = norm_report.get("rows")
        train_tree.run_tree(ctx, seed, dev)
        models = list_models(ctx.path_finder.models_path())

    _, meta, params = load_model(models[0])
    names = meta["denseNames"] + meta["indexNames"]
    feats = np.asarray(params["trees"]["feature"]).ravel()
    if "gain" in params["trees"]:
        gains = np.asarray(params["trees"]["gain"], np.float64).ravel()
    else:  # models trained before gain tracking: split counts
        gains = np.ones_like(feats, np.float64)
    fi = np.zeros(len(names))
    valid = feats >= 0
    np.add.at(fi, feats[valid].astype(int), np.maximum(gains[valid], 0.0))
    ranked = sorted(zip(names, fi), key=lambda kv: -kv[1])
    keep = {n for n, _ in ranked[:vs.filterNum]}
    for cc in candidates:
        cc.finalSelect = cc.columnName in keep
