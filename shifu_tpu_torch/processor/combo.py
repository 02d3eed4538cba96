"""`combo` — assembled multi-algorithm (stacked) models, the port of
`shifu_tpu/processor/combo.py` (`ComboModelProcessor.java`).

The user names a chain of algorithms (`combo -new NN,GBT,LR`): all but
the last become sub-models, each trained as its own model set in a
subdirectory, and the LAST is the assemble model, trained on the
sub-models' scores. Every sub-model scores the same in-memory table, so
the reference's join of score files by uid is row order here.

  new  → write ComboTrain.json                    (:133 createNewCombo)
  init → scaffold the sub-model workspaces         (:150 initComboModels)
  run  → train the subs as sibling DAG nodes, each
         `python -m shifu_tpu_torch.processor.combo <sub> --device D`
         (init → stats → norm → train in a process of its own), then
         the sink: score the training table with every sub-model
         (`ModelRunner.score_frame`: K1 for an NN over ZSCALE, K2 for
         trees) and train the assemble model on the (R, n_subs) score
         matrix                                    (:278 runComboModels)
  eval → the eval sets through the subs and the assemble model
                                                   (:363 evalComboModels)

`-resume` parks sub-models that already have models as ``cached``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from shifu_tpu_torch.config.model_config import Algorithm, ModelConfig
from shifu_tpu_torch.fileio import atomic_write
from shifu_tpu_torch.processor.base import ProcessorContext

log = logging.getLogger("shifu_tpu_torch")

COMBO_FILE = "ComboTrain.json"


def _combo_path(ctx: ProcessorContext) -> str:
    return os.path.join(ctx.path_finder.root, COMBO_FILE)


def _load_combo(ctx: ProcessorContext) -> Dict:
    p = _combo_path(ctx)
    if not os.path.exists(p):
        raise FileNotFoundError(
            f"{COMBO_FILE} not found under {ctx.path_finder.root}; run "
            "`combo -new ALG1,ALG2,...` first")
    with open(p) as f:
        return json.load(f)


def _sub_dir(ctx: ProcessorContext, name: str) -> str:
    return os.path.join(ctx.path_finder.root, name)


def new(ctx: ProcessorContext, algorithms: str) -> int:
    """`combo -new NN,GBT,LR`: all but the last algorithm are
    sub-models, the last is the assemble model
    (ComboModelProcessor.validate:483-516 requires three or more)."""
    try:
        algs = [Algorithm.parse(a.strip()) for a in algorithms.split(",")
                if a.strip()]
    except ValueError as e:
        raise ValueError(f"unknown algorithm in {algorithms!r}: {e}")
    if len(algs) < 3:
        raise ValueError("combo needs at least 3 algorithms: "
                         "N-1 sub-models + 1 assemble model")
    name = ctx.model_config.model_set_name
    spec = {
        "uidColumnName": "",
        "subModels": [{"name": f"{name}_{a.value}_{i}",
                       "algorithm": a.value}
                      for i, a in enumerate(algs[:-1])],
        "assemble": {"name": f"{name}_assemble_{algs[-1].value}",
                     "algorithm": algs[-1].value},
    }
    with atomic_write(_combo_path(ctx), "w") as f:
        json.dump(spec, f, indent=2)
    log.info("combo: %d sub-models + %s assemble → %s",
             len(spec["subModels"]), algs[-1].value, _combo_path(ctx))
    return 0


def init(ctx: ProcessorContext) -> int:
    """One model-set directory a sub-model, inheriting the parent's
    dataSet/stats/varSelect with the algorithm overridden and every
    parent-relative path made absolute."""
    combo = _load_combo(ctx)
    mc = ctx.model_config
    mc_dict = mc.to_dict()

    def absolutize(d: Dict, keys: List[str]) -> None:
        # the sub-model workspace is a SUBDIRECTORY of the parent
        for k in keys:
            if d.get(k):
                d[k] = os.path.abspath(mc.resolve_path(str(d[k])))

    for block, keys in (("dataSet", ["dataPath", "headerPath",
                                     "validationDataPath",
                                     "metaColumnNameFile",
                                     "categoricalColumnNameFile",
                                     "segExpressionFile"]),
                        ("varSelect", ["forceSelectColumnNameFile",
                                       "forceRemoveColumnNameFile",
                                       "candidateColumnNameFile"])):
        if block in mc_dict:
            absolutize(mc_dict[block], keys)
    for ev in mc_dict.get("evals", []):
        absolutize(ev.get("dataSet", {}),
                   ["dataPath", "headerPath", "metaColumnNameFile",
                    "categoricalColumnNameFile"])

    for sub in combo["subModels"]:
        sub_dir = _sub_dir(ctx, sub["name"])
        os.makedirs(sub_dir, exist_ok=True)
        sub_mc = json.loads(json.dumps(mc_dict))  # deep copy
        sub_mc["basic"]["name"] = sub["name"]
        sub_mc["train"]["algorithm"] = sub["algorithm"]
        with atomic_write(os.path.join(sub_dir, "ModelConfig.json"),
                          "w") as f:
            json.dump(sub_mc, f, indent=2)
        log.info("combo init: %s (%s)", sub_dir, sub["algorithm"])
    return 0


def _sub_trained(sub_dir: str) -> bool:
    models = os.path.join(sub_dir, "models")
    return os.path.isdir(models) and any(
        f.startswith("model") for f in os.listdir(models))


def _train_sub(sub_dir: str, device: str) -> None:
    """init → stats → norm → train of one sub-model through the port's
    CLI, each step printing its JSON line."""
    from shifu_tpu_torch import cli
    for verb in ("init", "stats", "norm", "train"):
        argv = ["--dir", sub_dir, verb]
        if verb != "init":
            argv += ["--device", device]
        if cli.main(argv) != 0:
            raise RuntimeError(
                f"combo sub-model step {verb} failed in {sub_dir}")


def _train_sub_node(root: str, sub_dir: str, name: str, device: str,
                    lease_env: Optional[Dict[str, str]] = None) -> None:
    """One sub-model's init → stats → norm → train as a subprocess
    (this module's ``__main__``), so siblings scheduled at once keep
    their process-wide state as isolated as a serial loop kept it. The
    log lands in ``tmp/dag_logs/<node>.log``."""
    import sys

    from shifu_tpu_torch.pipeline.nodes import run_logged
    run_logged([sys.executable, "-m", "shifu_tpu_torch.processor.combo",
                sub_dir, "--device", device], root, name, lease_env)


def _sub_scores(ctx: ProcessorContext, combo: Dict, table,
                device: torch.device) -> np.ndarray:
    """(R, n_subs) ensemble-mean score of every sub-model over a raw
    `Table` on `device`: the reference's DataMerger join is column
    stacking here."""
    from shifu_tpu_torch.eval.model_runner import ModelRunner
    cols = []
    for sub in combo["subModels"]:
        runner = ModelRunner.from_model_set(_sub_dir(ctx, sub["name"]),
                                            device=device)
        cols.append(runner.score_frame(table)["final"])
    return np.stack(cols, axis=1).astype(np.float32)


def _weights(table, wname: str) -> np.ndarray:
    """The weight column's values, 1.0 where a token does not parse (or
    all ones without a weight column)."""
    from shifu_tpu_torch.data.reader import to_numeric
    if wname and wname in table:
        w = to_numeric(table[wname])
        return np.where(np.isnan(w), 1.0, w).astype(np.float32)
    return np.ones(len(table), np.float32)


def _load_training_table(mc: ModelConfig):
    from shifu_tpu_torch.data.dataset import parse_tags, valid_tag_mask
    from shifu_tpu_torch.data.purifier import DataPurifier
    from shifu_tpu_torch.data.reader import (read_raw_table,
                                             simple_column_name,
                                             string_column)
    table = read_raw_table(mc)
    table = table.select(DataPurifier(mc.dataSet.filterExpressions)
                         .apply(table))
    table = table.select(valid_tag_mask(mc, table))
    tgt = simple_column_name(mc.dataSet.targetColumnName.split("|")[0])
    tags = parse_tags(string_column(table[tgt]), mc.pos_tags, mc.neg_tags)
    return table, tags.astype(np.float32), \
        _weights(table, mc.dataSet.weightColumnName)


def run(ctx: ProcessorContext, resume: bool = False,
        device: "str | torch.device" = "cuda",
        report: Optional[Dict] = None) -> int:
    """Train every sub-model as a sibling node of the pipeline DAG,
    then, as the sink, score the training table with each and train
    the assemble model on the (R, n_subs) score matrix. `report`, when
    given, receives the DAG's report (``dag``)."""
    from shifu_tpu_torch import resolve_device
    from shifu_tpu_torch.pipeline.scheduler import Node, run_dag
    dev = resolve_device(device)
    t0 = time.time()
    mc = ctx.model_config
    combo = _load_combo(ctx)
    root = ctx.path_finder.root

    nodes = []
    sub_names = []
    for sub in combo["subModels"]:
        sub_dir = _sub_dir(ctx, sub["name"])
        if not os.path.exists(os.path.join(sub_dir, "ModelConfig.json")):
            raise FileNotFoundError(f"{sub_dir} not scaffolded; run "
                                    "`combo -init` first")
        name = f"combo.{sub['name']}"
        sub_names.append(name)
        nodes.append(Node(
            name=name,
            fn=(lambda d=sub_dir, n=name, lease_env=None: _train_sub_node(
                root, d, n, str(dev), lease_env)),
            deps=(), device=True,
            done_check=(lambda d=sub_dir: _sub_trained(d)) if resume
            else None))

    def assemble() -> None:
        table, tags, weights = _load_training_table(mc)
        scores = _sub_scores(ctx, combo, table, dev)
        asm = combo["assemble"]
        alg = Algorithm.parse(asm["algorithm"])
        asm_dir = _sub_dir(ctx, asm["name"])
        os.makedirs(os.path.join(asm_dir, "models"), exist_ok=True)
        if alg.is_tree:
            # a tree assemble (`combo -new NN,LR,GBT`) boosts or bags
            # over the score matrix with its own tree trainer
            val_err = _train_assemble_tree(ctx, asm_dir, alg, scores,
                                           tags, weights, combo, dev)
        else:
            val_err = _train_assemble_dense(ctx, asm_dir, alg, scores,
                                            tags, weights, combo, asm, dev)
        log.info("combo run: %d subs + assemble (%s) in %.2fs; assemble "
                 "val err %.6f", len(combo["subModels"]),
                 asm["algorithm"], time.time() - t0, val_err)

    nodes.append(Node(name="combo.assemble", fn=assemble,
                      deps=tuple(sub_names), device=True))
    dag = run_dag(nodes, root=root, label="combo")
    if report is not None:
        report["dag"] = dag
    return 0


def _train_assemble_dense(ctx: ProcessorContext, asm_dir: str, alg,
                          scores: np.ndarray, tags: np.ndarray,
                          weights: np.ndarray, combo: Dict, asm: Dict,
                          device: torch.device) -> float:
    """The assemble model as a dense gradient model over the
    sub-models' scores (seed 4001)."""
    from shifu_tpu_torch.models import nn as nn_mod
    from shifu_tpu_torch.models.spec import save_model
    from shifu_tpu_torch.train.trainer import train_nn
    conf = ctx.model_config.train
    if alg in (Algorithm.LR, Algorithm.SVM):
        from shifu_tpu_torch.processor.train import _lr_spec
        spec = _lr_spec(conf.params, scores.shape[1])
    else:
        spec = nn_mod.MLPSpec.from_train_params(conf.params, scores.shape[1])
    res = train_nn(conf, scores, tags, weights, seed=4001, spec=spec,
                   device=device)
    kind = "lr" if alg in (Algorithm.LR, Algorithm.SVM) else "nn"
    meta = {
        "spec": {
            "input_dim": res.spec.input_dim,
            "hidden_dims": list(res.spec.hidden_dims),
            "activations": list(res.spec.activations),
            "output_dim": 1, "output_activation": "sigmoid",
            "dropout_rate": 0.0, "l2": res.spec.l2, "l1": res.spec.l1,
            "loss": res.spec.loss, "weight_init": res.spec.weight_init,
        },
        "inputNames": [s["name"] for s in combo["subModels"]],
        "normType": "SCORE", "modelSetName": asm["name"],
    }
    save_model(os.path.join(asm_dir, "models", f"model0.{kind}"), kind,
               meta, res.params_per_bag[0])
    return float(res.best_val.min())


def _train_assemble_tree(ctx: ProcessorContext, asm_dir: str, alg,
                         scores: np.ndarray, tags: np.ndarray,
                         weights: np.ndarray, combo: Dict,
                         device: torch.device) -> float:
    """The assemble model as GBT/RF over the (R, n_subs) score matrix:
    scores lie in [0, 1], so 32 equal-interval slots bin them."""
    import dataclasses

    from shifu_tpu_torch.models import gbdt
    from shifu_tpu_torch.models.spec import save_model
    from shifu_tpu_torch.processor.train_tree import tree_config_from_params
    from shifu_tpu_torch.train.trainer import split_validation
    mc = ctx.model_config
    n_sub = scores.shape[1]
    n_cut_slots = 32
    cuts = np.tile(np.linspace(0.0, 1.0, n_cut_slots + 1)[1:-1, None],
                   (1, n_sub)).astype(np.float32)
    n_bins = cuts.shape[0] + 2  # cut slots + 1 value slot + missing
    cfg = dataclasses.replace(tree_config_from_params(mc), n_bins=n_bins)
    tables = gbdt.make_bin_tables(cuts, [], n_bins)
    bins = gbdt.bin_dataset(tables, scores, None, n_bins, device=device)

    # the standalone tree trainer's TreeNum/subset defaults
    n_trees = int(mc.train.get_param(
        "TreeNum", 10 if alg is Algorithm.RF else 100) or 10)
    if alg is Algorithm.DT:
        n_trees = 1
    subset = str(mc.train.get_param("FeatureSubsetStrategy", "ALL") or "ALL")
    tr_mask, val_mask = split_validation(len(tags), mc.train.validSetRate,
                                         4001)
    val_err = float("nan")
    if alg is Algorithm.GBT:
        trees, val_errs = gbdt.build_gbt(
            cfg, bins[tr_mask], tags[tr_mask], weights[tr_mask], n_trees,
            val_data=((bins[val_mask], tags[val_mask])
                      if val_mask.any() else None), device=device)
        kind = "gbt"
        if val_errs:
            val_err = val_errs[-1]
    else:
        trees = gbdt.build_rf(cfg, bins[tr_mask], tags[tr_mask],
                              weights[tr_mask], n_trees, subset,
                              mc.train.baggingSampleRate, 4001,
                              device=device)
        kind = "rf"
    meta = {
        "kind": kind,
        "treeConfig": {"max_depth": cfg.max_depth, "n_bins": cfg.n_bins,
                       "learning_rate": cfg.learning_rate, "loss": cfg.loss},
        "denseNames": [s["name"] for s in combo["subModels"]],
        "indexNames": [], "modelSetName": mc.model_set_name,
        "nTrees": n_trees, "normType": "SCORE",
    }
    save_model(os.path.join(asm_dir, "models", f"model0.{kind}"), kind,
               meta, {"trees": trees, "tables": tables})
    return val_err


def _assemble_scorer(ctx: ProcessorContext, asm: Dict, dev: torch.device):
    """A function of the (R, n_subs) score matrix → (R,) assemble
    scores on the host: plain PyTorch for a dense assemble, the port's
    `gbdt.predict` (K2 on the card) for a tree."""
    from shifu_tpu_torch.models.spec import load_model
    alg = Algorithm.parse(asm["algorithm"])
    ext = {"LR": "lr", "SVM": "lr", "GBT": "gbt", "RF": "rf",
           "DT": "rf"}.get(alg.value, "nn")
    kind, meta, params = load_model(
        os.path.join(_sub_dir(ctx, asm["name"]), "models", f"model0.{ext}"))
    if alg.is_tree:
        from shifu_tpu_torch import weights as weights_mod
        from shifu_tpu_torch.models import gbdt
        ens = weights_mod.to_torch(kind, meta, params, dev)
        return lambda s: gbdt.predict(meta, ens, s, None).cpu().numpy()
    from shifu_tpu_torch.models import nn as nn_mod
    spec = nn_mod.MLPSpec.from_meta(meta["spec"])
    tparams = [{k: torch.as_tensor(v, device=dev) for k, v in layer.items()}
               for layer in params]

    def score(s: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            return nn_mod.forward(spec, tparams, torch.as_tensor(
                s, device=dev)).cpu().numpy()
    return score


def eval_table(mc: ModelConfig, ec):
    """Eval set `ec`'s raw `Table`, filtered and with its known tags,
    with those tags and the weights."""
    import copy

    from shifu_tpu_torch.data.dataset import parse_tags
    from shifu_tpu_torch.data.purifier import DataPurifier
    from shifu_tpu_torch.data.reader import (read_raw_table,
                                             simple_column_name,
                                             string_column)
    from shifu_tpu_torch.processor.eval import effective_dataset_conf
    ds = effective_dataset_conf(mc, ec)
    eval_mc = copy.copy(mc)
    eval_mc.dataSet = ds
    table = read_raw_table(eval_mc, ds=ds)
    table = table.select(DataPurifier(ds.filterExpressions).apply(table))
    tgt = simple_column_name(ds.targetColumnName.split("|")[0])
    tags = parse_tags(string_column(table[tgt]),
                      [str(t) for t in ds.posTags],
                      [str(t) for t in ds.negTags])
    ok = ~np.isnan(tags)
    table, tags = table.select(ok), tags[ok]
    return table, tags, _weights(table, ds.weightColumnName)


def assemble_scores(ctx: ProcessorContext, table,
                    device: "str | torch.device" = "cuda") -> np.ndarray:
    """The assembled model's (R,) scores of a raw `Table` on `device`:
    every sub-model's score, then the assemble model over them."""
    from shifu_tpu_torch import resolve_device
    dev = resolve_device(device)
    combo = _load_combo(ctx)
    return _assemble_scorer(ctx, combo["assemble"], dev)(
        _sub_scores(ctx, combo, table, dev))


def evaluate(ctx: ProcessorContext, eval_name: Optional[str] = None,
             device: "str | torch.device" = "cuda",
             report: Optional[Dict] = None) -> int:
    """The eval sets through the sub-models, then the assemble model,
    on `device`; writes EvalPerformance.json an eval set under
    ``evals/<name>_combo/``. `report`, when given, receives the rows
    scored (``rows``) and each set's AUC (``auc``)."""
    from shifu_tpu_torch import resolve_device
    from shifu_tpu_torch.ops.metrics import performance_result
    dev = resolve_device(device)
    mc = ctx.model_config
    combo = _load_combo(ctx)
    score_asm = _assemble_scorer(ctx, combo["assemble"], dev)
    rows, aucs = 0, {}
    for ec in mc.evals:
        if eval_name is not None and ec.name != eval_name:
            continue
        table, tags, weights = eval_table(mc, ec)
        final = score_asm(_sub_scores(ctx, combo, table, dev))
        perf = performance_result(final, tags, weights,
                                  n_buckets=ec.performanceBucketNum,
                                  score_scale=float(ec.scoreScale),
                                  device=dev)
        out_dir = os.path.join(ctx.path_finder.root, "evals",
                               f"{ec.name}_combo")
        os.makedirs(out_dir, exist_ok=True)
        with atomic_write(os.path.join(out_dir, "EvalPerformance.json"),
                          "w") as f:
            json.dump(perf, f, indent=1)
        rows += len(final)
        aucs[ec.name] = perf["areaUnderRoc"]
        log.info("combo eval[%s]: %d rows, AUC=%.4f", ec.name, len(final),
                 perf["areaUnderRoc"])
    if report is not None:
        report.update(rows=rows, auc=aucs)
    return 0


if __name__ == "__main__":
    # the DAG's sub-model node (`_train_sub_node`): one sub-model's
    # init → stats → norm → train in a process of its own
    import argparse
    ap = argparse.ArgumentParser(prog="shifu_tpu_torch.processor.combo")
    ap.add_argument("sub_dir")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    _train_sub(args.sub_dir, args.device)
