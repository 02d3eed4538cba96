"""ModelInspector — per-step semantic validation of ModelConfig.

The port's copy of `shifu_tpu/config/inspector.py` (`probe`,
`ModelStep`; `core/validator/ModelInspector.java:56-92`): a
ValidateResult with human-readable failure causes, and warnings for
typo-like unknown keys. Scheme'd remote paths are not checked here;
reading them raises later (remote filesystems are ROADMAP A8.4).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from enum import Enum
from typing import List

from shifu_tpu_torch.config.model_config import (Algorithm, ModelConfig,
                                                 SourceType)


class ModelStep(Enum):
    """`ModelInspector.java:60-62`."""
    INIT = "INIT"
    STATS = "STATS"
    VARSELECT = "VARSELECT"
    NORMALIZE = "NORMALIZE"
    TRAIN = "TRAIN"
    POSTTRAIN = "POSTTRAIN"
    EVAL = "EVAL"
    EXPORT = "EXPORT"
    COMBO = "COMBO"
    ENCODE = "ENCODE"
    TEST = "TEST"


@dataclass
class ValidateResult:
    status: bool = True
    causes: List[str] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)

    def fail(self, cause: str) -> None:
        self.status = False
        self.causes.append(cause)


_PROPAGATIONS = ("B", "BACKPROP", "SGD", "Q", "QUICK", "QUICKPROP", "R",
                 "RESILIENT", "RPROP", "M", "MOMENTUM", "N", "NESTEROV",
                 "ADAM", "ADAGRAD", "RMSPROP")
_LOSSES = ("squared", "log", "absolute")
_SUBSET_STRATEGIES = ("ALL", "AUTO", "HALF", "ONETHIRD", "TWOTHIRDS",
                      "SQRT", "LOG2")
_SCORE_SELECTORS = ("mean", "max", "min", "median")
_GBT_CONVERT = ("RAW", "SIGMOID", "CUTOFF", "MAXMIN_SCALE")


def probe(mc: ModelConfig, step: ModelStep) -> ValidateResult:
    """Validate the config for a pipeline step
    (`ModelInspector.probe`, `ModelInspector.java:92+`)."""
    from shifu_tpu_torch.config import meta as meta_mod
    r = ValidateResult()
    for cause in meta_mod.validate_fields(mc):
        r.fail(cause)
    r.warnings.extend(meta_mod.unknown_key_warnings(mc))
    _check_basic(mc, r)
    if step in (ModelStep.INIT, ModelStep.STATS, ModelStep.NORMALIZE,
                ModelStep.TRAIN, ModelStep.POSTTRAIN):
        _check_dataset(mc, r, require_data=step in (ModelStep.INIT,
                                                    ModelStep.STATS))
    if step is ModelStep.STATS:
        _check_stats(mc, r)
    if step is ModelStep.VARSELECT:
        _check_varselect(mc, r)
    if step is ModelStep.NORMALIZE:
        _check_normalize(mc, r)
    if step is ModelStep.TRAIN:
        _check_train(mc, r)
    if step is ModelStep.EVAL:
        _check_evals(mc, r)
    return r


def _check_basic(mc: ModelConfig, r: ValidateResult) -> None:
    if not mc.basic.name:
        r.fail("basic#name is empty")


def _file_should_exist(mc: ModelConfig, p: str, label: str,
                       r: ValidateResult) -> None:
    if not p:
        return
    from shifu_tpu_torch.fileio import has_scheme
    if has_scheme(p):
        return  # remote: reading it raises (ROADMAP A8.4)
    rp = mc.resolve_path(p)
    if not os.path.exists(rp):
        r.fail(f"{label} points to {p!r}, which does not exist "
               f"(resolved {rp})")


def _check_dataset(mc: ModelConfig, r: ValidateResult,
                   require_data: bool) -> None:
    ds = mc.dataSet
    if not ds.dataPath:
        r.fail("dataSet#dataPath is empty")
    elif require_data and ds.source is SourceType.LOCAL:
        _file_should_exist(mc, ds.dataPath, "dataSet#dataPath", r)
    if not ds.targetColumnName:
        r.fail("dataSet#targetColumnName is empty")
    if ds.weightColumnName and \
            ds.weightColumnName == ds.targetColumnName:
        r.fail(f"dataSet#weightColumnName and targetColumnName are both "
               f"{ds.targetColumnName!r} — the weight column cannot be "
               "the target")
    _file_should_exist(mc, ds.metaColumnNameFile,
                       "dataSet#metaColumnNameFile", r)
    _file_should_exist(mc, ds.categoricalColumnNameFile,
                       "dataSet#categoricalColumnNameFile", r)
    if ds.validationDataPath and ds.source is SourceType.LOCAL:
        _file_should_exist(mc, ds.validationDataPath,
                           "dataSet#validationDataPath", r)
    if mc.is_regression:
        overlap = set(mc.pos_tags) & set(mc.neg_tags)
        if overlap:
            r.fail(f"posTags and negTags overlap: {sorted(overlap)}")
    elif not mc.is_multi_classification:
        # one side empty and ≤2 total tags: neither binary (both sides
        # non-empty) nor multi-class (>2 flattened tags)
        r.fail(f"dataSet#posTags {mc.pos_tags} / negTags {mc.neg_tags} "
               "define neither binary modeling (both non-empty) nor "
               "multi-class (>2 total tags)")


def _check_stats(mc: ModelConfig, r: ValidateResult) -> None:
    if mc.stats.maxNumBin <= 1:
        r.fail(f"stats#maxNumBin must be > 1, got {mc.stats.maxNumBin}")


def _check_varselect(mc: ModelConfig, r: ValidateResult) -> None:
    vs = mc.varSelect
    if vs.filterEnable and vs.filterNum <= 0 and \
            vs.filterBy.upper() not in ("FI",):
        r.fail(f"varSelect#filterNum must be positive, got {vs.filterNum}")
    if vs.filterBy.upper() not in ("KS", "IV", "MIX", "PARETO", "SE",
                                   "ST", "SC", "V", "FI"):
        r.fail(f"varSelect#filterBy unknown: {vs.filterBy}")
    _file_should_exist(mc, vs.forceSelectColumnNameFile,
                       "varSelect#forceSelectColumnNameFile", r)
    _file_should_exist(mc, vs.forceRemoveColumnNameFile,
                       "varSelect#forceRemoveColumnNameFile", r)


def _check_normalize(mc: ModelConfig, r: ValidateResult) -> None:
    # WOE families need the stats phase's binning (computed WOE per
    # bin); without ColumnConfig this is re-checked with data by the
    # norm processor — here catch the config-only impossibility
    if mc.normalize.normType.is_woe and mc.stats.maxNumBin <= 1:
        r.fail(f"normType {mc.normalize.normType.value} needs binning, "
               f"but stats#maxNumBin={mc.stats.maxNumBin}")


def _check_train(mc: ModelConfig, r: ValidateResult) -> None:
    """Train-step checks (`TrainModelProcessor.validateDistributedTrain:
    384-458` condensed to what is semantically meaningful on TPU)."""
    t = mc.train
    alg = t.algorithm
    norm = mc.normalize.normType
    if alg is Algorithm.WDL and not norm.is_index:
        # WDLWorker requires *_INDEX norm so categoricals arrive as
        # embedding indices (TrainModelProcessor.java:441-448 analog);
        # MTL consumes the dense block and takes any normType.
        r.fail(f"{alg.value} requires an *_INDEX normType for embeddings, "
               f"got {norm.value}")
    if alg in (Algorithm.NN, Algorithm.WDL, Algorithm.MTL):
        # arch lists feed MLPSpec for all three families
        # (nn.parse_arch_params; WDL/MTL reuse it with
        # honor_num_layers=False, so the count-vs-NumHiddenLayers
        # check is NN-only)
        nh = t.get_param("NumHiddenLayers")
        nodes = t.get_param("NumHiddenNodes")
        acts = t.get_param("ActivationFunc")
        if alg is Algorithm.NN and nh is not None and nodes is not None \
                and not isinstance(nodes, dict):
            n_layers = int(nh)
            if isinstance(nodes, list) and not _grid_list(nodes) and \
                    len(nodes) != n_layers:
                r.fail(f"NumHiddenNodes has {len(nodes)} entries but "
                       f"NumHiddenLayers={n_layers}")
            if isinstance(acts, list) and not _grid_list(acts) and \
                    len(acts) != n_layers:
                r.fail(f"ActivationFunc has {len(acts)} entries but "
                       f"NumHiddenLayers={n_layers}")
        if isinstance(acts, list):
            from shifu_tpu_torch.models.nn import ACTIVATIONS
            flat = [a for x in acts for a in (x if isinstance(x, list)
                                              else [x])]
            for a in flat:
                if str(a).lower() not in ACTIVATIONS:
                    r.fail(f"ActivationFunc {a!r} unknown; supported: "
                           f"{sorted(ACTIVATIONS)}")
        nodes_flat = []
        if isinstance(nodes, list):
            nodes_flat = [n for x in nodes
                          for n in (x if isinstance(x, list) else [x])]
        for n in nodes_flat:
            if not isinstance(n, (int, float)) or int(n) <= 0:
                r.fail(f"NumHiddenNodes entries must be positive ints, "
                       f"got {n!r}")
    if alg is Algorithm.WDL:
        wide = t.get_param("WideEnable")
        deep = t.get_param("DeepEnable")
        if wide is not None and deep is not None \
                and not bool(wide) and not bool(deep):
            r.fail("WDL with WideEnable=false and DeepEnable=false has "
                   "no model branches (WideAndDeep.java:78-249)")
    prop = t.get_param("Propagation")
    if prop is not None:
        props = prop if isinstance(prop, list) else [prop]
        for p in props:
            if str(p).strip().upper() not in _PROPAGATIONS:
                r.fail(f"Propagation {p!r} unknown; supported: "
                       f"{sorted(set(_PROPAGATIONS))}")
    if alg.is_tree:
        loss = t.get_param("Loss")
        if loss is not None:
            losses = loss if isinstance(loss, list) else [loss]
            for lo in losses:
                if str(lo).lower() not in _LOSSES:
                    r.fail(f"Loss {lo!r} unknown for trees; supported: "
                           f"{_LOSSES}")
        fss = t.get_param("FeatureSubsetStrategy")
        if fss is not None:
            # grid-search lists check element-wise (the round-2 gap:
            # a list-valued FSS skipped validation entirely)
            for s0 in (fss if isinstance(fss, list) else [fss]):
                s = str(s0).upper()
                if s not in _SUBSET_STRATEGIES:
                    try:
                        int(s)
                    except ValueError:
                        r.fail(f"FeatureSubsetStrategy {s0!r} unknown; "
                               f"supported: {_SUBSET_STRATEGIES} or an int")
    fixed = t.get_param("FixedLayers")
    if fixed is not None:
        # 1-based hidden-layer indices, like the reference (layer 1 =
        # input→hidden1 weights; input/output layers cannot be fixed —
        # NNMaster.getFixedWights:605-624)
        n_hidden = t.get_param("NumHiddenLayers")
        if not isinstance(n_hidden, int):
            # optional param: depth falls back to len(NumHiddenNodes)
            # (models/nn.parse_arch_params does the same); a grid-form
            # list-of-lists has no single depth — skip the bound (grid
            # + isContinuous is rejected below anyway)
            nodes = t.get_param("NumHiddenNodes")
            n_hidden = len(nodes) if isinstance(nodes, list) \
                and not _grid_list(nodes) else None
        if not isinstance(fixed, list) or \
                any(not isinstance(i, int) or i < 1 for i in fixed):
            r.fail(f"FixedLayers must be a list of 1-based hidden layer "
                   f"indices, got {fixed!r}")
        elif isinstance(n_hidden, int) and any(i > n_hidden
                                               for i in fixed):
            r.fail(f"FixedLayers {fixed!r} exceeds NumHiddenLayers="
                   f"{n_hidden} (only hidden layers can be fixed)")
        elif not t.isContinuous:
            r.fail("FixedLayers only applies to continuous training "
                   "(train#isContinuous=true)")
    if t.gridConfigFile:
        _file_should_exist(mc, t.gridConfigFile, "train#gridConfigFile", r)
    if t.numKFold is not None and t.numKFold > 1:
        if t.isContinuous:
            r.fail("k-fold cross validation cannot be combined with "
                   "isContinuous")
        if t.trainOnDisk and not mc.is_multi_classification:
            # multi-class ignores trainOnDisk (resident route) and
            # honors k-fold — mirror the runtime guard exactly
            r.fail("train#numKFold is not supported with trainOnDisk "
                   "(the streaming layout has one fixed validation "
                   "region) — run k-fold resident or use validSetRate")
        if t.numKFold > 20:
            r.fail(f"train#numKFold must be <= 20, got {t.numKFold}")
    from shifu_tpu_torch.train.grid_search import expand
    try:
        combos = expand(t.params)
    except Exception:
        combos = [t.params]
    if len(combos) > 1 and t.isContinuous:
        r.fail("grid search (list-valued train#params) cannot be combined "
               "with isContinuous")


def _check_evals(mc: ModelConfig, r: ValidateResult) -> None:
    if not mc.evals:
        r.fail("no eval sets configured under 'evals'")
    names = [e.name for e in mc.evals]
    dup = {n for n in names if names.count(n) > 1}
    if dup:
        r.fail(f"duplicate eval set names: {sorted(dup)}")
    for e in mc.evals:
        if not e.dataSet.dataPath:
            r.fail(f"eval {e.name}: dataSet#dataPath is empty")
        elif e.dataSet.source is SourceType.LOCAL:
            _file_should_exist(mc, e.dataSet.dataPath,
                               f"eval {e.name}: dataSet#dataPath", r)
        if not e.dataSet.targetColumnName and \
                not mc.dataSet.targetColumnName:
            # eval sets inherit the model target when unset
            # (EvalConfig falls back to ModelConfig's dataSet —
            # processor/eval.effective_dataset_conf; the reference's
            # bundled model sets leave this empty)
            r.fail(f"eval {e.name}: dataSet#targetColumnName is empty "
                   "and the model-level dataSet#targetColumnName (the "
                   "inherited fallback) is empty too")
        if e.performanceBucketNum < 2:
            r.fail(f"eval {e.name}: performanceBucketNum must be >= 2, "
                   f"got {e.performanceBucketNum}")
        sel = (e.performanceScoreSelector or "mean").lower()
        if sel not in _SCORE_SELECTORS and not sel.startswith("model"):
            r.fail(f"eval {e.name}: performanceScoreSelector {sel!r} "
                   f"unknown; supported: {_SCORE_SELECTORS} or modelN")
        if (e.gbtScoreConvertStrategy or "RAW").upper() not in _GBT_CONVERT:
            r.fail(f"eval {e.name}: gbtScoreConvertStrategy "
                   f"{e.gbtScoreConvertStrategy!r} unknown; supported: "
                   f"{_GBT_CONVERT}")
        _file_should_exist(mc, e.scoreMetaColumnNameFile,
                           f"eval {e.name}: scoreMetaColumnNameFile", r)
        overlap = set(e.dataSet.posTags) & set(e.dataSet.negTags)
        if overlap:
            r.fail(f"eval {e.name}: posTags and negTags overlap: "
                   f"{sorted(overlap)}")


def _grid_list(v) -> bool:
    """Grid-search configs put a list *of lists* in a scalar-list slot
    (`gs/GridSearch.java:44-65`)."""
    return isinstance(v, list) and any(isinstance(x, list) for x in v)
