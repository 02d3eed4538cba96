"""PMML 4.2 export + a conformance mini-evaluator — the port's copy of
`shifu_tpu/pmml.py` (`core/pmml/PMMLTranslator.java`,
`PMMLEncogNeuralNetworkModel`, `TreeEnsemblePMMLTranslator`,
`builder/creator/*`; entry `core/processor/ExportModelProcessor.java:
87-103`). The writers are the JAX package's line for line, so both
packages emit the same document for the same model files; trained
model specs become standard PMML documents whose LocalTransformations
encode the zscore / woe / woe_zscale normalization, so any PMML
consumer scores raw records exactly like the pipeline.

Model mapping:
  nn        → NeuralNetwork (logistic/tanh/rectifier layers)
  lr        → RegressionModel (normalizationMethod="logit")
  gbt / rf  → MiningModel with per-tree TreeModel segments (sum /
              average, `TreeEnsemblePMMLTranslator`), predicates on raw
              feature values reconstructed from the bin tables.

`evaluate_pmml` is a numpy scorer over the subset of PMML this module
emits, vectorized over the records (the jpmml-based conformance tests'
analog, `PMMLTranslatorTest.java`). It reads the port's `Table` (or a
mapping of column name → string values) instead of a pandas frame,
runs each NeuralLayer as one float64 product where the JAX package
adds one connection at a time, and routes the rows through a TreeModel
a node at a time where the JAX package walks one row at a time.
"""

from __future__ import annotations

import copy
import xml.etree.ElementTree as ET
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from shifu_tpu_torch.config.column_config import ColumnConfig
from shifu_tpu_torch.config.model_config import ModelConfig, NormType

PMML_XMLNS = "http://www.dmg.org/PMML-4_2"
STD_EPS = 1e-6

# activation name → PMML activationFunction
_PMML_ACT = {"sigmoid": "logistic", "tanh": "tanh", "relu": "rectifier",
             "linear": "identity", "identity": "identity", "sin": "sine",
             "gaussian": "Gauss", "ptanh": "tanh"}


def _el(parent, tag, **attrs):
    e = ET.SubElement(parent, tag)
    for k, v in attrs.items():
        e.set(k, str(v))
    return e


def _fmt(x: float) -> str:
    return repr(float(x))


# ---------------------------------------------------------------------------
# LocalTransformations — normalization as DerivedFields
# ---------------------------------------------------------------------------

def _zscore_linear_norms(parent, mean: float, std: float, cutoff: float):
    std = std if abs(std) > STD_EPS else 1.0
    _el(parent, "LinearNorm", orig=_fmt(mean - cutoff * std), norm=_fmt(-cutoff))
    _el(parent, "LinearNorm", orig=_fmt(mean + cutoff * std), norm=_fmt(cutoff))


def _numeric_woe_values(cc: ColumnConfig, weighted: bool) -> np.ndarray:
    bn = cc.columnBinning
    woe = bn.binWeightedWoe if weighted and bn.binWeightedWoe is not None \
        else bn.binCountWoe
    return np.asarray(woe or [0.0], np.float64)


def _woe_mean_std_of(cc: ColumnConfig, weighted: bool) -> Tuple[float, float]:
    from shifu_tpu_torch.ops.normalize import _woe_mean_std
    bn = cc.columnBinning
    woe = _numeric_woe_values(cc, weighted)
    pos = np.asarray(bn.binCountPos or np.zeros(len(woe)), np.float64)
    neg = np.asarray(bn.binCountNeg or np.zeros(len(woe)), np.float64)
    return _woe_mean_std(woe, pos, neg)


def _numeric_woe_discretize(parent, cc: ColumnConfig, out_name: str,
                            weighted: bool):
    """DerivedField: raw numeric → bin woe (Discretize, left-closed
    bins `binBoundary[i] <= v < binBoundary[i+1]`)."""
    woe = _numeric_woe_values(cc, weighted)
    bb = [x for x in (cc.columnBinning.binBoundary or [float("-inf")])]
    missing_woe = woe[-1] if len(woe) > len(bb) else 0.0
    df = _el(parent, "DerivedField", name=out_name, optype="continuous",
             dataType="double")
    disc = _el(df, "Discretize", field=cc.columnName,
               mapMissingTo=_fmt(missing_woe), defaultValue=_fmt(missing_woe))
    for i in range(len(bb)):
        b = _el(disc, "DiscretizeBin", binValue=_fmt(woe[i] if i < len(woe)
                                                     else 0.0))
        iv = _el(b, "Interval", closure="closedOpen")
        if np.isfinite(bb[i]):
            iv.set("leftMargin", _fmt(bb[i]))
        if i + 1 < len(bb) and np.isfinite(bb[i + 1]):
            iv.set("rightMargin", _fmt(bb[i + 1]))


def _cat_map_values(parent, cc: ColumnConfig, out_name: str,
                    values: np.ndarray, missing_value: float):
    """DerivedField: raw category string → per-category value
    (MapValues + InlineTable; unseen/missing → missing slot value)."""
    df = _el(parent, "DerivedField", name=out_name, optype="continuous",
             dataType="double")
    mv = _el(df, "MapValues", outputColumn="out",
             mapMissingTo=_fmt(missing_value),
             defaultValue=_fmt(missing_value))
    _el(mv, "FieldColumnPair", field=cc.columnName, column="in")
    tbl = _el(mv, "InlineTable")
    for cat, val in zip(cc.columnBinning.binCategory or [], values):
        row = _el(tbl, "row")
        _el(row, "in").text = str(cat)
        _el(row, "out").text = _fmt(val)


def _zscore_of(parent, src_field: str, out_name: str, mean: float,
               std: float, cutoff: float, map_missing_zero: bool = False):
    df = _el(parent, "DerivedField", name=out_name, optype="continuous",
             dataType="double")
    nc = _el(df, "NormContinuous", field=src_field,
             outliers="asExtremeValues")
    if map_missing_zero:
        nc.set("mapMissingTo", "0.0")
    _zscore_linear_norms(nc, mean, std, cutoff)


def build_local_transformations(parent, mc: ModelConfig,
                                ccs_by_name: Dict[str, ColumnConfig],
                                input_names: List[str]) -> List[str]:
    """Emit one DerivedField chain per model input; returns the derived
    field names in input order. Supported families mirror the
    reference's PMML creators: ZSCALE/ZSCORE (+OLD_*), WOE, WEIGHT_WOE,
    WOE_ZSCALE/WOE_ZSCORE, WEIGHT_WOE_ZSCALE/ZSCORE."""
    nt = mc.normalize.normType
    cutoff = float(mc.normalize.stdDevCutOff or 4.0)
    lt = _el(parent, "LocalTransformations")
    derived = []
    woe_like = nt in (NormType.WOE, NormType.WEIGHT_WOE)
    woe_z = nt in (NormType.WOE_ZSCORE, NormType.WOE_ZSCALE,
                   NormType.WEIGHT_WOE_ZSCORE, NormType.WEIGHT_WOE_ZSCALE)
    zscore_like = nt in (NormType.ZSCALE, NormType.ZSCORE, NormType.OLD_ZSCALE,
                         NormType.OLD_ZSCORE)
    if not (woe_like or woe_z or zscore_like):
        raise ValueError(
            f"PMML export supports zscore/woe norm families, not {nt.value} "
            "(PMMLTranslator supports the same subset)")
    weighted = nt.value.upper().startswith("WEIGHT_")
    for name in input_names:
        cc = ccs_by_name.get(name)
        if cc is None:
            raise ValueError(f"model input {name!r} has no ColumnConfig "
                             "(onehot/index norm families are not "
                             "PMML-exportable)")
        st, bn = cc.columnStats, cc.columnBinning
        out = f"{name}_norm"
        if cc.is_categorical:
            n_cats = len(bn.binCategory or [])
            if woe_like or woe_z:
                woe = _numeric_woe_values(cc, weighted)
                missing = woe[n_cats] if len(woe) > n_cats else 0.0
                if woe_z:
                    m, s = _woe_mean_std_of(cc, weighted)
                    _cat_map_values(lt, cc, f"{name}_woe", woe[:n_cats], missing)
                    _zscore_of(lt, f"{name}_woe", out, m, s, cutoff)
                else:
                    _cat_map_values(lt, cc, out, woe[:n_cats], missing)
            else:
                pr = np.asarray(bn.binPosRate or [0.0] * (n_cats + 1),
                                np.float64)
                missing = pr[n_cats] if len(pr) > n_cats else 0.0
                if nt in (NormType.OLD_ZSCALE, NormType.OLD_ZSCORE):
                    # old behavior: posRate, not z-scored (Normalizer.java:545)
                    _cat_map_values(lt, cc, out, pr[:n_cats], missing)
                else:
                    mean = st.mean if st.mean is not None else 0.0
                    std = st.stdDev if st.stdDev is not None else 1.0
                    _cat_map_values(lt, cc, f"{name}_pr", pr[:n_cats], missing)
                    _zscore_of(lt, f"{name}_pr", out, mean, std, cutoff)
        else:
            if woe_like:
                _numeric_woe_discretize(lt, cc, out, weighted)
            elif woe_z:
                m, s = _woe_mean_std_of(cc, weighted)
                _numeric_woe_discretize(lt, cc, f"{name}_woe", weighted)
                _zscore_of(lt, f"{name}_woe", out, m, s, cutoff)
            else:
                mean = st.mean if st.mean is not None else 0.0
                std = st.stdDev if st.stdDev is not None else 1.0
                _zscore_of(lt, cc.columnName, out, mean, std, cutoff,
                           map_missing_zero=True)
        derived.append(out)
    return derived


# ---------------------------------------------------------------------------
# Document skeleton
# ---------------------------------------------------------------------------

def _pmml_root(mc: ModelConfig) -> ET.Element:
    root = ET.Element("PMML")
    root.set("xmlns", PMML_XMLNS)
    root.set("version", "4.2")
    header = _el(root, "Header", copyright="shifu-tpu",
                 description=f"model set {mc.model_set_name}")
    _el(header, "Application", name="shifu-tpu", version="0.1")
    return root


def _data_dictionary(root, mc: ModelConfig,
                     ccs_by_name: Dict[str, ColumnConfig],
                     raw_inputs: List[str]):
    dd = _el(root, "DataDictionary", numberOfFields=len(raw_inputs) + 1)
    tgt = mc.dataSet.targetColumnName.split("|")[0].split("::")[-1]
    _el(dd, "DataField", name=tgt, optype="categorical", dataType="string")
    for name in raw_inputs:
        cc = ccs_by_name.get(name)
        if cc is not None and cc.is_categorical:
            _el(dd, "DataField", name=name, optype="categorical",
                dataType="string")
        else:
            _el(dd, "DataField", name=name, optype="continuous",
                dataType="double")
    return tgt


def _mining_schema(parent, raw_inputs: List[str], target: str):
    ms = _el(parent, "MiningSchema")
    _el(ms, "MiningField", name=target, usageType="target")
    for name in raw_inputs:
        _el(ms, "MiningField", name=name, usageType="active")
    return ms


# ---------------------------------------------------------------------------
# NeuralNetwork / RegressionModel
# ---------------------------------------------------------------------------

def _append_network_body(net: ET.Element, derived: List[str],
                         meta: Dict[str, Any], params: Any,
                         target: str) -> None:
    """NeuralInputs + NeuralLayers + NeuralOutputs for one trained MLP,
    referencing already-derived (normalized) fields."""
    spec = meta["spec"]
    inputs = _el(net, "NeuralInputs", numberOfInputs=len(derived))
    for i, name in enumerate(derived):
        ni = _el(inputs, "NeuralInput", id=f"0,{i}")
        df = _el(ni, "DerivedField", optype="continuous", dataType="double")
        _el(df, "FieldRef", field=name)

    acts = list(spec.get("activations", ())) + [
        spec.get("output_activation", "sigmoid")]
    prev_ids = [f"0,{i}" for i in range(len(derived))]
    for li, layer in enumerate(params):
        act = _PMML_ACT.get(str(acts[li]).lower())
        if act is None:
            raise ValueError(f"activation {acts[li]!r} has no PMML mapping")
        w = np.asarray(layer["w"], np.float64)
        b = np.asarray(layer["b"], np.float64)
        nl = _el(net, "NeuralLayer", activationFunction=act,
                 numberOfNeurons=w.shape[1])
        ids = []
        for j in range(w.shape[1]):
            nid = f"{li + 1},{j}"
            neuron = _el(nl, "Neuron", id=nid, bias=_fmt(b[j]))
            for i, pid in enumerate(prev_ids):
                _el(neuron, "Con", **{"from": pid, "weight": _fmt(w[i, j])})
            ids.append(nid)
        prev_ids = ids

    outs = _el(net, "NeuralOutputs", numberOfOutputs=1)
    no = _el(outs, "NeuralOutput", outputNeuron=prev_ids[0])
    df = _el(no, "DerivedField", optype="continuous", dataType="double")
    _el(df, "FieldRef", field=target)


def build_nn_pmml(mc: ModelConfig, ccs: List[ColumnConfig],
                  meta: Dict[str, Any], params: Any) -> ET.Element:
    input_names = list(meta["inputNames"])
    ccs_by_name = {c.columnName: c for c in ccs}
    root = _pmml_root(mc)
    target = _data_dictionary(root, mc, ccs_by_name, input_names)

    net = _el(root, "NeuralNetwork", functionName="regression",
              algorithmName="shifu-tpu-nn")
    _mining_schema(net, input_names, target)
    out = _el(net, "Output")
    _el(out, "OutputField", name="FinalResult", feature="predictedValue")
    derived = build_local_transformations(net, mc, ccs_by_name, input_names)
    _append_network_body(net, derived, meta, params, target)
    return root


def build_bagging_nn_pmml(mc: ModelConfig, ccs: List[ColumnConfig],
                          members: List) -> ET.Element:
    """One unified PMML for ALL bags: a MiningModel whose Segmentation
    averages the member NeuralNetworks (`shifu export -t baggingpmml`,
    `ExportModelProcessor.java:192-207` ONE_BAGGING_PMML_MODEL — the
    reference builds the same multi-model document via
    PMMLConstructorFactory.produce(..., isOutBaggingToOne=true)).
    `members` = [(meta, params), ...] from the per-bag model specs;
    normalization derives once at the MiningModel level and every
    segment references the shared derived fields."""
    if not members:
        raise ValueError("baggingpmml needs at least one trained model")
    meta0 = members[0][0]
    input_names = list(meta0["inputNames"])
    ccs_by_name = {c.columnName: c for c in ccs}
    root = _pmml_root(mc)
    target = _data_dictionary(root, mc, ccs_by_name, input_names)

    mm = _el(root, "MiningModel", functionName="regression",
             algorithmName="shifu-tpu-nn-bagging")
    _mining_schema(mm, input_names, target)
    out = _el(mm, "Output")
    _el(out, "OutputField", name="FinalResult", feature="predictedValue")
    derived = build_local_transformations(mm, mc, ccs_by_name, input_names)
    seg = _el(mm, "Segmentation", multipleModelMethod="average")
    for k, (meta, params) in enumerate(members):
        if list(meta["inputNames"]) != input_names:
            raise ValueError(f"bag {k} has different inputs; bags must "
                             "share one variable set for baggingpmml")
        s = _el(seg, "Segment", id=str(k))
        _el(s, "True")
        net = _el(s, "NeuralNetwork", functionName="regression",
                  algorithmName="shifu-tpu-nn")
        _mining_schema(net, input_names, target)
        _append_network_body(net, derived, meta, params, target)
    return root


def build_lr_pmml(mc: ModelConfig, ccs: List[ColumnConfig],
                  meta: Dict[str, Any], params: Any) -> ET.Element:
    """LR (no hidden layers + sigmoid) → RegressionModel logit
    (`RegressionPmmlCreator`)."""
    spec = meta["spec"]
    if spec.get("hidden_dims"):
        return build_nn_pmml(mc, ccs, meta, params)
    input_names = list(meta["inputNames"])
    ccs_by_name = {c.columnName: c for c in ccs}
    root = _pmml_root(mc)
    target = _data_dictionary(root, mc, ccs_by_name, input_names)
    rm = _el(root, "RegressionModel", functionName="regression",
             normalizationMethod="logit", algorithmName="shifu-tpu-lr")
    _mining_schema(rm, input_names, target)
    out = _el(rm, "Output")
    _el(out, "OutputField", name="FinalResult", feature="predictedValue")
    derived = build_local_transformations(rm, mc, ccs_by_name, input_names)
    w = np.asarray(params[0]["w"], np.float64)[:, 0]
    b = float(np.asarray(params[0]["b"])[0])
    tbl = _el(rm, "RegressionTable", intercept=_fmt(b))
    for name, coef in zip(derived, w):
        _el(tbl, "NumericPredictor", name=name, exponent=1,
            coefficient=_fmt(coef))
    return root


# ---------------------------------------------------------------------------
# Tree ensembles
# ---------------------------------------------------------------------------

def _tree_children(parent_el, tree, node, feat_kind, feat_name, num_cuts,
                   num_col_of, cat_left_sets, scale, depth, max_depth):
    is_leaf = bool(tree["is_leaf"][node]) or depth >= max_depth \
        or int(tree["feature"][node]) < 0
    if is_leaf:
        return
    f = int(tree["feature"][node])
    sbin = int(tree["bin"][node])
    left_id, right_id = 2 * node + 1, 2 * node + 2
    parent_el.set("defaultChild", str(left_id if tree["default_left"][node]
                                      else right_id))
    default_left = bool(tree["default_left"][node])
    for child, is_left in ((left_id, True), (right_id, False)):
        cn = _el(parent_el, "Node", id=child,
                 score=_fmt(float(tree["leaf_value"][child]) * scale))
        if feat_kind[f] == "num":
            cut = float(num_cuts[min(sbin, num_cuts.shape[0] - 1),
                                 num_col_of[f]])
            _el(cn, "SimplePredicate", field=feat_name[f],
                operator="lessThan" if is_left else "greaterOrEqual",
                value=_fmt(cut))
        else:
            # The default-direction child matches by EXCLUSION of the
            # opposite side's set, so categories unseen in training or
            # mapped to the missing bin (neither set) route to the
            # default side — exactly the native scorer's
            # `miss → default_left` rule; PMML defaultChild alone only
            # covers true missing values.
            if is_left == default_left:
                cats = cat_left_sets(f, sbin, not is_left)
                op = "isNotIn"
            else:
                cats = cat_left_sets(f, sbin, is_left)
                op = "isIn"
            sp = _el(cn, "SimpleSetPredicate", field=feat_name[f],
                     booleanOperator=op)
            arr = _el(sp, "Array", type="string", n=len(cats))
            arr.text = " ".join('"%s"' % str(c).replace('"', '\\"')
                                for c in cats)
        _tree_children(cn, tree, child, feat_kind, feat_name, num_cuts,
                       num_col_of, cat_left_sets, scale, depth + 1, max_depth)


def build_tree_pmml(mc: ModelConfig, ccs: List[ColumnConfig],
                    meta: Dict[str, Any], params: Any) -> ET.Element:
    cfg = meta["treeConfig"]
    kind = meta["kind"]
    n_bins = int(cfg["n_bins"])
    max_depth = int(cfg["max_depth"])
    dense_names = list(meta.get("denseNames", []))
    index_names = list(meta.get("indexNames", []))
    feat_name = dense_names + index_names
    feat_kind = ["num"] * len(dense_names) + ["cat"] * len(index_names)
    num_cuts = np.asarray(params["tables"]["num_cuts"], np.float64)
    cat_map = np.asarray(params["tables"]["cat_map"])
    ccs_by_name = {c.columnName: c for c in ccs}
    # feat_name = dense_names + index_names, so feature f maps to dense
    # column f (numeric) or categorical column f - len(dense_names)
    n_dense = len(dense_names)
    num_col_of = [f if f < n_dense else -1 for f in range(len(feat_name))]

    def cat_left_sets(f: int, sbin: int, left: bool) -> List[str]:
        j = f - n_dense
        cc = ccs_by_name.get(feat_name[f])
        vocab = (cc.columnBinning.binCategory or []) if cc else []
        out = []
        for code, cat in enumerate(vocab):
            b = int(cat_map[j, code]) if code < cat_map.shape[1] else n_bins - 1
            if b == n_bins - 1:
                continue  # in neither set → isNotIn routes to default side
            if (b <= sbin) == left:
                out.append(cat)
        return out

    root = _pmml_root(mc)
    target = _data_dictionary(root, mc, ccs_by_name, feat_name)
    mm = _el(root, "MiningModel", functionName="regression",
             algorithmName=f"shifu-tpu-{kind}")
    _mining_schema(mm, feat_name, target)
    out = _el(mm, "Output")
    _el(out, "OutputField", name="FinalResult", feature="predictedValue")
    if kind == "gbt" and str(cfg.get("loss", "")).startswith("log"):
        of = _el(out, "OutputField", name="probability",
                 feature="transformedValue", dataType="double",
                 optype="continuous")
        # logistic(FinalResult) via Apply
        ap = _el(of, "Apply", function="/")
        _el(ap, "Constant", dataType="double").text = "1.0"
        plus = _el(ap, "Apply", function="+")
        _el(plus, "Constant", dataType="double").text = "1.0"
        ex = _el(plus, "Apply", function="exp")
        neg = _el(ex, "Apply", function="*")
        _el(neg, "Constant", dataType="double").text = "-1.0"
        _el(neg, "FieldRef", field="FinalResult")

    seg = _el(mm, "Segmentation",
              multipleModelMethod="sum" if kind == "gbt" else "average")
    trees = params["trees"]
    n_trees = int(np.asarray(trees["feature"]).shape[0])
    scale = float(cfg["learning_rate"]) if kind == "gbt" else 1.0
    for t in range(n_trees):
        tree = {k: np.asarray(v[t]) for k, v in trees.items()}
        s = _el(seg, "Segment", id=t + 1)
        _el(s, "True")
        tm = _el(s, "TreeModel", functionName="regression",
                 missingValueStrategy="defaultChild",
                 noTrueChildStrategy="returnLastPrediction",
                 splitCharacteristic="binarySplit")
        _mining_schema(tm, feat_name, target)
        rn = _el(tm, "Node", id=0,
                 score=_fmt(float(tree["leaf_value"][0]) * scale))
        _el(rn, "True")
        _tree_children(rn, tree, 0, feat_kind, feat_name, num_cuts,
                       num_col_of, cat_left_sets, scale, 0, max_depth)
    return root


# ---------------------------------------------------------------------------
# Entry
# ---------------------------------------------------------------------------

def build_pmml(mc: ModelConfig, ccs: List[ColumnConfig], kind: str,
               meta: Dict[str, Any], params: Any) -> ET.Element:
    if kind == "nn":
        return build_nn_pmml(mc, ccs, meta, params)
    if kind == "lr":
        return build_lr_pmml(mc, ccs, meta, params)
    if kind in ("gbt", "rf"):
        return build_tree_pmml(mc, ccs, meta, params)
    raise ValueError(f"PMML export not supported for model kind {kind!r} "
                     "(reference exports NN/LR/tree only)")


def to_string(root: ET.Element) -> str:
    ET.indent(root)
    return ET.tostring(root, encoding="unicode", xml_declaration=True)


# ---------------------------------------------------------------------------
# Structural conformance validation
# ---------------------------------------------------------------------------

# PMML 4.2 child-order (subset this module emits). The reference
# validates via the jpmml evaluator (`PMMLTranslatorTest.java`); with
# no external consumer installable here, this enforces the schema
# rules a consumer would trip on: namespace/version, element order,
# count attributes, and that every reference (field, neuron id,
# output neuron) resolves.
_MODEL_TAGS = ("NeuralNetwork", "RegressionModel", "MiningModel",
               "TreeModel")
_PREDICATES = ("True", "False", "SimplePredicate", "SimpleSetPredicate",
               "CompoundPredicate")


def validate_structure(root: ET.Element) -> List[str]:
    """PMML 4.2 structural conformance errors ([] = conformant)."""
    errs: List[str] = []
    root = _strip_ns(copy.deepcopy(root))
    if root.tag != "PMML":
        return [f"root element is {root.tag}, not PMML"]
    if root.get("version") != "4.2":
        errs.append(f"PMML version {root.get('version')!r}, expected 4.2")

    kids = list(root)
    if not kids or kids[0].tag != "Header":
        errs.append("first PMML child must be Header")
    dd = root.find("DataDictionary")
    if dd is None:
        return errs + ["DataDictionary missing"]
    if kids[1].tag != "DataDictionary":
        errs.append("DataDictionary must directly follow Header")
    fields = {f.get("name") for f in dd.findall("DataField")}
    n_decl = dd.get("numberOfFields")
    if n_decl is not None and int(n_decl) != len(fields):
        errs.append(f"DataDictionary numberOfFields={n_decl} but has "
                    f"{len(fields)} DataField elements")

    models = [e for e in root if e.tag in _MODEL_TAGS]
    if not models:
        errs.append("no model element (NeuralNetwork/RegressionModel/"
                    "MiningModel/TreeModel)")
    for m in models:
        errs.extend(_validate_model(m, fields))
    return errs


def _validate_model(m: ET.Element, fields) -> List[str]:
    errs: List[str] = []
    kids = list(m)
    if not kids or kids[0].tag != "MiningSchema":
        errs.append(f"{m.tag}: first child must be MiningSchema")
        return errs
    for mf in kids[0].findall("MiningField"):
        if mf.get("name") not in fields:
            errs.append(f"{m.tag}: MiningField {mf.get('name')!r} not in "
                        "DataDictionary")
    # fields visible to the model = data fields + derived fields
    visible = set(fields)
    lt = m.find("LocalTransformations")
    if lt is not None:
        for df in lt.findall("DerivedField"):
            for ref in df.iter("FieldRef"):
                if ref.get("field") not in visible:
                    errs.append(f"{m.tag}: DerivedField "
                                f"{df.get('name')!r} references undefined "
                                f"field {ref.get('field')!r}")
            for nc in df.iter("NormContinuous"):
                if nc.get("field") not in visible:
                    errs.append(f"{m.tag}: NormContinuous field "
                                f"{nc.get('field')!r} undefined")
            visible.add(df.get("name"))

    if m.tag == "NeuralNetwork":
        errs.extend(_validate_nn(m, visible))
    elif m.tag == "RegressionModel":
        tables = m.findall("RegressionTable")
        if not tables:
            errs.append("RegressionModel: no RegressionTable")
        for t in tables:
            for np_ in t.findall("NumericPredictor"):
                if np_.get("name") not in visible:
                    errs.append(f"RegressionModel: NumericPredictor "
                                f"{np_.get('name')!r} undefined")
    elif m.tag == "MiningModel":
        seg = m.find("Segmentation")
        if seg is None:
            errs.append("MiningModel: Segmentation missing")
        else:
            if seg.get("multipleModelMethod") not in (
                    "sum", "average", "majorityVote", "weightedAverage",
                    "max", "selectFirst", "modelChain"):
                errs.append("MiningModel: bad multipleModelMethod "
                            f"{seg.get('multipleModelMethod')!r}")
            for s in seg.findall("Segment"):
                kids = list(s)
                if len(kids) < 2 or kids[0].tag not in _PREDICATES:
                    errs.append(f"Segment {s.get('id')}: must be "
                                "(predicate, model)")
                    continue
                if kids[1].tag == "TreeModel":
                    errs.extend(_validate_tree(kids[1], visible,
                                               s.get("id")))
                elif kids[1].tag == "NeuralNetwork":
                    errs.extend(_validate_nn(kids[1], visible))
    elif m.tag == "TreeModel":
        errs.extend(_validate_tree(m, visible, "-"))
    return errs


def _validate_nn(m: ET.Element, visible) -> List[str]:
    errs: List[str] = []
    order = [e.tag for e in m
             if e.tag in ("NeuralInputs", "NeuralLayer", "NeuralOutputs")]
    if not order or order[0] != "NeuralInputs" \
            or order[-1] != "NeuralOutputs" \
            or "NeuralLayer" not in order:
        errs.append("NeuralNetwork: children must be NeuralInputs, "
                    "NeuralLayer+, NeuralOutputs in order")
        return errs
    ids = set()
    ni = m.find("NeuralInputs")
    for e in ni.findall("NeuralInput"):
        ids.add(e.get("id"))
        fr = e.find("DerivedField/FieldRef")
        if fr is None or fr.get("field") not in visible:
            errs.append(f"NeuralInput {e.get('id')}: FieldRef must name a "
                        "defined field")
    n_decl = ni.get("numberOfInputs")
    if n_decl is not None and int(n_decl) != len(ids):
        errs.append(f"NeuralInputs numberOfInputs={n_decl} ≠ {len(ids)}")
    for layer in m.findall("NeuralLayer"):
        if layer.get("activationFunction") is None:
            errs.append("NeuralLayer without activationFunction")
        new_ids = set()
        for neuron in layer.findall("Neuron"):
            nid = neuron.get("id")
            if nid in ids or nid in new_ids:
                errs.append(f"duplicate Neuron id {nid}")
            new_ids.add(nid)
            for con in neuron.findall("Con"):
                if con.get("from") not in ids:
                    errs.append(f"Neuron {nid}: Con from "
                                f"{con.get('from')!r} does not resolve to "
                                "an earlier neuron/input")
        n_decl = layer.get("numberOfNeurons")
        if n_decl is not None and int(n_decl) != len(new_ids):
            errs.append(f"NeuralLayer numberOfNeurons={n_decl} ≠ "
                        f"{len(new_ids)}")
        ids |= new_ids
    for no in m.find("NeuralOutputs").findall("NeuralOutput"):
        if no.get("outputNeuron") not in ids:
            errs.append(f"NeuralOutput outputNeuron "
                        f"{no.get('outputNeuron')!r} does not resolve")
    return errs


def _validate_tree(tm: ET.Element, visible, seg_id) -> List[str]:
    errs: List[str] = []
    root_node = tm.find("Node")
    if root_node is None:
        return [f"TreeModel (segment {seg_id}): no root Node"]

    def walk(node):
        kids = list(node)
        if not kids or kids[0].tag not in _PREDICATES:
            errs.append(f"TreeModel (segment {seg_id}) Node "
                        f"{node.get('id')}: first child must be a "
                        "predicate")
            return
        for p in kids[0].iter():
            f = p.get("field")
            if p.tag in ("SimplePredicate", "SimpleSetPredicate") and \
                    f not in visible:
                errs.append(f"TreeModel (segment {seg_id}): predicate "
                            f"field {f!r} undefined")
        children = [k for k in kids if k.tag == "Node"]
        if not children and node.get("score") is None:
            errs.append(f"TreeModel (segment {seg_id}) leaf Node "
                        f"{node.get('id')}: missing score")
        for ch in children:
            walk(ch)

    walk(root_node)
    return errs


# ---------------------------------------------------------------------------
# Mini evaluator (conformance testing — jpmml analog)
# ---------------------------------------------------------------------------

def _strip_ns(root: ET.Element) -> ET.Element:
    for e in root.iter():
        if "}" in e.tag:
            e.tag = e.tag.split("}", 1)[1]
    return root


def _apply_activation(name: str, x: np.ndarray) -> np.ndarray:
    if name == "logistic":
        return 1.0 / (1.0 + np.exp(-np.clip(x, -60, 60)))
    if name == "tanh":
        return np.tanh(x)
    if name == "rectifier":
        return np.maximum(x, 0.0)
    if name == "identity":
        return x
    if name == "sine":
        return np.sin(x)
    if name == "Gauss":
        return np.exp(-np.square(x))
    raise ValueError(f"unsupported activationFunction {name}")


def _is_missing_token(v) -> bool:
    return v is None or (isinstance(v, float) and np.isnan(v)) or v == ""


class _Evaluator:
    def __init__(self, root: ET.Element, records):
        from shifu_tpu_torch.data.reader import to_numeric
        self.root = _strip_ns(root)
        names = list(records.columns) if hasattr(records, "columns") \
            else list(records)
        self.n = len(records[names[0]]) if names else 0
        self.fields: Dict[str, np.ndarray] = {}
        # raw fields, typed per DataDictionary
        for dfld in self.root.find("DataDictionary"):
            name = dfld.get("name")
            if name not in names:
                continue
            col = np.asarray(records[name])
            if dfld.get("optype") == "continuous":
                self.fields[name] = col.astype(np.float64) \
                    if col.dtype.kind in "fiub" else to_numeric(col.astype(str))
            else:
                self.fields[name] = np.asarray(
                    [None if _is_missing_token(v) else str(v)
                     for v in col.tolist()], object)

    # -- transformations ----------------------------------------------------

    def _run_local_transformations(self, model_el):
        lt = model_el.find("LocalTransformations")
        if lt is None:
            return
        for df in lt.findall("DerivedField"):
            self.fields[df.get("name")] = self._derived(df)

    def _derived(self, df: ET.Element) -> np.ndarray:
        child = next(iter(df))
        if child.tag == "NormContinuous":
            src = self.fields[child.get("field")]
            pts = [(float(ln.get("orig")), float(ln.get("norm")))
                   for ln in child.findall("LinearNorm")]
            (o1, n1), (o2, n2) = pts[0], pts[-1]
            v = np.asarray(src, np.float64)
            mm = child.get("mapMissingTo")
            out = n1 + (v - o1) * (n2 - n1) / (o2 - o1) if o2 != o1 \
                else np.full_like(v, n1)
            if child.get("outliers") == "asExtremeValues":
                out = np.clip(out, min(n1, n2), max(n1, n2))
            if mm is not None:
                out = np.where(np.isnan(v), float(mm), out)
            return out
        if child.tag == "Discretize":
            src = np.asarray(self.fields[child.get("field")], np.float64)
            out = np.full(self.n, float(child.get("defaultValue", "nan")))
            for b in child.findall("DiscretizeBin"):
                iv = b.find("Interval")
                lo = float(iv.get("leftMargin", "-inf"))
                hi = float(iv.get("rightMargin", "inf"))
                m = (src >= lo) & (src < hi)
                out = np.where(m, float(b.get("binValue")), out)
            mm = child.get("mapMissingTo")
            if mm is not None:
                out = np.where(np.isnan(src), float(mm), out)
            return out
        if child.tag == "MapValues":
            fcp = child.find("FieldColumnPair")
            src = self.fields[fcp.get("field")]
            table = {}
            for row in child.find("InlineTable").findall("row"):
                table[row.find("in").text] = float(row.find("out").text)
            default = float(child.get("defaultValue", "nan"))
            missing = float(child.get("mapMissingTo", "nan"))
            out = np.empty(self.n, np.float64)
            for i, v in enumerate(src):
                out[i] = missing if v is None else table.get(v, default)
            return out
        if child.tag == "FieldRef":
            return np.asarray(self.fields[child.get("field")], np.float64)
        raise ValueError(f"unsupported DerivedField child {child.tag}")

    # -- models -------------------------------------------------------------

    def evaluate(self) -> np.ndarray:
        for tag in ("NeuralNetwork", "RegressionModel", "MiningModel",
                    "TreeModel"):
            m = self.root.find(tag)
            if m is not None:
                return getattr(self, f"_eval_{tag}")(m)
        raise ValueError("no supported model element found")

    def _eval_NeuralNetwork(self, net: ET.Element) -> np.ndarray:
        self._run_local_transformations(net)
        ids: List[str] = []
        cols: List[np.ndarray] = []
        for ni in net.find("NeuralInputs"):
            ref = ni.find("DerivedField").find("FieldRef").get("field")
            ids.append(ni.get("id"))
            cols.append(np.asarray(self.fields[ref], np.float64))
        acts = np.stack(cols, axis=1) if cols else np.zeros((self.n, 0))
        for nl in net.findall("NeuralLayer"):
            fn = nl.get("activationFunction")
            pos = {nid: k for k, nid in enumerate(ids)}
            neurons = nl.findall("Neuron")
            w = np.zeros((len(ids), len(neurons)))
            b = np.zeros(len(neurons))
            for j, neuron in enumerate(neurons):
                b[j] = float(neuron.get("bias", "0"))
                for con in neuron.findall("Con"):
                    w[pos[con.get("from")], j] += float(con.get("weight"))
            acts = _apply_activation(fn, acts @ w + b)
            ids = [neuron.get("id") for neuron in neurons]
        out_id = net.find("NeuralOutputs").find("NeuralOutput") \
            .get("outputNeuron")
        return acts[:, ids.index(out_id)]

    def _eval_RegressionModel(self, rm: ET.Element) -> np.ndarray:
        self._run_local_transformations(rm)
        tbl = rm.find("RegressionTable")
        z = np.full(self.n, float(tbl.get("intercept", "0")))
        for p in tbl.findall("NumericPredictor"):
            z = z + np.asarray(self.fields[p.get("name")], np.float64) \
                * float(p.get("coefficient"))
        if rm.get("normalizationMethod") == "logit":
            return 1.0 / (1.0 + np.exp(-np.clip(z, -60, 60)))
        return z

    def _predicate(self, node: ET.Element, rows: np.ndarray):
        """(true, missing) masks of a child node's predicate over `rows`
        (the JAX package's per-row True / False / None)."""
        sp = node.find("SimplePredicate")
        if sp is not None:
            v = np.asarray(self.fields[sp.get("field")][rows], np.float64)
            miss = np.isnan(v)
            t = float(sp.get("value"))
            with np.errstate(invalid="ignore"):
                hit = v < t if sp.get("operator") == "lessThan" else v >= t
            return hit & ~miss, miss
        ssp = node.find("SimpleSetPredicate")
        if ssp is not None:
            vals = self.fields[ssp.get("field")][rows]
            miss = np.asarray([v is None for v in vals], bool)
            txt = ssp.find("Array").text or ""
            cats = [c.strip('"') for c in txt.split('" "')] if txt else []
            cats = {c.strip('"') for c in cats}
            isin = np.asarray([v is not None and str(v) in cats
                               for v in vals], bool)
            hit = isin if ssp.get("booleanOperator") == "isIn" else ~isin
            return hit & ~miss, miss
        none = np.zeros(len(rows), bool)
        return (~none if node.find("True") is not None else none), none

    def _walk(self, node: ET.Element, rows: np.ndarray,
              out: np.ndarray) -> None:
        """Score `rows` at `node`: each row takes the first child whose
        predicate holds; a missing value goes to the defaultChild (else
        stops here), and a row no child takes keeps this node's
        score."""
        children = node.findall("Node")
        if not children:
            out[rows] = float(node.get("score"))
            return
        default_child = node.get("defaultChild")
        target = [c for c in children if c.get("id") == default_child] \
            if default_child is not None else []
        left = rows
        for ch in children:
            if not len(left):
                break
            hit, miss = self._predicate(ch, left)
            if miss.any():
                if target:
                    self._walk(target[0], left[miss], out)
                else:
                    out[left[miss]] = float(node.get("score"))
            if hit.any():
                self._walk(ch, left[hit], out)
            left = left[~hit & ~miss]
        out[left] = float(node.get("score"))

    def _eval_TreeModel(self, tm: ET.Element) -> np.ndarray:
        out = np.empty(self.n, np.float64)
        self._walk(tm.find("Node"), np.arange(self.n), out)
        return out

    def _eval_MiningModel(self, mm: ET.Element) -> np.ndarray:
        self._run_local_transformations(mm)
        seg = mm.find("Segmentation")
        parts = []
        for s in seg.findall("Segment"):
            for tag in ("TreeModel", "NeuralNetwork", "RegressionModel"):
                el = s.find(tag)
                if el is not None:
                    parts.append(getattr(self, f"_eval_{tag}")(el))
                    break
            else:
                raise ValueError("Segment holds no supported model")
        stack = np.stack(parts, axis=0)
        agg = stack.sum(axis=0) if seg.get("multipleModelMethod") == "sum" \
            else stack.mean(axis=0)
        # Output transformedValue logistic (GBT log loss)
        out = mm.find("Output")
        if out is not None and any(
                of.get("feature") == "transformedValue"
                for of in out.findall("OutputField")):
            return 1.0 / (1.0 + np.exp(-np.clip(agg, -60, 60)))
        return agg


def evaluate_pmml(xml, records) -> np.ndarray:
    """Score raw records (a `data.reader.Table`, or a mapping of column
    name → string values) through a PMML doc emitted by this module (its
    text, or its parsed root, which the evaluator strips of its
    namespace)."""
    root = ET.fromstring(xml) if isinstance(xml, str) else xml
    return _Evaluator(root, records).evaluate()
