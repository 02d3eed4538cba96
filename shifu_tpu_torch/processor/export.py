"""`shifu export` — the port of `shifu_tpu/processor/export.py`
(`core/processor/ExportModelProcessor.java:87-103`): columnstats
(per-column metrics CSV), woemapping (bin → WOE CSV), correlation
(`processor/correlation.py`, on `device`), pmml (one PMML 4.2 document
per model spec, `pmml.py`), bagging (one spec file of every bag),
baggingpmml (one PMML averaging the NN bags), woe (per-variable WOE
intervals), and ume / baggingume / normume through the
SHIFU_TPU_UME_EXPORTER hook (rc 3 when it is absent). `tf` (a
TensorFlow SavedModel, through jax2tf in the JAX package) raises: it
needs tensorflow (ROADMAP, not queued until tensorflow is on the card
machine).

Every type but correlation is a host-side file conversion. The port is
one process, so no writer election and no `step_guard` manifest (A8).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional

import torch

from shifu_tpu_torch.config.environment import knob_str
from shifu_tpu_torch.fileio import atomic_write
from shifu_tpu_torch.processor.base import ProcessorContext

log = logging.getLogger("shifu_tpu_torch")

COLUMNSTATS_FIELDS = [
    "columnNum", "columnName", "columnType", "finalSelect", "ks", "iv",
    "weightedKs", "weightedIv", "mean", "stdDev", "min", "max", "median",
    "missingCount", "totalCount", "missingPercentage", "woe", "weightedWoe",
    "skewness", "kurtosis", "distinctCount", "psi",
]

TYPES = ("columnstats", "woemapping", "correlation", "pmml", "tf",
         "bagging", "baggingpmml", "woe", "ume", "baggingume", "normume")


def run(ctx: ProcessorContext, export_type: str = "columnstats",
        device: "str | torch.device" = "cuda",
        report: Optional[Dict[str, Any]] = None) -> int:
    """`report`, when given, receives what the correlation export reports
    (rows, columns)."""
    t0 = time.time()
    ctx.require_columns()
    et = (export_type or "columnstats").lower()
    if et not in TYPES:
        raise ValueError(f"unknown export type {export_type!r}")
    if et == "columnstats":
        out = _export_columnstats(ctx)
    elif et == "woemapping":
        out = _export_woemapping(ctx)
    elif et == "correlation":
        from shifu_tpu_torch.processor import correlation
        correlation.run(ctx, device=device, report=report)
        out = ctx.path_finder.correlation_path()
    elif et == "pmml":
        out = _export_pmml(ctx)
    elif et == "tf":
        raise NotImplementedError(
            "export -t tf (a TensorFlow SavedModel of an NN spec) needs "
            "tensorflow (ROADMAP, not queued until tensorflow is on the "
            "card machine); export PMML or the portable spec instead")
    elif et == "bagging":
        out = _export_bagging(ctx)
    elif et == "baggingpmml":
        out = _export_bagging_pmml(ctx)
    elif et == "woe":
        out = _export_woe_info(ctx)
    else:   # ume, baggingume, normume
        return _export_ume(ctx, et)
    log.info("export[%s] → %s in %.2fs", et, out, time.time() - t0)
    return 0


def _export_columnstats(ctx: ProcessorContext) -> str:
    out = ctx.path_finder.column_stats_export_path()
    ctx.path_finder.ensure(out)
    with atomic_write(out) as f:
        f.write(",".join(COLUMNSTATS_FIELDS) + "\n")
        for cc in ctx.column_configs:
            st = cc.columnStats
            row = [cc.columnNum, cc.columnName,
                   cc.columnType.value if cc.columnType else "",
                   cc.finalSelect, st.ks, st.iv, st.weightedKs, st.weightedIv,
                   st.mean, st.stdDev, st.min, st.max, st.median,
                   st.missingCount, st.totalCount, st.missingPercentage,
                   st.woe, st.weightedWoe, st.skewness, st.kurtosis,
                   st.distinctCount, st.psi]
            f.write(",".join("" if v is None else str(v) for v in row) + "\n")
    return out


def _models(ctx: ProcessorContext):
    from shifu_tpu_torch.models.spec import list_models
    paths = list_models(ctx.path_finder.models_path())
    if not paths:
        raise FileNotFoundError("no trained models to export; run "
                                "`shifu train` first")
    return paths


def _checked(pmml_mod, root, what: str):
    """The structural conformance gate (jpmml-validation analog,
    PMMLTranslatorTest.java): never emit a nonconforming document."""
    problems = pmml_mod.validate_structure(root)
    if problems:
        raise ValueError(f"PMML for {what} failed conformance: "
                         + "; ".join(problems))
    return pmml_mod.to_string(root)


def _export_pmml(ctx: ProcessorContext) -> str:
    """One .pmml per model spec under models/, written to pmmls/
    (`ExportModelProcessor.exportPmml`)."""
    from shifu_tpu_torch import pmml as pmml_mod
    from shifu_tpu_torch.models.spec import load_model
    out_dir = None
    for i, p in enumerate(_models(ctx)):
        kind, meta, params = load_model(p)
        root = pmml_mod.build_pmml(ctx.model_config, ctx.column_configs,
                                   kind, meta, params)
        text = _checked(pmml_mod, root, os.path.basename(p))
        out = ctx.path_finder.pmml_path(i)
        ctx.path_finder.ensure(out)
        out_dir = os.path.dirname(out)
        with atomic_write(out) as f:
            f.write(text)
        log.info("pmml: %s → %s", os.path.basename(p), out)
    return out_dir


def _export_bagging(ctx: ProcessorContext) -> str:
    """`export -t bagging` — every bag's spec merged into ONE deployable
    model file (kind 'bagging') that the portable scorer ensembles
    (`ExportModelProcessor.java:140-174` ONE_BAGGING_MODEL; the members
    keep their kinds and the container averages)."""
    from shifu_tpu_torch.models.spec import load_model, save_model
    members = [load_model(p) for p in _models(ctx)]
    kinds = sorted({k for k, _, _ in members})
    if any(k not in ("nn", "lr", "gbt", "rf") for k in kinds):
        raise ValueError(f"export -t bagging supports nn/lr/gbt/rf "
                         f"members, got {kinds}")
    meta = {"members": [{"kind": k, "meta": m} for k, m, _ in members],
            "assemble": "mean",
            "modelSetName": ctx.model_config.model_set_name}
    params = {f"m{i}": p for i, (_, _, p) in enumerate(members)}
    out = os.path.join(ctx.path_finder.root, "onebagging",
                       f"{ctx.model_config.model_set_name}.bagging")
    ctx.path_finder.ensure(out)
    save_model(out, "bagging", meta, params)
    log.info("bagging: %d member model(s) (%s) → %s", len(members),
             ",".join(kinds), out)
    return out


def _export_bagging_pmml(ctx: ProcessorContext) -> str:
    """`export -t baggingpmml` — ONE PMML averaging all NN bags
    (`ExportModelProcessor.java:192-207`; NN-only there and here)."""
    from shifu_tpu_torch import pmml as pmml_mod
    from shifu_tpu_torch.models.spec import load_model
    members = []
    for p in _models(ctx):
        kind, meta, params = load_model(p)
        if kind not in ("nn", "lr"):
            raise ValueError("export -t baggingpmml only supports NN "
                             f"models (reference warns the same), got "
                             f"{kind}")
        members.append((meta, params))
    root = pmml_mod.build_bagging_nn_pmml(ctx.model_config,
                                          ctx.column_configs, members)
    text = _checked(pmml_mod, root, "the bagging model")
    out = os.path.join(ctx.path_finder.root, "pmmls",
                       f"{ctx.model_config.model_set_name}.pmml")
    ctx.path_finder.ensure(out)
    with atomic_write(out) as f:
        f.write(text)
    log.info("baggingpmml: %d bag(s) → %s", len(members), out)
    return out


def _export_woe_info(ctx: ProcessorContext) -> str:
    """`export -t woe` — human-readable per-variable WOE intervals
    (varwoe_info.txt, `ExportModelProcessor.java:226-246` +
    generateWoeInfos: '(lo,hi]\\twoe' lines plus a MISSING row)."""
    lines = []
    for cc in ctx.column_configs:
        bn = cc.columnBinning
        woes = bn.binCountWoe or []
        if len(woes) < 2:
            continue
        if cc.is_categorical and bn.binCategory:
            labels = list(bn.binCategory)
        elif not cc.is_categorical and bn.binBoundary \
                and len(bn.binBoundary) > 1:
            bb = bn.binBoundary
            labels = []
            for i in range(len(bb)):
                lo = "-∞" if i == 0 else str(bb[i])
                hi = str(bb[i + 1]) if i + 1 < len(bb) else "+∞"
                labels.append(f"({lo},{hi}]")
        else:
            continue
        lines.append(cc.columnName)
        for i, label in enumerate(labels):
            if i < len(woes):
                lines.append(f"{label}\t{woes[i]}")
        lines.append(f"MISSING\t{woes[-1]}")
        lines.append("")
    out = os.path.join(ctx.path_finder.root, "varwoe_info.txt")
    with atomic_write(out) as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return out


def _export_ume(ctx: ProcessorContext, et: str) -> int:
    """`export -t ume|baggingume|normume` — the reference reflectively
    invokes a PROPRIETARY exporter class shipped outside the repo
    (`ExportModelProcessor.java:249-267`, rc 3 when absent). Here the
    same contract is a Python entry point: SHIFU_TPU_UME_EXPORTER=
    "pkg.module:ClassName" names a class built with the ModelConfig and
    called as .translate(model_set_name, params)."""
    import importlib
    target = knob_str("SHIFU_TPU_UME_EXPORTER")
    if not target or ":" not in target:
        log.error("UME exporter not configured (set SHIFU_TPU_UME_"
                  "EXPORTER=pkg.module:Class); the reference's "
                  "com.paypal.gds.art.UmeExporter is proprietary and "
                  "ships outside the framework")
        return 3
    mod_name, cls_name = target.split(":", 1)
    try:
        cls = getattr(importlib.import_module(mod_name), cls_name)
        exporter = cls(ctx.model_config)
        exporter.translate(ctx.model_config.model_set_name, {
            "baggingMode": et == "baggingume",
            "normAsUme": et == "normume",
        })
    except (ImportError, AttributeError) as e:
        log.error("UME exporter %s not loadable: %s", target, e)
        return 3
    return 0


def _export_woemapping(ctx: ProcessorContext) -> str:
    out = os.path.join(ctx.path_finder.root, "woemapping.csv")
    with atomic_write(out) as f:
        f.write("columnName,binIndex,binLow/category,binCountWoe,"
                "binWeightedWoe\n")
        for cc in ctx.column_configs:
            bn = cc.columnBinning
            if not bn.binCountWoe:
                continue
            labels = (bn.binCategory if bn.binCategory is not None
                      else (bn.binBoundary or []))
            for i, woe in enumerate(bn.binCountWoe):
                label = labels[i] if i < len(labels) else "MISSING"
                wwoe = bn.binWeightedWoe[i] if bn.binWeightedWoe and \
                    i < len(bn.binWeightedWoe) else ""
                f.write(f"{cc.columnName},{i},{label},{woe},{wwoe}\n")
    return out
