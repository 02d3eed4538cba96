"""Declarative ModelConfig field constraints — the port's copy of
`shifu_tpu/config/meta.py` (`validate_fields`, `unknown_key_warnings`),
which `config/inspector.probe` runs before a step.
"""

from __future__ import annotations

import difflib
from dataclasses import dataclass, fields as dc_fields
from typing import Any, List, Optional, Tuple

from shifu_tpu_torch.config.model_config import ModelConfig


@dataclass(frozen=True)
class FieldMeta:
    """One user-editable field: dotted path + constraint."""
    path: str                       # e.g. "train.baggingNum"
    kind: str                       # int | float | str | bool
    lo: Optional[float] = None      # inclusive lower bound
    hi: Optional[float] = None      # inclusive upper bound
    lo_open: bool = False           # exclusive lower bound
    choices: Optional[Tuple[str, ...]] = None
    required: bool = False          # non-empty for str


# Enum-typed fields (runMode, normType, algorithm, ...) are validated
# by the JSON loader itself — a bad value cannot construct the enum —
# so the table below carries the numeric/string constraints the loader
# does not enforce. Ranges mirror the reference's meta spec semantics
# (ModelConfigMeta.json) without reproducing its file format.
FIELD_METAS: List[FieldMeta] = [
    FieldMeta("basic.name", "str", required=True),
    FieldMeta("dataSet.dataDelimiter", "str", required=True),
    FieldMeta("dataSet.targetColumnName", "str", required=True),
    FieldMeta("stats.maxNumBin", "int", lo=2, hi=10_000),
    FieldMeta("stats.cateMaxNumBin", "int", lo=0),
    FieldMeta("stats.sampleRate", "float", lo=0, hi=1, lo_open=True),
    FieldMeta("varSelect.filterNum", "int", lo=0),
    FieldMeta("varSelect.wrapperNum", "int", lo=1),
    FieldMeta("varSelect.wrapperRatio", "float", lo=0, hi=1),
    FieldMeta("varSelect.missingRateThreshold", "float", lo=0, hi=1),
    FieldMeta("normalize.stdDevCutOff", "float", lo=0, lo_open=True),
    FieldMeta("normalize.sampleRate", "float", lo=0, hi=1, lo_open=True),
    FieldMeta("normalize.precisionType", "str",
              choices=("FLOAT7", "FLOAT16", "FLOAT32", "DOUBLE64")),
    FieldMeta("train.baggingNum", "int", lo=1),
    FieldMeta("train.baggingSampleRate", "float", lo=0, hi=1,
              lo_open=True),
    FieldMeta("train.validSetRate", "float", lo=0, hi=0.999999),
    FieldMeta("train.numTrainEpochs", "int", lo=1),
    FieldMeta("train.epochsPerIteration", "int", lo=1),
    FieldMeta("train.workerThreadCount", "int", lo=1),
    FieldMeta("train.upSampleWeight", "float", lo=1),
    FieldMeta("train.convergenceThreshold", "float", lo=0),
    # k-fold: -1 = disabled (reference default); DTrain caps folds at 20
    FieldMeta("train.numKFold", "int", lo=-1, hi=20),
]

# train#params entries: (name, kind, lo, hi, lo_open); values may also
# be grid-search lists — each element is then checked
PARAM_METAS = {
    "LearningRate": ("float", 0, None, True),
    "NumHiddenLayers": ("int", 0, 64, False),
    "TreeNum": ("int", 1, 100_000, False),
    "MaxDepth": ("int", 1, 16, False),
    "MinInstancesPerNode": ("int", 1, None, False),
    "MinInfoGain": ("float", 0, None, False),
    "RegLambda": ("float", 0, None, False),
    "MiniBatchRows": ("int", 0, None, False),
    "ChunkRows": ("int", 1, None, False),
    "CheckpointInterval": ("int", 0, None, False),
    "DropoutRate": ("float", 0, 0.999999, False),
    # WDL/MTL architecture params (wdl.WDLSpec.from_train_params /
    # mtl.MTLSpec.from_train_params; reference WideAndDeep.java:78-249)
    "EmbedSize": ("int", 1, 4096, False),
    "RegularizedConstant": ("float", 0, None, False),
}


def _get_path(mc: ModelConfig, path: str) -> Any:
    obj: Any = mc
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _check_value(v: Any, m: FieldMeta, errs: List[str],
                 label: Optional[str] = None) -> None:
    label = label or m.path
    if m.kind == "str":
        if not isinstance(v, str):
            errs.append(f"{label} must be a string, got {type(v).__name__}")
            return
        if m.required and not v:
            errs.append(f"{label} must not be empty")
        if m.choices and v not in m.choices:
            errs.append(f"{label} must be one of {list(m.choices)}, "
                        f"got {v!r}")
        return
    if m.kind in ("int", "float"):
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            errs.append(f"{label} must be a number, got {type(v).__name__}")
            return
        if m.kind == "int" and float(v) != int(v):
            errs.append(f"{label} must be an integer, got {v}")
            return
        if m.lo is not None and (v <= m.lo if m.lo_open else v < m.lo):
            op = ">" if m.lo_open else ">="
            errs.append(f"{label} must be {op} {m.lo}, got {v}")
        if m.hi is not None and v > m.hi:
            errs.append(f"{label} must be <= {m.hi}, got {v}")


def validate_fields(mc: ModelConfig) -> List[str]:
    """Range/enum checks for every constrained field, plus the
    train#params table (grid-search lists check element-wise,
    gs/GridSearch.java:44-65 list-valued params)."""
    errs: List[str] = []
    for m in FIELD_METAS:
        try:
            v = _get_path(mc, m.path)
        except AttributeError:
            continue
        if v is None:
            continue
        _check_value(v, m, errs)

    for name, (kind, lo, hi, lo_open) in PARAM_METAS.items():
        v = mc.train.get_param(name)
        if v is None:
            continue
        meta = FieldMeta(f"train#params.{name}", kind, lo=lo, hi=hi,
                         lo_open=lo_open)
        vals = v if isinstance(v, list) else [v]
        for x in vals:
            if isinstance(x, list):     # grid list of lists
                for xx in x:
                    _check_value(xx, meta, errs)
            else:
                _check_value(x, meta, errs)
    return errs


def _known_keys(section) -> List[str]:
    return [f.name for f in dc_fields(section)
            if not f.name.startswith("_")]


def unknown_key_warnings(mc: ModelConfig) -> List[str]:
    """Typo detection: unknown JSON keys land in each section's
    `_extras` (preserved on save for forward compatibility, so never a
    hard failure); near-misses of real field names get a suggestion."""
    warns: List[str] = []
    sections = [("basic", mc.basic), ("dataSet", mc.dataSet),
                ("stats", mc.stats), ("varSelect", mc.varSelect),
                ("normalize", mc.normalize), ("train", mc.train)]
    for ev in mc.evals:
        sections.append((f"evals[{ev.name}]", ev))
        sections.append((f"evals[{ev.name}].dataSet", ev.dataSet))
    for label, sec in sections:
        extras = getattr(sec, "_extras", None) or {}
        known = _known_keys(sec)
        for k in extras:
            close = difflib.get_close_matches(k, known, n=1, cutoff=0.75)
            if close:
                warns.append(f"{label}: unknown key {k!r} — did you mean "
                             f"{close[0]!r}?")
            else:
                warns.append(f"{label}: unknown key {k!r} (preserved, "
                             "but not interpreted)")
    return warns
