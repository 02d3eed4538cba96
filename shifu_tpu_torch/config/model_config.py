"""ModelConfig object tree — a copy of `shifu_tpu/config/model_config.py`.

The port's copy (the JAX package is the reference and is not imported);
only the atomic-write and URL-scheme helpers come from
`shifu_tpu_torch.fileio` instead of `shifu_tpu.resilience` and
`shifu_tpu.data.fs`. The original docstring follows.

ModelConfig object tree — JSON-compatible with the reference.

Mirrors the Jackson-bound config of the reference
(`container/obj/ModelConfig.java:59-103` aggregates
basic / dataSet / stats / varSelect / normalize / train / evals;
enums from `ModelTrainConf.java:43-58`, `ModelNormalizeConf.java:33-60`,
`ModelBasicConf.java:33-34`, `ModelStatsConf.java`). The on-disk JSON
uses camelCase keys and is readable/writable unchanged by either
implementation; unknown keys are preserved on round-trip (the reference
uses `@JsonIgnoreProperties(ignoreUnknown = true)`).

This is plain-Python metadata — nothing here touches a device. All
device work is driven off these objects by the step processors.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional


# ---------------------------------------------------------------------------
# Enums (string-valued for JSON friendliness; parsing is case-insensitive
# like the reference's custom Jackson deserializers)
# ---------------------------------------------------------------------------

class _CIEnum(str, Enum):
    """Case-insensitively parsed string enum."""

    @classmethod
    def parse(cls, value, default=None):
        if value is None:
            return default
        if isinstance(value, cls):
            return value
        s = str(value).strip()
        for m in cls:
            if m.value.lower() == s.lower() or m.name.lower() == s.lower():
                return m
        raise ValueError(f"cannot parse {s!r} as {cls.__name__}")


class RunMode(_CIEnum):
    """`ModelBasicConf.java:33-34` — LOCAL/DIST(MAPRED). We add TPU as the
    native distributed mode; DIST/MAPRED are accepted as aliases of TPU so
    existing configs keep working."""
    LOCAL = "LOCAL"
    TPU = "TPU"
    DIST = "DIST"
    MAPRED = "MAPRED"

    @property
    def is_distributed(self) -> bool:
        return self is not RunMode.LOCAL


class SourceType(_CIEnum):
    """`container/obj/RawSourceData.java` SourceType — LOCAL/HDFS/S3/GS.
    Only LOCAL paths (incl. gs:// style fsspec-able URIs) are dispatched
    natively for now."""
    LOCAL = "LOCAL"
    HDFS = "HDFS"
    S3 = "S3"
    GS = "GS"


class Algorithm(_CIEnum):
    """`ModelTrainConf.java:43-45`."""
    NN = "NN"
    LR = "LR"
    SVM = "SVM"
    DT = "DT"
    RF = "RF"
    GBT = "GBT"
    TENSORFLOW = "TENSORFLOW"
    WDL = "WDL"
    MTL = "MTL"

    @property
    def is_tree(self) -> bool:
        return self in (Algorithm.DT, Algorithm.RF, Algorithm.GBT)


class MultipleClassification(_CIEnum):
    """`ModelTrainConf.java:54-58`."""
    NATIVE = "NATIVE"
    ONEVSALL = "ONEVSALL"
    ONEVSREST = "ONEVSREST"
    ONEVSONE = "ONEVSONE"


class NormType(_CIEnum):
    """`ModelNormalizeConf.java:33-60` — the full 29-member NormType enum."""
    OLD_ZSCORE = "OLD_ZSCORE"
    OLD_ZSCALE = "OLD_ZSCALE"
    ZSCORE = "ZSCORE"
    ZSCALE = "ZSCALE"
    WOE = "WOE"
    WEIGHT_WOE = "WEIGHT_WOE"
    HYBRID = "HYBRID"
    WEIGHT_HYBRID = "WEIGHT_HYBRID"
    WOE_ZSCORE = "WOE_ZSCORE"
    WOE_ZSCALE = "WOE_ZSCALE"
    WEIGHT_WOE_ZSCORE = "WEIGHT_WOE_ZSCORE"
    WEIGHT_WOE_ZSCALE = "WEIGHT_WOE_ZSCALE"
    ONEHOT = "ONEHOT"
    ZSCALE_ONEHOT = "ZSCALE_ONEHOT"
    ZSCALE_ORDINAL = "ZSCALE_ORDINAL"
    MAXMIN_INDEX = "MAXMIN_INDEX"
    ASIS_WOE = "ASIS_WOE"
    ASIS_PR = "ASIS_PR"
    DISCRETE_ZSCORE = "DISCRETE_ZSCORE"
    DISCRETE_ZSCALE = "DISCRETE_ZSCALE"
    ZSCALE_INDEX = "ZSCALE_INDEX"
    ZSCORE_INDEX = "ZSCORE_INDEX"
    WOE_INDEX = "WOE_INDEX"
    WOE_ZSCALE_INDEX = "WOE_ZSCALE_INDEX"
    ZSCALE_APPEND_INDEX = "ZSCALE_APPEND_INDEX"
    ZSCORE_APPEND_INDEX = "ZSCORE_APPEND_INDEX"
    WOE_APPEND_INDEX = "WOE_APPEND_INDEX"
    WOE_ZSCALE_APPEND_INDEX = "WOE_ZSCALE_APPEND_INDEX"
    INDEX = "INDEX"

    @property
    def is_woe(self) -> bool:
        """`ModelNormalizeConf.NormType.isWoe`."""
        return self in (NormType.WOE, NormType.WEIGHT_WOE, NormType.WOE_ZSCORE,
                        NormType.WOE_ZSCALE, NormType.WEIGHT_WOE_ZSCORE,
                        NormType.WEIGHT_WOE_ZSCALE)

    @property
    def is_weighted(self) -> bool:
        return self in (NormType.WEIGHT_WOE, NormType.WEIGHT_HYBRID,
                        NormType.WEIGHT_WOE_ZSCORE, NormType.WEIGHT_WOE_ZSCALE)

    @property
    def is_index(self) -> bool:
        """Categorical columns become vocabulary indices (embedding input
        for WDL/MTL) rather than dense floats."""
        return self in (NormType.MAXMIN_INDEX, NormType.ZSCALE_INDEX,
                        NormType.ZSCORE_INDEX, NormType.WOE_INDEX,
                        NormType.WOE_ZSCALE_INDEX, NormType.ZSCALE_APPEND_INDEX,
                        NormType.ZSCORE_APPEND_INDEX, NormType.WOE_APPEND_INDEX,
                        NormType.WOE_ZSCALE_APPEND_INDEX, NormType.INDEX)


class BinningMethod(_CIEnum):
    """`container/obj/ModelStatsConf.java` BinningMethod."""
    EqualPositive = "EqualPositive"
    EqualNegative = "EqualNegative"
    EqualTotal = "EqualTotal"
    EqualInterval = "EqualInterval"
    WeightEqualPositive = "WeightEqualPositive"
    WeightEqualNegative = "WeightEqualNegative"
    WeightEqualTotal = "WeightEqualTotal"
    WeightEqualInterval = "WeightEqualInterval"


class BinningAlgorithm(_CIEnum):
    """`container/obj/ModelStatsConf.java` BinningAlgorithm. The reference's
    distributed sketches (SPDT/MunroPat) are approximations forced by
    MapReduce; on TPU a full pass is cheap so every algorithm maps to the
    exact quantile kernel (`shifu_tpu/ops/binning.py`). Names are kept so
    existing configs parse; results are exact rather than sketched."""
    Native = "Native"
    SPDT = "SPDT"
    MunroPat = "MunroPat"
    SPDTI = "SPDTI"
    MunroPatI = "MunroPatI"
    DynamicBinning = "DynamicBinning"


class Correlation(_CIEnum):
    """`ModelNormalizeConf.java` Correlation enum."""
    NONE = "None"
    Pearson = "Pearson"
    NormPearson = "NormPearson"


# ---------------------------------------------------------------------------
# Config sections
# ---------------------------------------------------------------------------

def _extras_roundtrip(obj, d: Dict[str, Any], known: List[str]) -> None:
    obj._extras = {k: v for k, v in d.items() if k not in known}


@dataclass
class ModelBasicConf:
    """`container/obj/ModelBasicConf.java`."""
    name: str = ""
    author: str = ""
    description: str = ""
    version: str = "0.13.0"
    runMode: RunMode = RunMode.LOCAL
    postTrainOn: bool = False
    customPaths: Dict[str, str] = field(default_factory=dict)
    _extras: Dict[str, Any] = field(default_factory=dict, repr=False)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ModelBasicConf":
        d = d or {}
        o = cls(
            name=d.get("name", ""),
            author=d.get("author", ""),
            description=d.get("description", ""),
            version=d.get("version", "0.13.0"),
            runMode=RunMode.parse(d.get("runMode"), RunMode.LOCAL),
            postTrainOn=bool(d.get("postTrainOn", False)),
            customPaths=d.get("customPaths") or {},
        )
        _extras_roundtrip(o, d, ["name", "author", "description", "version",
                                 "runMode", "postTrainOn", "customPaths"])
        return o

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "author": self.author,
                "description": self.description, "version": self.version,
                "runMode": self.runMode.value, "postTrainOn": self.postTrainOn,
                "customPaths": self.customPaths, **self._extras}


@dataclass
class ModelSourceDataConf:
    """`container/obj/ModelSourceDataConf.java` (extends RawSourceData):
    where the raw data lives and how to interpret it."""
    source: SourceType = SourceType.LOCAL
    dataPath: str = ""
    dataDelimiter: str = "|"
    headerPath: str = ""
    headerDelimiter: str = "|"
    filterExpressions: str = ""
    weightColumnName: str = ""
    targetColumnName: str = ""
    posTags: List[str] = field(default_factory=list)
    negTags: List[str] = field(default_factory=list)
    missingOrInvalidValues: List[str] = field(
        default_factory=lambda: ["", "*", "#", "?", "null", "~"])
    metaColumnNameFile: str = ""
    categoricalColumnNameFile: str = ""
    validationDataPath: str = ""
    _extras: Dict[str, Any] = field(default_factory=dict, repr=False)

    KNOWN = ["source", "dataPath", "dataDelimiter", "headerPath",
             "headerDelimiter", "filterExpressions", "weightColumnName",
             "targetColumnName", "posTags", "negTags",
             "missingOrInvalidValues", "metaColumnNameFile",
             "categoricalColumnNameFile", "validationDataPath"]

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ModelSourceDataConf":
        d = d or {}
        o = cls(
            source=SourceType.parse(d.get("source"), SourceType.LOCAL),
            dataPath=d.get("dataPath", "") or "",
            dataDelimiter=d.get("dataDelimiter", "|") or "|",
            headerPath=d.get("headerPath", "") or "",
            headerDelimiter=d.get("headerDelimiter", "|") or "|",
            filterExpressions=d.get("filterExpressions", "") or "",
            weightColumnName=d.get("weightColumnName", "") or "",
            targetColumnName=d.get("targetColumnName", "") or "",
            posTags=list(d.get("posTags") or []),
            negTags=list(d.get("negTags") or []),
            missingOrInvalidValues=list(d.get("missingOrInvalidValues")
                                        if d.get("missingOrInvalidValues") is not None
                                        else ["", "*", "#", "?", "null", "~"]),
            metaColumnNameFile=d.get("metaColumnNameFile", "") or "",
            categoricalColumnNameFile=d.get("categoricalColumnNameFile", "") or "",
            validationDataPath=d.get("validationDataPath", "") or "",
        )
        _extras_roundtrip(o, d, cls.KNOWN)
        return o

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "source": self.source.value, "dataPath": self.dataPath,
            "dataDelimiter": self.dataDelimiter, "headerPath": self.headerPath,
            "headerDelimiter": self.headerDelimiter,
            "filterExpressions": self.filterExpressions,
            "weightColumnName": self.weightColumnName,
            "targetColumnName": self.targetColumnName,
            "posTags": self.posTags, "negTags": self.negTags,
            "missingOrInvalidValues": self.missingOrInvalidValues,
            "metaColumnNameFile": self.metaColumnNameFile,
            "categoricalColumnNameFile": self.categoricalColumnNameFile,
        }
        if self.validationDataPath:
            out["validationDataPath"] = self.validationDataPath
        out.update(self._extras)
        return out


@dataclass
class ModelStatsConf:
    """`container/obj/ModelStatsConf.java`."""
    maxNumBin: int = 10
    cateMaxNumBin: int = 0  # 0 = unlimited (reference default)
    binningMethod: BinningMethod = BinningMethod.EqualPositive
    sampleRate: float = 1.0
    sampleNegOnly: bool = False
    binningAlgorithm: BinningAlgorithm = BinningAlgorithm.SPDTI
    psiColumnName: str = ""
    correlation: Correlation = Correlation.NONE
    _extras: Dict[str, Any] = field(default_factory=dict, repr=False)

    KNOWN = ["maxNumBin", "cateMaxNumBin", "binningMethod", "sampleRate",
             "sampleNegOnly", "binningAlgorithm", "psiColumnName",
             "correlation"]

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ModelStatsConf":
        d = d or {}
        o = cls(
            maxNumBin=int(d.get("maxNumBin", 10)),
            cateMaxNumBin=int(d.get("cateMaxNumBin", 0)),
            binningMethod=BinningMethod.parse(d.get("binningMethod"),
                                              BinningMethod.EqualPositive),
            sampleRate=float(d.get("sampleRate", 1.0)),
            sampleNegOnly=bool(d.get("sampleNegOnly", False)),
            binningAlgorithm=BinningAlgorithm.parse(d.get("binningAlgorithm"),
                                                    BinningAlgorithm.SPDTI),
            psiColumnName=d.get("psiColumnName", "") or "",
            correlation=Correlation.parse(d.get("correlation"),
                                          Correlation.NONE),
        )
        _extras_roundtrip(o, d, cls.KNOWN)
        return o

    def to_dict(self) -> Dict[str, Any]:
        return {"maxNumBin": self.maxNumBin,
                "cateMaxNumBin": self.cateMaxNumBin,
                "binningMethod": self.binningMethod.value,
                "sampleRate": self.sampleRate,
                "sampleNegOnly": self.sampleNegOnly,
                "binningAlgorithm": self.binningAlgorithm.value,
                "psiColumnName": self.psiColumnName,
                "correlation": self.correlation.value, **self._extras}


@dataclass
class ModelVarSelectConf:
    """`container/obj/ModelVarSelectConf.java`."""
    forceEnable: bool = True
    forceSelectColumnNameFile: str = ""
    forceRemoveColumnNameFile: str = ""
    filterEnable: bool = True
    filterNum: int = 200
    filterBy: str = "KS"  # KS | IV | PARETO | MIX | SE | ST
    wrapperEnabled: bool = False
    wrapperNum: int = 50
    wrapperRatio: float = 0.05
    wrapperBy: str = "S"
    missingRateThreshold: float = 0.98
    filterBySE: bool = True
    params: Optional[Dict[str, Any]] = None
    autoFilterEnable: bool = False
    postCorrelationMetric: str = "IV"
    minIvThreshold: Optional[float] = None
    minKsThreshold: Optional[float] = None
    correlationThreshold: Optional[float] = None
    _extras: Dict[str, Any] = field(default_factory=dict, repr=False)

    KNOWN = ["forceEnable", "forceSelectColumnNameFile",
             "forceRemoveColumnNameFile", "filterEnable", "filterNum",
             "filterBy", "wrapperEnabled", "wrapperNum", "wrapperRatio",
             "wrapperBy", "missingRateThreshold", "filterBySE", "params",
             "autoFilterEnable", "postCorrelationMetric", "minIvThreshold",
             "minKsThreshold", "correlationThreshold"]

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ModelVarSelectConf":
        d = d or {}
        o = cls(
            forceEnable=bool(d.get("forceEnable", True)),
            forceSelectColumnNameFile=d.get("forceSelectColumnNameFile", "") or "",
            forceRemoveColumnNameFile=d.get("forceRemoveColumnNameFile", "") or "",
            filterEnable=bool(d.get("filterEnable", True)),
            filterNum=int(d.get("filterNum", 200)),
            filterBy=str(d.get("filterBy", "KS")),
            wrapperEnabled=bool(d.get("wrapperEnabled", False)),
            wrapperNum=int(d.get("wrapperNum", 50)),
            wrapperRatio=float(d.get("wrapperRatio", 0.05)),
            wrapperBy=str(d.get("wrapperBy", "S")),
            missingRateThreshold=float(d.get("missingRateThreshold", 0.98)),
            filterBySE=bool(d.get("filterBySE", True)),
            params=d.get("params"),
            autoFilterEnable=bool(d.get("autoFilterEnable", False)),
            postCorrelationMetric=str(d.get("postCorrelationMetric", "IV")),
            minIvThreshold=d.get("minIvThreshold"),
            minKsThreshold=d.get("minKsThreshold"),
            correlationThreshold=d.get("correlationThreshold"),
        )
        _extras_roundtrip(o, d, cls.KNOWN)
        return o

    def to_dict(self) -> Dict[str, Any]:
        return {"forceEnable": self.forceEnable,
                "forceSelectColumnNameFile": self.forceSelectColumnNameFile,
                "forceRemoveColumnNameFile": self.forceRemoveColumnNameFile,
                "filterEnable": self.filterEnable, "filterNum": self.filterNum,
                "filterBy": self.filterBy,
                "wrapperEnabled": self.wrapperEnabled,
                "wrapperNum": self.wrapperNum,
                "wrapperRatio": self.wrapperRatio,
                "wrapperBy": self.wrapperBy,
                "missingRateThreshold": self.missingRateThreshold,
                "filterBySE": self.filterBySE, "params": self.params,
                "autoFilterEnable": self.autoFilterEnable,
                "postCorrelationMetric": self.postCorrelationMetric,
                **({"minIvThreshold": self.minIvThreshold}
                   if self.minIvThreshold is not None else {}),
                **({"minKsThreshold": self.minKsThreshold}
                   if self.minKsThreshold is not None else {}),
                **({"correlationThreshold": self.correlationThreshold}
                   if self.correlationThreshold is not None else {}),
                **self._extras}


@dataclass
class ModelNormalizeConf:
    """`container/obj/ModelNormalizeConf.java`."""
    stdDevCutOff: float = 4.0
    sampleRate: float = 1.0
    sampleNegOnly: bool = False
    normType: NormType = NormType.ZSCALE
    precisionType: str = "FLOAT32"  # udf/norm/PrecisionType.java:20-56
    _extras: Dict[str, Any] = field(default_factory=dict, repr=False)

    KNOWN = ["stdDevCutOff", "sampleRate", "sampleNegOnly", "normType",
             "precisionType"]

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ModelNormalizeConf":
        d = d or {}
        o = cls(
            stdDevCutOff=float(d.get("stdDevCutOff", 4.0)),
            sampleRate=float(d.get("sampleRate", 1.0)),
            sampleNegOnly=bool(d.get("sampleNegOnly", False)),
            normType=NormType.parse(d.get("normType"), NormType.ZSCALE),
            precisionType=str(d.get("precisionType", "FLOAT32")),
        )
        _extras_roundtrip(o, d, cls.KNOWN)
        return o

    def to_dict(self) -> Dict[str, Any]:
        return {"stdDevCutOff": self.stdDevCutOff,
                "sampleRate": self.sampleRate,
                "sampleNegOnly": self.sampleNegOnly,
                "normType": self.normType.value,
                "precisionType": self.precisionType, **self._extras}


@dataclass
class ModelTrainConf:
    """`container/obj/ModelTrainConf.java:74-191`."""
    baggingNum: int = 1
    baggingWithReplacement: bool = False  # ModelTrainConf.java:80 default FALSE
    baggingSampleRate: float = 1.0
    validSetRate: float = 0.2
    numTrainEpochs: int = 100
    epochsPerIteration: int = 1
    trainOnDisk: bool = False
    isContinuous: bool = False
    workerThreadCount: int = 4
    algorithm: Algorithm = Algorithm.NN
    params: Dict[str, Any] = field(default_factory=dict)
    customPaths: Dict[str, str] = field(default_factory=dict)
    multiClassifyMethod: MultipleClassification = MultipleClassification.NATIVE
    isCrossOver: bool = False
    numKFold: int = -1
    upSampleWeight: float = 1.0
    convergenceThreshold: float = 0.0
    gridConfigFile: str = ""
    earlyStoppingRounds: int = -1  # window early-stop (WindowEarlyStop.java)
    # bagging-sampling refinements (ModelTrainConf.java:128,444;
    # applied in train.bagging_weights). fixInitialInput
    # (ModelConfig.java:670) is accepted but always-on here: bags
    # derive from a fixed seed, so resumes replay identical samples.
    stratifiedSample: bool = False
    sampleNegOnly: bool = False
    fixInitialInput: bool = False
    _extras: Dict[str, Any] = field(default_factory=dict, repr=False)

    KNOWN = ["baggingNum", "baggingWithReplacement", "baggingSampleRate",
             "validSetRate", "numTrainEpochs", "epochsPerIteration",
             "trainOnDisk", "isContinuous", "workerThreadCount", "algorithm",
             "params", "customPaths", "multiClassifyMethod", "isCrossOver",
             "numKFold", "upSampleWeight", "convergenceThreshold",
             "gridConfigFile", "earlyStoppingRounds", "stratifiedSample",
             "sampleNegOnly", "fixInitialInput"]

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ModelTrainConf":
        d = d or {}
        o = cls(
            baggingNum=int(d.get("baggingNum", 1)),
            baggingWithReplacement=bool(d.get("baggingWithReplacement", False)),
            baggingSampleRate=float(d.get("baggingSampleRate", 1.0)),
            validSetRate=float(d.get("validSetRate", 0.2)),
            numTrainEpochs=int(d.get("numTrainEpochs", 100)),
            epochsPerIteration=int(d.get("epochsPerIteration", 1)),
            trainOnDisk=bool(d.get("trainOnDisk", False)),
            isContinuous=bool(d.get("isContinuous", False)),
            workerThreadCount=int(d.get("workerThreadCount", 4)),
            algorithm=Algorithm.parse(d.get("algorithm"), Algorithm.NN),
            params=d.get("params") or {},
            customPaths=d.get("customPaths") or {},
            multiClassifyMethod=MultipleClassification.parse(
                d.get("multiClassifyMethod"), MultipleClassification.NATIVE),
            isCrossOver=bool(d.get("isCrossOver", False)),
            numKFold=int(d.get("numKFold", -1) if d.get("numKFold") is not None else -1),
            upSampleWeight=float(d.get("upSampleWeight", 1.0)),
            convergenceThreshold=float(d.get("convergenceThreshold", 0.0)),
            gridConfigFile=d.get("gridConfigFile", "") or "",
            earlyStoppingRounds=int(d.get("earlyStoppingRounds", -1)),
            stratifiedSample=bool(d.get("stratifiedSample", False)),
            sampleNegOnly=bool(d.get("sampleNegOnly", False)),
            fixInitialInput=bool(d.get("fixInitialInput", False)),
        )
        _extras_roundtrip(o, d, cls.KNOWN)
        return o

    def to_dict(self) -> Dict[str, Any]:
        return {"baggingNum": self.baggingNum,
                "baggingWithReplacement": self.baggingWithReplacement,
                "baggingSampleRate": self.baggingSampleRate,
                "validSetRate": self.validSetRate,
                "numTrainEpochs": self.numTrainEpochs,
                "epochsPerIteration": self.epochsPerIteration,
                "trainOnDisk": self.trainOnDisk,
                "isContinuous": self.isContinuous,
                "workerThreadCount": self.workerThreadCount,
                "algorithm": self.algorithm.value, "params": self.params,
                "customPaths": self.customPaths,
                "multiClassifyMethod": self.multiClassifyMethod.value,
                "isCrossOver": self.isCrossOver,
                "numKFold": self.numKFold,
                "upSampleWeight": self.upSampleWeight,
                "convergenceThreshold": self.convergenceThreshold,
                "gridConfigFile": self.gridConfigFile,
                "earlyStoppingRounds": self.earlyStoppingRounds,
                "stratifiedSample": self.stratifiedSample,
                "sampleNegOnly": self.sampleNegOnly,
                "fixInitialInput": self.fixInitialInput,
                **self._extras}

    def get_param(self, key: str, default=None):
        """Case-tolerant train#params lookup (reference keys use TitleCase:
        NumHiddenLayers, LearningRate, ...)."""
        if key in self.params:
            return self.params[key]
        for k, v in self.params.items():
            if k.lower() == key.lower():
                return v
        return default


@dataclass
class EvalConfig:
    """`container/obj/EvalConfig.java` — one eval set."""
    name: str = "Eval1"
    dataSet: ModelSourceDataConf = field(default_factory=ModelSourceDataConf)
    performanceBucketNum: int = 10
    performanceScoreSelector: str = "mean"
    scoreMetaColumnNameFile: str = ""
    customPaths: Dict[str, str] = field(default_factory=dict)
    gbtScoreConvertStrategy: str = "RAW"  # RAW | SIGMOID | CUTOFF | MAXMIN_SCALE
    # display units for bucket thresholds in EvalPerformance / gain
    # charts (EvalConfig.java:51 default 1000; ConfusionMatrix.java:290)
    scoreScale: int = 1000
    _extras: Dict[str, Any] = field(default_factory=dict, repr=False)

    # gbtConvertToProb stays OUT of KNOWN: it is read above but kept
    # in _extras so legacy configs round-trip with the field intact
    KNOWN = ["name", "dataSet", "performanceBucketNum",
             "performanceScoreSelector", "scoreMetaColumnNameFile",
             "customPaths", "gbtScoreConvertStrategy", "scoreScale"]

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "EvalConfig":
        d = d or {}
        strategy = d.get("gbtScoreConvertStrategy")
        if strategy is None and d.get("gbtConvertToProb") is not None:
            # pre-0.11 legacy bool (EvalConfig.java:64-73): true meant
            # sigmoid conversion; only honored when the newer strategy
            # field is absent
            strategy = "SIGMOID" if d["gbtConvertToProb"] else "RAW"
        o = cls(
            name=d.get("name", "Eval1"),
            dataSet=ModelSourceDataConf.from_dict(d.get("dataSet")),
            performanceBucketNum=int(d.get("performanceBucketNum", 10)),
            performanceScoreSelector=str(d.get("performanceScoreSelector", "mean")),
            scoreMetaColumnNameFile=d.get("scoreMetaColumnNameFile", "") or "",
            customPaths=d.get("customPaths") or {},
            gbtScoreConvertStrategy=str(strategy or "RAW"),
            scoreScale=int(d.get("scoreScale", 1000) or 1000),
        )
        _extras_roundtrip(o, d, cls.KNOWN)
        return o

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "dataSet": self.dataSet.to_dict(),
                "performanceBucketNum": self.performanceBucketNum,
                "performanceScoreSelector": self.performanceScoreSelector,
                "scoreMetaColumnNameFile": self.scoreMetaColumnNameFile,
                "customPaths": self.customPaths,
                "gbtScoreConvertStrategy": self.gbtScoreConvertStrategy,
                "scoreScale": self.scoreScale,
                **self._extras}


# ---------------------------------------------------------------------------
# Root
# ---------------------------------------------------------------------------

@dataclass
class ModelConfig:
    """Root config — `container/obj/ModelConfig.java:59-103`."""
    basic: ModelBasicConf = field(default_factory=ModelBasicConf)
    dataSet: ModelSourceDataConf = field(default_factory=ModelSourceDataConf)
    stats: ModelStatsConf = field(default_factory=ModelStatsConf)
    varSelect: ModelVarSelectConf = field(default_factory=ModelVarSelectConf)
    normalize: ModelNormalizeConf = field(default_factory=ModelNormalizeConf)
    train: ModelTrainConf = field(default_factory=ModelTrainConf)
    evals: List[EvalConfig] = field(default_factory=list)
    _extras: Dict[str, Any] = field(default_factory=dict, repr=False)
    _base_dir: str = field(default="", repr=False)  # dir ModelConfig.json was loaded from

    KNOWN = ["basic", "dataSet", "stats", "varSelect", "normalize", "train",
             "evals"]

    # -- construction -------------------------------------------------------

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        o = cls(
            basic=ModelBasicConf.from_dict(d.get("basic")),
            dataSet=ModelSourceDataConf.from_dict(d.get("dataSet")),
            stats=ModelStatsConf.from_dict(d.get("stats")),
            varSelect=ModelVarSelectConf.from_dict(d.get("varSelect")),
            normalize=ModelNormalizeConf.from_dict(d.get("normalize")),
            train=ModelTrainConf.from_dict(d.get("train")),
            evals=[EvalConfig.from_dict(e) for e in (d.get("evals") or [])],
        )
        _extras_roundtrip(o, d, cls.KNOWN)
        return o

    def to_dict(self) -> Dict[str, Any]:
        return {"basic": self.basic.to_dict(), "dataSet": self.dataSet.to_dict(),
                "stats": self.stats.to_dict(),
                "varSelect": self.varSelect.to_dict(),
                "normalize": self.normalize.to_dict(),
                "train": self.train.to_dict(),
                "evals": [e.to_dict() for e in self.evals], **self._extras}

    @classmethod
    def load(cls, path: str) -> "ModelConfig":
        """Load ModelConfig.json (accepts a dir containing one)."""
        if os.path.isdir(path):
            path = os.path.join(path, "ModelConfig.json")
        with open(path) as f:
            o = cls.from_dict(json.load(f))
        o._base_dir = os.path.dirname(os.path.abspath(path))
        return o

    def save(self, path: str) -> None:
        from shifu_tpu_torch.fileio import atomic_write
        if os.path.isdir(path):
            path = os.path.join(path, "ModelConfig.json")
        with atomic_write(path) as f:
            json.dump(self.to_dict(), f, indent=2)
            f.write("\n")

    # -- convenience accessors (mirror ModelConfig.java getters) ------------

    @property
    def model_set_name(self) -> str:
        return self.basic.name

    @property
    def algorithm(self) -> Algorithm:
        return self.train.algorithm

    @property
    def is_classification(self) -> bool:
        return bool(self.dataSet.posTags or self.dataSet.negTags)

    @property
    def is_regression(self) -> bool:
        """Reference calls binary-tag modeling 'regression'
        (ModelBasicConf); multi-class is 'classification'."""
        return len(self.pos_tags) > 0 and len(self.neg_tags) > 0

    @property
    def is_multi_task(self) -> bool:
        return isinstance(self.dataSet.targetColumnName, str) and \
            "|" in self.dataSet.targetColumnName

    @property
    def class_tags(self) -> List[str]:
        """Flattened class list for multi-class modeling: posTags then
        negTags, preserving order (`CommonUtils.flattenTags` /
        `ModelConfig.getFlattenTags`). Class index = position here."""
        return self.pos_tags + self.neg_tags

    @property
    def is_multi_classification(self) -> bool:
        """>2 distinct tags → multi-class (the reference's
        isClassification with multiple tags; decomposition strategy in
        `train#multiClassifyMethod`, ModelTrainConf.java:74-90)."""
        return len(self.class_tags) > 2

    @property
    def pos_tags(self) -> List[str]:
        return [str(t) for t in self.dataSet.posTags]

    @property
    def neg_tags(self) -> List[str]:
        return [str(t) for t in self.dataSet.negTags]

    def resolve_path(self, p: str) -> str:
        """Resolve a config-relative path against the model-set dir.
        Scheme'd remote paths (hdfs://, s3://, gs://, memory://) pass
        through untouched (fs/ShifuFileUtils SourceType dispatch)."""
        if not p:
            return p
        from shifu_tpu_torch.fileio import has_scheme
        if has_scheme(p):
            return p
        if os.path.isabs(p):
            return p
        base = self._base_dir or os.getcwd()
        cand = os.path.join(base, p)
        if os.path.exists(cand):
            return cand
        return os.path.normpath(cand)

    def column_names_from_file(self, p: str) -> List[str]:
        """Read a one-name-per-line column list (meta/categorical/forceselect
        files; `CommonUtils.readConfNamesAsList`). '#' comments allowed."""
        if not p:
            return []
        rp = self.resolve_path(p)
        if not os.path.exists(rp):
            return []
        names = []
        with open(rp) as f:
            for line in f:
                s = line.strip()
                if s and not s.startswith("#"):
                    names.append(s)
        return names
