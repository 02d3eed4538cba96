"""ColumnConfig — a copy of `shifu_tpu/config/column_config.py`; only
`atomic_write` comes from `shifu_tpu_torch.fileio`. The original
docstring follows.

ColumnConfig — per-column metadata, JSON-compatible with the reference.

Mirrors `container/obj/ColumnConfig.java` + nested `ColumnBinning.java` /
`ColumnStats.java`. ColumnConfig.json is a JSON array of per-column
objects; the reference serializes ±Infinity bin boundaries as the strings
"-Infinity"/"Infinity" (Jackson default), which we parse and re-emit
identically so files round-trip between implementations.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional


class ColumnType(str, Enum):
    """`container/obj/ColumnType.java` — N(umerical), C(ategorical),
    H(ybrid: numerical with some categorical values)."""
    N = "N"
    C = "C"
    H = "H"

    @classmethod
    def parse(cls, v, default=None):
        if v is None:
            return default
        if isinstance(v, cls):
            return v
        s = str(v).strip().upper()
        return {"N": cls.N, "C": cls.C, "H": cls.H}.get(s, default)


class ColumnFlag(str, Enum):
    """`container/obj/ColumnConfig.java` ColumnFlag."""
    ForceSelect = "ForceSelect"
    ForceRemove = "ForceRemove"
    Meta = "Meta"
    Target = "Target"
    Weight = "Weight"
    Candidate = "Candidate"

    @classmethod
    def parse(cls, v):
        if v is None:
            return None
        if isinstance(v, cls):
            return v
        s = str(v).strip().lower()
        for m in cls:
            if m.value.lower() == s:
                return m
        return None


def _num(v) -> Optional[float]:
    """Parse a JSON number that may be the string '-Infinity' etc."""
    if v is None:
        return None
    if isinstance(v, str):
        s = v.strip()
        if s in ("-Infinity", "-inf"):
            return float("-inf")
        if s in ("Infinity", "inf", "+Infinity"):
            return float("inf")
        if s == "NaN":
            return float("nan")
        return float(s)
    return float(v)


def _num_out(v: Optional[float]):
    """Emit floats with Jackson-style ±Infinity strings."""
    if v is None:
        return None
    if isinstance(v, float):
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        if math.isnan(v):
            return "NaN"
    return v


@dataclass
class ColumnStats:
    """`container/obj/ColumnStats.java`."""
    max: Optional[float] = None
    min: Optional[float] = None
    mean: Optional[float] = None
    median: Optional[float] = None
    totalCount: Optional[int] = None
    distinctCount: Optional[int] = None
    missingCount: Optional[int] = None
    stdDev: Optional[float] = None
    missingPercentage: Optional[float] = None
    woe: Optional[float] = None
    ks: Optional[float] = None
    iv: Optional[float] = None
    weightedKs: Optional[float] = None
    weightedIv: Optional[float] = None
    weightedWoe: Optional[float] = None
    skewness: Optional[float] = None
    kurtosis: Optional[float] = None
    psi: Optional[float] = None
    unitStats: Optional[List[str]] = None
    validNumCount: Optional[int] = None
    p25th: Optional[float] = None
    p75th: Optional[float] = None
    _extras: Dict[str, Any] = field(default_factory=dict, repr=False)

    KNOWN = ["max", "min", "mean", "median", "totalCount", "distinctCount",
             "missingCount", "stdDev", "missingPercentage", "woe", "ks", "iv",
             "weightedKs", "weightedIv", "weightedWoe", "skewness", "kurtosis",
             "psi", "unitStats", "validNumCount", "p25th", "p75th"]

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ColumnStats":
        d = d or {}
        o = cls(
            max=_num(d.get("max")), min=_num(d.get("min")),
            mean=_num(d.get("mean")), median=_num(d.get("median")),
            totalCount=d.get("totalCount"),
            distinctCount=d.get("distinctCount"),
            missingCount=d.get("missingCount"),
            stdDev=_num(d.get("stdDev")),
            missingPercentage=_num(d.get("missingPercentage")),
            woe=_num(d.get("woe")), ks=_num(d.get("ks")), iv=_num(d.get("iv")),
            weightedKs=_num(d.get("weightedKs")),
            weightedIv=_num(d.get("weightedIv")),
            weightedWoe=_num(d.get("weightedWoe")),
            skewness=_num(d.get("skewness")), kurtosis=_num(d.get("kurtosis")),
            psi=_num(d.get("psi")), unitStats=d.get("unitStats"),
            validNumCount=d.get("validNumCount"),
            p25th=_num(d.get("p25th")), p75th=_num(d.get("p75th")),
        )
        o._extras = {k: v for k, v in d.items() if k not in cls.KNOWN}
        return o

    def to_dict(self) -> Dict[str, Any]:
        return {"max": _num_out(self.max), "min": _num_out(self.min),
                "mean": _num_out(self.mean), "median": _num_out(self.median),
                "totalCount": self.totalCount,
                "distinctCount": self.distinctCount,
                "missingCount": self.missingCount,
                "stdDev": _num_out(self.stdDev),
                "missingPercentage": _num_out(self.missingPercentage),
                "woe": _num_out(self.woe), "ks": _num_out(self.ks),
                "iv": _num_out(self.iv),
                "weightedKs": _num_out(self.weightedKs),
                "weightedIv": _num_out(self.weightedIv),
                "weightedWoe": _num_out(self.weightedWoe),
                "skewness": _num_out(self.skewness),
                "kurtosis": _num_out(self.kurtosis),
                "psi": _num_out(self.psi), "unitStats": self.unitStats,
                # emitted only when set: reference files predating these
                # fields round-trip unchanged, ours keep their values
                **({"validNumCount": self.validNumCount}
                   if self.validNumCount is not None else {}),
                **({"p25th": _num_out(self.p25th)} if self.p25th is not None else {}),
                **({"p75th": _num_out(self.p75th)} if self.p75th is not None else {}),
                **self._extras}


@dataclass
class ColumnBinning:
    """`container/obj/ColumnBinning.java`. For numerical columns
    `binBoundary` holds bin left edges (first is -Infinity); for
    categoricals `binCategory` holds category values, and the implicit
    last bin is the missing-value bin (reference convention: arrays
    carrying counts/woe have length len(bins)+1, the tail slot being the
    missing bin — see `udf/CalculateNewStatsUDF` outputs)."""
    length: int = 0
    binBoundary: Optional[List[float]] = None
    binCategory: Optional[List[str]] = None
    binCountNeg: Optional[List[int]] = None
    binCountPos: Optional[List[int]] = None
    binPosRate: Optional[List[float]] = None
    binAvgScore: Optional[List[float]] = None
    binWeightedNeg: Optional[List[float]] = None
    binWeightedPos: Optional[List[float]] = None
    binCountWoe: Optional[List[float]] = None
    binWeightedWoe: Optional[List[float]] = None
    _extras: Dict[str, Any] = field(default_factory=dict, repr=False)

    KNOWN = ["length", "binBoundary", "binCategory", "binCountNeg",
             "binCountPos", "binPosRate", "binAvgScore", "binWeightedNeg",
             "binWeightedPos", "binCountWoe", "binWeightedWoe"]

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ColumnBinning":
        d = d or {}
        bb = d.get("binBoundary")
        o = cls(
            length=int(d.get("length", 0) or 0),
            binBoundary=None if bb is None else [_num(x) for x in bb],
            binCategory=d.get("binCategory"),
            binCountNeg=d.get("binCountNeg"),
            binCountPos=d.get("binCountPos"),
            binPosRate=None if d.get("binPosRate") is None else [_num(x) for x in d["binPosRate"]],
            binAvgScore=d.get("binAvgScore"),
            binWeightedNeg=d.get("binWeightedNeg"),
            binWeightedPos=d.get("binWeightedPos"),
            binCountWoe=None if d.get("binCountWoe") is None else [_num(x) for x in d["binCountWoe"]],
            binWeightedWoe=None if d.get("binWeightedWoe") is None else [_num(x) for x in d["binWeightedWoe"]],
        )
        o._extras = {k: v for k, v in d.items() if k not in cls.KNOWN}
        return o

    def to_dict(self) -> Dict[str, Any]:
        return {"length": self.length,
                "binBoundary": None if self.binBoundary is None
                else [_num_out(x) for x in self.binBoundary],
                "binCategory": self.binCategory,
                "binCountNeg": self.binCountNeg,
                "binCountPos": self.binCountPos,
                "binPosRate": self.binPosRate,
                "binAvgScore": self.binAvgScore,
                "binWeightedNeg": self.binWeightedNeg,
                "binWeightedPos": self.binWeightedPos,
                "binCountWoe": self.binCountWoe,
                "binWeightedWoe": self.binWeightedWoe, **self._extras}


@dataclass
class ColumnConfig:
    """`container/obj/ColumnConfig.java` — one column's full metadata."""
    columnNum: int = 0
    columnName: str = ""
    version: str = "0.13.0"
    columnType: Optional[ColumnType] = ColumnType.N  # None round-trips as null
    columnFlag: Optional[ColumnFlag] = None
    finalSelect: bool = False
    columnStats: ColumnStats = field(default_factory=ColumnStats)
    columnBinning: ColumnBinning = field(default_factory=ColumnBinning)
    hashSeed: Optional[int] = None
    sampleValues: Optional[List[str]] = None
    _extras: Dict[str, Any] = field(default_factory=dict, repr=False)

    KNOWN = ["columnNum", "columnName", "version", "columnType", "columnFlag",
             "finalSelect", "columnStats", "columnBinning", "hashSeed",
             "sampleValues"]

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ColumnConfig":
        o = cls(
            columnNum=int(d.get("columnNum", 0)),
            columnName=d.get("columnName", ""),
            version=d.get("version", "0.13.0"),
            columnType=ColumnType.parse(d.get("columnType"), None),
            columnFlag=ColumnFlag.parse(d.get("columnFlag")),
            finalSelect=bool(d.get("finalSelect", False)),
            columnStats=ColumnStats.from_dict(d.get("columnStats")),
            columnBinning=ColumnBinning.from_dict(d.get("columnBinning")),
            hashSeed=d.get("hashSeed"),
            sampleValues=d.get("sampleValues"),
        )
        o._extras = {k: v for k, v in d.items() if k not in cls.KNOWN}
        return o

    def to_dict(self) -> Dict[str, Any]:
        return {"columnNum": self.columnNum, "columnName": self.columnName,
                "version": self.version,
                "columnType": None if self.columnType is None else self.columnType.value,
                "columnFlag": None if self.columnFlag is None else self.columnFlag.value,
                "finalSelect": self.finalSelect,
                "columnStats": self.columnStats.to_dict(),
                "columnBinning": self.columnBinning.to_dict(),
                **({"hashSeed": self.hashSeed} if self.hashSeed is not None else {}),
                **({"sampleValues": self.sampleValues}
                   if self.sampleValues is not None else {}),
                **self._extras}

    # -- predicates mirroring ColumnConfig.java -----------------------------

    @property
    def is_segment(self) -> bool:
        """Segment-expansion copy (`ColumnConfig.isSegment`); round-trips
        through _extras as the JSON `segment` property."""
        return bool(self._extras.get("segment", False))

    @property
    def is_target(self) -> bool:
        return self.columnFlag is ColumnFlag.Target

    @property
    def is_weight(self) -> bool:
        return self.columnFlag is ColumnFlag.Weight

    @property
    def is_meta(self) -> bool:
        return self.columnFlag in (ColumnFlag.Meta, ColumnFlag.Target,
                                   ColumnFlag.Weight)

    @property
    def is_force_select(self) -> bool:
        return self.columnFlag is ColumnFlag.ForceSelect

    @property
    def is_force_remove(self) -> bool:
        return self.columnFlag is ColumnFlag.ForceRemove

    @property
    def is_categorical(self) -> bool:
        return self.columnType is ColumnType.C

    @property
    def is_numerical(self) -> bool:
        return self.columnType in (ColumnType.N, ColumnType.H, None)

    @property
    def is_hybrid(self) -> bool:
        return self.columnType is ColumnType.H

    @property
    def is_candidate(self) -> bool:
        """Usable as a model input: not meta/target/weight/force-removed."""
        return not self.is_meta and not self.is_force_remove

    @property
    def bin_boundaries(self) -> List[float]:
        return self.columnBinning.binBoundary or []

    @property
    def bin_categories(self) -> List[str]:
        return self.columnBinning.binCategory or []

    @property
    def num_bins(self) -> int:
        return self.columnBinning.length or 0


# ---------------------------------------------------------------------------
# List-level IO
# ---------------------------------------------------------------------------

def load_column_configs(path: str) -> List[ColumnConfig]:
    """Load ColumnConfig.json (a JSON array; dir accepted)."""
    if os.path.isdir(path):
        path = os.path.join(path, "ColumnConfig.json")
    with open(path) as f:
        raw = json.load(f)
    return [ColumnConfig.from_dict(d) for d in raw]


def save_column_configs(configs: List[ColumnConfig], path: str) -> None:
    from shifu_tpu_torch.fileio import atomic_write
    if os.path.isdir(path):
        path = os.path.join(path, "ColumnConfig.json")
    with atomic_write(path) as f:
        json.dump([c.to_dict() for c in configs], f, indent=1)
        f.write("\n")
