"""ModelRunner — the embeddable scoring API (no pipeline required).

The port of `shifu_tpu/eval/model_runner.py` (`core/ModelRunner.java`):
a ModelRunner owns ModelConfig + ColumnConfig + the model specs, and
scores raw records (dicts, lists, delimited strings, or a whole `Table`
of string columns in place of the JAX package's DataFrame) through the
same normalize and scoring path as the pipeline, on `device` (the card
by default; raises without one).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from shifu_tpu_torch.config.column_config import (ColumnConfig,
                                                  load_column_configs)
from shifu_tpu_torch.config.model_config import ModelConfig
from shifu_tpu_torch.data.dataset import build_columnar
from shifu_tpu_torch.data.reader import Table
from shifu_tpu_torch.eval.scorer import Scorer
from shifu_tpu_torch.processor import norm as norm_proc


class CaseScoreResult:
    """`container/CaseScoreResult.java` — per-record ensemble scores."""

    def __init__(self, scores: Dict[str, float]):
        self.scores = scores

    @property
    def avg_score(self) -> float:
        return self.scores["mean"]

    @property
    def max_score(self) -> float:
        return self.scores["max"]

    @property
    def min_score(self) -> float:
        return self.scores["min"]

    @property
    def median_score(self) -> float:
        return self.scores["median"]

    def model_score(self, i: int) -> float:
        return self.scores[f"model{i}"]


class ModelRunner:
    def __init__(self, model_config: ModelConfig,
                 column_configs: List[ColumnConfig],
                 models_dir: str,
                 score_selector: str = "mean",
                 device: "str | torch.device" = "cuda"):
        self.mc = model_config
        self.ccs = column_configs
        self.cols = norm_proc.selected_candidates(column_configs)
        self.scorer = Scorer.from_dir(models_dir,
                                      score_selector=score_selector,
                                      device=device)
        self.header = [c.columnName for c in
                       sorted(column_configs, key=lambda c: c.columnNum)]

    @classmethod
    def from_model_set(cls, model_set_dir: str, **kw) -> "ModelRunner":
        mc = ModelConfig.load(model_set_dir)
        ccs = load_column_configs(os.path.join(model_set_dir,
                                               "ColumnConfig.json"))
        return cls(mc, ccs, os.path.join(model_set_dir, "models"), **kw)

    # -- batch path ---------------------------------------------------------

    def score_frame(self, table: Table) -> Dict[str, np.ndarray]:
        """Score a raw `Table` (columns by name, values as strings;
        missing columns are treated as all-missing)."""
        n = len(table)
        cols = {c: np.asarray(table[c]).astype(str) for c in table.columns}
        for c in self.cols:
            cols.setdefault(c.columnName, np.full(n, "", dtype="<U1"))
        dset = build_columnar(
            self.mc, norm_proc._restrict(self.ccs, self.cols),
            Table(cols, n),
            vocabs={c.columnNum: (c.columnBinning.binCategory or [])
                    for c in self.cols if c.is_categorical})
        result = norm_proc.normalize_columns(self.mc, self.cols, dset,
                                             device=self.scorer.device)
        return self.scorer.score(
            result.dense, result.index if result.index.size else None,
            raw_dense=dset.numeric, raw_codes=dset.cleaned_codes())

    # -- single-record path (ModelRunner.compute) ---------------------------

    def compute(self, record: Union[Dict[str, str], Sequence[str], str]
                ) -> CaseScoreResult:
        """Score one raw record: a name→value map, an ordered value
        list, or a delimited string (`ModelRunner.compute(Map)` /
        `compute(String)`)."""
        if isinstance(record, str):
            record = record.split(self.mc.dataSet.dataDelimiter or "|")
        if isinstance(record, (list, tuple)):
            record = dict(zip(self.header, [str(v) for v in record]))
        # target is irrelevant for scoring; fill a neg tag so the row is
        # not dropped by the invalid-tag filter
        tgt = self.mc.dataSet.targetColumnName.split("|")[0].split("::")[-1]
        if not record.get(tgt) and self.mc.neg_tags:
            record = dict(record, **{tgt: self.mc.neg_tags[0]})
        table = Table({k: np.asarray([str(v)]) for k, v in record.items()})
        scores = self.score_frame(table)
        return CaseScoreResult({k: float(v[0]) for k, v in scores.items()})
