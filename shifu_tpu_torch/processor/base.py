"""Shared processor lifecycle — the port's copy of `ProcessorContext`
from `shifu_tpu/processor/base.py` (`load`, `validate`,
`save_column_configs`, `require_columns`).

The `step_guard` completion manifests are not ported yet (ROADMAP A8):
a step of the port always runs, and its outputs are written through
`fileio.atomic_write` / `atomic_path`.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import List

from shifu_tpu_torch.config.column_config import (ColumnConfig,
                                                  load_column_configs,
                                                  save_column_configs)
from shifu_tpu_torch.config.inspector import ModelStep, probe
from shifu_tpu_torch.config.model_config import ModelConfig
from shifu_tpu_torch.config.path_finder import PathFinder

log = logging.getLogger("shifu_tpu_torch")


@dataclass
class ProcessorContext:
    model_config: ModelConfig
    column_configs: List[ColumnConfig] = field(default_factory=list)
    path_finder: PathFinder = None  # type: ignore[assignment]

    @classmethod
    def load(cls, model_set_dir: str, need_columns: bool = True
             ) -> "ProcessorContext":
        mc = ModelConfig.load(model_set_dir)
        pf = PathFinder(mc, root=model_set_dir if os.path.isdir(model_set_dir)
                        else os.path.dirname(model_set_dir))
        ccs: List[ColumnConfig] = []
        cc_path = pf.column_config_path()
        if need_columns and os.path.exists(cc_path):
            ccs = load_column_configs(cc_path)
        return cls(model_config=mc, column_configs=ccs, path_finder=pf)

    def validate(self, step: ModelStep) -> None:
        res = probe(self.model_config, step)
        for w in res.warnings:
            log.warning("config: %s", w)
        if not res.status:
            raise ValueError(
                f"ModelConfig validation failed for step {step.value}: "
                + "; ".join(res.causes))

    def save_column_configs(self) -> None:
        save_column_configs(self.column_configs,
                            self.path_finder.column_config_path())

    def require_columns(self) -> None:
        if not self.column_configs:
            raise FileNotFoundError(
                f"ColumnConfig.json not found under {self.path_finder.root}; "
                "run `init` first")
