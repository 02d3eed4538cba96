"""Shared processor lifecycle — the loading half of
`shifu_tpu/processor/base.py` (`ProcessorContext.load`,
`require_columns`, lines 35-81).

`validate()` (the `config/inspector.py` probe) and the `step_guard`
completion manifests are not ported yet; the processors of this slice
run without them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List

from shifu_tpu_torch.config.column_config import (ColumnConfig,
                                                  load_column_configs)
from shifu_tpu_torch.config.model_config import ModelConfig
from shifu_tpu_torch.config.path_finder import PathFinder


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

    def require_columns(self) -> None:
        if not self.column_configs:
            raise FileNotFoundError(
                f"ColumnConfig.json not found under {self.path_finder.root}; "
                "run `init` first")
