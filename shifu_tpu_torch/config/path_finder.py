"""PathFinder — a copy of `shifu_tpu/config/path_finder.py`. The
original docstring follows.

PathFinder — single source of truth for every model-set path.

Mirrors `fs/PathFinder.java:38` (40+ get*Path methods). The reference
splits paths between local FS and HDFS and syncs configs between them;
here everything is one filesystem namespace (local disk or an
fsspec-able URI), so the local/HDFS duality collapses — the TPU runtime
reads straight from the model-set workspace.
"""

from __future__ import annotations

import os
from typing import Optional

from shifu_tpu_torch.config.model_config import ModelConfig


class PathFinder:
    TRAIN_DATA_DIR = "tmp/NormalizedData"
    CLEAN_DATA_DIR = "tmp/CleanedData"
    STATS_DIR = "tmp/Stats"
    MODELS_DIR = "models"
    TMP_MODELS_DIR = "tmp/modelsTmp"
    EVALS_DIR = "evals"
    VARSEL_DIR = "varsel"
    CHECKPOINT_DIR = "tmp/checkpoints"
    MANIFEST_DIR = "tmp/manifests"

    def __init__(self, model_config: ModelConfig, root: Optional[str] = None):
        self.mc = model_config
        self.root = os.path.abspath(root or model_config._base_dir or os.getcwd())

    def _p(self, *parts: str) -> str:
        return os.path.join(self.root, *parts)

    # -- configs ------------------------------------------------------------
    def model_config_path(self) -> str:
        return self._p("ModelConfig.json")

    def column_config_path(self) -> str:
        return self._p("ColumnConfig.json")

    def mtl_column_config_path(self, task_index: int) -> str:
        """`PathFinder.getMTLColumnConfigPath` — per-task ColumnConfig for
        multi-task modeling."""
        return self._p("mtlcolumnconfig", f"ColumnConfig.json.{task_index}")

    def manifest_path(self, step: str) -> str:
        """Per-step completion manifest (processor.base.step_guard)."""
        return self._p(self.MANIFEST_DIR, f"{step}.json")

    # -- data products ------------------------------------------------------
    def normalized_data_path(self) -> str:
        custom = self.mc.train.customPaths.get("normalizedDataPath") if self.mc else None
        return custom or self._p(self.TRAIN_DATA_DIR)

    def cleaned_data_path(self) -> str:
        """Tree-algorithm input (`PathFinder.getCleanedDataPath`)."""
        return self._p(self.CLEAN_DATA_DIR)

    def stats_path(self) -> str:
        return self._p(self.STATS_DIR)

    def binning_info_path(self) -> str:
        return self._p(self.STATS_DIR, "BinningInfo.json")

    def correlation_path(self) -> str:
        return self._p(self.STATS_DIR, "correlation.csv")

    def psi_path(self) -> str:
        return self._p(self.STATS_DIR, "psi.csv")

    def date_stats_path(self) -> str:
        return self._p(self.STATS_DIR, "DateStats.csv")

    # -- models -------------------------------------------------------------
    def models_path(self) -> str:
        return self._p(self.MODELS_DIR)

    def model_path(self, index: int, alg: Optional[str] = None) -> str:
        alg = (alg or self.mc.train.algorithm.value).lower()
        ext = {"nn": "nn", "lr": "lr", "gbt": "gbt", "rf": "rf", "dt": "rf",
               "wdl": "wdl", "mtl": "mtl", "svm": "svm",
               "tensorflow": "tf"}.get(alg, alg)
        return self._p(self.MODELS_DIR, f"model{index}.{ext}")

    def tmp_models_path(self) -> str:
        return self._p(self.TMP_MODELS_DIR)

    def checkpoint_path(self, bag_index: int = 0) -> str:
        return self._p(self.CHECKPOINT_DIR, f"bag{bag_index}")

    def val_error_path(self) -> str:
        return self._p("tmp", "valerr.json")

    # -- varselect ----------------------------------------------------------
    def varsel_path(self) -> str:
        return self._p(self.VARSEL_DIR)

    def se_path(self, iteration: int = 0) -> str:
        """`PathFinder.getVarSelectMSEOutputPath` — se.N sensitivity files."""
        return self._p(self.VARSEL_DIR, f"se.{iteration}")

    # -- eval ---------------------------------------------------------------
    def eval_base_path(self, eval_name: str) -> str:
        return self._p(self.EVALS_DIR, eval_name)

    def eval_score_path(self, eval_name: str) -> str:
        return self._p(self.EVALS_DIR, eval_name, "EvalScore.csv")

    def eval_norm_path(self, eval_name: str) -> str:
        return self._p(self.EVALS_DIR, eval_name, "EvalNorm.csv")

    def eval_performance_path(self, eval_name: str) -> str:
        return self._p(self.EVALS_DIR, eval_name, "EvalPerformance.json")

    def eval_confusion_path(self, eval_name: str) -> str:
        return self._p(self.EVALS_DIR, eval_name, "EvalConfusionMatrix.csv")

    def gain_chart_path(self, eval_name: str, fmt: str = "html") -> str:
        return self._p(self.EVALS_DIR, eval_name, f"gainchart.{fmt}")

    # -- export -------------------------------------------------------------
    def pmml_path(self, index: int = 0) -> str:
        return self._p("pmmls", f"{self.mc.model_set_name}{index}.pmml")

    def column_stats_export_path(self) -> str:
        return self._p("columnstats.csv")

    def ensure(self, path: str) -> str:
        """mkdir -p the parent (or the dir itself if extension-less)."""
        d = path if not os.path.splitext(path)[1] else os.path.dirname(path)
        os.makedirs(d, exist_ok=True)
        return path
