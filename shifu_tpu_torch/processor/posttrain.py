"""`shifu posttrain` — bin-average scores + feature importance.

The port of `shifu_tpu/processor/posttrain.py`
(`PostTrainModelProcessor.java`): score the training data with the
trained ensemble on `device`, average the score per (column, bin) into
`columnBinning.binAvgScore`, and rank features into
`featureimportance.csv` (tree models: split counts; NN/LR: the squared
score deltas of column ablations, `varselect._sensitivity_kernel`;
WDL/MTL: the same deltas from one scoring pass a column, a dense column
zeroed or an index column set to its missing slot).

Bin score sums/counts and squared ablation deltas are pure sums, so a
raw set past the analysis trigger (`chunking.analysis_chunk_rows`) is
read in chunks (`reader.iter_raw_table`) and merges exactly. The
`step_guard` completion manifest is ROADMAP A8.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from shifu_tpu_torch import resolve_device
from shifu_tpu_torch.data.reader import iter_raw_table
from shifu_tpu_torch.eval.scorer import Scorer, score_matrix
from shifu_tpu_torch.fileio import atomic_write
from shifu_tpu_torch.ops import stats as stats_ops
from shifu_tpu_torch.ops.normalize import build_numeric_table
from shifu_tpu_torch.processor import norm as norm_proc
from shifu_tpu_torch.processor.base import ProcessorContext
from shifu_tpu_torch.processor.chunking import analysis_chunk_rows
from shifu_tpu_torch.processor.varselect import _sensitivity_kernel

log = logging.getLogger("shifu_tpu_torch")


def run(ctx: ProcessorContext, device: "str | torch.device" = "cuda",
        report: Optional[Dict[str, float]] = None) -> int:
    """`report`, when given, receives the rows scored (``rows``), the
    seconds spent reading the raw set (``read_s``) and in
    `Scorer.score` (``score_s``)."""
    ctx.require_columns()
    out = os.path.join(ctx.path_finder.root, "featureimportance.csv")
    return _run(ctx, out, resolve_device(device),
                report if report is not None else {})


def _run(ctx: ProcessorContext, out: str, dev: torch.device,
         report: Dict[str, float]) -> int:
    t0 = time.time()
    mc = ctx.model_config
    cols = norm_proc.selected_candidates(ctx.column_configs)
    chunk_rows = analysis_chunk_rows(ctx)
    if chunk_rows:
        log.info("posttrain: dataset exceeds the resident threshold — "
                 "exact accumulation in %d-row chunks", chunk_rows)
        frames = iter_raw_table(mc, chunk_rows=chunk_rows)
    else:
        frames = iter([None])   # one resident read through the same path

    scorer = Scorer.from_dir(ctx.path_finder.models_path(), device=dev)
    cc_by_num = {c.columnNum: c for c in ctx.column_configs}
    cuts = None
    # (col_num → (score sums per bin, counts per bin)) — exact merges
    bin_sums: Dict[int, np.ndarray] = {}
    bin_cnts: Dict[int, np.ndarray] = {}
    fi = _ImportanceAccumulator(scorer)
    report.update(rows=0, read_s=0.0, score_s=0.0)

    while True:
        t_read = time.perf_counter()
        df = next(frames, False)
        if df is False:
            break
        if df is None:
            df = norm_proc.read_for_columns(mc, ctx.column_configs)
        report["read_s"] += time.perf_counter() - t_read
        dset = norm_proc.load_dataset_for_columns(mc, ctx.column_configs,
                                                  cols, df=df)
        result = norm_proc.normalize_columns(mc, cols, dset, device=dev)
        raw_codes = dset.cleaned_codes()
        t_score = time.perf_counter()
        scores = scorer.score(result.dense,
                              result.index if result.index.size else None,
                              raw_dense=dset.numeric, raw_codes=raw_codes)
        report["score_s"] += time.perf_counter() - t_score
        report["rows"] += dset.num_rows
        final = scores["final"]

        if dset.numeric.shape[1]:
            if cuts is None:
                num_by = {c.columnNum: c for c in cols if c.is_numerical}
                num_ordered = [num_by[int(n)] for n in dset.num_column_nums
                               if int(n) in num_by]
                cuts = torch.as_tensor(build_numeric_table(
                    num_ordered, mc.stats.maxNumBin).cuts, device=dev)
            bi = stats_ops.bin_index_numeric(
                torch.as_tensor(dset.numeric, device=dev), cuts
            ).cpu().numpy()
            for j, cn in enumerate(dset.num_column_nums):
                k = cc_by_num[int(cn)].columnBinning.length or 1
                _add_bins(bin_sums, bin_cnts, int(cn),
                          np.minimum(bi[:, j], k), final, k)
        for j, cn in enumerate(dset.cat_column_nums):
            k = len(cc_by_num[int(cn)].columnBinning.binCategory or [])
            _add_bins(bin_sums, bin_cnts, int(cn),
                      np.minimum(raw_codes[:, j], k), final, k)
        fi.add_chunk(result)

    for cn, sums in bin_sums.items():
        cnts = bin_cnts[cn]
        cc_by_num[cn].columnBinning.binAvgScore = [
            float(s / c) if c > 0 else 0.0 for s, c in zip(sums, cnts)]

    importance = fi.finalize()
    with atomic_write(out) as f:
        f.write("column,importance\n")
        for name, v in sorted(importance.items(), key=lambda kv: -kv[1]):
            f.write(f"{name},{v:.8g}\n")

    ctx.save_column_configs()
    log.info("posttrain: binAvgScore + feature importance (%d cols) in %.2fs",
             len(importance), time.time() - t0)
    return 0


def _add_bins(bin_sums, bin_cnts, cn: int, idx: np.ndarray,
              final: np.ndarray, k: int) -> None:
    s = np.bincount(idx, weights=final, minlength=k + 1)
    c = np.bincount(idx, minlength=k + 1)
    bin_sums[cn] = bin_sums.get(cn, 0) + s
    bin_cnts[cn] = bin_cnts.get(cn, 0) + c


class _ImportanceAccumulator:
    """Tree models: split counts per feature
    (`CommonUtils.computeTreeModelFeatureImportance`) — no data needed.
    NN/LR/WDL/MTL: squared ablation-delta sums, accumulated per chunk
    and divided by the total row count at the end — identical to the
    resident mean."""

    def __init__(self, scorer: Scorer):
        self.kind, self.meta, self.model = scorer.models[0]
        self.device = scorer.device
        self.sums: Dict[str, float] = {}
        self.n = 0
    def add_chunk(self, result) -> None:
        if self.kind in ("gbt", "rf"):
            return
        if self.kind in ("wdl", "mtl"):
            self._add_ablations(result)
            return
        with torch.inference_mode():
            x = torch.as_tensor(result.dense, dtype=torch.float32,
                                device=self.device)
            base = self.model(x)
            # n_real=1 → per-column SUMS of squared deltas, mergeable
            deltas = _sensitivity_kernel(self.model, x, base,
                                         n_real=1).cpu().numpy()
        for name, d in zip(result.dense_names, deltas):
            self.sums[name] = self.sums.get(name, 0.0) + float(d)
        self.n += result.dense.shape[0]

    def _add_ablations(self, result) -> None:
        """WDL/MTL: one scoring pass a column through `score_matrix`,
        the dense column zeroed or the index column set to its missing
        slot (the JAX package's host loop)."""
        def score(d, i):
            return score_matrix(self.kind, self.meta, self.model, d, i)

        dense = result.dense
        index = result.index if result.index.size else None
        base = score(dense, index)
        for j, name in enumerate(result.dense_names):
            wiped = dense.copy()
            wiped[:, j] = 0.0
            self.sums[name] = self.sums.get(name, 0.0) \
                + float(np.sum((score(wiped, index) - base) ** 2))
        if index is not None:
            vocab_sizes = self.meta.get("indexVocabSizes") or \
                [int(index[:, j].max()) + 1 for j in range(index.shape[1])]
            for j, name in enumerate(result.index_names):
                wiped = index.copy()
                wiped[:, j] = vocab_sizes[j] - 1   # the missing slot
                self.sums[name] = self.sums.get(name, 0.0) \
                    + float(np.sum((score(dense, wiped) - base) ** 2))
        self.n += dense.shape[0]

    def finalize(self) -> Dict[str, float]:
        if self.kind in ("gbt", "rf"):
            names = self.meta["denseNames"] + self.meta["indexNames"]
            feats = self.model.trees["feature"].cpu().numpy().ravel()
            counts = np.bincount(feats[feats >= 0], minlength=len(names))
            total = max(counts.sum(), 1)
            return {n: float(c) / total for n, c in zip(names, counts)}
        n = max(self.n, 1)
        return {name: v / n for name, v in self.sums.items()}
