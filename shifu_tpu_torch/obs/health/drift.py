"""Rolling PSI/KS drift monitors over arriving data windows —
counterpart of `shifu_tpu/obs/health/drift.py`.

The one-shot `stats -psi` (processor/psi.py) answers "how stable
was each feature across cohorts of the training table"; this module
answers the production question — "is the data arriving NOW shaped
like the data the model trained on" — incrementally, window by
window, without rerunning a batch step.

It reuses the exact batch machinery so the numbers are comparable:

- bin assignment is `ops/stats.bin_index_numeric`, on `device` (the
  card by default), over the SAME frozen training cuts
  (`build_numeric_table` on ColumnConfig binBoundary), and categorical
  codes map through the SAME pinned
  `binCategory` vocabularies (unseen category → missing bin), so a
  window's distribution lives in the training bin space;
- per-window bin counts are pure sums (the streaming-stats sufficient
  statistic), so windows merge exactly and `mean_psi_vs_global()`
  reproduces the one-shot `columnStats.psi` bit-for-bit when the
  windows are the one-shot's cohorts (the parity gate in
  tests/test_health.py; tolerance 1e-8, pure float64 host math);
- the TRAINING baseline distribution is the frozen
  binCountPos+binCountNeg from stats, so per-window drift
  (`psi_metric(window, training)`) needs no second pass over history.

`RollingDrift.observe(table)` ingests one window (a raw `Table` in
the training header layout) and returns a snapshot:
per-feature psi/ks, aggregate psi_max/psi_mean, and the features past
``SHIFU_TPU_DRIFT_THRESHOLD``. The watch loop turns snapshots into
`drift.*` metric points and `drift` events.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from shifu_tpu_torch import resolve_device
from shifu_tpu_torch.config.environment import knob_float

log = logging.getLogger("shifu_tpu_torch")


class RollingDrift:
    """Incremental per-feature drift against the frozen training bins.

    Only columns with completed stats (binBoundary/binCategory AND
    binCountPos/Neg) participate — drift against an unknown baseline
    is undefined. Missing values occupy the same trailing missing bin
    as in stats, so a missing-rate shift IS drift.
    """

    def __init__(self, ctx, device: "str | torch.device" = "cuda"):
        from shifu_tpu_torch.data.reader import simple_column_name
        from shifu_tpu_torch.ops.normalize import build_numeric_table
        from shifu_tpu_torch.processor import norm as norm_proc

        self.device = resolve_device(device)
        self.ctx = ctx
        mc = ctx.model_config
        cols = norm_proc.selected_candidates(ctx.column_configs)
        self._ccs = norm_proc._restrict(ctx.column_configs, cols)
        self.threshold = knob_float("SHIFU_TPU_DRIFT_THRESHOLD")
        self.windows_seen = 0
        self.rows_seen = 0

        def has_baseline(c):
            return bool(c.columnBinning.binCountPos) and \
                bool(c.columnBinning.binCountNeg)

        num_ccs = [c for c in cols
                   if c.is_numerical and c.bin_boundaries and has_baseline(c)]
        cat_ccs = [c for c in cols
                   if c.is_categorical and c.bin_categories
                   and has_baseline(c)]
        if not num_ccs and not cat_ccs:
            raise ValueError(
                "drift monitor needs frozen training bins — run "
                "`stats` first (no column has binBoundary/"
                "binCategory with binCountPos/Neg)")

        self.n_features = len(num_ccs) + len(cat_ccs)
        self.vocabs = {c.columnNum: list(c.bin_categories) for c in cat_ccs}
        self._num_by = {c.columnNum: c for c in num_ccs}
        self._max_bins = mc.stats.maxNumBin
        self._build_numeric_table = build_numeric_table
        self._simple = simple_column_name

        # slot layouts are fixed by the frozen bins; lazily aligned to
        # build_columnar's column order on the first window
        self._num_tbl = None
        self._num_slots = 0
        self._num_names: List[str] = []
        self._cat_slots = 0
        self._cat_names: List[str] = []
        self._vlen: Optional[np.ndarray] = None

        # training baselines + running window state, keyed by feature
        self.baseline: Dict[str, np.ndarray] = {}
        self.totals: Dict[str, np.ndarray] = {}
        self.window_counts: List[Dict[str, np.ndarray]] = []
        self._baseline_src = {c.columnName: c for c in num_ccs + cat_ccs}

    # -- baselines -----------------------------------------------------

    @staticmethod
    def _training_counts(cc, n_slots: int, missing_slot: int) -> np.ndarray:
        """binCountPos+binCountNeg → counts in the live slot layout.
        Stats stores live bins first and the missing bin LAST; the
        runtime layout keeps live bins at their index and parks
        missing at `missing_slot`."""
        pos = np.asarray(cc.columnBinning.binCountPos, np.float64)
        neg = np.asarray(cc.columnBinning.binCountNeg, np.float64)
        raw = pos + neg
        out = np.zeros(n_slots, np.float64)
        live = min(len(raw) - 1, missing_slot)
        out[:live] = raw[:live]
        out[missing_slot] = raw[-1]
        return out

    def _bind_layout(self, dset) -> None:
        """First-window alignment of frozen bins to build_columnar's
        column ordering (stable afterwards)."""
        if dset.numeric.shape[1]:
            ordered = [self._num_by[int(n)] for n in dset.num_column_nums
                       if int(n) in self._num_by]
            self._num_tbl = self._build_numeric_table(ordered,
                                                      self._max_bins)
            self._num_slots = self._num_tbl.cuts.shape[0] + 2
            self._num_names = [c.columnName for c in ordered]
            miss = self._num_slots - 1
            for c in ordered:
                self.baseline[c.columnName] = self._training_counts(
                    c, self._num_slots, miss)
        if dset.cat_codes.shape[1]:
            self._vlen = np.asarray([len(v) for v in dset.vocabs], np.int32)
            self._cat_slots = int(self._vlen.max()) + 2
            self._cat_names = list(dset.cat_names)
            cc_by_name = self._baseline_src
            for j, name in enumerate(self._cat_names):
                cc = cc_by_name.get(name)
                if cc is None:
                    continue
                self.baseline[name] = self._training_counts(
                    cc, self._cat_slots, int(self._vlen[j]))

    # -- ingestion -----------------------------------------------------

    def observe(self, df) -> Dict:
        """Ingest one window (a raw `Table` in the training header
        layout) and return the drift snapshot."""
        from shifu_tpu_torch.data.dataset import build_columnar
        from shifu_tpu_torch.ops import stats as stats_ops

        mc = self.ctx.model_config
        if mc.dataSet.filterExpressions:
            from shifu_tpu_torch.data.purifier import DataPurifier
            keep = DataPurifier(mc.dataSet.filterExpressions).apply(df)
            df = df.select(keep)
        dset = build_columnar(mc, self._ccs, df, vocabs=self.vocabs)
        if self._num_tbl is None and not self._cat_names:
            self._bind_layout(dset)

        window: Dict[str, np.ndarray] = {}
        rows = 0
        if dset.numeric.shape[1] and self._num_tbl is not None:
            rows = dset.numeric.shape[0]
            with torch.inference_mode():
                bi = stats_ops.bin_index_numeric(
                    torch.as_tensor(dset.numeric, device=self.device),
                    torch.as_tensor(self._num_tbl.cuts,
                                    device=self.device)).cpu().numpy()
            for j, name in enumerate(self._num_names):
                window[name] = np.bincount(
                    bi[:, j], minlength=self._num_slots).astype(np.float64)
        if dset.cat_codes.shape[1] and self._cat_names:
            rows = rows or dset.cat_codes.shape[0]
            codes = np.where(dset.cat_codes < 0, self._vlen[None, :],
                             dset.cat_codes)
            for j, name in enumerate(self._cat_names):
                if name not in self.baseline:
                    continue
                window[name] = np.bincount(
                    codes[:, j], minlength=self._cat_slots
                ).astype(np.float64)

        for name, counts in window.items():
            tot = self.totals.get(name)
            self.totals[name] = counts if tot is None else tot + counts
        self.window_counts.append(window)
        self.windows_seen += 1
        self.rows_seen += rows
        return self._snapshot(window, rows)

    # -- metrics -------------------------------------------------------

    def _snapshot(self, window: Dict[str, np.ndarray], rows: int) -> Dict:
        from shifu_tpu_torch.ops import stats as stats_ops
        feats: Dict[str, Dict[str, float]] = {}
        for name, counts in window.items():
            base = self.baseline.get(name)
            if base is None or counts.sum() == 0 or base.sum() == 0:
                continue
            w = counts / counts.sum()
            b = base / base.sum()
            psi = stats_ops.psi_metric(w, b)
            ks = float(np.max(np.abs(np.cumsum(w) - np.cumsum(b))))
            feats[name] = {"psi": round(psi, 6), "ks": round(ks, 6)}
        psis = [f["psi"] for f in feats.values()]
        drifted = sorted(n for n, f in feats.items()
                         if f["psi"] > self.threshold)
        return {
            "window": self.windows_seen,
            "rows": rows,
            "features": feats,
            "psi_max": round(max(psis), 6) if psis else 0.0,
            "psi_mean": round(float(np.mean(psis)), 6) if psis else 0.0,
            "ks_max": round(max((f["ks"] for f in feats.values()),
                                default=0.0), 6),
            "drifted": drifted,
        }

    def mean_psi_vs_global(self) -> Dict[str, float]:
        """The one-shot `stats -psi` statistic over the windows seen so
        far: per feature, mean over windows of psi(window_dist,
        global_dist) with global = Σ windows. When the windows are the
        one-shot's cohorts this equals `columnStats.psi` exactly
        (same counts, same float64 `psi_metric`)."""
        from shifu_tpu_torch.ops import stats as stats_ops
        out: Dict[str, float] = {}
        for name, glob in self.totals.items():
            g = glob / max(glob.sum(), 1)
            unit = []
            for win in self.window_counts:
                c = win.get(name)
                if c is None:
                    continue
                unit.append(stats_ops.psi_metric(c / max(c.sum(), 1), g))
            if unit:
                out[name] = float(np.mean(unit))
        return out
