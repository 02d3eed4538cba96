"""Evaluation metrics: AUC, confusion matrix, PR/ROC/gain curves.

The port of `shifu_tpu/ops/metrics.py` (`_sorted_cumulatives`, `auc`,
`weighted_auc`, `performance_result`, `confusion_matrix_table`) as
plain PyTorch on an explicit `device`, in float32 as the JAX package
computes them (x64 is off there). One device sort of the scores gives
the exact cumulative TP/FP curves, unit and weighted, summed in the
JAX package's f32 order (`f32_cumsum`); they come to the host in one
copy, and the bucketing for the report runs there in numpy
on that copy, exactly as the JAX package runs it on its own.

The sort is stable on the negated scores (`jnp.argsort(-scores)`), so
rows of one score keep their input order on both packages: a bucket
edge that falls inside a tie group cuts it at the same row. The rank
AUC gives a tie group its average rank, the group's rank sum over its
size in f32. The JAX package sums the ranks with an f32 `segment_sum`,
which adds them one at a time: exact while the sum stays below 2^24,
rounded past it. The port takes the exact sum in integers below 2^24
and repeats the reference's sequential f32 adds on the host past it
(`f32_sequential_sums`), so it has no scatter-add whose order could
move the result, and the card and the CPU agree on it.

`ScoreHistogram` is the streaming eval's mergeable histogram: chunks of
(score, label, weight) add into 2^20 uniform float64 buckets on
`device`, and every curve metric then derives on the host from the
buckets' cumulative TP/FP, as the JAX package's class does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

_CUM_KEYS = ("scores", "cum_tp", "cum_fp", "cum_wtp", "cum_wfp")


def _f32(a, device: "str | torch.device") -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


SCAN_BLOCK = 16


def f32_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum of a 1-D tensor in the order of the JAX
    package's `jnp.cumsum` on the CPU (XLA rewrites the reduce-window
    into blocks of 16): sequential f32 adds within each block of 16,
    the blocks' totals scanned the same way, and each block's exclusive
    prefix added once. Every step is an elementwise f32 add, so the
    result is the same bits on the card and on the CPU (`torch.cumsum`
    accumulates in double on the CPU and in a parallel order on the
    card)."""
    n = x.shape[0]
    b = SCAN_BLOCK
    m = -(-n // b)
    blocks = torch.zeros(m * b, dtype=torch.float32, device=x.device)
    blocks[:n] = x
    blocks = blocks.reshape(m, b)
    for j in range(1, min(n, b)):
        blocks[:, j] = blocks[:, j - 1] + blocks[:, j]
    if m > 1:
        totals = f32_cumsum(blocks[:, -1].clone())
        blocks[1:] = blocks[1:] + totals[:-1, None]
    return blocks.reshape(-1)[:n]


def _sorted_cumulatives(scores: torch.Tensor, labels: torch.Tensor,
                        weights: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Sort scores descending (stable: ties keep input order); return
    the sorted scores and the cumulative tp/fp, unit and weighted. All
    shapes (N,), on the inputs' device."""
    order = torch.argsort(-scores, stable=True)
    s = scores[order]
    y = labels[order]
    w = weights[order]
    return {
        "scores": s,
        "cum_tp": f32_cumsum(y),
        "cum_fp": f32_cumsum(1.0 - y),
        "cum_wtp": f32_cumsum(y * w),
        "cum_wfp": f32_cumsum((1.0 - y) * w),
    }


def host_cumulatives(scores, labels, weights,
                     device: "str | torch.device" = "cuda"
                     ) -> Dict[str, np.ndarray]:
    """`_sorted_cumulatives` on `device` over f32 copies of the inputs,
    brought to the host in one copy as float32 numpy arrays."""
    cum = _sorted_cumulatives(_f32(scores, device), _f32(labels, device),
                              _f32(weights, device))
    host = torch.stack([cum[k] for k in _CUM_KEYS]).cpu().numpy()
    return {k: host[i] for i, k in enumerate(_CUM_KEYS)}


def f32_sequential_sums(first: np.ndarray, last: np.ndarray) -> np.ndarray:
    """float32 sums first + (first + 1) + ... + last of each pair of
    int64 bounds, added one term at a time in float32 as the JAX
    package's CPU `segment_sum` adds a tie group's ranks. A group of
    more than 512 ranks takes numpy's sequential f32 `cumsum`; the
    shorter ones advance together, one term a step."""
    out = np.empty(len(first), np.float32)
    lens = last - first + 1
    for i in np.nonzero(lens > 512)[0]:
        out[i] = np.cumsum(np.arange(first[i], last[i] + 1)
                           .astype(np.float32))[-1]
    short = np.nonzero(lens <= 512)[0]
    if short.size:
        a, n = first[short], lens[short]
        acc = a.astype(np.float32)
        for k in range(1, int(n.max())):
            m = n > k
            acc[m] = acc[m] + (a[m] + k).astype(np.float32)
        out[short] = acc
    return out


def _rank_auc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    n = scores.shape[0]
    order = torch.argsort(scores, stable=True)
    s = scores[order]
    y = labels[order]
    new_grp = torch.ones(n, dtype=torch.bool, device=s.device)
    new_grp[1:] = s[1:] != s[:-1]
    gid = torch.cumsum(new_grp.to(torch.int64), 0) - 1
    first = torch.nonzero(new_grp).reshape(-1) + 1      # 1-based ranks
    last = torch.cat([first[1:] - 1,
                      torch.full((1,), n, dtype=first.dtype,
                                 device=s.device)])
    count = last - first + 1
    exact = (first + last) * count // 2
    grp_sum = exact.to(torch.float32)
    # a rank sum below 2^24 is exact in f32 whatever the order; past it
    # the reference's sequential f32 adds round, so take the same adds
    big = torch.nonzero(exact >= 1 << 24).reshape(-1)
    if big.numel():
        bounds = torch.stack([first[big], last[big]]).cpu().numpy()
        grp_sum[big] = torch.as_tensor(
            f32_sequential_sums(bounds[0], bounds[1]), device=s.device)
    avg = grp_sum / count.to(torch.float32)
    rank_pos = torch.sum(avg[gid] * y)
    npos = torch.sum(labels)
    nneg = float(n) - npos
    return (rank_pos - npos * (npos + 1) / 2.0) / torch.clamp(npos * nneg,
                                                              min=1.0)


@torch.inference_mode()
def auc(scores, labels, device: "str | torch.device" = "cuda") -> float:
    """Exact ROC AUC via the rank statistic (ties get their average
    rank), in f32 on `device`."""
    return float(_rank_auc(_f32(scores, device), _f32(labels, device)))


def _trapezoid_auc(tp: np.ndarray, fp: np.ndarray) -> float:
    tot_p, tot_n = tp[-1], fp[-1]
    if tot_p <= 0 or tot_n <= 0:
        return 0.5
    tpr = np.concatenate(([0.0], tp / tot_p))
    fpr = np.concatenate(([0.0], fp / tot_n))
    return float(np.trapezoid(tpr, fpr))


@torch.inference_mode()
def weighted_auc(scores, labels, weights,
                 device: "str | torch.device" = "cuda") -> float:
    """Weighted ROC AUC by trapezoid over the exact weighted curve."""
    cum = host_cumulatives(scores, labels, weights, device)
    return _trapezoid_auc(cum["cum_wtp"], cum["cum_wfp"])


def _bucket_rows(n: int, n_buckets: int) -> np.ndarray:
    """Sorted row indices that end each of `n_buckets` equal fractions
    of the population (duplicates merged)."""
    return np.unique(np.clip(
        (np.arange(1, n_buckets + 1) / n_buckets * n).astype(int) - 1,
        0, n - 1))


@torch.inference_mode()
def performance_result(scores, labels, weights, n_buckets: int = 10,
                       score_scale: float = 1.0,
                       device: "str | torch.device" = "cuda",
                       cum: Optional[Dict[str, np.ndarray]] = None) -> Dict:
    """Bucketed PR/ROC/gain points + summary AUCs: the JAX package's
    `PerformanceResult` dict (`pr` / `roc` / `gains` rows, unit and
    weighted, cut at equal fractions of the score-sorted population).
    `cum` is `host_cumulatives` of the same inputs, when the caller
    already holds it."""
    n = len(scores)
    if cum is None:
        cum = host_cumulatives(scores, labels, weights, device)
    tp, fp = cum["cum_tp"], cum["cum_fp"]
    wtp, wfp = cum["cum_wtp"], cum["cum_wfp"]
    s = cum["scores"]
    tot_p, tot_n = max(tp[-1], 1e-12), max(fp[-1], 1e-12)
    tot_wp, tot_wn = max(wtp[-1], 1e-12), max(wfp[-1], 1e-12)

    pr_rows, roc_rows, gain_rows = [], [], []
    for i in _bucket_rows(n, n_buckets):
        depth = (i + 1) / n
        common = {
            "binLowestScore": float(s[i]) * score_scale,
            "recall": float(tp[i] / tot_p),
            "weightedRecall": float(wtp[i] / tot_wp),
        }
        pr_rows.append({**common,
                        "precision": float(tp[i] / max(tp[i] + fp[i], 1e-12)),
                        "weightedPrecision": float(
                            wtp[i] / max(wtp[i] + wfp[i], 1e-12))})
        roc_rows.append({**common,
                         "fpr": float(fp[i] / tot_n),
                         "weightedFpr": float(wfp[i] / tot_wn)})
        gain_rows.append({**common,
                          "actionRate": depth,
                          "liftUnit": float((tp[i] / tot_p)
                                            / max(depth, 1e-12)),
                          "liftWeight": float((wtp[i] / tot_wp)
                                              / max(depth, 1e-12))})

    roc_auc = float(_rank_auc(_f32(scores, device), _f32(labels, device)))
    w_roc_auc = _trapezoid_auc(wtp, wfp)

    # PR AUC by trapezoid over the bucket points (AreaUnderCurve.ofPrChart)
    rec = np.array([r["recall"] for r in pr_rows])
    prec = np.array([r["precision"] for r in pr_rows])
    pr_auc = float(np.trapezoid(prec, rec)) if len(pr_rows) > 1 else 0.0

    return {
        "version": "tpu-0.1",
        "areaUnderRoc": roc_auc,
        "weightedAreaUnderRoc": w_roc_auc,
        "areaUnderPr": pr_auc,
        "pr": pr_rows, "roc": roc_rows, "gains": gain_rows,
    }


@torch.inference_mode()
def confusion_matrix_table(scores, labels, weights,
                           n_thresholds: int = 100,
                           device: "str | torch.device" = "cuda",
                           cum: Optional[Dict[str, np.ndarray]] = None
                           ) -> np.ndarray:
    """Threshold sweep table: rows of
    (threshold, tp, fp, tn, fn, wtp, wfp, wtn, wfn) for the
    EvalConfusionMatrix.csv export. `cum` as in `performance_result`."""
    if cum is None:
        cum = host_cumulatives(scores, labels, weights, device)
    tp, fp, wtp, wfp = (cum["cum_tp"], cum["cum_fp"], cum["cum_wtp"],
                        cum["cum_wfp"])
    tot_p, tot_n, tot_wp, tot_wn = tp[-1], fp[-1], wtp[-1], wfp[-1]
    idx = _bucket_rows(len(scores), n_thresholds)
    out = np.zeros((len(idx), 9))
    for k, i in enumerate(idx):
        out[k] = (cum["scores"][i], tp[i], fp[i], tot_n - fp[i],
                  tot_p - tp[i], wtp[i], wfp[i], tot_wn - wfp[i],
                  tot_wp - wtp[i])
    return out


class ScoreHistogram:
    """Mergeable fixed-resolution score histogram of the streaming eval
    (`shifu_tpu/ops/metrics.py` `ScoreHistogram`).

    Chunks of (score, label, weight) add into 2^20 uniform buckets over
    [lo, hi] (four float64 sums a bucket, kept on `device`); the metrics
    then derive from the buckets' cumulative TP/FP exactly as the sorted
    path derives them from the rows. That equals the exact metrics of
    scores quantized to (hi - lo) / 2^20 — about 1e-6 at a sigmoid
    score's range, the precision EvalScore.csv prints — at O(buckets)
    memory and one pass a chunk."""

    N_BUCKETS = 1 << 20

    def __init__(self, lo: float, hi: float,
                 device: "str | torch.device" = "cuda"):
        self.lo = float(lo)
        self.hi = float(hi) if hi > lo else float(lo) + 1.0
        self.device = torch.device(device)
        # unit positive / negative counts, weighted positive / negative
        self.sums = torch.zeros((4, self.N_BUCKETS), dtype=torch.float64,
                                device=self.device)

    def add(self, scores, labels, weights) -> None:
        """Add a chunk: (n,) scores, labels in {0, 1} and weights, numpy
        arrays or tensors (moved to the histogram's device)."""
        def f64(a):
            return torch.as_tensor(a).to(device=self.device,
                                         dtype=torch.float64)
        k = self.N_BUCKETS
        b = ((f64(scores) - self.lo) / (self.hi - self.lo) * k).long() \
            .clamp(0, k - 1)
        y, w = f64(labels), f64(weights)
        for row, v in enumerate((y, 1.0 - y, y * w, (1.0 - y) * w)):
            self.sums[row].index_add_(0, b, v)

    def merge(self, other: "ScoreHistogram") -> None:
        """Add another histogram over the same range."""
        if (other.lo, other.hi) != (self.lo, self.hi):
            raise ValueError("histograms over different score ranges")
        self.sums += other.sums.to(self.device)

    def _cumulatives(self) -> Dict[str, np.ndarray]:
        """Descending-score cumulative curves over the non-empty buckets
        (the shape of `_sorted_cumulatives`' output)."""
        tp, fp, wtp, wfp = self.sums.cpu().numpy()
        idx = np.nonzero((tp + fp) > 0)[0][::-1]      # high score first
        centers = self.lo + (idx + 0.5) / self.N_BUCKETS \
            * (self.hi - self.lo)
        return {"scores": centers, "cum_tp": np.cumsum(tp[idx]),
                "cum_fp": np.cumsum(fp[idx]),
                "cum_wtp": np.cumsum(wtp[idx]),
                "cum_wfp": np.cumsum(wfp[idx]),
                "bucket_n": tp[idx] + fp[idx]}

    def performance_result(self, n_buckets: int = 10,
                           score_scale: float = 1.0) -> Dict:
        """The dict of `performance_result` (bucket rows cut at equal
        population fractions, trapezoid AUCs)."""
        cum = self._cumulatives()
        if cum["scores"].size == 0:
            return {"version": "tpu-0.1", "areaUnderRoc": 0.5,
                    "weightedAreaUnderRoc": 0.5, "areaUnderPr": 0.0,
                    "pr": [], "roc": [], "gains": []}
        tp, fp = cum["cum_tp"], cum["cum_fp"]
        wtp, wfp = cum["cum_wtp"], cum["cum_wfp"]
        s = cum["scores"]
        n = tp[-1] + fp[-1]
        tot_p, tot_n = max(tp[-1], 1e-12), max(fp[-1], 1e-12)
        tot_wp, tot_wn = max(wtp[-1], 1e-12), max(wfp[-1], 1e-12)
        pop = np.cumsum(cum["bucket_n"])
        cuts = np.arange(1, n_buckets + 1) / n_buckets * n
        idx = np.unique(np.searchsorted(pop, cuts).clip(0, len(pop) - 1))
        pr_rows, roc_rows, gain_rows = [], [], []
        for i in idx:
            depth = pop[i] / n
            common = {"binLowestScore": float(s[i]) * score_scale,
                      "recall": float(tp[i] / tot_p),
                      "weightedRecall": float(wtp[i] / tot_wp)}
            pr_rows.append({**common,
                            "precision": float(tp[i] / max(tp[i] + fp[i],
                                                           1e-12)),
                            "weightedPrecision":
                                float(wtp[i] / max(wtp[i] + wfp[i],
                                                   1e-12))})
            roc_rows.append({**common, "fpr": float(fp[i] / tot_n),
                             "weightedFpr": float(wfp[i] / tot_wn)})
            gain_rows.append({**common, "actionRate": float(depth),
                              "liftUnit": float((tp[i] / tot_p)
                                                / max(depth, 1e-12)),
                              "liftWeight": float((wtp[i] / tot_wp)
                                                  / max(depth, 1e-12))})
        # trapezoid AUC over every non-empty bucket (ties grouped at the
        # bucket's resolution: the rank AUC up to quantization)
        tpr = np.concatenate(([0.0], tp / tot_p))
        fpr = np.concatenate(([0.0], fp / tot_n))
        wtpr = np.concatenate(([0.0], wtp / tot_wp))
        wfpr = np.concatenate(([0.0], wfp / tot_wn))
        rec = np.array([r["recall"] for r in pr_rows])
        prec = np.array([r["precision"] for r in pr_rows])
        pr_auc = float(np.trapezoid(prec, rec)) if len(pr_rows) > 1 else 0.0
        return {"version": "tpu-0.1",
                "areaUnderRoc": float(np.trapezoid(tpr, fpr)),
                "weightedAreaUnderRoc": float(np.trapezoid(wtpr, wfpr)),
                "areaUnderPr": pr_auc,
                "pr": pr_rows, "roc": roc_rows, "gains": gain_rows}

    def confusion_table(self, n_thresholds: int = 100) -> np.ndarray:
        """The rows of `confusion_matrix_table`."""
        cum = self._cumulatives()
        if cum["scores"].size == 0:
            return np.zeros((0, 9))
        tp, fp = cum["cum_tp"], cum["cum_fp"]
        wtp, wfp = cum["cum_wtp"], cum["cum_wfp"]
        tot_p, tot_n, tot_wp, tot_wn = tp[-1], fp[-1], wtp[-1], wfp[-1]
        n = tp[-1] + fp[-1]
        pop = np.cumsum(cum["bucket_n"])
        cuts = np.arange(1, n_thresholds + 1) / n_thresholds * n
        idx = np.unique(np.searchsorted(pop, cuts).clip(0, len(pop) - 1))
        out = np.zeros((len(idx), 9))
        for k, i in enumerate(idx):
            out[k] = (cum["scores"][i], tp[i], fp[i], tot_n - fp[i],
                      tot_p - tp[i], wtp[i], wfp[i], tot_wn - wfp[i],
                      tot_wp - wtp[i])
        return out
