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

`ScoreHistogram`, the streaming eval's mergeable histogram, is not
ported yet (ROADMAP A6).
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
