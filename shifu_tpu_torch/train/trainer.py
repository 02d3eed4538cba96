"""The numpy half of `shifu_tpu/train/trainer.py`: `split_validation`,
`bagging_weights` and `_rescue_empty_bags`, copied op for op so the
same seed gives the same masks and multiplicities bit for bit. The NN
trainer itself comes with the NN training slice.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("shifu_tpu_torch")


def split_validation(n: int, valid_rate: float, seed: int,
                     cross_over: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Random train/valid split (`AbstractNNWorker.init` validation
    sampling). Returns boolean masks (train, valid)."""
    rng = np.random.default_rng(seed)
    is_val = rng.random(n) < valid_rate
    if valid_rate <= 0.0:
        return np.ones(n, bool), np.zeros(n, bool)
    if is_val.all():
        is_val[0] = False
    if not is_val.any():
        is_val[-1] = True
    return ~is_val, is_val


def bagging_weights(n: int, n_bags: int, sample_rate: float,
                    with_replacement: bool, seed: int,
                    labels: Optional[np.ndarray] = None,
                    stratified: bool = False,
                    neg_only: bool = False) -> np.ndarray:
    """(bags, n) per-row multiplicities: Poisson(rate) for
    with-replacement (AbstractNNWorker Poisson bagging), Bernoulli mask
    otherwise. Bag 0 of a 1-bag run sees the full data (reference runs
    the plain training as bag 0).

    `neg_only` (train.sampleNegOnly, `wdl/WDLWorker.java:431-455`):
    positive records are always kept; only negatives are sampled at
    the bagging rate. `stratified` (train.stratifiedSample,
    `nn/AbstractNNWorker.java:173,216-222` per-class bagging random
    maps): each label class contributes exactly round(rate·n_class)
    rows per bag, removing class-imbalance variance from the bags.
    The reference's fixInitialInput (hash-range sampling so resumed
    runs see identical bags) is always-on here: weights derive from a
    fixed seed, so every resume replays the same bags.
    """
    rng = np.random.default_rng(seed)
    if neg_only and stratified and labels is not None:
        log.warning("sampleNegOnly and stratifiedSample are both set: "
                    "neg-only sampling wins (every positive kept, "
                    "negatives rate-sampled); stratification is subsumed")
    if neg_only and labels is not None:
        lab = np.asarray(labels)
        # NaN labels (MTL primary-task gaps) are kept, like positives
        # (lab < 0.5 is False for NaN) — the streaming counterpart
        # (_chunk_bag_weights) mirrors this
        neg = lab < 0.5
        n_neg = int(neg.sum())
        if with_replacement:
            # Poisson bagging still applies to positives in the
            # reference (sampleNegOnly only DROPS negatives;
            # AbstractNNWorker keeps Poisson multiplicities for kept
            # rows) — force-keep clamps positives to ≥1 rather than
            # pinning them to exactly 1
            w = rng.poisson(sample_rate, size=(n_bags, n)) \
                .astype(np.float32)
            w[:, ~neg] = np.maximum(w[:, ~neg], 1.0)
        else:
            w = np.ones((n_bags, n), np.float32)
            w[:, neg] = rng.random((n_bags, n_neg)) < sample_rate
        return _rescue_empty_bags(w)
    if stratified and labels is not None:
        if sample_rate >= 1.0 and not with_replacement:
            if n_bags == 1:
                # keep-all IS the perfect stratified sample at rate 1.0
                return np.ones((1, n), np.float32)
            # N identical full-data bags are useless (same degrade as
            # the unstratified branch below) — use a BALANCED bootstrap:
            # per-class draws with replacement keep each bag's class mix
            # fixed instead of silently dropping stratification
            log.warning(
                "stratifiedSample with baggingSampleRate >= 1.0 and "
                "%d bags: using per-class balanced bootstrap (draw with "
                "replacement within each class)", n_bags)
            with_replacement = True
        lab = np.asarray(labels)
        w = np.zeros((n_bags, n), np.float32)
        valid = ~np.isnan(lab)
        for cls in np.unique(lab[valid]):
            idx = np.flatnonzero(valid & (lab == cls))
            k = max(1, int(round(sample_rate * len(idx))))
            for b in range(n_bags):
                if with_replacement:
                    np.add.at(w[b], rng.choice(idx, size=k, replace=True),
                              1.0)
                else:
                    w[b, rng.choice(idx, size=min(k, len(idx)),
                                    replace=False)] = 1.0
        nan_idx = np.flatnonzero(~valid)
        if len(nan_idx):
            # NaN labels (MTL primary-task gaps) have no class to
            # stratify into — they sample at the plain rate
            for b in range(n_bags):
                if with_replacement:
                    w[b, nan_idx] = rng.poisson(sample_rate, len(nan_idx))
                else:
                    w[b, nan_idx] = rng.random(len(nan_idx)) < sample_rate
        return _rescue_empty_bags(w)
    if n_bags == 1 and sample_rate >= 1.0 and not with_replacement:
        return np.ones((1, n), np.float32)
    if n_bags > 1 and sample_rate >= 1.0 and not with_replacement:
        # "100% sample without replacement" per bag would give every
        # bag the identical full dataset — N identical models at N×
        # cost. Degrade to Poisson(rate) resampling, which is what the
        # reference's per-bag worker actually does (AbstractNNWorker
        # Poisson bagging runs regardless of the replacement flag).
        with_replacement = True
    if with_replacement:
        w = rng.poisson(sample_rate, size=(n_bags, n)).astype(np.float32)
    else:
        w = (rng.random((n_bags, n)) < sample_rate).astype(np.float32)
    return _rescue_empty_bags(w)


def _rescue_empty_bags(w: np.ndarray) -> np.ndarray:
    """A bag with zero total weight would divide by ~0 — reset it to
    the full data (every bagging branch shares this guard)."""
    empty = w.sum(axis=1) == 0
    w[empty] = 1.0
    return w
