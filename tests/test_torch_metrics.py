"""Port parity for `ops/metrics.py` against `shifu_tpu.ops.metrics`.

The same f32 scores, labels and weights (made from a private
`np.random.default_rng(seed)`) go through both packages'
`performance_result`, `auc`, `weighted_auc` and `confusion_matrix_table`:
random scores; tree-like scores with few distinct values, whose tie
groups straddle the bucket edges and whose rank sums pass 2^24; all
positive and all negative labels; fewer rows than buckets; zero
weights. The port sums the curves in the JAX package's f32 order
(`f32_cumsum`) and sorts stably on the negated scores, so every bucket
field and every confusion row is the JAX value to the bit; the AUCs
agree within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shifu_tpu.ops import metrics as jm
from shifu_tpu_torch.ops import metrics as tm

AUCS = ("areaUnderRoc", "weightedAreaUnderRoc", "areaUnderPr")


CASES = ["random", "ties", "big_ties", "all_pos", "all_neg", "tiny",
         "zero_weights"]


def _case(name):
    rng = np.random.default_rng(1 + CASES.index(name))
    n = {"big_ties": 20000, "tiny": 7}.get(name, 2000)
    s = rng.random(n)
    if name in ("ties", "big_ties"):
        # a 10-tree ensemble of shallow trees: few distinct sums
        s = rng.integers(0, 12 if name == "ties" else 7, n) / 12.0
    y = (rng.random(n) < 0.2 + 0.6 * s).astype(np.float32)
    if name == "all_pos":
        y[:] = 1.0
    if name == "all_neg":
        y[:] = 0.0
    w = np.round(rng.uniform(0.5, 2.0, n), 4)
    if name == "zero_weights":
        w[rng.random(n) < 0.3] = 0.0
    return s.astype(np.float32), y, w.astype(np.float32)


@pytest.mark.parametrize("case", CASES)
def test_performance_result_matches_jax(case):
    s, y, w = _case(case)
    want = jm.performance_result(s, y, w, n_buckets=10, score_scale=1000.0)
    got = tm.performance_result(s, y, w, n_buckets=10, score_scale=1000.0,
                                device="cpu")
    assert set(got) == set(want)
    for k in AUCS:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    for curve in ("pr", "roc", "gains"):
        assert got[curve] == want[curve], curve
    assert got["version"] == want["version"]


@pytest.mark.parametrize("case", CASES)
def test_auc_weighted_auc_and_confusion_table_match_jax(case):
    s, y, w = _case(case)
    assert abs(tm.auc(s, y, device="cpu")
               - float(jm.auc(jnp.asarray(s), jnp.asarray(y)))) <= 1e-6
    assert abs(tm.weighted_auc(s, y, w, device="cpu")
               - jm.weighted_auc(s, y, w)) <= 1e-6
    for n_thr in (100, 3):
        got = tm.confusion_matrix_table(s, y, w, n_thresholds=n_thr,
                                        device="cpu")
        want = jm.confusion_matrix_table(s, y, w, n_thresholds=n_thr)
        np.testing.assert_array_equal(got, want)


def test_big_tie_groups_take_the_reference_f32_rank_sums():
    """Past 2^24 a tie group's rank sum rounds in the JAX package's
    sequential f32 segment sum; the exact average rank would move the
    AUC by more than the tolerance, the port's emulation does not."""
    s, y, _ = _case("big_ties")
    n = len(s)
    order = np.argsort(s, kind="stable")
    ss = s[order]
    first = np.flatnonzero(np.r_[True, ss[1:] != ss[:-1]]) + 1
    last = np.r_[first[1:] - 1, n]
    assert ((first + last) * (last - first + 1) // 2 >= 1 << 24).any()
    want = float(jm.auc(jnp.asarray(s), jnp.asarray(y)))
    assert abs(tm.auc(s, y, device="cpu") - want) <= 1e-6
    avg = np.repeat((first + last) / 2.0, last - first + 1)
    n_pos = y.sum()
    exact = ((avg * y[order]).sum() - n_pos * (n_pos + 1) / 2) \
        / (n_pos * (n - n_pos))
    assert abs(exact - want) > 1e-6


@pytest.mark.parametrize("n", [1, 5, 16, 17, 255, 256, 257, 4097, 100_003])
def test_f32_cumsum_is_jax_cumsum_bit_for_bit(n):
    rng = np.random.default_rng(n)
    x = (rng.uniform(0.5, 2.0, n) * (rng.random(n) < 0.7)).astype(np.float32)
    want = np.asarray(jax.jit(jnp.cumsum)(jnp.asarray(x)))
    np.testing.assert_array_equal(tm.f32_cumsum(torch.as_tensor(x)).numpy(),
                                  want)


def test_f32_sequential_sums_add_one_term_at_a_time():
    rng = np.random.default_rng(9)
    first = rng.integers(1, 3_000_000, 40)
    lens = np.r_[rng.integers(1, 512, 30), rng.integers(513, 5000, 10)]
    last = first + lens - 1
    got = tm.f32_sequential_sums(first, last)
    for a, b, v in zip(first, last, got):
        acc = np.float32(0)
        for r in range(a, b + 1):
            acc = np.float32(acc + np.float32(r))
        assert v == acc, (a, b, v, acc)
