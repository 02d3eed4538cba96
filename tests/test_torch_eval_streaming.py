"""Port parity for the streaming `eval -run` (past
SHIFU_TPU_EVAL_CHUNK_ROWS) and `ops.metrics.ScoreHistogram`, plain
PyTorch on the CPU against the JAX package's streaming eval on copies
of the same JAX-trained synth sets (a private `np.random.default_rng`
each):

- binary GBT and NN sets: EvalScore.csv equal but for the scores
  (within 1e-6 trees / 1e-5 NN, as the resident eval), the AUCs within
  1e-6 and every bucket field within the score tolerance, the
  confusion table and gain chart the same way (`chip_smoke`'s
  comparisons), scoreStatus and the streaming block equal;
- a 3-class NATIVE NN set: EvalScore.csv and the C×C confusion matrix
  equal (`chip_smoke.compare_multiclass_eval` with no moved row);
- `ScoreHistogram` merged over chunks equals the one-shot histogram and
  the JAX package's, bucket for bucket (weights that are binary
  fractions, so every float64 sum is exact).
"""

import json
import os

import numpy as np
import pytest

import chip_smoke as cs
from tests.test_torch_eval import (assert_eval_outputs, copy_set, jax_ctx,
                                   port, trained_set)


def streamed_pair(src, tmp_path, monkeypatch, chunk="64"):
    """JAX and port copies of `src`, each evaluated streaming."""
    from shifu_tpu.processor import eval as jeval
    want = copy_set(src, tmp_path / "jax")
    got = copy_set(src, tmp_path / "port")
    monkeypatch.setenv("SHIFU_TPU_EVAL_CHUNK_ROWS", chunk)
    assert jeval.run(jax_ctx(want)) == 0
    port(got, "eval")
    return want, got


def _perf(root, name="Eval1"):
    with open(os.path.join(root, "evals", name,
                           "EvalPerformance.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def binary_sets(tmp_path_factory):
    made = {}

    def get(alg):
        if alg not in made:
            made[alg] = trained_set(tmp_path_factory.mktemp(alg), alg,
                                    1300 + len(made))
        return made[alg]
    return get


@pytest.mark.parametrize("alg", ["GBT", "NN"])
def test_streaming_eval_matches_jax(binary_sets, tmp_path, monkeypatch,
                                    alg):
    want, got = streamed_pair(binary_sets(alg), tmp_path, monkeypatch)
    assert_eval_outputs(got, want, alg)
    pw, pg = _perf(want), _perf(got)
    assert pg["streaming"] == pw["streaming"]
    assert pg["streaming"]["chunks"] > 1
    for k in ("records", "posCount", "negCount"):
        assert pg["scoreStatus"][k] == pw["scoreStatus"][k], k
    for k in ("weightedPos", "weightedNeg", "maxScore", "minScore"):
        assert abs(pg["scoreStatus"][k] - pw["scoreStatus"][k]) <= \
            1e-5 * (1 + abs(pw["scoreStatus"][k])), k
    assert not [f for f in os.listdir(os.path.join(got, "evals", "Eval1"))
                if f.endswith(".bin")]


def multiclass_set(tmp_dir, seed):
    """A 3-class NATIVE NN set made and trained by the JAX package."""
    from shifu_tpu.processor import init, norm, stats, train
    from shifu_tpu.processor.base import ProcessorContext
    from tests.synth import make_model_set
    from tests.test_torch_eval import _edit
    root = make_model_set(tmp_dir, np.random.default_rng(seed), n_rows=700,
                          n_classes=3, multi_classify="NATIVE")
    _edit(root, lambda mc: mc["train"].update(numTrainEpochs=6,
                                              baggingNum=1))
    for proc in (init, stats, norm, train):
        assert proc.run(ProcessorContext.load(root)) == 0
    return root


def test_streaming_multiclass_eval_matches_jax(tmp_path, monkeypatch):
    src = multiclass_set(tmp_path / "src", 1310)
    want, got = streamed_pair(src, tmp_path, monkeypatch, chunk="50")
    out = cs.compare_multiclass_eval(got, want, "Eval1", 1e-5, rows=0)
    assert out["moved_rows"] == 0
    with open(os.path.join(got, "evals", "Eval1",
                           "EvalConfusionMatrix.csv")) as a, \
            open(os.path.join(want, "evals", "Eval1",
                              "EvalConfusionMatrix.csv")) as b:
        assert a.read() == b.read()


def _chunks(seed, n=20_000, parts=5):
    rng = np.random.default_rng(seed)
    s = rng.uniform(-0.2, 1.3, n).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.float64)
    w = rng.choice([0.5, 1.0, 1.5, 2.0], n)
    cuts = np.linspace(0, n, parts + 1).astype(int)
    return s, y, w, list(zip(cuts[:-1], cuts[1:]))


def test_score_histogram_merges_chunks_like_one_shot():
    from shifu_tpu.ops.metrics import ScoreHistogram as JHist
    from shifu_tpu_torch.ops.metrics import ScoreHistogram
    s, y, w, parts = _chunks(1320)
    lo, hi = float(s.min()), float(s.max())
    one = ScoreHistogram(lo, hi, device="cpu")
    one.add(s, y, w)
    merged = ScoreHistogram(lo, hi, device="cpu")
    for a, b in parts:
        part = ScoreHistogram(lo, hi, device="cpu")
        part.add(s[a:b], y[a:b], w[a:b])
        merged.merge(part)
    ref = JHist(lo, hi)
    for a, b in parts:
        ref.add(s[a:b], y[a:b], w[a:b])
    want = np.stack([ref.tp, ref.fp, ref.wtp, ref.wfp])
    np.testing.assert_array_equal(merged.sums.numpy(), one.sums.numpy())
    np.testing.assert_array_equal(merged.sums.numpy(), want)
    assert merged.performance_result(10, 1000.0) == \
        ref.performance_result(10, 1000.0)
    np.testing.assert_array_equal(merged.confusion_table(),
                                  ref.confusion_table())


# ---------------------------------------------------------------------------
# C-port-5: the AUC gate's allowance for pairs the scores' own
# differences can reorder (`chip_smoke.auc_allowance`, `perf_allowance`)
# ---------------------------------------------------------------------------

def _aucs(s, y, w):
    from shifu_tpu_torch.ops.metrics import performance_result
    p = performance_result(s, y, w, device="cpu")
    return {k: p[k] for k in cs.AUCS} | {"pr": [], "roc": [], "gains": []}


def _near_tie_pair(seed, n=4000, delta=5.25e-6):
    """A near-random reference (AUC ≈ 0.55) whose scores pack into a
    narrow band, and a twin at most `delta` away that swaps every
    (positive, negative) pair planted closer than `delta`."""
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.45).astype(np.float64)
    w = rng.choice([0.5, 1.0, 2.0], n)
    ref = np.round(0.5 + 0.002 * rng.normal(0, 1, n) + 0.0002 * y, 6)
    # planted near-ties: positives just below a negative
    neg = np.flatnonzero(y == 0)[:300]
    posi = np.flatnonzero(y == 1)[:300]
    ref[posi] = ref[neg] - 2e-6
    twin = ref.copy()
    twin[posi] += delta            # each planted pair swaps its order
    return ref, twin, y, w, delta


def test_auc_allowance_admits_near_tie_reorders(tmp_path):
    ref, twin, y, w, delta = _near_tie_pair(1330)
    a, b = _aucs(twin, y, w), _aucs(ref, y, w)
    counts = (0, 0, 0.0, 0.0, 1.0)
    auc_err = max(abs(a[k] - b[k]) for k in cs.AUCS)
    assert auc_err > 1e-6      # the bare gate would fail
    with pytest.raises(AssertionError):
        cs.compare_perf(a, b, 1e-5, counts, 1000.0, auc_tol=1e-6)
    # the allowance read from the reference's EvalScore.csv
    path = tmp_path / "EvalScore.csv"
    with open(path, "w") as f:
        f.write("tag,weight,mean\n")
        for yi, wi, si in zip(y, w, ref):
            f.write(f"{int(yi)},{wi:.6g},{si:.6f}\n")
    allow = cs.perf_allowance(str(path), {}, delta)
    assert all(allow[k] >= abs(a[k] - b[k]) - 1e-6 for k in cs.AUCS)
    err, edges = cs.compare_perf(a, b, 1e-5, counts, 1000.0, auc_tol=1e-6,
                                 allowance=allow)
    assert err == auc_err and edges == 0
    # the same allowance by brute force over every pair
    pos, negm = y > 0.5, y < 0.5
    near = np.abs(ref[pos][:, None] - ref[negm][None, :]) \
        <= 2 * (delta + 1e-6)
    unit, weighted = cs.auc_allowance(ref, y, w, delta + 1e-6, 0.0)
    assert unit == pytest.approx(near.mean(), rel=1e-12)
    wp, wn = w[pos], w[negm]
    assert weighted == pytest.approx(
        (wp[:, None] * wn[None, :] * near).sum() / (wp.sum() * wn.sum()),
        rel=1e-9)


def test_auc_allowance_still_fails_a_real_shift(tmp_path):
    ref, twin, y, w, delta = _near_tie_pair(1331)
    b = _aucs(ref, y, w)
    a = dict(_aucs(twin, y, w))
    unit, weighted = cs.auc_allowance(ref, y, w, delta + 1e-6, 0.0)
    allow = {"areaUnderRoc": unit, "areaUnderPr": unit,
             "weightedAreaUnderRoc": weighted}
    # a shift the scores' differences cannot explain
    a["areaUnderRoc"] = b["areaUnderRoc"] + 2 * unit + 1e-3
    with pytest.raises(AssertionError):
        cs.compare_perf(a, b, 1e-5, (0, 0, 0.0, 0.0, 1.0), 1000.0,
                        auc_tol=1e-6, allowance=allow)
    # and a twin whose scores really moved (every positive down) fails
    moved = ref - 0.003 * (y > 0.5)
    with pytest.raises(AssertionError):
        cs.compare_perf(_aucs(moved, y, w), b, 1e-5,
                        (0, 0, 0.0, 0.0, 1.0), 1000.0, auc_tol=1e-6,
                        allowance=allow)


@pytest.mark.parametrize("beta", [0.0, 1e-6])
def test_auc_allowance_is_zero_without_close_pairs(beta):
    rng = np.random.default_rng(1332)
    n = 500
    y = (np.arange(n) % 2).astype(np.float64)
    s = np.arange(n) * 0.01 + rng.uniform(0, 1e-4, n)   # ≥ 0.0099 apart
    w = rng.choice([0.5, 1.0], n)
    assert cs.auc_allowance(s, y, w, 1e-5, beta) == (0.0, 0.0)
    assert cs.auc_allowance(s, y, w, 0.006, beta)[0] > 0.0
