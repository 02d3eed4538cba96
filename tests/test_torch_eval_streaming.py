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
