"""Port parity for `eval` and the embeddable `ModelRunner`.

Synth model sets (`tests/synth.py`, a private `np.random.default_rng`
each) are made and trained by the JAX package on the CPU: NN over a
ZSCALE set with no categorical column (so both packages may take the
fused normalize + first-layer route, K1), LR with categorical columns,
GBT and RF. Each test copies a trained set twice and runs the JAX
package's eval on one copy and the port's `eval --device cpu` on the
other, then holds every output against the JAX package's with
`chip_smoke`'s comparisons (the same ones the card run uses):

- EvalScore.csv: header, tag and weight columns identical, scores
  within 1e-6 (trees) or 1e-5 (NN/LR);
- EvalPerformance.json: the AUCs within 1e-6, every bucket field
  within the score tolerance (binLowestScore times scoreScale) or one
  row's share where a tie group straddles a bucket edge; scoreStatus
  equal but for the max/min score;
- EvalConfusionMatrix.csv and gainchart.csv the same way; gainchart.html
  equal around its embedded points;
- the NN against both JAX routes: the default XLA route over the dense
  block and SHIFU_TPU_SCORE_FUSED=pallas (the Pallas kernel, interpreted
  on the CPU);
- `-score`, `-confmat`, `-perf`, `-norm` (EvalNorm.csv within 1e-6),
  `-audit` (line for line, scores within 1e-6), a champion score
  column, and `-new` / `-list` / `-delete`;
- an eval set's `customPaths.modelsPath` models join the ensemble;
- `-norm` and `-score` read in chunks equal the resident run byte for
  byte; the streaming `eval`, binary and multi-class, raises and names
  ROADMAP A6 (the resident multi-class paths are held in
  `test_torch_train_dense.py`).
"""

import json
import os
import shutil

import numpy as np
import pytest

import chip_smoke as cs
from shifu_tpu_torch import cli

TREES = {"GBT": {"TreeNum": 4, "MaxDepth": 3, "LearningRate": 0.3,
                 "Loss": "log"},
         "RF": {"TreeNum": 5, "MaxDepth": 4,
                "FeatureSubsetStrategy": "TWOTHIRDS"}}
SETS = {
    "NN": dict(algorithm="NN", train_params={
        "NumHiddenLayers": 1, "ActivationFunc": ["tanh"],
        "NumHiddenNodes": [8], "LearningRate": 0.1,
        "Propagation": "ADAM"}),
    "LR": dict(algorithm="LR", train_params={"LearningRate": 0.1,
                                             "Propagation": "ADAM"}),
    "GBT": dict(algorithm="GBT", train_params=TREES["GBT"]),
    "RF": dict(algorithm="RF", train_params=TREES["RF"]),
}
TOL = {"NN": 1e-5, "LR": 1e-5, "GBT": 1e-6, "RF": 1e-6}


def _edit(root, fn):
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as f:
        mc = json.load(f)
    fn(mc)
    with open(path, "w") as f:
        json.dump(mc, f, indent=2)


def trained_set(tmp_dir, alg, seed):
    """A synth model set made and trained by the JAX package."""
    from shifu_tpu.processor import init, norm, stats, train
    from shifu_tpu.processor.base import ProcessorContext
    from tests.synth import make_model_set
    root = make_model_set(tmp_dir, np.random.default_rng(seed),
                          n_rows=1000, **SETS[alg])

    def cut(mc):
        mc["train"]["numTrainEpochs"] = 10
        if alg == "NN":   # no categorical column: the z-score route
            meta = os.path.join(root, "columns", "meta.column.names")
            with open(meta, "w") as f:
                f.write("rowid\ncat_0\ncat_1\n")
            mc["dataSet"]["categoricalColumnNameFile"] = ""
    _edit(root, cut)
    for proc in (init, stats, norm, train):
        assert proc.run(ProcessorContext.load(root)) == 0
    return root


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    made = {}

    def get(alg):
        if alg not in made:
            made[alg] = trained_set(tmp_path_factory.mktemp(alg), alg,
                                    90 + list(SETS).index(alg))
        return made[alg]
    return get


def copy_set(src, dst):
    """A copy of a model set whose config points at the copy's files."""
    shutil.copytree(src, dst)
    path = os.path.join(dst, "ModelConfig.json")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace(src, str(dst)))
    return str(dst)


def jax_ctx(root):
    from shifu_tpu.processor.base import ProcessorContext
    return ProcessorContext.load(root)


def port(root, *args, capsys=None):
    assert cli.main(["--dir", root, *args, "--device", "cpu"]) == 0
    if capsys is not None:
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return None


def assert_html(a_root, b_root, name, tol, counts):
    pages = []
    for root in (a_root, b_root):
        with open(os.path.join(root, "evals", name, "gainchart.html")) as f:
            text = f.read()
        head, _, rest = text.partition("const PERF = ")
        blob, _, tail = rest.partition(";\n")
        pages.append((head, json.loads(blob), tail))
    assert pages[0][0] == pages[1][0] and pages[0][2] == pages[1][2]
    cs.compare_perf(pages[0][1], pages[1][1], tol, counts, 1000.0)


def assert_eval_outputs(got_root, want_root, alg, name="Eval1"):
    tol = TOL[alg]
    out = cs.compare_eval_dir(got_root, want_root, name, tol)
    assert out["auc_err"] <= 1e-6, out
    counts = cs.score_counts(os.path.join(want_root, "evals", name,
                                          "EvalScore.csv"))
    assert_html(got_root, want_root, name, tol, counts)
    return out


@pytest.mark.parametrize("alg", list(SETS))
def test_eval_matches_jax(sets, tmp_path, capsys, monkeypatch, alg):
    from shifu_tpu.processor import eval as jeval
    from shifu_tpu_torch.ops import fused_score
    root = sets(alg)
    want = copy_set(root, tmp_path / "jax")
    got = copy_set(root, tmp_path / "port")
    assert jeval.run(jax_ctx(want)) == 0
    fused = []
    real = fused_score.score_nn
    monkeypatch.setattr(fused_score, "score_nn",
                        lambda *a, **k: fused.append(1) or real(*a, **k))
    line = port(got, "eval", capsys=capsys)
    assert line["step"] == "eval" and line["device"] == "cpu"
    assert line["rows"] == 200
    assert 0 < line["score_seconds"] <= line["seconds"]
    assert line["launches"] == {"fused_score": 0, "fused_trees": 0}
    assert bool(fused) == (alg == "NN"), "K1's route on the z-score set"
    out = assert_eval_outputs(got, want, alg)
    print(f"{alg}: {out}")
    if alg == "NN":
        # the JAX package's Pallas route (interpreted here) for the same
        # fused first layer
        monkeypatch.setenv("SHIFU_TPU_SCORE_FUSED", "pallas")
        pallas = copy_set(root, tmp_path / "jax_pallas")
        assert jeval.run(jax_ctx(pallas)) == 0
        assert_eval_outputs(got, pallas, alg)


def _champion(mc):
    ec = mc["evals"][0]
    path = os.path.join(os.path.dirname(mc["dataSet"]["dataPath"]),
                        "columns", "Eval1Score.meta.column.names")
    with open(path, "w") as f:
        f.write("wgt\n")
    ec["scoreMetaColumnNameFile"] = path


@pytest.mark.parametrize("alg", ["GBT", "NN"])
def test_eval_split_steps_match_jax(sets, tmp_path, alg):
    """-score, -confmat, -perf, -norm and -audit, with a champion score
    column, against the JAX steps."""
    from shifu_tpu.processor import eval as jeval
    root = sets(alg)
    want = copy_set(root, tmp_path / "jax")
    got = copy_set(root, tmp_path / "port")
    for r in (want, got):
        _edit(r, _champion)
    assert jeval.run(jax_ctx(want)) == 0
    port(got, "eval")
    assert_eval_outputs(got, want, alg)
    perf = []
    for r in (got, want):
        with open(os.path.join(r, "evals", "Eval1",
                               "EvalPerformance-wgt.json")) as f:
            perf.append(json.load(f))
    counts = cs.score_counts(os.path.join(want, "evals", "Eval1",
                                          "EvalScore.csv"))
    cs.compare_perf(perf[0], perf[1], 1e-6, counts, 1000.0)
    with open(os.path.join(got, "evals", "Eval1",
                           "EvalPerformance.json")) as f:
        assert set(json.load(f)["championAuc"]) == {"wgt"}

    for r in (want, got):
        shutil.rmtree(os.path.join(r, "evals"))
    ctx = jax_ctx(want)
    assert jeval.run_score(ctx) == 0
    assert jeval.run_confmat(jax_ctx(want)) == 0
    assert jeval.run_perf(jax_ctx(want)) == 0
    assert jeval.run_norm(jax_ctx(want)) == 0
    assert jeval.run_audit(jax_ctx(want), n_records=20) == 0
    for args in (["-score"], ["-confmat"], ["-perf"], ["-norm"],
                 ["-audit", "-n", "20"]):
        port(got, "eval", *args)
    tol = TOL[alg]
    cs.compare_eval_dir(got, want, "Eval1", tol)
    assert cs.compare_eval_norm(
        os.path.join(got, "evals", "Eval1", "EvalNorm.csv"),
        os.path.join(want, "evals", "Eval1", "EvalNorm.csv"), 1e-6) <= 1e-6
    audit = os.path.join("tmp", "SynthTest_Eval1_audit.data")
    assert cs.compare_audit(os.path.join(got, audit),
                            os.path.join(want, audit), tol) == 20


def test_eval_set_management_matches_jax(sets, tmp_path, capsys):
    from shifu_tpu.processor import eval as jeval
    root = sets("GBT")
    want = copy_set(root, tmp_path / "jax")
    got = copy_set(root, tmp_path / "port")
    assert jeval.run_new(jax_ctx(want), "Eval2") == 0
    line = port(got, "eval", "-new", "Eval2", capsys=capsys)
    assert line["step"] == "eval -new" and line["device"] == "host"

    def configs():
        out = []
        for r in (got, want):
            with open(os.path.join(r, "ModelConfig.json")) as f:
                out.append(json.loads(f.read().replace(r, "ROOT")))
        return out
    a, b = configs()
    assert a == b and [e["name"] for e in a["evals"]] == ["Eval1", "Eval2"]
    for rel in ("columns/Eval2.meta.column.names",
                "columns/Eval2Score.meta.column.names"):
        assert os.path.exists(os.path.join(got, rel))
    assert cli.main(["--dir", got, "eval", "-list"]) == 0
    assert capsys.readouterr().out.splitlines()[:2] == ["Eval1", "Eval2"]
    with pytest.raises(ValueError, match="already exists"):
        port(got, "eval", "-new", "Eval2")
    assert jeval.run_delete(jax_ctx(want), "Eval2") == 0
    port(got, "eval", "-delete", "Eval2")
    a, b = configs()
    assert a == b and [e["name"] for e in a["evals"]] == ["Eval1"]
    with pytest.raises(ValueError, match="no eval set"):
        port(got, "eval", "-delete", "Eval2")


def test_chunked_norm_and_score_equal_resident(sets, tmp_path,
                                               monkeypatch):
    root = sets("LR")
    resident = copy_set(root, tmp_path / "resident")
    chunked = copy_set(root, tmp_path / "chunked")
    for args in (["-norm"], ["-score"]):
        port(resident, "eval", *args)
    monkeypatch.setenv("SHIFU_TPU_EVAL_CHUNK_ROWS", "37")
    for args in (["-norm"], ["-score"]):
        port(chunked, "eval", *args)
    for f in ("EvalNorm.csv", "EvalScore.csv"):
        paths = [os.path.join(r, "evals", "Eval1", f)
                 for r in (resident, chunked)]
        with open(paths[0]) as a, open(paths[1]) as b:
            text = a.read()
            assert text == b.read(), f
        assert text.count("\n") == 201


def test_streaming_and_multiclass_paths_raise(sets, tmp_path, monkeypatch):
    from tests.synth import make_model_set
    root = copy_set(sets("RF"), tmp_path / "rf")
    monkeypatch.setenv("SHIFU_TPU_EVAL_CHUNK_ROWS", "37")
    with pytest.raises(NotImplementedError, match="A6"):
        port(root, "eval")
    monkeypatch.delenv("SHIFU_TPU_EVAL_CHUNK_ROWS")
    multi = make_model_set(tmp_path / "multi", np.random.default_rng(97),
                           n_rows=300, n_classes=3)
    assert cli.main(["--dir", multi, "init"]) == 0
    monkeypatch.setenv("SHIFU_TPU_EVAL_CHUNK_ROWS", "37")
    with pytest.raises(NotImplementedError, match="multi-class.*A6"):
        port(multi, "eval")


@pytest.mark.parametrize("alg", ["GBT", "NN", "LR"])
def test_model_runner_matches_jax(sets, alg):
    from shifu_tpu.data.reader import read_raw_table as jread
    from shifu_tpu.config.model_config import ModelConfig as JModelConfig
    from shifu_tpu.eval.model_runner import ModelRunner as JRunner
    from shifu_tpu_torch.data.reader import Table
    from shifu_tpu_torch.eval.model_runner import ModelRunner
    root = sets(alg)
    want = JRunner.from_model_set(root)
    got = ModelRunner.from_model_set(root, device="cpu")
    ec = JModelConfig.load(root).evals[0]
    df = jread(JModelConfig.load(root), ds=ec.dataSet).head(50)
    tol = TOL[alg]
    w = want.score_frame(df.copy())
    g = got.score_frame(Table({c: df[c].to_numpy(str) for c in df.columns}))
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=tol, atol=tol,
                                   err_msg=k)
    header = got.header
    rows = df.astype(str).to_numpy()
    for i in range(3):
        record = {h: rows[i][j] for j, h in enumerate(df.columns)}
        as_list = [record.get(h, "") for h in header]
        for rec in (record, as_list, "|".join(as_list)):
            a, b = got.compute(rec), want.compute(rec)
            assert a.scores.keys() == b.scores.keys()
            for k in b.scores:
                assert abs(a.scores[k] - b.scores[k]) <= tol, (k, rec)
            assert abs(a.avg_score - b.avg_score) <= tol
            assert abs(a.model_score(0) - b.model_score(0)) <= tol


def test_custom_paths_models_join_the_ensemble(sets, tmp_path):
    """An eval set's `customPaths.modelsPath` (a directory of spec
    files) adds its models to the ensemble, as in the JAX package."""
    from shifu_tpu.processor import eval as jeval
    root = sets("GBT")
    extra = tmp_path / "extra"
    extra.mkdir()
    shutil.copy(os.path.join(sets("RF"), "models", "model0.rf"),
                extra / "model0.rf")
    want = copy_set(root, tmp_path / "jax")
    got = copy_set(root, tmp_path / "port")

    def custom(mc):
        mc["evals"][0]["customPaths"] = {"modelsPath": str(extra)}
    for r in (want, got):
        _edit(r, custom)
    assert jeval.run(jax_ctx(want)) == 0
    port(got, "eval")
    with open(os.path.join(got, "evals", "Eval1", "EvalScore.csv")) as f:
        assert f.readline().startswith("tag,weight,model0,model1,mean")
    assert_eval_outputs(got, want, "GBT")
