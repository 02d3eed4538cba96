"""Port parity for the dense branch of `train` (NN, LR, SVM, TENSORFLOW)
and the multi-class eval paths that score what it trains.

Synth model sets (`tests/synth.py`, a private `np.random.default_rng`
each; binary and 3-class) are made by the JAX package's init → stats →
norm and copied twice. The JAX package's `train` runs on one copy and
the port's `train --device cpu` on the other. `jax.random` and torch
generators differ, so the port is handed the JAX package's initial
parameters through pytest's `monkeypatch` (its `processor.train`'s
`train_nn` gets the JAX `vmap(init_params)` of the same seed; its
`nn.init_params`, which continuous growth draws, the JAX draw of the
same key); nothing of the JAX package is edited.

Gates (f32, small widths, ≤ 8 epochs; see test_torch_trainer.py for why
1e-5 holds): every saved model file has the JAX file's kind and meta
and its arrays within 1e-5 of each array's largest entry;
tmp/valerr.json's best epochs equal and best errors within 1e-5; the
JAX package's `load_model` reads the port's files and its `Scorer`
scores them as the port's does (within 1e-6). Grid search (list-valued
params and a gridConfigFile), k-fold, continuous training (resume,
growth with FixedLayers, and the shrink error), NATIVE and ONEVSALL.
Multi-class `eval -run`, `-score` and `-audit` of the same model files
against the JAX package's outputs (`chip_smoke.compare_multiclass_eval`:
class scores within 1e-6, the same predictions, the C×C matrix and
accuracy equal to the printed digit); `-confmat`/`-perf` refuse a
multi-class set, as the JAX package does. The refusals that name their
ROADMAP item (CheckpointInterval and the supervised restarts, A8) and
the card default; trainOnDisk and WDL train now, held in
`test_torch_streaming.py` and `test_torch_wdl_mtl.py`.
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
from shifu_tpu.models import nn as jnn
from shifu_tpu_torch import cli

NN = {"NumHiddenLayers": 1, "ActivationFunc": ["tanh"],
      "NumHiddenNodes": [6], "LearningRate": 0.1, "Propagation": "ADAM"}


def _edit(root, fn):
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as f:
        mc = json.load(f)
    fn(mc)
    with open(path, "w") as f:
        json.dump(mc, f, indent=2)


def _made(tmp_dir, seed, n_classes, method="NATIVE"):
    from shifu_tpu.processor import init, norm, stats
    from shifu_tpu.processor.base import ProcessorContext
    from tests.synth import make_model_set
    root = make_model_set(tmp_dir, np.random.default_rng(seed), n_rows=700,
                          n_classes=n_classes, multi_classify=method)

    def cut(mc):
        mc["train"]["numTrainEpochs"] = 8
        mc["train"]["baggingNum"] = 2
        mc["train"]["baggingWithReplacement"] = True
        mc["train"]["baggingSampleRate"] = 0.9
    _edit(root, cut)
    for proc in (init, stats, norm):
        assert proc.run(ProcessorContext.load(root)) == 0
    return root


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    made = {}

    def get(key):
        if key not in made:
            n_classes = 2 if key == "binary" else 3
            made[key] = _made(tmp_path_factory.mktemp(key),
                              {"binary": 60, "NATIVE": 61,
                               "ONEVSALL": 62}[key], n_classes, key
                              if n_classes > 2 else "NATIVE")
        return made[key]
    return get


def pair(src, tmp_path, edit=None):
    """Two copies of a model set (JAX, port) whose configs point at
    their own files, each edited by `edit`."""
    out = []
    for side in ("jax", "port"):
        dst = str(tmp_path / side)
        shutil.copytree(src, dst)
        path = os.path.join(dst, "ModelConfig.json")
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(text.replace(src, dst))
        if edit is not None:
            _edit(dst, edit)
        out.append(dst)
    return out


def _jspec(spec):
    return jnn.MLPSpec(**dataclasses.asdict(spec))


@pytest.fixture
def jax_init(monkeypatch):
    """The port trains from the JAX package's initial params."""
    from shifu_tpu_torch.processor import train as tproc
    orig = tproc.train_nn

    def train_nn(conf, x, y, w, seed=12306, spec=None, init_params=None,
                 **kw):
        if init_params is None:
            keys = jax.random.split(jax.random.PRNGKey(seed),
                                    max(conf.baggingNum, 1) + 1)
            init_params = jax.tree.map(np.asarray, jax.vmap(
                lambda k: jnn.init_params(_jspec(spec), k))(keys[:-1]))
        return orig(conf, x, y, w, seed=seed, spec=spec,
                    init_params=init_params, **kw)

    def init_params(spec, generator):
        key = jax.random.PRNGKey(generator.initial_seed())
        return [{k: torch.tensor(np.asarray(v)) for k, v in layer.items()}
                for layer in jnn.init_params(_jspec(spec), key)]

    monkeypatch.setattr(tproc, "train_nn", train_nn)
    monkeypatch.setattr(tproc.nn_mod, "init_params", init_params)


def jax_train(root):
    from shifu_tpu.processor import train
    from shifu_tpu.processor.base import ProcessorContext
    assert train.run(ProcessorContext.load(root)) == 0


def port(root, *args, capsys=None):
    assert cli.main(["--dir", root, *args, "--device", "cpu"]) == 0
    if capsys is not None:
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _rel(got, want, rel, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def same_models(jroot, proot, rel=1e-5):
    """Model files and valerr.json of the two sides; returns the port's
    model paths."""
    from shifu_tpu.models.spec import list_models as jlist
    from shifu_tpu.models.spec import load_model as jload
    from shifu_tpu_torch.models.spec import list_models, load_model
    want = jlist(os.path.join(jroot, "models"))
    got = list_models(os.path.join(proot, "models"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        gk, gm, gp = load_model(g)
        wk, wm, wp = jload(w)
        assert (gk, gm) == (wk, wm)
        assert jload(g)[0] == gk        # the JAX package reads the file
        for gl, wl in zip(gp, wp):
            for k in wl:
                _rel(gl[k], wl[k], rel, f"{os.path.basename(g)} {k}")
    with open(os.path.join(jroot, "tmp", "valerr.json")) as f:
        jv = json.load(f)
    with open(os.path.join(proot, "tmp", "valerr.json")) as f:
        pv = json.load(f)
    assert pv["bestEpoch"] == jv["bestEpoch"]
    _rel(pv["bestValError"], jv["bestValError"], rel, "bestValError")
    assert pv.get("classes") == jv.get("classes")
    return got


@pytest.mark.parametrize("alg", ["NN", "LR", "SVM", "TENSORFLOW"])
def test_dense_algorithms_match_jax(sets, tmp_path, capsys, jax_init, alg):
    from shifu_tpu.eval.scorer import Scorer as JScorer
    from shifu_tpu_torch.eval.scorer import Scorer

    def conf(mc):
        mc["train"]["algorithm"] = alg
        mc["train"]["params"] = dict(NN, Propagation="B" if alg == "SVM"
                                     else "ADAM",
                                     RegularizedConstant=0.001)
    jroot, proot = pair(sets("binary"), tmp_path, conf)
    jax_train(jroot)
    line = port(proot, "train", capsys=capsys)
    assert line["algorithm"] == alg and line["device"] == "cpu"
    assert line["bags"] == 2 and line["epochs"] == 8 and line["rows"] > 0
    assert len(line["best_epoch"]) == 2
    paths = same_models(jroot, proot)
    assert all(p.endswith(".nn" if alg in ("NN", "TENSORFLOW") else ".lr")
               for p in paths)
    data = np.load(os.path.join(proot, "tmp", "NormalizedData",
                                "data.npz"))
    dense = data["dense"][:100].astype(np.float32)
    want = JScorer(paths).score(dense)
    got = Scorer(paths, device="cpu").score(dense)
    for k in ("model0", "model1", "mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)


def test_grid_search_and_grid_config_file_match_jax(sets, tmp_path,
                                                    jax_init):
    def grid(mc):
        mc["train"]["params"] = dict(NN, LearningRate=[0.2, 0.02])
    jroot, proot = pair(sets("binary"), tmp_path / "list", grid)
    jax_train(jroot)
    port(proot, "train")
    same_models(jroot, proot)
    grid_file = tmp_path / "grid.conf"
    grid_file.write_text("# axes\nNumHiddenNodes:4,7\nPropagation:M\n")

    def from_file(mc):
        mc["train"]["params"] = dict(NN)
        mc["train"]["gridConfigFile"] = str(grid_file)
    jroot, proot = pair(sets("binary"), tmp_path / "file", from_file)
    jax_train(jroot)
    port(proot, "train")
    same_models(jroot, proot)


def test_parse_grid_config_file_matches_jax(tmp_path):
    from shifu_tpu.train.grid_search import parse_grid_config_file as jparse
    from shifu_tpu_torch.train.grid_search import parse_grid_config_file
    p = tmp_path / "g.conf"
    p.write_text("LearningRate: 0.1, 0.01\n\n# c\nNumHiddenNodes:10,20\n"
                 "Propagation:Q,ADAM\nbad line\n")
    assert parse_grid_config_file(str(p)) == jparse(str(p))


def test_kfold_matches_jax(sets, tmp_path, jax_init):
    def kfold(mc):
        mc["train"]["numKFold"] = 3
        mc["train"]["baggingNum"] = 1
    jroot, proot = pair(sets("binary"), tmp_path, kfold)
    jax_train(jroot)
    port(proot, "train")
    same_models(jroot, proot)


def test_continuous_training_resumes_grows_and_refuses_to_shrink(
        sets, tmp_path, jax_init):
    def first(mc):
        mc["train"]["baggingNum"] = 1
        mc["train"]["params"] = dict(NN)
    jroot, proot = pair(sets("binary"), tmp_path, first)
    port(proot, "train")
    shutil.copytree(os.path.join(proot, "models"),
                    os.path.join(jroot, "models"))
    for nodes, fixed in (([6], None), ([9], [1])):
        def cont(mc, nodes=nodes, fixed=fixed):
            mc["train"]["isContinuous"] = True
            mc["train"]["params"] = dict(NN, NumHiddenNodes=nodes)
            if fixed:
                mc["train"]["params"]["FixedLayers"] = fixed
        for root in (jroot, proot):
            _edit(root, cont)
        jax_train(jroot)
        port(proot, "train")
        paths = same_models(jroot, proot)
        shutil.copy(paths[0], os.path.join(jroot, "models", "model0.nn"))
    # growth with FixedLayers [1] kept the absorbed corner
    from shifu_tpu_torch.models.spec import load_model
    _, meta, params = load_model(paths[0])
    assert meta["spec"]["hidden_dims"] == [9]

    def shrink(mc):
        mc["train"]["params"] = dict(NN, NumHiddenNodes=[4])
    _edit(proot, shrink)
    with pytest.raises(ValueError, match="cannot hold"):
        port(proot, "train")


@pytest.mark.parametrize("method", ["NATIVE", "ONEVSALL"])
def test_multiclass_train_and_eval_match_jax(sets, tmp_path, capsys,
                                            jax_init, method):
    from shifu_tpu.processor import eval as jeval
    from shifu_tpu.processor.base import ProcessorContext
    jroot, proot = pair(sets(method), tmp_path)
    jax_train(jroot)
    line = port(proot, "train", capsys=capsys)
    assert line["bags"] == (3 if method == "ONEVSALL" else 2)
    paths = same_models(jroot, proot)
    if method == "ONEVSALL":
        from shifu_tpu_torch.models.spec import load_model
        assert [load_model(p)[1]["ovaClass"] for p in paths] == [0, 1, 2]
    # eval of the same model files on both sides
    shutil.rmtree(os.path.join(jroot, "models"))
    shutil.copytree(os.path.join(proot, "models"),
                    os.path.join(jroot, "models"))
    assert jeval.run(ProcessorContext.load(jroot)) == 0
    port(proot, "eval")
    out = cs.compare_multiclass_eval(proot, jroot, "Eval1", 1e-6, rows=0)
    assert out["accuracy"] > 0.5
    # -score: the same score file on its own
    score = os.path.join("evals", "Eval1", "EvalScore.csv")
    for root in (jroot, proot):
        os.remove(os.path.join(root, score))
    assert jeval.run_score(ProcessorContext.load(jroot)) == 0
    port(proot, "eval", "-score")
    cs.compare_score_csv(os.path.join(proot, score),
                         os.path.join(jroot, score), 1e-6)
    assert jeval.run_audit(ProcessorContext.load(jroot), n_records=30) == 0
    port(proot, "eval", "-audit", "-n", "30")
    audit = os.path.join("tmp", "SynthTest_Eval1_audit.data")
    cs.compare_audit(os.path.join(proot, audit),
                     os.path.join(jroot, audit), 1e-6)
    with open(os.path.join(proot, audit)) as f:
        assert f.readline().rstrip().endswith(
            "class0|class1|class2|finalScore")
    for flag in ("-confmat", "-perf"):
        with pytest.raises(ValueError, match="binary-model steps"):
            port(proot, "eval", flag)


def test_refusals_name_their_roadmap_item(sets, tmp_path, monkeypatch):
    for i, (edit, item) in enumerate((
            (lambda mc: mc["train"]["params"].update(CheckpointInterval=2),
             "A8"),)):
        root = pair(sets("binary"), tmp_path / str(i), edit)[1]
        with pytest.raises(NotImplementedError, match=item):
            port(root, "train")
    root = pair(sets("binary"), tmp_path / "plain")[1]
    monkeypatch.setenv("SHIFU_TPU_MAX_RESTARTS", "2")
    with pytest.raises(NotImplementedError, match="A8"):
        port(root, "train")
    monkeypatch.delenv("SHIFU_TPU_MAX_RESTARTS")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        cli.main(["--dir", root, "train"])
