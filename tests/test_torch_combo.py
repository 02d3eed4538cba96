"""The port's `combo` (`shifu_tpu_torch/processor/combo.py`) and `test`
verbs against the JAX package's: `combo -new`/`-init` write the same
bytes; GBT,RF,GBT trained in both packages gives equal sub-model trees
and an assemble AUC within its stated tolerance; NN,GBT,LR runs in the
port, `-resume` parks its sub-models as cached and rewrites the same
assemble model; `test` runs the JAX package's DAG of host checks.
"""

import json
import os
import shutil

import numpy as np
import pytest

from tests.test_torch_pipeline_dag import (SUBPROCESS_S,
                                           serialize_jax_reads,
                                           within_timeout)

TREES = {"TreeNum": 5, "MaxDepth": 3, "LearningRate": 0.2}
NN = {"NumHiddenLayers": 1, "NumHiddenNodes": [8],
      "ActivationFunc": ["tanh"], "LearningRate": 0.1,
      "Propagation": "ADAM"}
# over the same sub-models the two packages' sub-model scores agree
# within 1e-6; the assemble GBT bins them at 32 equal-interval cuts,
# where a score within 1e-6 of a cut can change its bin, so the
# assemble AUCs are held within 1e-3
AUC_TOL = 1e-3


def _sets(tmp_path, seed, n_rows, params, alg="NN"):
    """A synth set and a copy of it for each package (the copies read
    the same raw files)."""
    from tests.synth import make_model_set
    src = make_model_set(tmp_path / "src", np.random.default_rng(seed),
                         n_rows=n_rows, algorithm=alg, train_params=params)
    out = []
    for name in ("jax", "port"):
        dst = str(tmp_path / name)
        shutil.copytree(src, dst)
        out.append(dst)
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _ctxs(jroot, proot):
    from shifu_tpu.processor.base import ProcessorContext as JCtx
    from shifu_tpu_torch.processor.base import ProcessorContext as PCtx
    return JCtx.load(jroot), PCtx.load(proot)


def test_new_and_init_write_the_jax_packages_bytes(tmp_path):
    from shifu_tpu.processor import combo as jcombo
    from shifu_tpu_torch.processor import combo as pcombo
    jroot, proot = _sets(tmp_path, 601, 200, NN)
    for root, mod in ((jroot, jcombo), (proot, pcombo)):
        ctx = _ctxs(jroot, proot)[root == proot]
        assert mod.new(ctx, "NN, GBT ,LR") == 0
        assert mod.init(ctx) == 0
    assert _read(os.path.join(proot, "ComboTrain.json")) == \
        _read(os.path.join(jroot, "ComboTrain.json"))
    with open(os.path.join(proot, "ComboTrain.json")) as f:
        combo = json.load(f)
    assert [s["algorithm"] for s in combo["subModels"]] == ["NN", "GBT"]
    assert combo["assemble"] == {"name": "SynthTest_assemble_LR",
                                 "algorithm": "LR"}
    for sub in combo["subModels"]:
        assert _read(os.path.join(proot, sub["name"], "ModelConfig.json")) \
            == _read(os.path.join(jroot, sub["name"], "ModelConfig.json"))


@pytest.mark.parametrize("algs", ["NN,LR", "NN,XGB,LR", ""])
def test_bad_chains_raise_as_the_jax_package(tmp_path, algs):
    from shifu_tpu.processor import combo as jcombo
    from shifu_tpu_torch.processor import combo as pcombo
    jroot, proot = _sets(tmp_path, 602, 100, NN)
    jctx, pctx = _ctxs(jroot, proot)
    with pytest.raises(ValueError) as je:
        jcombo.new(jctx, algs)
    with pytest.raises(ValueError) as pe:
        pcombo.new(pctx, algs)
    assert str(pe.value) == str(je.value)
    from shifu_tpu_torch import cli
    with pytest.raises(ValueError):
        cli.main(["--dir", proot, "combo", "-new", algs or ","])


def _tree_file(root, name, kind):
    from shifu_tpu_torch.models.spec import load_model
    return load_model(os.path.join(root, name, "models", f"model0.{kind}"))


def test_tree_chain_matches_the_jax_package(tmp_path, capsys, monkeypatch):
    """GBT,RF,GBT: the JAX package trains each sub-model in process (its
    DAG node's body) and then its assemble (`run(resume=True)` parks
    the trained subs); the port runs its DAG of sub-model processes.
    Each sub-model's cut points are equal, then its trees; the assemble
    AUCs agree within AUC_TOL."""
    from shifu_tpu.processor import combo as jcombo
    from shifu_tpu_torch import cli
    jroot, proot = _sets(tmp_path, 603, 900, TREES, alg="GBT")
    serialize_jax_reads(monkeypatch)     # its assemble reads on a worker
    jctx, _ = _ctxs(jroot, proot)
    assert jcombo.new(jctx, "GBT,RF,GBT") == 0
    assert jcombo.init(jctx) == 0
    with open(os.path.join(jroot, "ComboTrain.json")) as f:
        combo = json.load(f)
    for sub in combo["subModels"]:
        jcombo._train_sub(os.path.join(jroot, sub["name"]))
    assert jcombo.run(_ctxs(jroot, proot)[0], resume=True) == 0
    assert jcombo.evaluate(_ctxs(jroot, proot)[0]) == 0

    for argv in (["-new", "GBT,RF,GBT"], ["-init"]):
        assert cli.main(["--dir", proot, "combo", *argv]) == 0
    capsys.readouterr()
    assert within_timeout(lambda: cli.main(
        ["--dir", proot, "combo", "-run", "--device", "cpu"]),
        SUBPROCESS_S) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["step"] == "combo -run" and line["device"] == "cpu"
    states = {r["node"]: r["state"] for r in line["dag"]["nodes"]}
    assert states == {"combo.SynthTest_GBT_0": "done",
                      "combo.SynthTest_RF_1": "done",
                      "combo.assemble": "done"}
    assert line["dag"]["max_concurrent"] == 2
    assert cli.main(["--dir", proot, "combo", "-eval", "--device",
                     "cpu"]) == 0

    for sub, kind in zip(combo["subModels"], ("gbt", "rf")):
        _, jmeta, jp = _tree_file(jroot, sub["name"], kind)
        _, pmeta, pp = _tree_file(proot, sub["name"], kind)
        assert pmeta == jmeta, sub["name"]
        for k in jp["tables"]:
            np.testing.assert_array_equal(pp["tables"][k], jp["tables"][k],
                                          err_msg=f"{sub['name']} {k}")
        got, want = pp["trees"], jp["trees"]
        # `tests/test_torch_train_tree._close`, but where the two packages
        # split a node on another candidate: the two candidates' gains
        # agree within that comparison's gain tolerance (C-port-3's tie:
        # each package's f32 histogram sums pick among near-equal gains)
        np.testing.assert_array_equal(got["is_leaf"], want["is_leaf"])
        gain_atol = 1e-5 * float(np.abs(want["gain"]).max())
        np.testing.assert_allclose(got["gain"], want["gain"], rtol=1e-5,
                                   atol=gain_atol, err_msg=sub["name"])
        np.testing.assert_allclose(got["leaf_value"], want["leaf_value"],
                                   rtol=1e-5, atol=1e-6, err_msg=sub["name"])
        on = want["feature"] >= 0
        split = on & ((got["feature"] != want["feature"])
                      | (got["bin"] != want["bin"]))
        for k in ("feature", "bin", "default_left"):
            np.testing.assert_array_equal(got[k][on & ~split],
                                          want[k][on & ~split],
                                          err_msg=f"{sub['name']} {k}")
        print(f"{sub['name']}: {int(split.sum())} node(s) split at a "
              f"gain tie: port {got['gain'][split]}, JAX "
              f"{want['gain'][split]}")
    _, _, pa = _tree_file(proot, combo["assemble"]["name"], "gbt")
    assert pa["trees"]["feature"].shape[0] == TREES["TreeNum"]
    own = _auc(proot)
    # the assemble and -eval over the JAX package's sub-models: the
    # port's `combo -run -resume` parks them and trains only the assemble
    for sub in combo["subModels"]:
        shutil.rmtree(os.path.join(proot, sub["name"]))
        shutil.copytree(os.path.join(jroot, sub["name"]),
                        os.path.join(proot, sub["name"]))
    for argv in (["-run", "-resume"], ["-eval"]):
        assert cli.main(["--dir", proot, "combo", *argv, "--device",
                         "cpu"]) == 0
    aucs = [_auc(jroot), _auc(proot)]
    print(f"assemble AUC: JAX {aucs[0]}, port {aucs[1]} (own sub-models "
          f"{own})")
    assert abs(aucs[0] - aucs[1]) <= AUC_TOL, aucs
    assert own > 0.9


def _auc(root):
    with open(os.path.join(root, "evals", "Eval1_combo",
                           "EvalPerformance.json")) as f:
        return json.load(f)["areaUnderRoc"]


def test_stacked_chain_runs_and_resumes(tmp_path, capsys):
    """NN,GBT,LR in the port (the JAX package's test of the same chain):
    the sub-model logs carry each step's JSON line, `-run -resume`
    parks both sub-models as cached and rewrites the same assemble
    model, and the assemble AUC is above 0.85."""
    from shifu_tpu_torch import cli
    _, root = _sets(tmp_path, 604, 1200, NN)
    for argv in (["-new", "NN,GBT,LR"], ["-init"]):
        assert cli.main(["--dir", root, "combo", *argv]) == 0
    with open(os.path.join(root, "ComboTrain.json")) as f:
        combo = json.load(f)
    model = os.path.join(root, combo["assemble"]["name"], "models",
                         "model0.lr")
    states = []
    for extra in ([], ["-resume"]):
        capsys.readouterr()
        assert within_timeout(lambda: cli.main(
            ["--dir", root, "combo", "-run", *extra, "--device", "cpu"]),
            SUBPROCESS_S) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        states.append({r["node"]: r["state"] for r in line["dag"]["nodes"]})
        if not extra:
            first = _read(model)
    assert states[0] == {"combo.SynthTest_NN_0": "done",
                         "combo.SynthTest_GBT_1": "done",
                         "combo.assemble": "done"}
    assert states[1] == {"combo.SynthTest_NN_0": "cached",
                         "combo.SynthTest_GBT_1": "cached",
                         "combo.assemble": "done"}
    assert _read(model) == first
    log = os.path.join(root, "tmp", "dag_logs", "combo.SynthTest_GBT_1.log")
    with open(log) as f:
        steps = [json.loads(ln) for ln in f if ln.startswith("{")]
    assert [s.get("step", "train") for s in steps] == \
        ["init", "stats", "norm", "train"]
    assert steps[-1]["algorithm"] == "GBT" and steps[-1]["device"] == "cpu"
    capsys.readouterr()
    assert cli.main(["--dir", root, "combo", "-eval", "--device",
                     "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["auc"]["Eval1"] > 0.85
    with open(os.path.join(root, "evals", "Eval1_combo",
                           "EvalPerformance.json")) as f:
        assert json.load(f)["areaUnderRoc"] == line["auc"]["Eval1"]


def test_run_before_init_raises(tmp_path):
    from shifu_tpu_torch import cli
    _, root = _sets(tmp_path, 605, 100, NN)
    with pytest.raises(FileNotFoundError, match="combo -new"):
        cli.main(["--dir", root, "combo", "-run", "--device", "cpu"])
    assert cli.main(["--dir", root, "combo", "-new", "NN,GBT,LR"]) == 0
    with pytest.raises(FileNotFoundError, match="combo -init"):
        cli.main(["--dir", root, "combo", "-run", "--device", "cpu"])


def test_test_verb_runs_the_jax_packages_dag(tmp_path, monkeypatch, capsys):
    """`test -n 50`: the port's DAG has the JAX package's node names,
    deps and states (two eval sets here), every node host-only."""
    from shifu_tpu.cli import main as jmain
    from shifu_tpu.pipeline import scheduler as jsched
    from shifu_tpu_torch import cli
    jroot, proot = _sets(tmp_path, 606, 300, NN)
    for root in (jroot, proot):
        path = os.path.join(root, "ModelConfig.json")
        with open(path) as f:
            mc = json.load(f)
        mc["evals"].append(dict(mc["evals"][0], name="Eval2"))
        with open(path, "w") as f:
            json.dump(mc, f, indent=2)
    serialize_jax_reads(monkeypatch)
    box = {}
    real = jsched.run_dag

    def capture(*a, **kw):
        box["report"] = real(*a, **kw)
        return box["report"]
    monkeypatch.setattr(jsched, "run_dag", capture)
    assert within_timeout(lambda: jmain(["--dir", jroot, "test", "-n",
                                         "50"])) == 0
    capsys.readouterr()
    assert within_timeout(lambda: cli.main(["--dir", proot, "test", "-n",
                                            "50"])) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["step"], line["device"], line["rc"]) == ("test", "host", 0)

    def shape(rep):
        return [(r["node"], r["deps"], r["state"], r["devices"])
                for r in rep["nodes"]]
    assert shape(line["dag"]) == shape(box["report"])
    assert [r["node"] for r in line["dag"]["nodes"]] == [
        "test.config", "test.filter", "test.eval.Eval1", "test.eval.Eval2",
        "test.plan"]
    assert line["dag"]["max_concurrent"] == 0
