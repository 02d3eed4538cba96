"""The `tf` model kind in the port: `export -t tf` (a SavedModel whose
`f` is the NN/LR spec rebuilt in tf ops, `processor/export.py`) and
scoring a SavedModel on the host (`eval/scorer.py`), against the JAX
package's jax2tf export and its `tf` scoring:

- each package exports the same NN (relu and sigmoid hidden layers) and
  LR, and each package scores both SavedModels, within 1e-6 of each
  other and of the JAX forward;
- every activation of `models/nn.ACTIVATIONS`, the softmax head and the
  bf16 compute dtype in the port's export, against the JAX forward;
- a SavedModel joins the eval ensemble through
  `customPaths.genericModelsPath` and scores like the native spec
  (`tests/test_cli_and_aux.py::test_generic_savedmodel_scores_in_eval`);
- a foreign single-input `serving_default` scores, a multi-input or
  multi-output one is refused with the JAX package's messages;
- without tensorflow (``sys.modules["tensorflow"] = None``) both the
  export and the scoring raise the JAX package's gating errors, and a
  GBT set or a set with no models is refused as the JAX package does.

Every generator is a private `np.random.default_rng(seed)` (C-ref-1).
"""

import csv
import os
import shutil
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from shifu_tpu.eval import scorer as jscorer  # noqa: E402
from shifu_tpu.models import nn as jnn  # noqa: E402
from shifu_tpu.models.spec import load_model as jload_model  # noqa: E402
from shifu_tpu.processor import export as jexport  # noqa: E402
from shifu_tpu.processor.base import ProcessorContext as JContext  # noqa
from shifu_tpu_torch import cli  # noqa: E402
from shifu_tpu_torch.eval import scorer  # noqa: E402
from shifu_tpu_torch.models.spec import load_model, save_model  # noqa
from tests.test_torch_stats import make_sets, run_port  # noqa: E402

IN = 7


def _spec(hidden, acts, out=1, head="sigmoid", dtype="float32"):
    return {"input_dim": IN, "hidden_dims": list(hidden),
            "activations": list(acts), "output_dim": out,
            "output_activation": head, "compute_dtype": dtype}


def _params(rng, spec):
    dims = [spec["input_dim"]] + spec["hidden_dims"] + [spec["output_dim"]]
    return [{"w": rng.normal(0, 0.6, (a, b)).astype(np.float32),
             "b": rng.normal(0, 0.2, b).astype(np.float32)}
            for a, b in zip(dims[:-1], dims[1:])]


@pytest.fixture(scope="module")
def base_set(tmp_path_factory):
    """A synth set through the port's `init` and `stats` (ColumnConfig
    is all `export` needs besides the models)."""
    _, port = make_sets(tmp_path_factory.mktemp("tf"), 301, n_rows=300)
    run_port(port, ("init", "stats"))
    return port


def _set_with(base_set, dst, kind, spec, params):
    shutil.copytree(base_set, dst)
    save_model(os.path.join(dst, "models", f"model0.{kind}"), kind,
               {"spec": spec}, params)
    return str(dst)


def _forward(spec, params, x):
    s = dict(spec, hidden_dims=tuple(spec["hidden_dims"]),
             activations=tuple(spec["activations"]))
    return np.asarray(jnn.forward(jnn.MLPSpec(**s), params, x))


def _rows(seed):
    return np.random.default_rng(seed).normal(0, 1.5, (33, IN)) \
        .astype(np.float32)


CASES = {
    "nn_relu": ("nn", _spec((6, 5), ("relu", "relu"))),
    "nn_sigmoid": ("nn", _spec((6,), ("sigmoid",))),
    "lr": ("lr", _spec((), ())),
}


@pytest.mark.parametrize("case", list(CASES))
def test_each_package_scores_both_exports(base_set, tmp_path, case):
    kind, spec = CASES[case]
    params = _params(np.random.default_rng(302 + list(CASES).index(case)),
                     spec)
    port = _set_with(base_set, tmp_path / "port", kind, spec, params)
    jax_root = str(tmp_path / "jax")
    shutil.copytree(port, jax_root)
    assert cli.main(["--dir", port, "export", "-t", "tf",
                     "--device", "cpu"]) == 0
    assert jexport.run(JContext.load(jax_root), "tf") == 0
    x = _rows(303)
    want = _forward(spec, params, x)
    paths = [os.path.join(r, "tfmodel") for r in (port, jax_root)]
    for p in paths:
        assert load_model(p) == jload_model(p) == ("tf", {"path": p}, None)
        got = scorer.score_matrix("tf", {"path": p}, p, x)
        jgot = jscorer.score_matrix("tf", {"path": p}, None, x)
        assert got.shape == jgot.shape == (len(x),)
        np.testing.assert_allclose(got, jgot, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


ACTS = ("sigmoid", "tanh", "relu", "leakyrelu", "swish", "gaussian", "log",
        "sin", "linear", "ptanh")


@pytest.mark.parametrize("variant", list(ACTS) + ["softmax", "bfloat16"])
def test_export_holds_every_activation_head_and_dtype(base_set, tmp_path,
                                                      variant):
    if variant == "softmax":
        spec = _spec((6,), ("tanh",), out=3, head="softmax")
    elif variant == "bfloat16":
        spec = _spec((6, 4), ("relu", "swish"), dtype="bfloat16")
    else:
        spec = _spec((6, 4), (variant, variant), head=variant)
    params = _params(np.random.default_rng(310), spec)
    root = _set_with(base_set, tmp_path / "set", "nn", spec, params)
    assert cli.main(["--dir", root, "export", "-t", "tf",
                     "--device", "cpu"]) == 0
    mod = tf.saved_model.load(os.path.join(root, "tfmodel"))
    x = _rows(311)
    got = mod.f(tf.constant(x)).numpy()
    want = _forward(spec, params, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(Exception):
        mod.f(tf.constant(np.zeros((2, IN + 1), np.float32)))


def test_generic_savedmodel_scores_in_eval(tmp_path):
    """The port's own SavedModel export joins the eval ensemble through
    customPaths.genericModelsPath, its scores the native spec's within
    1e-5, column for column."""
    import json
    _, port = make_sets(tmp_path, 320, n_rows=600)
    run_port(port, ("init", "stats", "norm", "train"))
    assert cli.main(["--dir", port, "export", "-t", "tf",
                     "--device", "cpu"]) == 0
    path = os.path.join(port, "ModelConfig.json")
    with open(path) as f:
        mc = json.load(f)
    mc["evals"][0]["customPaths"] = {"genericModelsPath": "tfmodel"}
    with open(path, "w") as f:
        json.dump(mc, f)
    assert cli.main(["--dir", port, "eval", "--device", "cpu"]) == 0
    with open(os.path.join(port, "evals", "Eval1", "EvalScore.csv")) as f:
        rows = list(csv.DictReader(f))
    assert {"model0", "model1"} <= set(rows[0])
    a = np.array([float(r["model0"]) for r in rows])
    b = np.array([float(r["model1"]) for r in rows])
    np.testing.assert_allclose(b, a, atol=1e-5)


def _foreign(root, n_in, n_out):
    """A SavedModel with only a serving_default signature."""
    w = tf.constant(np.ones((IN, n_out), np.float32) / IN)

    class M(tf.Module):
        pass
    m = M()
    if n_in == 1:
        @tf.function(input_signature=[tf.TensorSpec([None, IN],
                                                    tf.float32)])
        def serve(x):
            return {"score": tf.matmul(x, w)}
    else:
        @tf.function(input_signature=[tf.TensorSpec([None, IN], tf.float32),
                                      tf.TensorSpec([None, IN], tf.float32)])
        def serve(x, y):
            return {"score": tf.matmul(x + y, w)}
    tf.saved_model.save(m, root, signatures={"serving_default": serve})
    return root


@pytest.mark.parametrize("n_in,n_out", [(1, 1), (2, 1), (1, 2)])
def test_foreign_savedmodel_shapes(tmp_path, n_in, n_out):
    p = _foreign(str(tmp_path / "sm"), n_in, n_out)
    x = _rows(330)
    if (n_in, n_out) == (1, 1):
        got = scorer.score_matrix("tf", {"path": p}, p, x)
        np.testing.assert_allclose(got, x.mean(1), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(
            got, jscorer.score_matrix("tf", {"path": p}, None, x))
        return
    with pytest.raises(ValueError) as e:
        scorer.score_matrix("tf", {"path": p}, p, x)
    with pytest.raises(ValueError) as j:
        jscorer.score_matrix("tf", {"path": p}, None, x)
    assert str(e.value) == str(j.value)


def test_gating_errors_without_tensorflow(base_set, tmp_path, monkeypatch):
    spec = _spec((4,), ("relu",))
    root = _set_with(base_set, tmp_path / "set", "nn", spec,
                     _params(np.random.default_rng(340), spec))
    assert cli.main(["--dir", root, "export", "-t", "tf",
                     "--device", "cpu"]) == 0
    sm = os.path.join(root, "tfmodel")
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    monkeypatch.setattr(scorer, "_TF_FN_CACHE", {})
    monkeypatch.setattr(jscorer, "_TF_FN_CACHE", {})
    with pytest.raises(NotImplementedError) as e:
        cli.main(["--dir", root, "export", "-t", "tf", "--device", "cpu"])
    with pytest.raises(NotImplementedError) as j:
        jexport.run(JContext.load(root), "tf")
    assert str(e.value) == str(j.value)
    assert "needs the optional tensorflow package" in str(e.value)
    x = _rows(341)
    with pytest.raises(NotImplementedError) as e:
        scorer.score_matrix("tf", {"path": sm}, sm, x)
    with pytest.raises(NotImplementedError) as j:
        jscorer.score_matrix("tf", {"path": sm}, None, x)
    assert str(e.value) == str(j.value)
    # a model set with a SavedModel still loads: the kind is numpy-only
    assert load_model(sm) == ("tf", {"path": sm}, None)


@pytest.mark.parametrize("case", ["gbt", "no_models"])
def test_export_refusals_match_the_jax_package(base_set, tmp_path, case):
    root = str(tmp_path / "set")
    shutil.copytree(base_set, root)
    if case == "gbt":
        save_model(os.path.join(root, "models", "model0.gbt"), "gbt", {},
                   {"trees": {"feature": np.zeros((1, 1), np.int32)}})
        err = ValueError
    else:
        shutil.rmtree(os.path.join(root, "models"), ignore_errors=True)
        err = FileNotFoundError
    with pytest.raises(err) as e:
        cli.main(["--dir", root, "export", "-t", "tf", "--device", "cpu"])
    with pytest.raises(err) as j:
        jexport.run(JContext.load(root), "tf")
    assert str(e.value) == str(j.value)
