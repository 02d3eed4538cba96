"""Port parity for `varselect`.

A synth model set (`tests/synth.py`, a private `np.random.default_rng`)
gets the JAX package's `init` and `stats` once; each test copies it
twice, runs the JAX package's `varselect` on one copy and the port's
`varsel --device cpu` on the other, and holds ColumnConfig.json equal:

- every filterBy: KS, IV, MIX and PARETO (with the minIv/minKs
  thresholds), SE, ST, SC and `-r 1` (the quick NN from the JAX
  package's initial weights: se.0 deltas within 1e-5 of the largest),
  V (the population from the JAX package's initial nets: each
  generation's best validation error within 1e-5 relative) and FI
  (RF trained into the set by each package, K3/K5's plain routes here);
- the candidate pre-filters (forceSelect, forceRemove,
  missingRateThreshold) and the host edits `-reset`, `-list` and `-f`,
  with its two refusals.
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from shifu_tpu.models import nn as jnn

from shifu_tpu_torch import cli
from shifu_tpu_torch.processor import varselect as pvs


def _edit(root, fn):
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as f:
        mc = json.load(f)
    fn(mc)
    with open(path, "w") as f:
        json.dump(mc, f, indent=2)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A synth set with the JAX package's init and stats done."""
    from shifu_tpu.processor import init, stats
    from shifu_tpu.processor.base import ProcessorContext
    from tests.synth import make_model_set
    root = make_model_set(tmp_path_factory.mktemp("vs"),
                          np.random.default_rng(140), n_rows=1500)

    def cut(mc):
        mc["train"]["numTrainEpochs"] = 20
        mc["train"]["params"] = {
            "NumHiddenLayers": 1, "ActivationFunc": ["tanh"],
            "NumHiddenNodes": [6], "LearningRate": 0.1, "Propagation": "B"}
        mc["varSelect"]["filterNum"] = 4
    _edit(root, cut)
    for proc in (init, stats):
        assert proc.run(ProcessorContext.load(root)) == 0
    return root


def pair(src, tmp_path, edit=None):
    """Two copies of `src` (jax, port) whose configs point at their own
    files, `edit` applied to both."""
    out = []
    for name in ("jax", "port"):
        dst = str(tmp_path / name)
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


def jax_varsel(root, **kw):
    from shifu_tpu.processor import varselect
    from shifu_tpu.processor.base import ProcessorContext
    return varselect.run(ProcessorContext.load(root), **kw)


def port(root, *args, capsys=None):
    rc = cli.main(["--dir", root, *args, "--device", "cpu"])
    line = None
    if capsys is not None:
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return rc, line


def column_configs(root):
    with open(os.path.join(root, "ColumnConfig.json")) as f:
        return json.load(f)


def selected(root):
    return [c["columnName"] for c in column_configs(root) if c["finalSelect"]]


def assert_same(jroot, proot):
    assert column_configs(proot) == column_configs(jroot), \
        (selected(proot), selected(jroot))


def _jspec(spec):
    return jnn.MLPSpec(**dataclasses.asdict(spec))


@pytest.fixture
def jax_init(monkeypatch):
    """The port's quick NN and wrapper nets start from the JAX package's
    initial weights (`jax.random` and torch generators differ)."""
    orig = pvs.train_nn

    def train_nn(conf, x, y, w, seed=12306, spec=None, init_params=None,
                 **kw):
        from shifu_tpu_torch.models import nn as tnn
        spec = spec or tnn.MLPSpec.from_train_params(conf.params,
                                                     input_dim=x.shape[1])
        keys = jax.random.split(jax.random.PRNGKey(seed),
                                max(conf.baggingNum, 1) + 1)
        init = jax.tree.map(np.asarray, jax.vmap(
            lambda k: jnn.init_params(_jspec(spec), k))(keys[:-1]))
        return orig(conf, x, y, w, seed=seed, spec=spec, init_params=init,
                    **kw)

    def voted_init_params(spec, pop_size, seed):
        keys = jax.random.split(jax.random.PRNGKey(seed), pop_size)
        init = jax.vmap(lambda k: jnn.init_params(_jspec(spec), k))(keys)
        return [{k: torch.tensor(np.asarray(v)) for k, v in layer.items()}
                for layer in init]

    monkeypatch.setattr(pvs, "train_nn", train_nn)
    monkeypatch.setattr(pvs, "voted_init_params", voted_init_params)


@pytest.mark.parametrize("by,thresholds", [
    ("KS", {}), ("IV", {}), ("MIX", {}), ("PARETO", {}),
    ("KS", {"minIvThreshold": 0.05, "minKsThreshold": 10.0})])
def test_stats_filters_match_jax(base, tmp_path, capsys, by, thresholds):
    def conf(mc):
        mc["varSelect"].update(filterBy=by, **thresholds)
    jroot, proot = pair(base, tmp_path, conf)
    assert jax_varsel(jroot) == 0
    rc, line = port(proot, "varsel", capsys=capsys)
    assert rc == 0 and line["device"] == "host"
    assert line["filterBy"] == by and line["selected"] == len(selected(proot))
    assert_same(jroot, proot)
    assert 0 < len(selected(proot)) <= 4


def test_pre_filters_match_jax(base, tmp_path):
    """forceSelect and forceRemove files and missingRateThreshold."""
    def conf(mc):
        cols = os.path.join(os.path.dirname(mc["dataSet"]["dataPath"]),
                            "columns")
        mc["varSelect"].update(
            forceEnable=True, missingRateThreshold=0.02, filterNum=2,
            forceSelectColumnNameFile=os.path.join(cols, "fsel.names"),
            forceRemoveColumnNameFile=os.path.join(cols, "frem.names"))
    jroot, proot = pair(base, tmp_path, conf)
    for root in (jroot, proot):
        with open(os.path.join(root, "columns", "fsel.names"), "w") as f:
            f.write("num_1\n")
        with open(os.path.join(root, "columns", "frem.names"), "w") as f:
            f.write("num_0\n")
    assert jax_varsel(jroot) == 0
    assert port(proot, "varsel")[0] == 0
    assert_same(jroot, proot)
    sel = selected(proot)
    assert "num_1" in sel and "num_0" not in sel
    missing = {c["columnName"] for c in column_configs(proot)
               if (c["columnStats"].get("missingPercentage") or 0) > 0.02}
    assert missing and not (missing & set(sel)) - {"num_1"}


def test_reset_list_and_file_match_jax(base, tmp_path, capsys):
    jroot, proot = pair(base, tmp_path)
    assert jax_varsel(jroot) == 0 and port(proot, "varsel")[0] == 0
    capsys.readouterr()
    rc, line = port(proot, "varsel", "-list", capsys=None)
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1])["device"] == "host"
    assert out[:-1] == selected(proot) and len(out) > 1
    assert jax_varsel(jroot, reset=True) == 0
    assert port(proot, "varsel", "-reset")[0] == 0
    assert_same(jroot, proot)
    assert selected(proot) == []
    for root in (jroot, proot):
        with open(os.path.join(root, "pick.txt"), "w") as f:
            f.write("# chosen\nnum_2\ncat_1\nnot_a_column\n")
    assert jax_varsel(jroot, select_file="pick.txt") == 0
    assert port(proot, "varsel", "-f", "pick.txt")[0] == 0
    assert_same(jroot, proot)
    assert selected(proot) == ["num_2", "cat_1"]


@pytest.mark.parametrize("name,text", [("absent.txt", None),
                                       ("typo.txt", "NUM_2\nnope\n")])
def test_select_file_refusals_match_jax(base, tmp_path, name, text):
    jroot, proot = pair(base, tmp_path)
    for root in (jroot, proot):
        if text is not None:
            with open(os.path.join(root, name), "w") as f:
                f.write(text)
    with pytest.raises(ValueError) as want:
        jax_varsel(jroot, select_file=name)
    with pytest.raises(ValueError) as got:
        port(proot, "varsel", "-f", name)
    assert str(got.value) == str(want.value)
    assert_same(jroot, proot)


def se_deltas(root):
    with open(os.path.join(root, "varsel", "se.0")) as f:
        rows = [line.split("\t") for line in f]
    return {n: float(v) for n, v in rows}


@pytest.mark.parametrize("by,recursive", [("SE", 0), ("ST", 0), ("SC", 0),
                                          ("SE", 1)])
def test_sensitivity_filters_match_jax(base, tmp_path, capsys, jax_init, by,
                                       recursive):
    def conf(mc):
        mc["varSelect"].update(filterBy=by, filterNum=5 - recursive)
    jroot, proot = pair(base, tmp_path, conf)
    assert jax_varsel(jroot, recursive=recursive) == 0
    args = ["varsel"] + (["-r", str(recursive)] if recursive else [])
    rc, line = port(proot, *args, capsys=capsys)
    assert rc == 0 and line["device"] == "cpu" and line["rows"] == 1200
    want, got = se_deltas(jroot), se_deltas(proot)
    assert list(got) == list(want)
    scale = max(abs(v) for v in want.values())
    err = max(abs(got[k] - want[k]) for k in want) / scale
    print(f"{by} -r {recursive}: se.0 deltas within {err:.2e} of the largest")
    assert err <= 1e-5
    assert_same(jroot, proot)


def test_voted_wrapper_matches_jax(base, tmp_path, capsys, jax_init,
                                   monkeypatch):
    def conf(mc):
        mc["varSelect"].update(filterBy="V", wrapperNum=3, params={
            "population_live_size": 8, "population_multiply_cnt": 3})
    jroot, proot = pair(base, tmp_path, conf)
    from shifu_tpu.processor import varselect as jvs
    best = []
    orig = jvs.log.info

    def spy(msg, *args):
        if msg.startswith("voted wrapper gen"):
            best.append(float(args[2]))
        return orig(msg, *args)
    monkeypatch.setattr(jvs.log, "info", spy)
    assert jax_varsel(jroot) == 0
    rc, line = port(proot, "varsel", capsys=capsys)
    assert rc == 0 and len(line["generations"]) == 3 == len(best)
    np.testing.assert_allclose(line["generations"], best, rtol=1e-5)
    assert_same(jroot, proot)
    assert len(selected(proot)) == 3


@pytest.mark.parametrize("reuse", [False, True])
def test_feature_importance_matches_jax(base, tmp_path, capsys, monkeypatch,
                                        reuse):
    def conf(mc):
        mc["varSelect"].update(filterBy="FI", filterNum=3)
        mc["train"].update(algorithm="RF", params={
            "TreeNum": 3, "MaxDepth": 3, "FeatureSubsetStrategy": "ALL"})
    jroot, proot = pair(base, tmp_path, conf)
    if reuse:   # both rank the same model file, trained by the JAX package
        assert jax_varsel(jroot) == 0
        shutil.copytree(os.path.join(jroot, "models"),
                        os.path.join(proot, "models"))
        monkeypatch.setenv("shifu.varsel.reuse.model", "true")
    assert jax_varsel(jroot) == 0
    rc, line = port(proot, "varsel", capsys=capsys)
    assert rc == 0 and line["device"] == "cpu"
    assert_same(jroot, proot)
    assert len(selected(proot)) == 3
    if not reuse:
        assert line["rows"] == 1200
        assert os.path.exists(os.path.join(proot, "models", "model0.rf"))


def test_fi_refusals_and_device_default(base, tmp_path, monkeypatch):
    jroot, proot = pair(base, tmp_path, lambda mc: mc["varSelect"].update(
        filterBy="FI"))
    with pytest.raises(ValueError, match="GBT/RF"):
        port(proot, "varsel")
    _edit(proot, lambda mc: mc["varSelect"].update(filterBy="SE"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        cli.main(["--dir", proot, "varsel"])
    # host edits need no card
    assert cli.main(["--dir", proot, "varsel", "-reset"]) == 0
