"""Port parity for `export`, `pmml.py`, `portable.py` and `convert`.

Model files come from both packages: the JAX-trained synth sets of
`tests/test_torch_eval.py` (NN over ZSCALE, LR with categorical columns
over ZSCALE and the WOE families, GBT, RF), a JAX-trained 2-bag NN, and
LR / GBT sets trained by the port's `train --device cpu`. Each is
exported by both packages from the same files:

- PMML (`-t pmml`, `-t baggingpmml`): the XML string-equal to the JAX
  package's; the port's `evaluate_pmml` within 1e-6 of the JAX
  package's on the raw eval rows; `tests/pmml_external_eval.py` (the
  independent evaluator) within 1e-5 of the port's `Scorer` on the CPU;
- `columnstats`, `woemapping`, `woe` byte-equal, `bagging` with equal
  zip members (its npz stamps the write time), `portable` scores equal;
- `convert` bundles with equal contents, and the round trip;
- the UME hook's rc-3 contract and its call; `-t tf` raising (it needs
  tensorflow: not queued until tensorflow is on the card machine).
"""

import json
import os
import shutil
import xml.etree.ElementTree as ET
import zipfile

import numpy as np
import pandas as pd
import pytest

from shifu_tpu_torch import cli
from tests.test_torch_eval import copy_set, jax_ctx, sets  # noqa: F401


def _edit(root, fn):
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as f:
        mc = json.load(f)
    fn(mc)
    with open(path, "w") as f:
        json.dump(mc, f, indent=2)


def port(root, *args, capsys=None, device=True):
    rc = cli.main(["--dir", root, *args]
                  + (["--device", "cpu"] if device else []))
    if capsys is not None:
        return rc, json.loads(capsys.readouterr().out.strip()
                              .splitlines()[-1])
    return rc, None


def jax_export(root, et):
    from shifu_tpu.processor import export
    return export.run(jax_ctx(root), export_type=et)


@pytest.fixture(scope="module")
def bagged(sets, tmp_path_factory):  # noqa: F811
    """The NN set retrained by the JAX package with two bags."""
    from shifu_tpu.processor import train
    root = copy_set(sets("NN"), str(tmp_path_factory.mktemp("bag") / "b"))
    shutil.rmtree(os.path.join(root, "models"))
    _edit(root, lambda mc: mc["train"].update(baggingNum=2))
    assert train.run(jax_ctx(root)) == 0
    return root


@pytest.fixture(scope="module")
def port_trained(sets, tmp_path_factory):  # noqa: F811
    """LR and GBT sets whose model files the port's `train --device cpu`
    wrote (from the JAX package's norm outputs)."""
    out = {}
    for alg in ("LR", "GBT"):
        root = copy_set(sets(alg), str(tmp_path_factory.mktemp(alg) / "p"))
        shutil.rmtree(os.path.join(root, "models"))
        assert cli.main(["--dir", root, "train", "--device", "cpu"]) == 0
        out[alg] = root
    return out


def _set_of(which, sets, bagged, port_trained):  # noqa: F811
    if which == "bagging_nn":
        return bagged
    if which.startswith("port_"):
        return port_trained[which[5:]]
    return sets(which.split("_")[0])


def raw_eval(root):
    """The raw eval split: string columns as the file holds them."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.data.reader import read_raw_table
    mc = ModelConfig.load(root)
    return mc, read_raw_table(mc, ds=mc.evals[0].dataSet)


def records(table):
    """The PMML evaluators' records: the missing token '?' → ''."""
    return {k: np.where(table[k] == "?", "", table[k])
            for k in table.columns}


def port_scores(root, mc, table):
    """The port's `Scorer` on the CPU over the normalized eval rows."""
    from shifu_tpu_torch.config.column_config import load_column_configs
    from shifu_tpu_torch.eval.scorer import Scorer
    from shifu_tpu_torch.processor import norm as norm_proc
    ccs = load_column_configs(os.path.join(root, "ColumnConfig.json"))
    cols = norm_proc.selected_candidates(ccs)
    dset = norm_proc.load_dataset_for_columns(mc, ccs, cols, df=table)
    result = norm_proc.normalize_columns(mc, cols, dset, device="cpu")
    scorer = Scorer.from_dir(os.path.join(root, "models"), device="cpu")
    return scorer.score(result.dense,
                        result.index if result.index.size else None,
                        raw_dense=dset.numeric,
                        raw_codes=dset.cleaned_codes())["mean"]


# (set, norm type, export type): JAX-trained NN/LR/GBT/RF, LR under the
# WOE families, the 2-bag NN, and port-trained LR/GBT
PMML_CASES = [
    ("NN", None, "pmml"), ("LR", None, "pmml"), ("GBT", None, "pmml"),
    ("RF", None, "pmml"), ("LR", "WOE", "pmml"), ("LR", "WOE_ZSCALE", "pmml"),
    ("LR", "WEIGHT_WOE", "pmml"), ("bagging_nn", None, "baggingpmml"),
    ("port_LR", None, "pmml"), ("port_GBT", None, "pmml")]


def pmml_files(root):
    d = os.path.join(root, "pmmls")
    return [os.path.join(d, f) for f in sorted(os.listdir(d))]


@pytest.mark.parametrize("which,norm,et", PMML_CASES)
def test_pmml_matches_jax(sets, bagged, port_trained, tmp_path,  # noqa: F811
                          capsys, which, norm, et):
    from shifu_tpu import pmml as jpmml
    from shifu_tpu_torch import pmml as ppmml
    src = _set_of(which, sets, bagged, port_trained)
    jroot = copy_set(src, str(tmp_path / "jax"))
    proot = copy_set(src, str(tmp_path / "port"))
    if norm:
        for root in (jroot, proot):
            _edit(root, lambda mc: mc["normalize"].update(normType=norm))
    assert jax_export(jroot, et) == 0
    rc, line = port(proot, "export", "-t", et, capsys=capsys)
    assert rc == 0 and line["device"] == "host"
    got, want = pmml_files(proot), pmml_files(jroot)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] and got
    mc, table = raw_eval(proot)
    recs = records(table)
    for g, w in zip(got, want):
        text = open(g).read()
        assert text == open(w).read(), f"{g} differs from the JAX export"
        assert ppmml.validate_structure(ET.fromstring(text)) == []
        mine = ppmml.evaluate_pmml(text, recs)
        ref = jpmml.evaluate_pmml(text, pd.DataFrame(
            {k: v.astype(object) for k, v in recs.items()}))
        assert mine.shape == (len(table),) and np.isfinite(mine).all()
        np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-6)
    if norm is None and et == "pmml":
        # the independent evaluator scores the port's PMML like the
        # port's Scorer scores the normalized rows
        from tests.pmml_external_eval import PMMLScorer
        ext = np.asarray(PMMLScorer(open(got[0]).read()).score(
            {k: v.tolist() for k, v in recs.items()}), np.float64)
        np.testing.assert_allclose(ext, port_scores(proot, mc, table),
                                   rtol=0, atol=1e-5)


def test_evaluate_pmml_tables_and_mappings_agree(sets):  # noqa: F811
    """`evaluate_pmml` reads the reader's Table and a plain mapping the
    same way."""
    from shifu_tpu_torch import pmml as ppmml
    root = sets("GBT")
    mc, table = raw_eval(root)
    from shifu_tpu_torch.config.column_config import load_column_configs
    from shifu_tpu_torch.models.spec import load_model
    kind, meta, params = load_model(os.path.join(root, "models",
                                                 "model0.gbt"))
    ccs = load_column_configs(os.path.join(root, "ColumnConfig.json"))
    text = ppmml.to_string(ppmml.build_pmml(mc, ccs, kind, meta, params))
    from shifu_tpu_torch.data.reader import Table
    a = ppmml.evaluate_pmml(text, Table(records(table)))
    b = ppmml.evaluate_pmml(text, records(table))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("et,path", [
    ("columnstats", "ColumnStats.csv"), ("woemapping", "woemapping.csv"),
    ("woe", "varwoe_info.txt")])
@pytest.mark.parametrize("alg", ["LR", "GBT"])
def test_stats_exports_byte_equal(sets, tmp_path, capsys, et, path,  # noqa
                                  alg):
    from shifu_tpu.config.path_finder import PathFinder
    src = sets(alg)
    jroot = copy_set(src, str(tmp_path / "jax"))
    proot = copy_set(src, str(tmp_path / "port"))
    assert jax_export(jroot, et) == 0
    rc, line = port(proot, "export", "-t", et, capsys=capsys)
    assert rc == 0 and line["step"] == f"export -t {et}"
    if et == "columnstats":
        ctx = jax_ctx(jroot)
        rel = os.path.relpath(PathFinder(ctx.model_config, root=jroot)
                              .column_stats_export_path(), jroot)
    else:
        rel = path
    with open(os.path.join(proot, rel), "rb") as f, \
            open(os.path.join(jroot, rel), "rb") as g:
        got, want = f.read(), g.read()
    assert got == want and len(got) > 100


def zip_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("which", ["bagging_nn", "GBT", "port_LR"])
def test_bagging_and_portable_match_jax(sets, bagged, port_trained,  # noqa
                                        tmp_path, which):
    from shifu_tpu import portable as jport
    from shifu_tpu_torch import portable as pport
    src = _set_of(which, sets, bagged, port_trained)
    jroot = copy_set(src, str(tmp_path / "jax"))
    proot = copy_set(src, str(tmp_path / "port"))
    assert jax_export(jroot, "bagging") == 0
    assert port(proot, "export", "-t", "bagging")[0] == 0
    name = os.listdir(os.path.join(jroot, "onebagging"))
    assert os.listdir(os.path.join(proot, "onebagging")) == name
    got = os.path.join(proot, "onebagging", name[0])
    want = os.path.join(jroot, "onebagging", name[0])
    assert zip_members(got) == zip_members(want)
    # portable scorers of both packages on the container and each model
    mc, table = raw_eval(proot)
    from shifu_tpu_torch.config.column_config import load_column_configs
    from shifu_tpu_torch.processor import norm as norm_proc
    ccs = load_column_configs(os.path.join(proot, "ColumnConfig.json"))
    cols = norm_proc.selected_candidates(ccs)
    dset = norm_proc.load_dataset_for_columns(mc, ccs, cols, df=table)
    res = norm_proc.normalize_columns(mc, cols, dset, device="cpu")
    blocks = dict(dense=res.dense, index=None, raw_dense=dset.numeric,
                  raw_codes=dset.cleaned_codes())
    a = pport.score_model(*pport.load_model(got), **blocks)
    b = jport.score_model(*jport.load_model(want), **blocks)
    np.testing.assert_array_equal(a, b)
    models = os.path.join(proot, "models")
    a = pport.PortableScorer(models).score(**blocks)
    b = jport.PortableScorer(models).score(**blocks)
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kind", ["nn", "gbt"])
def test_convert_bundles_match_jax_and_round_trip(sets, tmp_path,  # noqa
                                                  capsys, kind):
    from shifu_tpu.models.spec import spec_to_bundle as jbundle
    from shifu_tpu_torch.models.spec import load_model
    root = sets(kind.upper())
    spec = os.path.join(root, "models", f"model0.{kind}")
    want = jbundle(spec, str(tmp_path / "jax.zip"))
    rc, line = port(root, "convert", spec, str(tmp_path / "port"),
                    capsys=capsys, device=False)
    assert rc == 0 and line["step"] == "convert"
    got = line["out"]
    assert got == str(tmp_path / "port.zip")
    a, b = zip_members(got), zip_members(want)
    assert set(a) == set(b)
    assert json.loads(a.pop("meta.json")) == json.loads(b.pop("meta.json"))
    assert a == b
    back = str(tmp_path / f"back.{kind}")
    assert port(root, "convert", got, back, device=False)[0] == 0
    k0, m0, p0 = load_model(spec)
    k1, m1, p1 = load_model(back)
    assert (k1, m1) == (k0, m0)
    from shifu_tpu_torch.models.spec import _flatten
    f0, f1 = _flatten(p0), _flatten(p1)
    assert set(f0) == set(f1)
    for k in f0:
        np.testing.assert_array_equal(f0[k], f1[k])


def test_ume_contract_and_tf_refusal(sets, tmp_path, monkeypatch,  # noqa
                                     capsys):
    root = copy_set(sets("NN"), str(tmp_path / "nn"))
    monkeypatch.delenv("SHIFU_TPU_UME_EXPORTER", raising=False)
    for et in ("ume", "baggingume", "normume"):
        assert jax_export(root, et) == 3
        rc, line = port(root, "export", "-t", et, capsys=capsys)
        assert rc == 3 and line["rc"] == 3
    plug = tmp_path / "port_ume_plug.py"
    plug.write_text(
        "calls = []\n"
        "class Exporter:\n"
        "    def __init__(self, mc):\n"
        "        self.mc = mc\n"
        "    def translate(self, name, params):\n"
        "        calls.append((name, params))\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("SHIFU_TPU_UME_EXPORTER", "port_ume_plug:Exporter")
    assert port(root, "export", "-t", "normume")[0] == 0
    import port_ume_plug
    assert port_ume_plug.calls == [("SynthTest", {"baggingMode": False,
                                                  "normAsUme": True})]
    monkeypatch.setenv("SHIFU_TPU_UME_EXPORTER", "port_ume_plug:Missing")
    assert port(root, "export", "-t", "ume")[0] == 3
    with pytest.raises(NotImplementedError,
                       match="not queued until tensorflow"):
        port(root, "export", "-t", "tf")


def test_export_refusals(sets, tmp_path):  # noqa: F811
    root = copy_set(sets("GBT"), str(tmp_path / "gbt"))
    with pytest.raises(ValueError, match="baggingpmml only supports NN"):
        port(root, "export", "-t", "baggingpmml")
    shutil.rmtree(os.path.join(root, "models"))
    for et in ("pmml", "bagging"):
        with pytest.raises(FileNotFoundError, match="no trained models"):
            port(root, "export", "-t", et)
