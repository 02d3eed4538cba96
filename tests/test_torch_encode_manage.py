"""Port parity for `encode`, `new`, `save`, `switch` and `show`.

`encode` runs on the JAX-trained GBT and RF synth sets of
`tests/test_torch_eval.py` in both packages (the port with `--device
cpu`): `encoded/part-00000` and its header byte-equal, and
`gbdt.leaf_indices` equal to the JAX package's walk on the same bins.
`new` writes the JAX package's scaffold; `save` / `switch` / `show` leave
the same files and versions behind on two copies of one set. `combo`
and `test` run through the pipeline DAG and are held by
`tests/test_torch_combo.py` and `tests/test_torch_pipeline_dag.py`.
"""

import json
import os

import numpy as np
import pytest
import torch

from shifu_tpu_torch import cli
from tests.test_torch_eval import copy_set, jax_ctx, sets  # noqa: F401


def port(root, *args, device=True, capsys=None):
    rc = cli.main(["--dir", root, *args]
                  + (["--device", "cpu"] if device else []))
    if capsys is not None:
        return rc, json.loads(capsys.readouterr().out.strip()
                              .splitlines()[-1])
    return rc, None


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("alg", ["GBT", "RF"])
def test_encode_matches_jax(sets, tmp_path, capsys, alg):  # noqa: F811
    from shifu_tpu.processor import encode as jencode
    src = sets(alg)
    jroot = copy_set(src, str(tmp_path / "jax"))
    proot = copy_set(src, str(tmp_path / "port"))
    assert jencode.run(jax_ctx(jroot)) == 0
    rc, line = port(proot, "encode", capsys=capsys)
    assert rc == 0 and line["device"] == "cpu" and line["rows"] == 800
    for name in (".pig_header", "part-00000"):
        got = read_bytes(os.path.join(proot, "encoded", name))
        want = read_bytes(os.path.join(jroot, "encoded", name))
        assert got == want, name
    n_trees = {"GBT": 4, "RF": 5}[alg]
    assert line["trees"] == n_trees
    first = read_bytes(os.path.join(proot, "encoded", "part-00000")) \
        .decode().splitlines()[0].split("|")
    assert len(first) == 2 + n_trees


def test_leaf_indices_match_jax(sets):  # noqa: F811
    import jax.numpy as jnp
    from shifu_tpu.models import gbdt as jgbdt
    from shifu_tpu_torch.models import gbdt
    from shifu_tpu_torch.models.spec import load_model
    _, meta, params = load_model(os.path.join(sets("RF"), "models",
                                              "model0.rf"))
    cfg = meta["treeConfig"]
    n_bins, depth = int(cfg["n_bins"]), int(cfg["max_depth"])
    n_feat = len(meta["denseNames"]) + len(meta["indexNames"])
    bins = np.random.default_rng(160).integers(
        0, n_bins, (n_feat, 700)).astype(np.int32)   # missing bin included
    want = np.asarray(jgbdt.leaf_indices(
        {k: jnp.asarray(v) for k, v in params["trees"].items()},
        jnp.asarray(bins), depth, n_bins))
    got = gbdt.leaf_indices(gbdt._trees_on(params["trees"], "cpu"),
                            torch.as_tensor(bins), depth, n_bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_encode_needs_a_tree_model(sets, tmp_path):  # noqa: F811
    root = copy_set(sets("NN"), str(tmp_path / "nn"))
    with pytest.raises(FileNotFoundError, match="tree model"):
        port(root, "encode")


def test_new_writes_the_jax_scaffold(tmp_path, capsys, monkeypatch):
    from shifu_tpu import cli as jcli
    monkeypatch.setenv("USER", "tester")
    assert jcli.main(["--dir", str(tmp_path / "jax"), "new", "Demo"]) == 0
    rc, line = port(str(tmp_path / "port"), "new", "Demo", device=False,
                    capsys=capsys)
    assert rc == 0 and line["device"] == "host"
    configs = []
    for side in ("jax", "port"):
        root = tmp_path / side / "Demo"
        assert sorted(os.listdir(root / "columns")) == [
            "categorical.column.names", "forceremove.column.names",
            "forceselect.column.names", "meta.column.names"]
        with open(root / "ModelConfig.json") as f:
            mc = json.load(f)
        assert mc["basic"].pop("description").startswith("Created at ")
        configs.append(mc)
    assert configs[1] == configs[0]
    # a second `new` of the same name refuses, as the JAX package's does
    assert port(str(tmp_path / "port"), "new", "Demo", device=False)[0] == 1


def tree(root):
    """{relative path: bytes} of a model set's files."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = read_bytes(p)
    return out


def test_save_switch_show_match_jax(sets, tmp_path, capsys):  # noqa: F811
    from shifu_tpu.processor import manage as jmanage
    from shifu_tpu.processor import varselect as jvs
    src = sets("GBT")
    jroot = copy_set(src, str(tmp_path / "jax"))
    proot = copy_set(src, str(tmp_path / "port"))
    assert jmanage.save(jax_ctx(jroot), "v1") == 0
    assert port(proot, "save", "v1", device=False)[0] == 0
    # an edit between the versions: every variable deselected
    assert jvs.run(jax_ctx(jroot), reset=True) == 0
    assert port(proot, "varsel", "-reset")[0] == 0
    assert jmanage.save(jax_ctx(jroot), "v2") == 0
    assert port(proot, "save", "v2", device=False)[0] == 0
    before = tree(os.path.join(proot, ".shifu-versions", "v1"))
    assert jmanage.switch(jax_ctx(jroot), "v1") == 0
    capsys.readouterr()
    rc, line = port(proot, "switch", "v1", device=False, capsys=capsys)
    assert rc == 0 and line["step"] == "switch"
    got, want = tree(proot), tree(jroot)
    # the port ran through its CLI, which appends each step's record;
    # the JAX side ran its processors directly
    steps = [json.loads(s)["step"] for s in
             got.pop("tmp/metrics/steps.jsonl").decode().splitlines()]
    assert steps == ["save", "varsel", "save", "switch"]
    assert set(got) == set(want)
    for rel in want:
        if rel.endswith(("ModelConfig.json", "ColumnConfig.json")) or \
                rel.startswith(("models", ".shifu-versions")):
            assert got[rel] == want[rel].replace(
                jroot.encode(), proot.encode()), rel
    # the restored tree is the v1 snapshot
    for rel, data in before.items():
        assert got[rel] == data, rel
    rc, line = port(proot, "show", device=False, capsys=capsys)
    assert line["versions"] == ["master", "v1", "v2"] == \
        jmanage.list_versions(jax_ctx(jroot))
    with pytest.raises(ValueError, match="already exists"):
        port(proot, "save", "v1", device=False)
    with pytest.raises(ValueError, match="no saved version"):
        port(proot, "switch", "v9", device=False)
