"""Port parity for `norm` and for the whole `init → stats → norm` slice.

- `normalize_dataset` for every `NormType` on the same columnar blocks
  and the same ColumnConfigs as the JAX package's: names, index block
  and vocabulary sizes equal; the dense block equal for the lookup
  families and within atol/rtol 1e-5 for the z-score ones;
- the slice on `tests/synth.py` model sets: the port's `init`,
  `stats --device cpu` and `norm --device cpu` against the JAX steps on
  a copy, for ZSCALE, WOE, ONEHOT and ZSCALE_INDEX, with the JAX reader
  on its text route, with a two-expression `segExpressionFile`,
  `stats.sampleRate` 0.5 with `sampleNegOnly`, `filterExpressions` and
  `cateMaxNumBin` 2: ColumnConfig.json (`test_torch_stats.
  assert_column_configs`), both npz layouts and their meta.json, and
  with train#trainOnDisk the streaming `.npy` layout;
- end to end: the port's own `init → stats → norm → train --device cpu`
  against the JAX package's four steps (GBT and RF), the model files
  held as `tests/test_torch_train_tree.py` holds the `train` verb.

Each model set comes from a private `np.random.default_rng(seed)`.
"""

import json
import os

import numpy as np
import pytest
import torch

from shifu_tpu.config.model_config import NormType as JNormType
from shifu_tpu.ops import normalize as jnorm
from shifu_tpu_torch.config.model_config import NormType
from shifu_tpu_torch.ops import normalize as tnorm
from tests.test_torch_stats import (assert_column_configs, make_sets,
                                    run_jax, run_port)

LOOKUP = {"WOE", "WEIGHT_WOE", "ASIS_WOE", "ONEHOT", "INDEX", "WOE_INDEX",
          "WOE_APPEND_INDEX", "HYBRID", "WEIGHT_HYBRID", "ASIS_PR"}


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    """One JAX-made model set (init + stats) and its columnar blocks."""
    from shifu_tpu.config.column_config import load_column_configs
    from shifu_tpu.config.model_config import ModelConfig
    from shifu_tpu.processor.norm import (load_dataset_for_columns,
                                          selected_candidates)
    from shifu_tpu_torch.config.column_config import \
        load_column_configs as tload
    root, _ = make_sets(tmp_path_factory.mktemp("norm"), 41, n_rows=1200)
    run_jax(root, ("init", "stats"))
    mc = ModelConfig.load(root)
    ccs = load_column_configs(os.path.join(root, "ColumnConfig.json"))
    cols = selected_candidates(ccs)
    dset = load_dataset_for_columns(mc, ccs, cols)
    tccs = {c.columnNum: c for c in tload(os.path.join(root,
                                                       "ColumnConfig.json"))}
    num = [c for c in cols if c.columnNum in set(dset.num_column_nums)]
    cat = [c for c in cols if c.is_categorical]
    return (dset, num, cat, [tccs[c.columnNum] for c in num],
            [tccs[c.columnNum] for c in cat], mc.stats.maxNumBin)


@pytest.mark.parametrize("norm", [n.value for n in NormType])
def test_normalize_dataset_every_norm_type(blocks, norm):
    dset, jnum, jcat, tnum, tcat, max_bins = blocks
    want = jnorm.normalize_dataset(
        JNormType(norm), 4.0, dset.numeric, dset.num_names,
        jnorm.build_numeric_table(jnum, max_bins), dset.cat_codes,
        dset.cat_names, jnorm.build_categorical_table(jcat))
    got = tnorm.normalize_dataset(
        NormType(norm), 4.0, dset.numeric, dset.num_names,
        tnorm.build_numeric_table(tnum, max_bins), dset.cat_codes,
        dset.cat_names, tnorm.build_categorical_table(tcat), device="cpu")
    assert got.dense_names == want.dense_names
    assert got.index_names == want.index_names
    assert got.index_vocab_sizes == want.index_vocab_sizes
    assert got.dense.dtype == np.float32 and got.index.dtype == np.int32
    np.testing.assert_array_equal(got.index, want.index)
    if norm in LOOKUP:
        np.testing.assert_array_equal(got.dense, want.dense)
    else:
        np.testing.assert_allclose(got.dense, want.dense, atol=1e-5,
                                   rtol=1e-5)
    assert (got.zscore_params is None) == (want.zscore_params is None)


def _assert_npz(jax_root, port_root, norm):
    for sub in ("CleanedData", "NormalizedData"):
        want = np.load(os.path.join(jax_root, "tmp", sub, "data.npz"))
        got = np.load(os.path.join(port_root, "tmp", sub, "data.npz"))
        assert set(got) == set(want), sub
        for k in want:
            assert got[k].dtype == want[k].dtype, (sub, k)
            if sub == "NormalizedData" and k == "dense" \
                    and norm not in LOOKUP:
                np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                           rtol=1e-5, err_msg=sub)
            else:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{sub}.{k}")
        with open(os.path.join(jax_root, "tmp", sub, "meta.json")) as f:
            want_meta = json.load(f)
        with open(os.path.join(port_root, "tmp", sub, "meta.json")) as f:
            assert json.load(f) == want_meta, sub


def _seg(mc):
    path = os.path.join(os.path.dirname(mc["dataSet"]["dataPath"]),
                        "columns", "segments.txt")
    with open(path, "w") as f:
        f.write("cat_0 == 'aa'\n# a comment\nnum_0 > 0.2 and wgt < 1.5\n")
    mc["dataSet"]["segExpressionFile"] = path


def _sample(mc):
    mc["stats"]["sampleRate"] = 0.5
    mc["stats"]["sampleNegOnly"] = True
    mc["normalize"]["sampleRate"] = 0.5
    mc["normalize"]["sampleNegOnly"] = True


def _filter(mc):
    mc["dataSet"]["filterExpressions"] = "num_1 > -1.5 && cat_1 ne 'dd'"


def _cap(mc):
    mc["stats"]["cateMaxNumBin"] = 2


SCENARIOS = {
    "ZSCALE": ("ZSCALE", None, "1"),
    "WOE": ("WOE", None, "1"),
    "ONEHOT": ("ONEHOT", None, "1"),
    "ZSCALE_INDEX": ("ZSCALE_INDEX", None, "1"),
    "ZSCALE_text_route": ("ZSCALE", None, "0"),
    "segments": ("WOE_ZSCALE", _seg, "1"),
    "sampling": ("ZSCALE", _sample, "1"),
    "filter": ("WOE", _filter, "1"),
    "cate_cap": ("ZSCALE", _cap, "1"),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_init_stats_norm_slice_matches_jax(tmp_path, monkeypatch, scenario):
    norm, edit, native = SCENARIOS[scenario]
    monkeypatch.setenv("SHIFU_TPU_NATIVE_READER", native)
    root, port = make_sets(tmp_path, 50 + list(SCENARIOS).index(scenario),
                           n_rows=1500, norm_type=norm, edit=edit)
    run_jax(root)
    run_port(port)
    assert_column_configs(os.path.join(root, "ColumnConfig.json"),
                          os.path.join(port, "ColumnConfig.json"))
    _assert_npz(root, port, norm)
    with open(os.path.join(port, "ColumnConfig.json")) as f:
        ccs = json.load(f)
    if edit is _seg:
        assert sum(1 for c in ccs if c.get("segment")) == 2 * 11
    if edit is _cap:
        assert all(len(c["columnBinning"]["binCategory"]) == 2
                   for c in ccs if c["columnType"] == "C")


def test_cli_prints_one_json_line_a_step(tmp_path, capsys):
    from shifu_tpu_torch import cli
    _, port = make_sets(tmp_path, 61, n_rows=400)
    lines = {}
    for verb in (["init"], ["stats", "--device", "cpu"],
                 ["norm", "--device", "cpu"]):
        assert cli.main(["--dir", port, *verb]) == 0
        lines[verb[0]] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
    assert lines["init"]["device"] == "host"
    assert lines["init"]["rows"] == 320
    for verb in ("stats", "norm"):
        line = lines[verb]
        assert line["step"] == verb and line["device"] == "cpu"
        assert line["rows"] == 320
        assert 0 < line["read_seconds"] <= line["seconds"]


def test_norm_streaming_paths_raise(tmp_path, monkeypatch):
    """Past the size trigger the streaming norm writes the `.npy`
    layout with its recorded validSplit, equal to the JAX package's
    streaming norm (tests/test_torch_norm_streaming.py); with
    train#trainOnDisk the resident norm writes the streaming `.npy`
    layout, held against the JAX package's files."""
    from tests.test_torch_norm_streaming import assert_stream_layout
    from tests.test_torch_streaming import assert_layout
    root, port = make_sets(tmp_path, 62, n_rows=300)
    run_port(port, ("init", "stats"))
    run_jax(root, ("init", "stats"))
    monkeypatch.setenv("SHIFU_TPU_NORM_CHUNK_ROWS", "100")
    run_port(port, ("norm",))
    run_jax(root, ("norm",))
    assert_stream_layout(root, port)
    monkeypatch.setenv("SHIFU_TPU_NORM_CHUNK_ROWS", "0")
    for r in (root, port):
        path = os.path.join(r, "ModelConfig.json")
        with open(path) as f:
            mc = json.load(f)
        mc["train"]["trainOnDisk"] = True
        with open(path, "w") as f:
            json.dump(mc, f)
    run_jax(root)
    run_port(port, ("norm",))
    assert_layout(root, port)


@pytest.mark.parametrize("alg,seed", [("GBT", 21), ("RF", 22)])
def test_port_pipeline_trains_what_jax_trains(tmp_path, capsys, alg, seed):
    """The port's own init → stats → norm → train against the JAX
    package's four steps on the same synth set."""
    from shifu_tpu.models.spec import load_model as jload_model
    from shifu_tpu.processor import train as jtrain
    from shifu_tpu.processor.base import ProcessorContext
    from shifu_tpu_torch import cli
    from shifu_tpu_torch.models.spec import load_model
    from tests.test_torch_train_tree import PARAMS, _close, _exact
    root, port = make_sets(tmp_path, seed, n_rows=1200, algorithm=alg,
                           train_params=PARAMS[alg])
    run_jax(root)
    jtrain.run(ProcessorContext.load(root))
    run_port(port)
    assert cli.main(["--dir", port, "train", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]
                      )["algorithm"] == alg
    name = os.path.join("models", f"model0.{'gbt' if alg == 'GBT' else 'rf'}")
    jkind, jmeta, jparams = jload_model(os.path.join(root, name))
    kind, meta, params = load_model(os.path.join(port, name))
    assert (kind, meta) == (jkind, jmeta)
    _exact(params["tables"], jparams["tables"])
    _close(params["trees"], jparams["trees"])
    assert torch.isfinite(torch.as_tensor(params["trees"]["leaf_value"])
                          ).all()
