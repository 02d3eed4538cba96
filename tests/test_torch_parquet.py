"""Parquet input in the port (`shifu_tpu_torch/data/parquet.py` and the
parquet route of `data/reader.py`) against the JAX package's parquet
reader (`shifu_tpu/data/reader.py`) on the same files:

- the reader's tables equal the JAX package's frames value for value
  (all strings, or float32 numeric columns with the same bits), and the
  text route's once missing tokens are read as '';
- int categories read '5' (an arrow cast), empty part files read as no
  rows, the bounded head read, the chunked read in pyarrow's batches;
- the numeric contract over arrow's types: ints with and without nulls,
  floats, bools, dictionaries, timestamps, durations, junk strings
  (NaN); a null timestamp is NaN where pandas wraps it;
- a mixed text + parquet dataPath stays all strings; the footer's row
  count; the chunking trigger counts parquet bytes 4×; `watch`'s tail
  of a parquet dataPath;
- a parquet set's `init → stats → norm → train (GBT) → eval` held
  against the JAX package's outputs on the same files (stats and
  normalized data as the text-route parity holds them; the model and
  scores within `test_torch_train_tree`'s tolerances), and equal to the
  bytes of the same table read from `memory://`.

Every generator is a private `np.random.default_rng(seed)` (C-ref-1).
"""

import json
import os
import shutil
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from shifu_tpu.config.model_config import ModelConfig as JModelConfig
from shifu_tpu.data import reader as jreader
from shifu_tpu_torch import cli
from shifu_tpu_torch.config.model_config import ModelConfig
from shifu_tpu_torch.data import parquet, reader
from tests.test_torch_stats import (assert_column_configs, make_sets,
                                    run_jax, run_port)

NUMS = [f"num_{j}" for j in range(6)] + ["wgt"]


def _same(table, frame, numeric=()):
    assert table.columns == list(frame.columns)
    assert len(table) == len(frame)
    for c in table.columns:
        got, want = table[c], frame[c].to_numpy()
        if c in numeric:
            assert got.dtype == np.float32 and want.dtype == np.float32, c
            assert np.array_equal(got.view(np.int32), want.view(np.int32)), c
        else:
            assert got.dtype.kind == "U", c
            assert got.tolist() == [str(v) for v in want.tolist()], c


def _parquet_set(tmp_path, seed, n_rows=500, **kw):
    from tests.synth import make_model_set
    return make_model_set(tmp_path, np.random.default_rng(seed),
                          n_rows=n_rows, data_format="parquet", **kw)


@pytest.mark.parametrize("numeric", [False, True])
def test_reader_matches_the_jax_reader(tmp_path, numeric):
    root = _parquet_set(tmp_path, 201)
    nums = NUMS if numeric else None
    got = reader.read_raw_table(ModelConfig.load(root), numeric_columns=nums)
    want = jreader.read_raw_table(JModelConfig.load(root),
                                  numeric_columns=nums)
    _same(got, want, NUMS if numeric else ())


def test_reader_matches_the_text_route(tmp_path):
    """The same table as parquet and as delimited text: equal strings
    once the text's '?' is read as '' (both are missing tokens), equal
    float32 numeric columns."""
    from tests.synth import make_model_set
    t_root = make_model_set(tmp_path / "t", np.random.default_rng(202),
                            n_rows=500)
    p_root = _parquet_set(tmp_path / "p", 202)
    text = reader.read_raw_table(ModelConfig.load(t_root))
    par = reader.read_raw_table(ModelConfig.load(p_root))
    assert text.columns == par.columns
    for c in text.columns:
        tv = np.where(text[c] == "?", "", text[c])
        if c in NUMS:
            np.testing.assert_array_equal(
                reader.to_numeric(tv).astype(np.float32),
                reader.to_numeric(par[c]).astype(np.float32))
        else:
            assert tv.tolist() == par[c].tolist(), c
    tn = reader.read_raw_table(ModelConfig.load(t_root), numeric_columns=NUMS)
    pn = reader.read_raw_table(ModelConfig.load(p_root), numeric_columns=NUMS)
    for c in NUMS:
        np.testing.assert_array_equal(tn[c], pn[c])


@pytest.mark.parametrize("chunk", [100, 256, 1000])
def test_chunks_equal_the_jax_chunks(tmp_path, chunk):
    root = _parquet_set(tmp_path, 203)
    got = list(reader.iter_raw_table(ModelConfig.load(root),
                                     chunk_rows=chunk))
    want = list(jreader.iter_raw_table(JModelConfig.load(root),
                                       chunk_rows=chunk))
    assert [len(t) for t in got] == [len(f) for f in want]
    assert all(len(t) <= chunk for t in got)
    assert sum(len(t) for t in got) == 400
    for t, f in zip(got, want):
        _same(t, f)


def _int_categories(root):
    data_dir = os.path.join(root, "data")
    src = pq.read_table(os.path.join(data_dir, "part-00000.parquet"))
    codes = pa.array([5 if i % 2 else 7 for i in range(len(src) - 1)]
                     + [None], type=pa.int64())
    tbl = src.set_column(src.schema.get_field_index("cat_0"), "cat_0", codes)
    pq.write_table(tbl, os.path.join(data_dir, "part-00000.parquet"),
                   row_group_size=16)
    pq.write_table(tbl.slice(0, 0),
                   os.path.join(data_dir, "part-00001.parquet"))
    return len(src)


@pytest.mark.parametrize("max_rows", [None, 1, 10, 16, 17, 49, 500])
def test_int_categories_empty_parts_and_the_head_read(tmp_path, max_rows):
    root = _parquet_set(tmp_path, 204, n_rows=50)
    n = _int_categories(root)
    got = reader.read_raw_table(ModelConfig.load(root), max_rows=max_rows)
    want = jreader.read_raw_table(JModelConfig.load(root), max_rows=max_rows)
    _same(got, want)
    assert len(got) == min(n, max_rows or n)
    assert set(got["cat_0"].tolist()) <= {"5", "7", ""}
    if max_rows is None:
        assert set(got["cat_0"].tolist()) == {"5", "7", ""}
        assert list(reader.iter_raw_table(ModelConfig.load(root),
                                          chunk_rows=1000))[-1]["cat_0"][-1] \
            == ""


@pytest.mark.parametrize("column,want", [
    (pa.array([1, None, 3], pa.int64()), [1.0, np.nan, 3.0]),
    (pa.array([1, 2, 16777217], pa.int64()), [1.0, 2.0, 16777216.0]),
    (pa.array([-4, 0, 9], pa.int8()), [-4.0, 0.0, 9.0]),
    (pa.array([7, None, 0], pa.uint32()), [7.0, np.nan, 0.0]),
    (pa.array([0.1, None, -2.5], pa.float64()), [0.1, np.nan, -2.5]),
    (pa.array([0.1, np.nan, 3e38], pa.float32()), [0.1, np.nan, 3e38]),
    (pa.array([True, False, True], pa.bool_()), [1.0, 0.0, 1.0]),
    (pa.array(["1.5", "abc", None], pa.string()), [1.5, np.nan, np.nan]),
    (pa.array([" 2e3", "inf", "-7"], pa.string()), [2000.0, np.inf, -7.0]),
    (pa.array(["5", "6", "x"], pa.string()).dictionary_encode(),
     [5.0, 6.0, np.nan]),
    (pa.array([1704067200, 0, 86400], pa.timestamp("s")),
     [1704067200.0, 0.0, 86400.0]),
    (pa.array([1500, -2, 7], pa.duration("ms")), [1500.0, -2.0, 7.0]),
    (pa.array([Decimal("1.25"), None, Decimal("-3")], pa.decimal128(5, 2)),
     [1.25, np.nan, -3.0]),
])
def test_numeric_contract_over_arrow_types(column, want):
    """`to_table`'s float32 column equals the JAX package's
    ``pd.to_numeric(errors="coerce").astype(float32)`` bit for bit."""
    tbl = pa.table({"x": column, "s": column})
    got = parquet.to_table(tbl, ["x", "s"], ["x", "s"], ["x"])
    frame = jreader._table_to_contract(tbl, ["x", "s"], None, ["x"])
    ref = frame["x"].to_numpy()
    assert got["x"].dtype == np.float32
    assert np.array_equal(got["x"].view(np.int32), ref.view(np.int32))
    np.testing.assert_array_equal(got["x"], np.asarray(want, np.float32))
    assert got["s"].tolist() == [str(v) for v in frame["s"].tolist()]


def test_a_null_timestamp_is_nan():
    """The one numeric read that leaves the JAX package's bits on
    purpose: pandas turns a null timestamp (NaT) into the int64 minimum
    (-9.2e18); the port reads it as missing."""
    tbl = pa.table({"x": pa.array([None, 60], pa.timestamp("s"))})
    got = parquet.to_table(tbl, ["x"], ["x"], ["x"])["x"]
    want = jreader._table_to_contract(tbl, ["x"], None, ["x"])["x"]
    assert np.isnan(got[0]) and want.to_numpy()[0] < -9e18
    assert got[1] == want.to_numpy()[1] == 60.0


def test_column_count_mismatch_raises_like_the_jax_reader():
    tbl = pa.table({"a": [1], "b": [2]})
    with pytest.raises(ValueError, match="2 columns but the header "
                                         "declares 3"):
        parquet.to_table(tbl, ["a", "b", "c"], ["a", "b", "c"])


def test_mixed_text_and_parquet_stay_all_strings(tmp_path):
    """A dataPath of text and parquet parts: numeric_columns do not
    apply (the JAX package's dtype-homogeneity rule)."""
    from tests.synth import make_model_set
    root = make_model_set(tmp_path / "t", np.random.default_rng(205),
                          n_rows=300)
    p_root = _parquet_set(tmp_path / "p", 206, n_rows=200)
    shutil.copy(os.path.join(p_root, "data", "part-00000.parquet"),
                os.path.join(root, "data", "part-00001.parquet"))
    got = reader.read_raw_table(ModelConfig.load(root), numeric_columns=NUMS)
    want = jreader.read_raw_table(JModelConfig.load(root),
                                  numeric_columns=NUMS)
    _same(got, want)
    assert got["num_0"].dtype.kind == "U" and len(got) == 240 + 160
    chunks = list(reader.iter_raw_table(ModelConfig.load(root),
                                        chunk_rows=100))
    assert sum(len(t) for t in chunks) == len(got)


@pytest.mark.parametrize("header_rows", [0, 1])
def test_footer_row_count(tmp_path, header_rows):
    root = _parquet_set(tmp_path, 207, n_rows=50)
    _int_categories(root)
    for name in ("part-00000.parquet", "part-00001.parquet"):
        path = os.path.join(root, "data", name)
        assert reader.count_data_rows(path, header_rows) == \
            jreader._count_data_rows(path, header_rows) == \
            parquet.num_rows(path)
    text = str(tmp_path / "part-t")
    with open(text, "w") as f:
        f.write("a\nb\nc")
    assert reader.count_data_rows(text, header_rows) == \
        jreader._count_data_rows(text, header_rows) == 3 - header_rows


def test_header_comes_from_the_footer(tmp_path):
    root = _parquet_set(tmp_path, 208, n_rows=40)
    mc = ModelConfig.load(root)
    assert reader.read_header(mc.dataSet, mc.resolve_path) == \
        jreader.read_header(JModelConfig.load(root).dataSet,
                            JModelConfig.load(root).resolve_path)
    assert parquet.column_names(os.path.join(
        root, "data", "part-00000.parquet"))[0] == "num_0"


def test_chunk_trigger_counts_parquet_four_times(tmp_path, monkeypatch):
    from shifu_tpu.processor import chunking as jchunking
    from shifu_tpu.processor.base import ProcessorContext as JContext
    from shifu_tpu_torch.processor import chunking
    from shifu_tpu_torch.processor.base import ProcessorContext
    root = _parquet_set(tmp_path, 209, n_rows=400)
    size = os.path.getsize(os.path.join(root, "data", "part-00000.parquet"))
    ctx, jctx = ProcessorContext.load(root), JContext.load(root)
    for limit, want in ((4 * size - 1, 2_000_000), (4 * size, 0)):
        monkeypatch.setenv("SHIFU_TPU_STATS_STREAM_BYTES", str(limit))
        args = ((), "SHIFU_TPU_STATS_STREAM_BYTES",
                ctx.model_config.dataSet.dataPath, "stats")
        assert chunking.chunk_rows_for(ctx, *args) == want
        assert jchunking.chunk_rows_for(jctx, *args) == want


def test_watch_tail_of_a_parquet_data_path(tmp_path):
    """A parquet dataPath (no byte cursor) is tailed as the whole
    table's rows past the last tick's count."""
    from shifu_tpu_torch.obs.health.watch import _production_window
    from shifu_tpu_torch.processor.base import ProcessorContext
    root = _parquet_set(tmp_path, 210, n_rows=50)
    ctx = ProcessorContext.load(root)
    first, tail = _production_window(ctx, {})
    assert len(first) == 40 and tail == {"__rows__": 40}
    assert _production_window(ctx, tail)[0] is None
    src = os.path.join(root, "data", "part-00000.parquet")
    pq.write_table(pq.read_table(src).slice(0, 5),
                   os.path.join(root, "data", "part-00001.parquet"))
    more, tail = _production_window(ctx, tail)
    assert len(more) == 5 and tail["__rows__"] == 45
    assert more["rowid"].tolist() == first["rowid"][:5].tolist()


@pytest.mark.parametrize("seed", [211, 212])
def test_parquet_set_runs_every_step_like_the_jax_package(tmp_path, seed):
    from tests.test_torch_norm import _assert_npz
    from tests.test_torch_train_tree import PARAMS, _close, _exact
    from shifu_tpu.models.spec import load_model as jload_model
    from shifu_tpu.processor import eval as jeval
    from shifu_tpu.processor import train as jtrain
    from shifu_tpu.processor.base import ProcessorContext
    from shifu_tpu_torch.models.spec import load_model
    root, port = make_sets(tmp_path, seed, n_rows=1200, algorithm="GBT",
                           train_params=PARAMS["GBT"], data_format="parquet")
    run_jax(root)
    assert jtrain.run(ProcessorContext.load(root)) == 0
    assert jeval.run(ProcessorContext.load(root)) == 0
    run_port(port, ("init", "stats", "norm", "train"))
    assert cli.main(["--dir", port, "eval", "--device", "cpu"]) == 0
    names = [c["columnName"] for c in json.load(
        open(os.path.join(port, "ColumnConfig.json")))]
    assert names[:2] == ["num_0", "num_1"] and "diagnosis" in names
    assert_column_configs(os.path.join(root, "ColumnConfig.json"),
                          os.path.join(port, "ColumnConfig.json"))
    _assert_npz(root, port, "ZSCALE")
    name = os.path.join("models", "model0.gbt")
    jkind, jmeta, jparams = jload_model(os.path.join(root, name))
    kind, meta, params = load_model(os.path.join(port, name))
    assert (kind, meta) == (jkind, jmeta)
    _exact(params["tables"], jparams["tables"])
    _close(params["trees"], jparams["trees"])
    from tests.test_torch_eval import assert_eval_outputs
    assert_eval_outputs(port, root, "GBT")


def test_parquet_behind_memory_reads_like_local_parquet(tmp_path):
    """Parquet part files behind `memory://` (opened through
    `fs.open_text(..., "rb")`): every step's outputs are the bytes of
    the local parquet set's."""
    import filecmp
    import uuid
    import fsspec
    from tests.test_torch_fs import OUTPUTS
    from tests.test_torch_train_tree import PARAMS
    _, local = make_sets(tmp_path, 213, n_rows=900, algorithm="GBT",
                         train_params=PARAMS["GBT"], data_format="parquet")
    far = str(tmp_path / "far")
    shutil.copytree(local, far)
    base = f"memory://pq{uuid.uuid4().hex[:12]}"
    mem = fsspec.filesystem("memory")
    for sub in ("data", "evaldata"):
        with open(os.path.join(far, sub, "part-00000.parquet"), "rb") as f:
            data = f.read()
        with fsspec.open(f"{base}/{sub}/part-00000.parquet", "wb") as f:
            f.write(data)
    path = os.path.join(far, "ModelConfig.json")
    with open(path) as f:
        mc = json.load(f)
    mc["dataSet"]["dataPath"] = f"{base}/data"
    mc["evals"][0]["dataSet"]["dataPath"] = f"{base}/evaldata"
    with open(path, "w") as f:
        json.dump(mc, f)
    try:
        for root in (local, far):
            for cmd in (["init"], ["stats"], ["norm"], ["train"], ["eval"]):
                extra = [] if cmd == ["init"] else ["--device", "cpu"]
                assert cli.main(["--dir", root, *cmd, *extra]) == 0, cmd
    finally:
        mem.rm(base[len("memory://"):], recursive=True)
    for rel in OUTPUTS:
        assert filecmp.cmp(os.path.join(local, rel), os.path.join(far, rel),
                           shallow=False), rel
