"""Port parity for the raw reader, type detection and row filters.

- `read_raw_table` on `tests/synth.py` files — plain, gzip, `\\r\\n`
  line ends, a trailing empty line and blank lines — with and without
  `numeric_columns` and with `max_rows`, against the JAX reader with its
  native route on and off (``SHIFU_TPU_NATIVE_READER``): the same
  columns in the same order, strings equal, and the port's float32
  columns equal to the JAX values (its C floats, or its strings parsed
  as `build_columnar` parses them);
- `reader.to_numeric` and `init._detect_type` against pandas and the
  JAX `_detect_type` on the tokens pandas treats specially;
- `DataPurifier` against the JAX purifier on the same file.

Each test builds its data from a private `np.random.default_rng(seed)`.
"""

import gzip
import os

import numpy as np
import pandas as pd
import pytest

from shifu_tpu.config.model_config import ModelConfig as JModelConfig
from shifu_tpu.data.purifier import DataPurifier as JPurifier
from shifu_tpu.data.reader import read_raw_table as jread
from shifu_tpu.processor.init import _detect_type as jdetect
from shifu_tpu_torch.config.model_config import ModelConfig
from shifu_tpu_torch.data.purifier import DataPurifier
from shifu_tpu_torch.data.reader import Table, read_raw_table, to_numeric
from shifu_tpu_torch.processor.init import _detect_type

NUM = [f"num_{j}" for j in range(6)]
MISSING = ["", "*", "#", "?", "null", "~"]


def _model_set(tmp_path, seed, layout="plain", n_rows=800):
    """A synth model set whose data part is rewritten in `layout`."""
    from tests.synth import make_model_set
    root = make_model_set(tmp_path, np.random.default_rng(seed),
                          n_rows=n_rows)
    part = os.path.join(root, "data", "part-00000")
    with open(part) as f:
        lines = f.read().splitlines()
    if layout == "gzip":
        with gzip.open(part + ".gz", "wt") as f:
            f.write("\n".join(lines) + "\n")
        os.remove(part)
    elif layout == "crlf":
        with open(part, "w", newline="") as f:
            f.write("\r\n".join(lines) + "\r\n")
    elif layout == "trailing_blank":
        with open(part, "w") as f:
            f.write("\n".join(lines) + "\n\n")
    elif layout == "blank_lines":
        with open(part, "w") as f:
            f.write("\n".join(lines[:10] + [""] + lines[10:]) + "\n\n")
    return root


def _as_f32(values):
    """The JAX package's float of a column: native floats as they are,
    strings as `build_columnar` parses them (missing tokens NaN)."""
    s = pd.Series(values)
    if pd.api.types.is_float_dtype(s):
        return s.to_numpy(np.float32)
    s = s.astype(str).str.strip()
    out = pd.to_numeric(s, errors="coerce").to_numpy(np.float32)
    out[s.isin(MISSING).to_numpy()] = np.nan
    return out


def _assert_tables(got: Table, want: pd.DataFrame):
    assert got.columns == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        g = got[c]
        if g.dtype.kind == "f":
            np.testing.assert_array_equal(g, _as_f32(want[c].to_numpy()),
                                          err_msg=c)
        else:
            w = want[c].astype(str).to_numpy()
            if pd.api.types.is_float_dtype(want[c]):
                raise AssertionError(f"{c}: JAX float, port strings")
            np.testing.assert_array_equal(np.char.strip(g),
                                          np.char.strip(w.astype(str)),
                                          err_msg=c)


@pytest.mark.parametrize("native", ["0", "1"])
@pytest.mark.parametrize("numeric", [False, True])
@pytest.mark.parametrize("layout", ["plain", "gzip", "crlf",
                                    "trailing_blank", "blank_lines"])
def test_read_raw_table_matches_jax(tmp_path, monkeypatch, layout, numeric,
                                    native):
    root = _model_set(tmp_path, 11, layout)
    monkeypatch.setenv("SHIFU_TPU_NATIVE_READER", native)
    kw = {"numeric_columns": NUM} if numeric else {}
    want = jread(JModelConfig.load(root), **kw)
    got = read_raw_table(ModelConfig.load(root), **kw)
    _assert_tables(got, want)
    if numeric and layout != "gzip":
        assert all(got[c].dtype == np.float32 for c in NUM)
    else:
        assert all(got[c].dtype.kind == "U" for c in got.columns)


@pytest.mark.parametrize("layout", ["plain", "gzip", "crlf"])
@pytest.mark.parametrize("max_rows", [1, 57, 10_000])
def test_read_raw_table_max_rows(tmp_path, layout, max_rows):
    root = _model_set(tmp_path, 12, layout, n_rows=300)
    want = jread(JModelConfig.load(root), max_rows=max_rows,
                 numeric_columns=NUM)
    got = read_raw_table(ModelConfig.load(root), max_rows=max_rows,
                         numeric_columns=NUM)
    _assert_tables(got, want)
    assert len(got) == min(max_rows, 240)


def _two_parts(tmp_path):
    """A synth set whose data are two part files, the header taken from
    the first line of the first part (empty headerPath)."""
    import json
    root = _model_set(tmp_path, 13, n_rows=400)
    data = os.path.join(root, "data")
    with open(os.path.join(data, ".pig_header")) as f:
        header = f.read().strip()
    with open(os.path.join(data, "part-00000")) as f:
        lines = f.read().splitlines()
    with open(os.path.join(data, "part-00000"), "w") as f:
        f.write("\n".join([header] + lines[:100]) + "\n")
    with open(os.path.join(data, "part-00001"), "w") as f:
        f.write("\n".join(lines[100:]) + "\n")
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as f:
        mc = json.load(f)
    mc["dataSet"]["headerPath"] = ""
    with open(path, "w") as f:
        json.dump(mc, f)
    return root


def test_read_raw_table_multi_part_and_in_file_header(tmp_path):
    """Two part files, the header taken from the first line of the first
    part (empty headerPath)."""
    root = _two_parts(tmp_path)
    for kw in ({}, {"numeric_columns": NUM}, {"max_rows": 150}):
        want = jread(JModelConfig.load(root), **kw)
        got = read_raw_table(ModelConfig.load(root), **kw)
        _assert_tables(got, want)


@pytest.mark.parametrize("chunk_rows", [1, 37, 100, 5000])
def test_iter_raw_table_chunks_match_jax(tmp_path, monkeypatch, chunk_rows):
    """The chunked reader over two part files with the header line in the
    first only (and a blank line in the second): the port's chunks are
    the JAX iterator's, row for row."""
    from shifu_tpu.data.reader import iter_raw_table as jiter
    from shifu_tpu_torch.data.reader import iter_raw_table
    monkeypatch.setenv("SHIFU_TPU_PREFETCH_DEPTH", "0")
    root = _two_parts(tmp_path)
    part = os.path.join(root, "data", "part-00001")
    with open(part) as f:
        lines = f.read().splitlines()
    with open(part, "w") as f:
        f.write("\n".join(lines[:50] + ["   "] + lines[50:]) + "\n")
    want = list(jiter(JModelConfig.load(root), chunk_rows=chunk_rows))
    got = list(iter_raw_table(ModelConfig.load(root), chunk_rows=chunk_rows))
    assert [len(t) for t in got] == [len(df) for df in want]
    assert sum(len(t) for t in got) == 320
    for t, df in zip(got, want):
        _assert_tables(t, df)


def test_text_route_reproduces_pandas_tokenizing(tmp_path):
    """Quotes kept, `""` a token, short rows padded, lone \\r a line end."""
    from shifu_tpu_torch.data.reader import read_text_file
    path = str(tmp_path / "x.txt")
    with open(path, "w", newline="") as f:
        f.write('1| 2 |3\r""|"|\n4|5\r\n  \n6|7|8')
    want = pd.read_csv(path, sep="|", header=None, dtype=str,
                       names=["a", "b", "c"], na_filter=False, quoting=3)
    got = read_text_file(path, ["a", "b", "c"], "|")
    for c in "abc":
        assert got[c].tolist() == want[c].tolist()
    with open(path, "w") as f:
        f.write("1|2|3|4\n")
    with pytest.raises(ValueError, match="fields"):
        read_text_file(path, ["a", "b", "c"], "|")


TOKENS = ["nan", "NaN", "inf", "-Infinity", "iNf", "1e5", "+.5", " 3",
          "3 ", "1_000", "0x10", "", "1.5e", "1,000", "1.", ".", "+",
          "-0", "1e400", "00012", "1E-5", "True", "null", "١٢", "infinityx",
          "+nan", "1e", "e5", "\t4", "12345678.9", "+-1", "1e5e5", ".e1",
          "-", "5.", "-.5", "1.e5"]


def test_to_numeric_matches_pandas():
    want = pd.to_numeric(pd.Series(TOKENS, dtype=object),
                         errors="coerce").to_numpy(np.float64)
    got = to_numeric(np.asarray(TOKENS))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got.astype(np.float32),
                                  want.astype(np.float32))


@pytest.mark.parametrize("tokens", [
    ["1", "2.5", "nan", "nan"],               # "nan" is not parsed
    ["1_000", "2_000", "3"],
    ["0x10", "0x11", "5"],
    ["inf", "1e5", "+.5", " 3", "-2"],
    ["a", "1", "2", "3", "4"] * 4,            # 80 % numeric
    ["1"] * 96 + ["x"] * 4,                   # 96 % numeric
    ["?", "null", "~", "*"],                  # only missing tokens
    ["aa", "bb", "?", "cc"],
])
def test_detect_type_matches_jax(tokens):
    mc_t = ModelConfig.from_dict({"dataSet": {
        "missingOrInvalidValues": MISSING}})
    mc_j = JModelConfig.from_dict({"dataSet": {
        "missingOrInvalidValues": MISSING}})
    want = jdetect(pd.Series(tokens, dtype=object), mc_j)
    got = _detect_type(np.asarray(tokens), mc_t)
    assert got.value == want.value, tokens


EXPRESSIONS = [
    "num_0 > 0.5",
    "num_0 gt 0.5 && cat_0 == 'aa'",
    "num_1 le -0.2 || cat_1 ne \"dd\"",
    "cat_0 == 'a&&b' or cat_0 == 'bb'",
    "-1 < num_2 <= 1",
    "not (num_3 >= 0) and diagnosis == 'M'",
    "(num_0 + num_1) * 2 > num_2 - 1",
    "cat_0 != 'aa' & num_4 < 0 | num_5 > 1",
    "wgt >= 1.5 and rowid % 3 == 0",
    "num_0 == 'x'",
]


@pytest.mark.parametrize("numeric", [False, True])
@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_purifier_matches_jax(tmp_path, expr, numeric):
    root = _model_set(tmp_path, 14, n_rows=600)
    kw = {"numeric_columns": NUM} if numeric else {}
    df = jread(JModelConfig.load(root), **kw)
    table = read_raw_table(ModelConfig.load(root), **kw)
    want = JPurifier(expr).apply(df)
    got = DataPurifier(expr).apply(table)
    assert got.dtype == bool and len(got) == len(table)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got) or expr == "num_0 == 'x'"


@pytest.mark.parametrize("expr", ["num_0 in [1, 2]", "__import__('os')",
                                  "num_0.real > 1", "unknown_col > 1",
                                  "lambda: 1"])
def test_purifier_rejects_other_syntax(tmp_path, expr):
    root = _model_set(tmp_path, 15, n_rows=100)
    table = read_raw_table(ModelConfig.load(root))
    with pytest.raises(ValueError):
        DataPurifier(expr).apply(table)


def test_missing_mask_parse_tags_and_valid_tag_mask(tmp_path):
    from shifu_tpu.data import dataset as jds
    from shifu_tpu.data.reader import missing_mask as jmissing
    from shifu_tpu_torch.data import dataset as tds
    from shifu_tpu_torch.data.reader import missing_mask
    vals = np.asarray(["1", "?", "", "x", "null", " ?"])
    for miss in (MISSING, []):
        np.testing.assert_array_equal(missing_mask(vals, miss),
                                      jmissing(vals, miss))
    raw = np.asarray([" M", "B", "c2", "x", "0.5", "", "c0 "])
    for pos, neg, classes in ((["M"], ["B"], None), ([], [], None),
                              (["c0"], ["c1", "c2"], ["c0", "c1", "c2"])):
        np.testing.assert_array_equal(
            tds.parse_tags(raw, pos, neg, classes),
            jds.parse_tags(raw, pos, neg, classes))
    root = _model_set(tmp_path, 16, n_rows=200)
    with open(os.path.join(root, "data", "part-00000"), "a") as f:
        f.write("|".join(["1"] * 10 + ["X"]) + "\n")    # an unknown tag
    want = jds.valid_tag_mask(JModelConfig.load(root),
                              jread(JModelConfig.load(root)))
    got = tds.valid_tag_mask(ModelConfig.load(root),
                             read_raw_table(ModelConfig.load(root)))
    np.testing.assert_array_equal(got, want)
    assert not got[-1] and got[:-1].all()


@pytest.mark.parametrize("edit", [
    {}, {"basic": {"name": ""}}, {"stats": {"maxNumBin": 1}},
    {"dataSet": {"posTags": []}}, {"normalize": {"stdDevCutOff": -1}},
    {"dataSet": {"weightColumnName": "diagnosis"}},
    {"dataSet": {"metaColumnNameFile": "no/such/file"}},
    {"train": {"algorithm": "GBT", "params": {"Loss": "hinge",
                                              "MaxDepth": 40}}},
    {"stats": {"maxNumBinn": 3}},
])
def test_probe_matches_jax(tmp_path, edit):
    """`config/inspector.probe` gives the JAX package's causes and
    warnings for every step."""
    import json
    from shifu_tpu.config.inspector import ModelStep as JStep
    from shifu_tpu.config.inspector import probe as jprobe
    from shifu_tpu_torch.config.inspector import ModelStep, probe
    root = _model_set(tmp_path, 17, n_rows=50)
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as f:
        mc = json.load(f)
    for section, fields in edit.items():
        mc[section].update(fields)
    with open(path, "w") as f:
        json.dump(mc, f)
    for step in ModelStep:
        want = jprobe(JModelConfig.load(root), JStep(step.value))
        got = probe(ModelConfig.load(root), step)
        assert (got.status, got.causes, got.warnings) == \
            (want.status, want.causes, want.warnings), step
