"""Port parity for the `stats` flags and DateStats.

A synth model set (`tests/synth.py`, a private `np.random.default_rng`)
gains a meta column `month` (four values), named as both
`stats#psiColumnName` and `dataSet#dateColumnName`; the JAX package's
`init` and `stats` run on it once. Each test copies it twice and runs
the JAX package's step on one copy and the port's verb with
`--device cpu` on the other:

- `stats -correlation` (and `export -t correlation`): the Pearson matrix
  within 1e-5;
- `stats -psi`: each column's psi and per-cohort unitStats within 1e-6,
  psi.csv equal;
- `stats -rebin` with `-n`, `-vars`, `-ivr` and `-bic`: ColumnConfig.json
  equal;
- DateStats (written by the port's own `stats`): `compute_date_stats`
  within 1e-6 relative of the JAX package's on the same arrays, and
  DateStats.csv equal to the JAX package's.
"""

import json
import os
import shutil

import numpy as np
import pytest

from shifu_tpu_torch import cli

MONTHS = ["2023-01", "2023-02", "2023-03", "2023-04"]


def _edit(root, fn):
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as f:
        mc = json.load(f)
    fn(mc)
    with open(path, "w") as f:
        json.dump(mc, f, indent=2)


def _add_month(data_dir, rng):
    with open(os.path.join(data_dir, ".pig_header")) as f:
        header = f.read().strip()
    with open(os.path.join(data_dir, ".pig_header"), "w") as f:
        f.write(header + "|month\n")
    with open(os.path.join(data_dir, "part-00000")) as f:
        lines = f.read().splitlines()
    months = rng.choice(MONTHS, len(lines), p=[0.4, 0.3, 0.2, 0.1])
    with open(os.path.join(data_dir, "part-00000"), "w") as f:
        f.write("".join(f"{line}|{m}\n" for line, m in zip(lines, months)))


def jax_ctx(root):
    from shifu_tpu.processor.base import ProcessorContext
    return ProcessorContext.load(root)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The synth set with its month column, before any step, and the
    same set after the JAX package's init and stats."""
    from shifu_tpu.processor import init, stats
    from tests.synth import make_model_set
    top = tmp_path_factory.mktemp("flags")
    raw = make_model_set(top / "raw", np.random.default_rng(150),
                         n_rows=1500)
    rng = np.random.default_rng(151)
    for sub in ("data", "evaldata"):
        _add_month(os.path.join(raw, sub), rng)
    with open(os.path.join(raw, "columns", "meta.column.names"), "a") as f:
        f.write("month\n")

    def conf(mc):
        mc["dataSet"]["dateColumnName"] = "month"
        mc["stats"]["psiColumnName"] = "month"
    _edit(raw, conf)
    statted = copy_set(raw, str(top / "statted"))
    for proc in (init, stats):
        assert proc.run(jax_ctx(statted)) == 0
    return {"raw": raw, "statted": statted}


def copy_set(src, dst):
    shutil.copytree(src, dst)
    path = os.path.join(dst, "ModelConfig.json")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace(src, dst))
    return dst


def pair(src, tmp_path):
    return [copy_set(src, str(tmp_path / n)) for n in ("jax", "port")]


def port(root, *args, capsys=None):
    assert cli.main(["--dir", root, *args, "--device", "cpu"]) == 0
    if capsys is not None:
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return None


def _pf(root):
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.config.path_finder import PathFinder
    return PathFinder(ModelConfig.load(root), root=root)


def read_matrix(path):
    with open(path) as f:
        header = f.readline().strip().split(",")[1:]
        rows = [line.strip().split(",") for line in f]
    assert [r[0] for r in rows] == header
    return header, np.asarray([[float(v) for v in r[1:]] for r in rows])


@pytest.mark.parametrize("verb", [["stats", "-correlation"],
                                  ["export", "-t", "correlation"]])
def test_correlation_matches_jax(base, tmp_path, capsys, verb):
    from shifu_tpu.processor import correlation
    jroot, proot = pair(base["statted"], tmp_path)
    assert correlation.run(jax_ctx(jroot)) == 0
    line = port(proot, *verb, capsys=capsys)
    assert line["device"] == "cpu" and line["rows"] == 1200
    names, want = read_matrix(_pf(jroot).correlation_path())
    got_names, got = read_matrix(_pf(proot).correlation_path())
    assert got_names == names and len(names) == 8
    err = float(np.abs(got - want).max())
    print(f"{verb}: Pearson within {err:.1e}")
    assert err <= 1e-5
    assert np.allclose(np.diag(got), 1.0)


def test_pearson_moments_match_jax():
    import jax.numpy as jnp
    import torch
    from shifu_tpu.processor import correlation as jcor
    from shifu_tpu_torch.processor import correlation as pcor
    rng = np.random.default_rng(152)
    x = rng.normal(0, 2, (500, 7)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    want = [np.asarray(m) for m in jcor.pearson_moments(jnp.asarray(x))]
    got = [m.numpy() for m in pcor.pearson_moments(torch.as_tensor(x))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(pcor.pearson_from_moments(*got),
                               jcor.pearson_from_moments(*want), atol=1e-5)


def test_psi_matches_jax(base, tmp_path, capsys):
    from shifu_tpu.processor import psi
    jroot, proot = pair(base["statted"], tmp_path)
    assert psi.run(jax_ctx(jroot)) == 0
    line = port(proot, "stats", "-psi", capsys=capsys)
    assert line["step"] == "stats -psi" and line["rows"] == 1200
    with open(os.path.join(jroot, "ColumnConfig.json")) as f:
        want = json.load(f)
    with open(os.path.join(proot, "ColumnConfig.json")) as f:
        got = json.load(f)
    n = 0
    for a, b in zip(got, want):
        sa, sb = a.pop("columnStats"), b.pop("columnStats")
        assert a == b
        assert sa.pop("unitStats") == sb.pop("unitStats")
        if sb.get("psi") is not None:
            assert abs(sa.pop("psi") - sb.pop("psi")) <= 1e-6
            n += 1
        assert sa == sb
    assert n == 8
    with open(_pf(proot).psi_path()) as f, open(_pf(jroot).psi_path()) as g:
        assert f.read() == g.read()


def test_psi_needs_its_column(base, tmp_path):
    (proot,) = [copy_set(base["statted"], str(tmp_path / "p"))]
    _edit(proot, lambda mc: mc["stats"].update(psiColumnName=""))
    with pytest.raises(ValueError, match="psiColumnName"):
        port(proot, "stats", "-psi")


@pytest.mark.parametrize("flags", [
    ["-n", "5"], ["-n", "3", "-vars", "num_0,cat_0,wgt"],
    ["-n", "4", "-ivr", "0.9", "-bic", "60"]])
def test_rebin_matches_jax(base, tmp_path, capsys, flags):
    from shifu_tpu.processor import stats
    jroot, proot = pair(base["statted"], tmp_path)
    opt = dict(zip(flags[::2], flags[1::2]))
    assert stats.run_rebin(
        jax_ctx(jroot), request_vars=opt.get("-vars"),
        expect_bin_num=int(opt.get("-n", -1)),
        iv_keep_ratio=float(opt.get("-ivr", 1.0)),
        min_inst_cnt=int(opt.get("-bic", 0))) == 0
    line = port(proot, "stats", "-rebin", *flags, capsys=capsys)
    assert line["device"] == "host"
    want, got = (json.load(open(os.path.join(r, "ColumnConfig.json")))
                 for r in (jroot, proot))
    assert got == want
    lengths = [c["columnBinning"]["length"] for c in got
               if c["columnBinning"].get("length")]
    assert max(lengths) <= int(opt["-n"]) or "-vars" in opt


def test_date_stats_kernel_matches_jax():
    from shifu_tpu.processor.datestat import compute_date_stats as jds
    from shifu_tpu_torch.processor.datestat import compute_date_stats as pds
    rng = np.random.default_rng(153)
    v = rng.normal(3, 2, (2000, 5)).astype(np.float32)
    v[rng.random(v.shape) < 0.05] = np.nan
    v[:, 4] = np.nan                       # an all-missing column
    tags = (rng.random(2000) < 0.3).astype(np.float32)
    ids = rng.integers(0, 6, 2000).astype(np.int32)   # date 5 empty-ish
    ids[ids == 5] = 4
    want = jds(v, tags, ids, 6)
    got = pds(v, tags, ids, 6, device="cpu")
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=k)


def test_stats_writes_date_stats_like_jax(base, tmp_path, capsys):
    """The port's own init + stats on the raw set write the JAX
    package's DateStats.csv."""
    proot = copy_set(base["raw"], str(tmp_path / "port"))
    assert cli.main(["--dir", proot, "init"]) == 0
    line = port(proot, "stats", capsys=capsys)
    assert line["rows"] == 1200
    with open(_pf(proot).date_stats_path()) as f:
        got = f.read().splitlines()
    with open(_pf(base["statted"]).date_stats_path()) as f:
        want = f.read().splitlines()
    assert got[0] == want[0] == "date,column," + ",".join(
        ["count", "missing", "mean", "stdDev", "min", "max", "sum",
         "posCount"])
    assert len(got) == len(want) == 1 + 4 * 6
    assert got == want
