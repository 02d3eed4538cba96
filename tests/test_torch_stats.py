"""Port parity for the column math of `stats` (and the ColumnConfig
comparison the slice tests share).

The port's `ops/stats.py` and `ops/binning.py` run on the CPU against
the JAX package's on the same numpy inputs, each test on a private
`np.random.default_rng(seed)`:

- `weighted_quantiles` and `bin_index_numeric` bit-exact (0/1 weights);
  under real weights each quantile equals JAX's or is the value next to
  it in the sorted column;
- `bin_accumulate` / `cat_bin_accumulate`: counts exact, weighted sums
  within rtol 1e-5;
- `moment_stats`: min/max/count/missing exact, mean/std within rtol
  1e-5, skewness/kurtosis within atol 1e-4, an all-NaN column NaN;
- `compute_numeric_binning` for every `BinningMethod`;
- `stats` on `tests/synth.py` model sets under each binning method:
  ColumnConfig.json against the JAX step's (`assert_column_configs`).
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shifu_tpu.config.model_config import BinningMethod as JBM
from shifu_tpu.ops import binning as jbinning
from shifu_tpu.ops import stats as jstats
from shifu_tpu_torch.config.model_config import BinningMethod
from shifu_tpu_torch.ops import binning as tbinning
from shifu_tpu_torch.ops import stats as tstats

# ---------------------------------------------------------------------------
# ColumnConfig comparison under the slice's tolerances
# ---------------------------------------------------------------------------

STATS_RTOL5 = {"mean", "stdDev"}
STATS_ATOL4 = {"skewness", "kurtosis"}
BIN_RTOL5 = {"binWeightedPos", "binWeightedNeg"}
# a bin's weighted WOE is a log ratio of f32 weighted sums, which the JAX
# package adds over 8 CPU shards and the port in row order: it holds
# rtol 1e-5 with an atol of 1e-6 for WOEs near 0, and it must equal
# JAX's `column_metrics` of the port's own weighted counts (rtol 1e-9)
BIN_WOE = {"binWeightedWoe"}
# metrics of the counts: checked against JAX's `column_metrics` of the
# port's own counts (rtol 1e-9), so a weighted metric inherits no
# tolerance from its weighted counts
METRICS = {"ks", "iv", "woe", "weightedKs", "weightedIv", "weightedWoe"}
WEIGHT_METHODS = {"WeightEqualPositive", "WeightEqualNegative",
                  "WeightEqualTotal"}


def _close(a, b, rtol=0.0, atol=0.0):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return a.shape == b.shape and np.allclose(a, b, rtol=rtol, atol=atol,
                                              equal_nan=True)


def _adjacent_moves(want, got, column):
    """How many boundaries moved to the neighbouring value of the sorted
    column; raises when one moved further."""
    vals = np.unique(column[~np.isnan(column)]).astype(np.float32)
    want = np.asarray(want[1:], np.float32)
    got = np.asarray(got[1:], np.float32)
    assert len(want) == len(got), (want, got)
    pos_w = np.searchsorted(vals, want)
    pos_g = np.searchsorted(vals, got)
    assert np.all(np.abs(pos_w - pos_g) <= 1), (want, got)
    return int((pos_w != pos_g).sum())


def assert_column_configs(jax_path, port_path, method="EqualPositive",
                          raw_columns=None):
    """ColumnConfig.json of the port's `stats` against the JAX step's.
    Returns how many bin boundaries moved to a neighbouring value (only
    possible under a Weight* method)."""
    with open(jax_path) as f:
        want = json.load(f)
    with open(port_path) as f:
        got = json.load(f)
    assert [c["columnName"] for c in got] == [c["columnName"] for c in want]
    moved = 0
    for w, g in zip(want, got):
        name = w["columnName"]
        assert set(g) == set(w), name
        for k in w:
            if k not in ("columnStats", "columnBinning"):
                assert g[k] == w[k], (name, k)
        ws, gs = w["columnStats"], g["columnStats"]
        wb, gb = w["columnBinning"], g["columnBinning"]
        assert set(gs) == set(ws) and set(gb) == set(wb), name
        for k in ws:
            if k in STATS_RTOL5:
                assert _close(gs[k], ws[k], rtol=1e-5), (name, k)
            elif k in STATS_ATOL4:
                assert _close(gs[k], ws[k], atol=1e-4), (name, k)
            elif k not in METRICS:
                assert gs[k] == ws[k], (name, k, gs[k], ws[k])
        for k in wb:
            if k in BIN_RTOL5:
                assert _close(gb[k], wb[k], rtol=1e-5, atol=1e-9), (name, k)
            elif k in BIN_WOE:
                assert _close(gb[k], wb[k], rtol=1e-5, atol=1e-6), (name, k)
            elif k == "binBoundary" and method in WEIGHT_METHODS \
                    and wb[k] is not None:
                col = raw_columns[name] if raw_columns else None
                if gb[k] != wb[k]:
                    moved += _adjacent_moves(wb[k], gb[k], col)
            elif k != "binCountWoe":
                assert gb[k] == wb[k], (name, k)
        if gb["binCountPos"] is None:
            continue
        for kind, pos, neg, woe in (
                ("", gb["binCountPos"], gb["binCountNeg"],
                 gb["binCountWoe"]),
                ("weighted", gb["binWeightedPos"], gb["binWeightedNeg"],
                 gb["binWeightedWoe"])):
            ks, iv, cw, bin_woe = jstats.column_metrics(pos, neg)
            keys = ("ks", "iv", "woe") if not kind else \
                ("weightedKs", "weightedIv", "weightedWoe")
            for key, ref in zip(keys, (ks, iv, cw)):
                if ref is None:
                    assert gs[key] is None, (name, key)
                else:
                    assert _close(gs[key], ref, rtol=1e-9), (name, key)
            assert _close(woe, bin_woe, rtol=1e-9, atol=1e-12), name
            if not kind:
                assert _close(woe, wb["binCountWoe"], rtol=1e-9,
                              atol=1e-12), name
    return moved


# ---------------------------------------------------------------------------
# Column math on numpy inputs
# ---------------------------------------------------------------------------

def _values(seed, r=3000, c=5):
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 1, (r, c)).astype(np.float32)
    v[:, 1] = np.round(v[:, 1] * 2)                  # discrete, ties
    v[rng.random((r, c)) < 0.05] = np.nan
    v[:, 3] = np.nan                                  # all missing
    v[:7, 4] = np.inf
    tags = (rng.random(r) < 0.3).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, r).astype(np.float32)
    return v, tags, weights


@pytest.mark.parametrize("q", [1, 3, 9, 62])
def test_weighted_quantiles_bit_exact_with_unit_weights(q):
    v, tags, _ = _values(1)
    w = np.broadcast_to(tags[:, None], v.shape).astype(np.float32)
    for ww in (w, np.ones_like(v)):
        want = np.asarray(jstats.weighted_quantiles(jnp.asarray(v),
                                                    jnp.asarray(ww), q))
        got = tstats.weighted_quantiles(torch.as_tensor(v),
                                        torch.as_tensor(ww), q).numpy()
        np.testing.assert_array_equal(got, want)
    assert np.isnan(got[:, 3]).all()


def test_weighted_quantiles_real_weights_land_on_a_neighbour():
    v, tags, weights = _values(2)
    w = np.broadcast_to((tags * weights)[:, None], v.shape) \
        .astype(np.float32)
    want = np.asarray(jstats.weighted_quantiles(jnp.asarray(v),
                                                jnp.asarray(w), 62))
    got = tstats.weighted_quantiles(torch.as_tensor(v), torch.as_tensor(w),
                                    62).numpy()
    moved = 0
    for j in range(v.shape[1]):
        if np.isnan(want[:, j]).all():
            assert np.isnan(got[:, j]).all()
            continue
        moved += _adjacent_moves(np.r_[-np.inf, want[:, j]],
                                 np.r_[-np.inf, got[:, j]], v[:, j])
    print(f"weighted quantiles: {moved} of {want.size} moved one value")


@pytest.mark.parametrize("n_cuts", [1, 9, 63])
def test_bin_index_numeric_bit_exact(n_cuts):
    v, _, _ = _values(3)
    v[:9, 0] = -np.inf
    cuts = np.full((n_cuts, v.shape[1]), np.inf, np.float32)
    rng = np.random.default_rng(3)
    for j in range(v.shape[1]):
        k = rng.integers(0, n_cuts + 1)
        cuts[:k, j] = np.sort(rng.normal(0, 1, k)).astype(np.float32)
    cuts[0, 0] = v[10, 0] if not np.isnan(v[10, 0]) else 0.0
    cuts[:, 0] = np.sort(cuts[:, 0])
    want = np.asarray(jstats.bin_index_numeric(jnp.asarray(v),
                                               jnp.asarray(cuts)))
    got = tstats.bin_index_numeric(torch.as_tensor(v),
                                   torch.as_tensor(cuts)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_bin_accumulate_counts_exact_weights_close():
    rng = np.random.default_rng(4)
    r, c, slots = 4000, 6, 11
    idx = rng.integers(0, slots, (r, c)).astype(np.int32)
    tags = (rng.random(r) < 0.4).astype(np.float32)
    w = rng.uniform(0.1, 3.0, r).astype(np.float32)
    mask = (rng.random(r) < 0.9).astype(np.float32)
    for m in (None, mask):
        want = jstats.bin_accumulate(jnp.asarray(idx), jnp.asarray(tags),
                                     jnp.asarray(w), slots,
                                     None if m is None else jnp.asarray(m))
        got = tstats.bin_accumulate(torch.as_tensor(idx),
                                    torch.as_tensor(tags),
                                    torch.as_tensor(w), slots,
                                    None if m is None else torch.as_tensor(m))
        for k in ("count_pos", "count_neg"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        for k in ("weight_pos", "weight_neg"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5)


def test_cat_bin_accumulate_exact():
    rng = np.random.default_rng(5)
    r = 3000
    vocab = np.array([4, 1, 7], np.int32)
    codes = np.stack([rng.integers(-1, v, r) for v in vocab], 1) \
        .astype(np.int32)
    tags = (rng.random(r) < 0.4).astype(np.float32)
    w = np.ones(r, np.float32)
    want = jstats.cat_bin_accumulate(jnp.asarray(codes), jnp.asarray(tags),
                                     jnp.asarray(w), jnp.asarray(vocab), 8)
    got = tstats.cat_bin_accumulate(torch.as_tensor(codes),
                                    torch.as_tensor(tags),
                                    torch.as_tensor(w),
                                    torch.as_tensor(vocab), 8)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_moment_stats():
    v, _, _ = _values(6)
    v = np.where(np.isinf(v), np.nan, v)
    mask = np.ones(len(v), np.float32)
    mask[-50:] = 0.0
    for m in (None, mask):
        want = {k: np.asarray(x) for k, x in jstats.moment_stats(
            jnp.asarray(v), None if m is None else jnp.asarray(m)).items()}
        got = {k: x.numpy() for k, x in tstats.moment_stats(
            torch.as_tensor(v),
            None if m is None else torch.as_tensor(m)).items()}
        assert set(got) == set(want)
        for k in ("count", "min", "max", "missing"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("mean", "std"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
        for k in ("skewness", "kurtosis"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-4,
                                       err_msg=k)
        for k in ("mean", "min", "max"):
            assert np.isnan(got[k][3]), k
        assert got["std"][3] == 0.0 and got["count"][3] == 0.0


@pytest.mark.parametrize("method", [m.value for m in BinningMethod])
def test_compute_numeric_binning_every_method(method):
    v, tags, weights = _values(7)
    want = jbinning.compute_numeric_binning(v, tags, weights, JBM(method),
                                            20)
    got = tbinning.compute_numeric_binning(
        torch.as_tensor(v), torch.as_tensor(tags), torch.as_tensor(weights),
        BinningMethod(method), 20)
    assert len(got.boundaries) == len(want.boundaries)
    if method in WEIGHT_METHODS:
        moved = sum(_adjacent_moves(w, g, v[:, j]) for j, (w, g) in
                    enumerate(zip(want.boundaries, got.boundaries)))
        print(f"{method}: {moved} boundaries moved one value")
        return
    for g, w in zip(got.boundaries, want.boundaries):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.cuts_padded, want.cuts_padded)


@pytest.mark.parametrize("cap", [0, 2, 3, 10])
def test_cap_categories(cap):
    vocab = ["a", "b", "c", "d", "e"]
    counts = np.array([5, 9, 1, 9, 3])
    assert tbinning.cap_categories(vocab, counts, cap) == \
        jbinning.cap_categories(vocab, counts, cap)
    assert tbinning.cap_categories(vocab, None, cap) == \
        jbinning.cap_categories(vocab, None, cap)


def test_column_metrics_and_psi_are_the_jax_functions():
    rng = np.random.default_rng(8)
    p = rng.integers(0, 50, 12).astype(float)
    n = rng.integers(0, 50, 12).astype(float)
    a, b = jstats.column_metrics(p, n), tstats.column_metrics(p, n)
    assert a[:3] == b[:3]
    np.testing.assert_array_equal(a[3], b[3])
    assert tstats.column_metrics(p, 0 * n)[0] is None
    assert tstats.psi_metric(p / p.sum(), n / n.sum()) == \
        jstats.psi_metric(p / p.sum(), n / n.sum())


# ---------------------------------------------------------------------------
# `stats` on model sets under each binning method
# ---------------------------------------------------------------------------

def make_sets(tmp_path, seed, n_rows=1500, edit=None, **kw):
    """A synth model set for the JAX steps and a copy for the port's,
    taken before either runs; `edit(dict)` rewrites ModelConfig.json on
    both."""
    from tests.synth import make_model_set
    root = make_model_set(tmp_path / "jax", np.random.default_rng(seed),
                          n_rows=n_rows, **kw)
    if edit is not None:
        path = os.path.join(root, "ModelConfig.json")
        with open(path) as f:
            mc = json.load(f)
        edit(mc)
        with open(path, "w") as f:
            json.dump(mc, f, indent=2)
    port = str(tmp_path / "port")
    shutil.copytree(root, port)
    # the JAX config points at the JAX copy's files; repoint the port's
    path = os.path.join(port, "ModelConfig.json")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace(root, port))
    return root, port


def run_jax(root, steps=("init", "stats", "norm")):
    from shifu_tpu.processor import init, norm, stats
    from shifu_tpu.processor.base import ProcessorContext
    procs = {"init": init, "stats": stats, "norm": norm}
    for s in steps:
        assert procs[s].run(ProcessorContext.load(root)) == 0


def run_port(port, steps=("init", "stats", "norm")):
    from shifu_tpu_torch import cli
    for s in steps:
        args = [s] if s == "init" else [s, "--device", "cpu"]
        assert cli.main(["--dir", port, *args]) == 0


def raw_numeric(root):
    """The raw numeric columns of a synth set, for the neighbour check."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.data.reader import read_raw_table
    t = read_raw_table(ModelConfig.load(root),
                       numeric_columns=[f"num_{j}" for j in range(6)])
    return {c: t[c] for c in t.columns if t[c].dtype.kind == "f"}


@pytest.mark.parametrize("method", [m.value for m in BinningMethod])
def test_stats_step_every_binning_method(tmp_path, method):
    def edit(mc):
        mc["stats"]["binningMethod"] = method
        mc["stats"]["maxNumBin"] = 12
    root, port = make_sets(tmp_path, 31, edit=edit)
    run_jax(root, ("init", "stats"))
    run_port(port, ("init", "stats"))
    moved = assert_column_configs(os.path.join(root, "ColumnConfig.json"),
                                  os.path.join(port, "ColumnConfig.json"),
                                  method, raw_numeric(port))
    print(f"{method}: {moved} bin boundaries moved one value")


def test_stats_defaults_to_the_card(tmp_path, monkeypatch):
    from shifu_tpu_torch import cli
    _, port = make_sets(tmp_path, 32, n_rows=200)
    run_port(port, ("init",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for verb in ("stats", "norm"):
        with pytest.raises(RuntimeError, match="no CUDA"):
            cli.main(["--dir", port, verb])


@pytest.mark.parametrize("flag", [["-seg", "1"], ["-seg-merge"],
                                  ["-base-only"]])
def test_stats_variants_not_ported_raise(tmp_path, flag):
    from shifu_tpu_torch import cli
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        cli.main(["--dir", str(tmp_path), "stats", *flag, "--device",
                  "cpu"])


def test_stats_streaming_trigger_and_date_stats_raise(tmp_path,
                                                      monkeypatch):
    _, port = make_sets(tmp_path, 33, n_rows=200)
    run_port(port, ("init",))
    monkeypatch.setenv("SHIFU_TPU_STATS_CHUNK_ROWS", "100")
    with pytest.raises(NotImplementedError, match="A6"):
        run_port(port, ("stats",))
    monkeypatch.setenv("SHIFU_TPU_STATS_CHUNK_ROWS", "0")
    path = os.path.join(port, "ModelConfig.json")
    with open(path) as f:
        mc = json.load(f)
    mc["dataSet"]["dateColumnName"] = "rowid"
    with open(path, "w") as f:
        json.dump(mc, f)
    # DateStats are ported: the resident stats step writes them
    # (tests/test_torch_stats_flags.py holds them against the JAX package)
    run_port(port, ("stats",))
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.config.path_finder import PathFinder
    out = PathFinder(ModelConfig.load(port), root=port).date_stats_path()
    with open(out) as f:
        assert f.readline().startswith("date,column,count,missing")
