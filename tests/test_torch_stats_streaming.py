"""Port parity for the streaming (>RAM) `stats` — `shifu_tpu_torch.
processor.stats_streaming` against `shifu_tpu.processor.stats_streaming.
run_streaming` on the same synth raw files and chunk rows (both read
SHIFU_TPU_STATS_CHUNK_ROWS), plain PyTorch on the CPU.

Tolerances: bin boundaries and every per-bin count equal (the fine
histogram's bin of a value is the same IEEE float64 arithmetic in both;
counts are exact sums); the float64 moments, the weighted bin sums and
KS/IV/WOE within 1e-9 relative (sums taken in another order), with an
absolute floor of 1e-9 for values near zero. Each set comes from a
private `np.random.default_rng(seed)`.
"""

import json
import os

import numpy as np
import pytest

from tests.test_torch_stats import make_sets, run_jax, run_port

CHUNK = "512"
FLOAT_STATS = ("mean", "stdDev", "skewness", "kurtosis", "min", "max",
               "median", "p25th", "p75th", "missingPercentage", "ks",
               "iv", "woe", "weightedKs", "weightedIv", "weightedWoe")
FLOAT_BINS = ("binWeightedPos", "binWeightedNeg", "binPosRate",
              "binCountWoe", "binWeightedWoe")


def _configs(root):
    with open(os.path.join(root, "ColumnConfig.json")) as f:
        return {c["columnName"]: c for c in json.load(f)}


def _close(a, b, rtol=1e-9, atol=1e-9):
    if a is None or b is None:
        return a is None and b is None
    return np.allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                       rtol=rtol, atol=atol, equal_nan=True)


def assert_streaming_configs(want_root, got_root, rtol=1e-9):
    """Every field equal, but the float64 sums and what derives from
    them within `rtol`."""
    want, got = _configs(want_root), _configs(got_root)
    assert list(want) == list(got)
    for name, w in want.items():
        g = got[name]
        for k in w:
            if k not in ("columnStats", "columnBinning"):
                assert g[k] == w[k], (name, k)
        for part, floats in (("columnStats", FLOAT_STATS),
                             ("columnBinning", FLOAT_BINS)):
            ws, gs = w[part], g[part]
            assert set(ws) == set(gs), (name, part)
            for k in ws:
                if k in floats:
                    assert _close(gs[k], ws[k], rtol), (name, k, gs[k],
                                                        ws[k])
                else:
                    assert gs[k] == ws[k], (name, k, gs[k], ws[k])


def _edit(method, sample_rate=1.0, filt=None):
    def edit(mc):
        mc["stats"]["binningMethod"] = method
        mc["stats"]["sampleRate"] = sample_rate
        if filt:
            mc["dataSet"]["filterExpressions"] = filt
    return edit


@pytest.mark.parametrize("method", ["EqualPositive", "EqualTotal",
                                    "EqualInterval", "WeightEqualTotal"])
def test_streaming_stats_match_jax(tmp_path, monkeypatch, method):
    root, port = make_sets(tmp_path, 1100, n_rows=2500, edit=_edit(method))
    monkeypatch.setenv("SHIFU_TPU_STATS_CHUNK_ROWS", CHUNK)
    run_jax(root, ("init", "stats"))
    run_port(port, ("init", "stats"))
    assert_streaming_configs(root, port)


def test_streaming_stats_sampling_and_filter_match_jax(tmp_path,
                                                       monkeypatch):
    """sampleRate keys on the global raw row index and the filter runs
    a chunk at a time: the port's ColumnConfig equals the JAX package's,
    and two chunkings give the same counts."""
    root, port = make_sets(tmp_path, 1101, n_rows=2500,
                           edit=_edit("EqualPositive", 0.5, "num_1 > -1"))
    monkeypatch.setenv("SHIFU_TPU_STATS_CHUNK_ROWS", "300")
    run_jax(root, ("init", "stats"))
    run_port(port, ("init", "stats"))
    assert_streaming_configs(root, port)
    first = _configs(port)
    monkeypatch.setenv("SHIFU_TPU_STATS_CHUNK_ROWS", "1100")
    run_port(port, ("stats",))
    for name, c in _configs(port).items():
        assert c["columnStats"]["totalCount"] == \
            first[name]["columnStats"]["totalCount"], name
        assert c["columnBinning"]["binCountPos"] == \
            first[name]["columnBinning"]["binCountPos"], name


def test_streaming_stats_order_invariant(tmp_path, monkeypatch):
    """The chunks of a label-sorted copy of the file give the same
    ColumnConfig (within the float64 sums' rounding)."""
    _, port = make_sets(tmp_path, 1102, n_rows=2500)
    monkeypatch.setenv("SHIFU_TPU_STATS_CHUNK_ROWS", "700")
    run_port(port, ("init", "stats"))
    before = str(tmp_path / "before")
    os.makedirs(before)
    with open(os.path.join(port, "ColumnConfig.json")) as f:
        text = f.read()
    with open(os.path.join(before, "ColumnConfig.json"), "w") as f:
        f.write(text)
    path = os.path.join(port, "data", "part-00000")
    with open(path) as f:
        lines = f.readlines()
    head, body = lines[:1], lines[1:]
    body.sort(key=lambda ln: ln.rsplit("|", 1)[-1])
    with open(path, "w") as f:
        f.writelines(head + body)
    run_port(port, ("stats",))
    assert_streaming_configs(before, port, rtol=1e-12)


def test_streaming_stats_near_resident(tmp_path, monkeypatch):
    """Against the port's resident stats on the same set: counts of rows
    and missing values equal, each numeric boundary within one fine bin
    (the column's range / 8,192) of the resident one, bin totals equal,
    moments within 1e-6 relative (float64 sums against the resident
    f32 ones)."""
    from shifu_tpu_torch.processor.stats_streaming import FINE_BINS
    _, port = make_sets(tmp_path, 1103, n_rows=4000)
    run_port(port, ("init", "stats"))
    resident = _configs(port)
    monkeypatch.setenv("SHIFU_TPU_STATS_CHUNK_ROWS", "512")
    run_port(port, ("stats",))
    streamed = _configs(port)
    for name, r in resident.items():
        s = streamed[name]
        sr, ss = r["columnStats"], s["columnStats"]
        br, bs = r["columnBinning"], s["columnBinning"]
        if not br.get("binCountPos"):
            continue
        for k in ("totalCount", "missingCount"):
            assert sr[k] == ss[k], (name, k)
        if br.get("binCategory") is not None:
            assert br["binCategory"] == bs["binCategory"], name
            assert br["binCountPos"] == bs["binCountPos"], name
            assert br["binCountNeg"] == bs["binCountNeg"], name
            continue
        for k in ("mean", "stdDev", "min", "max"):
            assert _close(ss[k], sr[k], rtol=1e-6, atol=1e-6), (name, k)
        fine = (sr["max"] - sr["min"]) / FINE_BINS
        b_r = np.asarray(br["binBoundary"][1:], float)
        b_s = np.asarray(bs["binBoundary"][1:], float)
        assert len(b_r) == len(b_s), name
        assert np.all(np.abs(b_r - b_s) <= fine * (1 + 1e-9)), \
            (name, np.abs(b_r - b_s).max(), fine)
        assert sum(br["binCountPos"]) == sum(bs["binCountPos"]), name
        assert sum(br["binCountNeg"]) == sum(bs["binCountNeg"]), name


def test_streaming_stats_refuse_segments(tmp_path, monkeypatch):
    """Segment expansion needs the resident path: an explicit chunk size
    is refused, as in the JAX package."""
    from shifu_tpu_torch.processor import init, stats
    from shifu_tpu_torch.processor.base import ProcessorContext
    _, port = make_sets(tmp_path, 1104, n_rows=500,
                        seg_expressions=["num_0 > 0"])
    monkeypatch.setenv("SHIFU_TPU_STATS_CHUNK_ROWS", "200")
    assert init.run(ProcessorContext.load(port)) == 0
    with pytest.raises(ValueError, match="resident stats"):
        stats.run(ProcessorContext.load(port), device="cpu")
