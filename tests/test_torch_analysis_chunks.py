"""Port parity for the analysis steps past SHIFU_TPU_ANALYSIS_CHUNK_ROWS:
the exact chunked `stats -correlation` and `stats -psi`, varselect's
sampled analysis frame (`processor/chunking.sampled_frame`,
`analysis_frame`) and `splitmix64_uniform`, plain PyTorch on the CPU
against the JAX package on copies of the same synth sets (a private
`np.random.default_rng` each).

Tolerances: chunked Pearson within 1e-5 of the JAX package's (its raw
f32 moments against the port's shifted ones, C-ref-2) and of the port's
resident matrix; chunked psi within 1e-6 and psi.csv equal to the text
(integer counts); `sampled_frame` and `splitmix64_uniform` equal to the
bit; varselect KS and SE on the sampled frame select the same columns
(SE's deltas within 1e-5 of the largest, from the JAX package's initial
weights).
"""

import os

import numpy as np
import pytest

from tests.test_torch_stats_flags import base  # noqa: F401
from tests.test_torch_stats_flags import _pf, jax_ctx, pair, port, read_matrix
from tests.test_torch_varselect import assert_same
from tests.test_torch_varselect import base as vs_base  # noqa: F401
from tests.test_torch_varselect import jax_init  # noqa: F401
from tests.test_torch_varselect import pair as vs_pair
from tests.test_torch_varselect import port as vs_port


def test_chunked_correlation_matches_jax(base, tmp_path, monkeypatch,
                                         capsys):
    from shifu_tpu.processor import correlation
    jroot, proot = pair(base["statted"], tmp_path)
    resident = pair(base["statted"], tmp_path / "resident")[1]
    port(resident, "stats", "-correlation")
    monkeypatch.setenv("SHIFU_TPU_ANALYSIS_CHUNK_ROWS", "256")
    assert correlation.run(jax_ctx(jroot)) == 0
    line = port(proot, "stats", "-correlation", capsys=capsys)
    assert line["rows"] == 1200
    names, want = read_matrix(_pf(jroot).correlation_path())
    got_names, got = read_matrix(_pf(proot).correlation_path())
    _, whole = read_matrix(_pf(resident).correlation_path())
    assert got_names == names and len(names) == 8
    assert float(np.abs(got - want).max()) <= 1e-5
    assert float(np.abs(got - whole).max()) <= 1e-5


def test_chunked_psi_matches_jax(base, tmp_path, monkeypatch, capsys):
    import json
    from shifu_tpu.processor import psi
    jroot, proot = pair(base["statted"], tmp_path)
    resident = pair(base["statted"], tmp_path / "resident")[1]
    port(resident, "stats", "-psi")
    monkeypatch.setenv("SHIFU_TPU_ANALYSIS_CHUNK_ROWS", "300")
    assert psi.run(jax_ctx(jroot)) == 0
    line = port(proot, "stats", "-psi", capsys=capsys)
    assert line["rows"] == 1200 and line["cohorts"] == 4
    with open(os.path.join(jroot, "ColumnConfig.json")) as f:
        want = json.load(f)
    with open(os.path.join(proot, "ColumnConfig.json")) as f:
        got = json.load(f)
    n = 0
    for a, b in zip(got, want):
        sa, sb = a["columnStats"], b["columnStats"]
        assert sa["unitStats"] == sb["unitStats"]
        if sb.get("psi") is not None:
            assert abs(sa["psi"] - sb["psi"]) <= 1e-6
            n += 1
    assert n == 8
    texts = []
    for root in (proot, jroot, resident):
        with open(_pf(root).psi_path()) as f:
            texts.append(f.read())
    assert texts[0] == texts[1] == texts[2]


@pytest.mark.parametrize("seed,start,n", [(12306, 0, 1000),
                                          (7, 123_456_789, 333),
                                          (2 ** 40 + 5, 2 ** 33, 64)])
@pytest.mark.parametrize("purpose", ["", "analysis-sample", "thin",
                                     "val-split"])
def test_splitmix64_uniform_bit_equal(seed, start, n, purpose):
    from shifu_tpu.processor.chunking import splitmix64_uniform as jsm
    from shifu_tpu_torch.processor.chunking import splitmix64_uniform
    np.testing.assert_array_equal(splitmix64_uniform(start, n, seed,
                                                     purpose),
                                  jsm(start, n, seed, purpose))


@pytest.mark.parametrize("cap,chunk", [(5000, 250), (300, 250),
                                       (100, 1000)])
def test_sampled_frame_bit_equal(base, cap, chunk):
    """The same rows, value for value, for a rate of 1, a rate below 1
    and a sample thinned to the cap."""
    from shifu_tpu.config.model_config import ModelConfig as JMC
    from shifu_tpu.processor.chunking import sampled_frame as jsampled
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.processor.chunking import sampled_frame
    root = base["raw"]
    want = jsampled(JMC.load(root), cap, chunk_rows=chunk)
    got = sampled_frame(ModelConfig.load(root), cap, chunk_rows=chunk)
    assert got is not None and len(got) == len(want)
    assert len(got) <= cap and 0 < len(got)
    assert got.columns == [str(c) for c in want.columns]
    for c in want.columns:
        np.testing.assert_array_equal(got[c], want[c].astype(str).to_numpy(),
                                      err_msg=c)


def _se(root):
    with open(os.path.join(root, "varsel", "se.0")) as f:
        lines = f.read().splitlines()
    head = [ln for ln in lines if ln.startswith("#")]
    rows = [ln.split("\t") for ln in lines if not ln.startswith("#")]
    return head, {n: float(v) for n, v in rows}


@pytest.mark.parametrize("by", ["KS", "SE"])
def test_varselect_on_the_sampled_frame_matches_jax(vs_base, tmp_path,
                                                    monkeypatch, capsys,
                                                    jax_init, by):
    from shifu_tpu.processor import varselect as jvs
    from shifu_tpu.processor.base import ProcessorContext
    jroot, proot = vs_pair(vs_base, tmp_path, lambda mc: mc["varSelect"]
                           .update(filterBy=by, filterNum=4))
    monkeypatch.setenv("SHIFU_TPU_ANALYSIS_CHUNK_ROWS", "300")
    monkeypatch.setenv("SHIFU_TPU_ANALYSIS_MAX_ROWS", "600")
    assert jvs.run(ProcessorContext.load(jroot)) == 0
    rc, line = vs_port(proot, "varsel", capsys=capsys)
    assert rc == 0
    assert_same(jroot, proot)
    if by == "SE":
        assert 0 < line["rows"] <= 600
        (jhead, want), (head, got) = _se(jroot), _se(proot)
        assert head == jhead and len(head) == 1 and "uniform sample" in \
            head[0]
        assert list(got) == list(want)
        scale = max(abs(v) for v in want.values())
        assert max(abs(got[k] - want[k]) for k in want) / scale <= 1e-5
