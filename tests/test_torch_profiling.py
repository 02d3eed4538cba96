"""The port's step records (`shifu_tpu_torch/profiling.py`, the CLI's
`step_metrics` ⊃ `trace_run` ⊃ `maybe_profile`) against the JAX
package's: the `steps.jsonl` record of `init`, `stats` and `norm` has
the JAX package's keys but the device keys, which each writes only for
an initialized backend (the JAX package: its CPU backend here; the
port: CUDA, never on a CPU run); the streaming `stats` reports the same
stage timers and chunk count; the schema tuples, row costs and
`roofline` (explicit peaks) are equal; `flush_step_record` writes the
same metric points; an injected transient read fault gives the same
retry record and `test` summary line; a supervised restart lands in the
record's events; and `maybe_profile` names its directory after the
trace run's id. Everything runs on the CPU; a private
`np.random.default_rng` where data is drawn."""

import json
import logging
import os
import shutil

import numpy as np
import pytest

from shifu_tpu import profiling as jprof
from shifu_tpu_torch import profiling as pprof

# what each package writes only for a backend it has initialized
DEVICE_KEYS = {"backend", "deviceCount", "peakBytesInUse", "bytesInUse",
               "bytesLimit"}


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    for name in ("SHIFU_TPU_TRACE", "SHIFU_TPU_TRACE_DIR", "SHIFU_TPU_FAULT",
                 "SHIFU_TPU_METRICS", "SHIFU_TPU_STATS_CHUNK_ROWS"):
        monkeypatch.delenv(name, raising=False)


def _records(root):
    path = os.path.join(root, "tmp", "metrics", "steps.jsonl")
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _pair(tmp_path, seed, n_rows=600):
    from tests.test_torch_stats import make_sets
    return make_sets(tmp_path, seed, n_rows=n_rows)


def _run_both(root, port, steps):
    from shifu_tpu.cli import main as jmain
    from shifu_tpu_torch import cli
    for s in steps:
        assert jmain(["--dir", root, s]) == 0
        args = [s] if s == "init" else [s, "--device", "cpu"]
        assert cli.main(["--dir", port, *args]) == 0


def test_step_records_carry_the_jax_keys(tmp_path):
    root, port = _pair(tmp_path, 1611)
    steps = ("init", "stats", "norm")
    _run_both(root, port, steps)
    want, got = _records(root), _records(port)
    assert [r["step"] for r in got] == [r["step"] for r in want] == \
        list(steps)
    # `inputPipeline` holds the process's stage timers, which threads a
    # test before this one left running in the same worker may feed;
    # the streaming test below holds its keys on a step that fills it
    for w, g in zip(want, got):
        assert g["rc"] == w["rc"] == 0
        assert isinstance(g["wallSeconds"], float)
        assert not set(g) & DEVICE_KEYS
        assert set(g) - {"inputPipeline"} == \
            set(w) - DEVICE_KEYS - {"inputPipeline"}, \
            (g["step"], set(g) ^ set(w))
        assert set(w) & DEVICE_KEYS <= {"backend", "deviceCount"}


def test_streaming_stats_reports_the_jax_stage_timers(tmp_path,
                                                      monkeypatch):
    root, port = _pair(tmp_path, 1612, n_rows=2500)
    monkeypatch.setenv("SHIFU_TPU_STATS_CHUNK_ROWS", "512")
    _run_both(root, port, ("init", "stats"))
    w = _records(root)[-1]["inputPipeline"]
    g = _records(port)[-1]["inputPipeline"]
    assert set(g) == set(w)
    assert {"host_parse_s", "input_stall_s", "chunks"} <= set(g)
    assert g["chunks"] == w["chunks"] > 2


def test_schema_tuples_row_costs_and_roofline_equal():
    names = [n for n in dir(jprof) if n.endswith("_FIELDS")]
    assert names and all(getattr(pprof, n) == getattr(jprof, n)
                         for n in names)
    rng = np.random.default_rng(1613)
    for _ in range(5):
        c, h = int(rng.integers(2, 700)), int(rng.integers(1, 600))
        kw = dict(train=bool(rng.integers(0, 2)),
                  dtype_bytes=int(rng.choice([2, 4])))
        assert pprof.mlp_row_costs(c, (h, 8), 3, **kw) == \
            jprof.mlp_row_costs(c, (h, 8), 3, **kw)
        assert pprof.wdl_row_costs(c, 26, 16, (h,), **kw) == \
            jprof.wdl_row_costs(c, 26, 16, (h,), **kw)
        assert pprof.mtl_row_costs(c, (h,), 4, **kw) == \
            jprof.mtl_row_costs(c, (h,), 4, **kw)
        for phase in ("build", "infer"):
            assert pprof.tree_row_costs(28, 64, 6, 20, phase=phase) == \
                jprof.tree_row_costs(28, 64, 6, 20, phase=phase)
        f, b = jprof.mlp_row_costs(c, (h,))
        rows = float(rng.uniform(1e3, 1e8))
        for peak in (67e12, 989e12):
            kw = dict(compute_dtype="float32", peak_flops=peak,
                      peak_bytes_per_s=3.35e12)
            got = pprof.roofline("NN", f, b, rows, **kw)
            assert got == jprof.roofline("NN", f, b, rows, **kw)
            assert tuple(got) == pprof.ROOFLINE_FIELDS
    # the default peaks are the card's, not a TPU's
    assert pprof.roofline("NN", 1e6, 1.0, 67e6)["mxu_util"] == 1.0
    assert pprof.roofline("NN", 1.0, 3.35e6, 1e6)["hbm_util"] == 1.0


def _points(root):
    with open(os.path.join(root, "tmp", "metrics", "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "ts"}
                for line in f if line.strip()]


def test_flush_step_record_writes_the_jax_points(tmp_path, monkeypatch):
    from shifu_tpu.obs.health import store as jstore
    from shifu_tpu_torch.obs.health import store as pstore
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    roof = pprof.roofline("NN", *pprof.mlp_row_costs(600, (512, 256)),
                          250000.0)
    rec = {"step": "train", "startedAt": 1.0, "rc": 0, "wallSeconds": 4.5,
           "inputPipeline": {"host_parse_s": 1.25, "input_stall_s": 0.5,
                             "chunks": 6, "h2d_s": 0.125},
           "roofline": roof,
           "dag": {"workers": 2, "total_devices": None, "wall_s": 3.0,
                   "critical_path_s": 2.5, "occupancy": 0.6,
                   "max_concurrent": 2, "failed": None, "nodes": []}}
    for name, store in (("jax", jstore), ("port", pstore)):
        store.flush_step_record(str(tmp_path / name), dict(rec))
    want, got = _points(str(tmp_path / "jax")), _points(str(tmp_path /
                                                            "port"))
    assert got == want
    assert {p["name"] for p in got} >= {"step.wall_s", "stage.chunks",
                                        "step.input_stall_frac",
                                        "roofline.mxu_util", "dag.wall_s"}


def test_injected_read_fault_gives_the_jax_retry_record(tmp_path,
                                                       monkeypatch):
    """`reader.native:oserror:1` through both packages' resident `stats`
    (both retry the C reader's row count): one retried call and the
    same `retries` block in the step record."""
    from shifu_tpu import resilience as jres
    from shifu_tpu_torch import resilience as pres
    root, port = _pair(tmp_path, 1614)
    _run_both(root, port, ("init",))
    monkeypatch.setenv("SHIFU_TPU_RETRY_BASE_S", "0.001")
    monkeypatch.setenv("SHIFU_TPU_FAULT", "reader.native:oserror:1")
    jres.reset_faults()
    pres.reset_faults()
    try:
        _run_both(root, port, ("stats",))
    finally:
        jres.reset_faults()
        pres.reset_faults()
    want = _records(root)[-1]["retries"]
    got = _records(port)[-1]["retries"]
    assert got == want == {"reader.native": {
        "attempts": 1,
        "lastError": "OSError: injected oserror at reader.native (call 1)"}}


def test_test_verb_summarizes_retries_as_the_jax_package(
        tmp_path, monkeypatch, caplog):
    """The `test` verb's closing I/O line: a retried read of the sampled
    rows (each package's read through its own `retrying`, as the JAX
    package reads a remote dataPath) with one injected transient fault
    gives the same line and the same `retries` record; a clean run says
    there were none."""
    from shifu_tpu import resilience as jres
    from shifu_tpu.cli import main as jmain
    from shifu_tpu.data import reader as jreader
    from shifu_tpu_torch import cli
    from shifu_tpu_torch import resilience as pres
    from shifu_tpu_torch.data import reader as preader
    from tests.synth import make_model_set
    from tests.test_torch_pipeline_dag import serialize_jax_reads
    serialize_jax_reads(monkeypatch)
    for mod, res in ((jreader, jres), (preader, pres)):
        real = mod.read_raw_table
        monkeypatch.setattr(
            mod, "read_raw_table",
            lambda *a, _r=real, _res=res, **kw: _res.retrying(
                "reader.read", _r, *a, **kw))
    src = make_model_set(tmp_path / "set", np.random.default_rng(1615),
                         n_rows=300)
    roots = {k: str(tmp_path / k) for k in ("jax", "port")}
    for r in roots.values():
        shutil.copytree(src, r)
    monkeypatch.setenv("SHIFU_TPU_RETRY_BASE_S", "0.001")
    lines = {}
    for fault in ("reader.read:oserror:1", None):
        if fault:
            monkeypatch.setenv("SHIFU_TPU_FAULT", fault)
        else:
            monkeypatch.delenv("SHIFU_TPU_FAULT")
        for name, main, res in (("jax", jmain, jres),
                                ("port", cli.main, pres)):
            res.reset_faults()
            caplog.clear()
            with caplog.at_level(logging.INFO):
                assert main(["--dir", roots[name], "test"]) == 0
            lines[name, fault] = [
                r.getMessage() for r in caplog.records
                if r.getMessage().startswith("resilience:")]
            res.reset_faults()
    for fault in ("reader.read:oserror:1", None):
        assert lines["port", fault] == lines["jax", fault]
        assert len(lines["port", fault]) == 1
    assert lines["port", None] == ["resilience: no I/O retries"]
    assert "retried 1 time(s)" in lines["port", "reader.read:oserror:1"][0]
    want, got = _records(roots["jax"]), _records(roots["port"])
    assert got[-2]["retries"] == want[-2]["retries"]
    assert "retries" not in got[-1] and "retries" not in want[-1]


def test_supervised_restart_lands_in_the_step_record(tmp_path, monkeypatch):
    from shifu_tpu_torch import resilience
    monkeypatch.setenv("SHIFU_TPU_RETRY_BASE_S", "0.001")
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise TimeoutError("transient")
        return 0

    resilience.set_abort_scope(str(tmp_path / "tmp"))
    try:
        with pprof.step_metrics(str(tmp_path), "train") as rec:
            rec["rc"] = resilience.supervise(flaky, max_restarts=2)
    finally:
        resilience.set_abort_scope(None)
    recs = _records(str(tmp_path))
    # the durable restart line, then the step's own record
    assert [r.get("event") for r in recs] == ["restart", None]
    assert recs[1]["restarts"] == 1
    assert recs[1]["events"][0]["error"] == "TimeoutError: transient"
    assert resilience.drain_events() == []


def test_maybe_profile_is_named_after_the_trace_run(tmp_path, monkeypatch):
    from shifu_tpu_torch.obs import trace as ptrace
    monkeypatch.setenv("SHIFU_TPU_TRACE", "1")
    root = str(tmp_path)
    with ptrace.trace_run(root, "train") as run, \
            pprof.maybe_profile(root, "train", True) as out:
        assert ptrace.current_run_id("train") == run.run_id
        np.dot(np.ones((64, 64)), np.ones((64, 64)))
    assert os.path.basename(out) == run.run_id
    with open(os.path.join(out, pprof.PROFILE_FILE)) as f:
        assert "traceEvents" in json.load(f)
    rows = ptrace.trace_ls(root)
    assert [r["run_id"] for r in rows] == [run.run_id]
    assert rows[0]["trace"] and rows[0]["profile"] == out
    assert rows[0]["span_files"] == 1
    with pprof.maybe_profile(root, "eval", False) as off:
        assert off is None
    # untraced: a fresh id, still namespaced by step and pid
    rid = ptrace.current_run_id("eval")
    assert rid.startswith("eval-") and rid.endswith(str(os.getpid()))


def test_device_stats_reports_nothing_without_cuda():
    import torch
    if torch.cuda.is_initialized():
        pytest.skip("CUDA already initialized in this process")
    assert pprof.device_stats() == {}
    assert not torch.cuda.is_initialized()
