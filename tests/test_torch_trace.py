"""The port's span tracer (`shifu_tpu_torch/obs/trace.py`) against the
JAX package's (`shifu_tpu/obs/trace.py`): one span program recorded by
both gives the same records (names, attributes, parent structure,
order; the clock, pid, tid and ids mapped away), the same ring-buffer
drops and the same top self-time names; `merge_trace` writes the same
bytes over the same two-host span files; the disabled path writes no
file and costs at most 5 % (`tests/test_obs.py`'s interleaved
best-of-15 gate); the span registry holds both ways over the port's
sources and equals the JAX package's less its `dist` family; the
serving spans equal each request's `timing` splits on the CPU route;
and a traced `test` verb gives the JAX package's span tree. Everything
runs on the CPU; a private `np.random.default_rng` where data is drawn.
"""

import gc
import glob
import json
import os
import time

import numpy as np
import pytest

from shifu_tpu.obs import trace as jtrace
from shifu_tpu_torch.obs import trace as ptrace

PACKAGES = {"jax": jtrace, "port": ptrace}
PORT_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "shifu_tpu_torch")


@pytest.fixture(autouse=True)
def _trace_isolation(monkeypatch):
    """Every test starts with tracing off and no inherited workspace."""
    for name in ("SHIFU_TPU_TRACE", "SHIFU_TPU_TRACE_DIR",
                 "SHIFU_TPU_TRACE_BUF"):
        monkeypatch.delenv(name, raising=False)
    assert jtrace._RUN is None and ptrace._RUN is None
    yield
    jtrace._RUN = None
    ptrace._RUN = None


def _program(trace):
    """The span program both packages record: nesting, attributes, an
    error, backfilled spans with explicit parents and a named track."""
    with trace.span("ckpt.stage", step=7):
        with trace.span("ckpt.publish", step=7):
            pass
        trace.record_span("input.h2d", 1.0, 1.5, bytes=64)
    try:
        with trace.span("watch.evaluate", tenant="a"):
            raise ValueError("boom")
    except ValueError:
        pass
    nid = trace.record_span("dag.node", 2.0, 3.0, track="dag.x",
                            node="x", state="done")
    trace.record_span("dag.queue", 2.0, 2.25, parent=nid, track="dag.x")
    trace.record_span("dag.run", 2.25, 3.0, parent=nid, track="dag.x")
    for i in range(3):
        trace.record_span("input.host_parse", 4.0 + i, 4.5 + i, chunk=i)


def _normalized(spans):
    """Records with ids renamed by order of appearance and the clock,
    pid and tid dropped."""
    ids = {}
    for s in spans:
        ids.setdefault(s["id"], len(ids))
    out = []
    for s in spans:
        out.append({"id": ids[s["id"]],
                    "parent": ids.get(s["parent"], "root?")
                    if s["parent"] is not None else None,
                    "name": s["name"], "thread": s["thread"],
                    "args": s.get("args")})
    return out


def _record(trace, root, monkeypatch, buf=None):
    monkeypatch.setenv("SHIFU_TPU_TRACE", "1")
    if buf is not None:
        monkeypatch.setenv("SHIFU_TPU_TRACE_BUF", str(buf))
    with trace.trace_run(str(root), "train") as run:
        assert trace.active()
        _program(trace)
        if buf is not None:
            for _ in range(20):
                trace.record_span("input.h2d", 0.0, 0.001)
    tracer = run.tracer
    return tracer.spans(), tracer.summary(), run


def test_span_program_records_the_jax_records(tmp_path, monkeypatch):
    got = {name: _record(trace, tmp_path / name, monkeypatch)
           for name, trace in PACKAGES.items()}
    recs = {k: _normalized(v[0]) for k, v in got.items()}
    assert recs["port"] == recs["jax"]
    # the root closes last, parentless, carrying the step
    assert recs["port"][-1]["name"] == "run.step"
    assert recs["port"][-1]["parent"] is None
    assert recs["port"][-1]["args"] == {"step": "train"}
    # durations of the backfilled spans are the timestamps' differences
    for name in PACKAGES:
        dur = {s["name"]: s["dur"] for s in got[name][0]
               if s["name"] in ("dag.queue", "dag.run", "dag.node")}
        assert dur == {"dag.node": 1.0, "dag.queue": 0.25, "dag.run": 0.75}
    err = [s for s in recs["port"] if s["name"] == "watch.evaluate"][0]
    assert "boom" in err["args"]["error"]
    summ = {k: v[1] for k, v in got.items()}
    assert tuple(summ["port"]) == tuple(summ["jax"])
    assert summ["port"]["span_count"] == summ["jax"]["span_count"]
    assert summ["port"]["dropped_spans"] == 0
    assert [t["name"] for t in summ["port"]["top_self"]] == \
        [t["name"] for t in summ["jax"]["top_self"]]


def test_ring_buffer_drops_as_the_jax_package(tmp_path, monkeypatch):
    got = {name: _record(trace, tmp_path / name, monkeypatch, buf=8)
           for name, trace in PACKAGES.items()}
    for name in PACKAGES:
        assert len(got[name][0]) == 8
    assert _normalized(got["port"][0]) == _normalized(got["jax"][0])
    sp, sj = got["port"][1], got["jax"][1]
    assert (sp["span_count"], sp["dropped_spans"]) == \
        (sj["span_count"], sj["dropped_spans"])
    assert sp["dropped_spans"] == sp["span_count"] - 8 > 0
    assert [t["name"] for t in sp["top_self"]] == \
        [t["name"] for t in sj["top_self"]]


def _two_hosts(tdir):
    os.makedirs(tdir)

    def host(pid, offset, spans):
        with open(os.path.join(tdir, f"spans.{pid}.jsonl"), "w") as f:
            f.write(json.dumps({"clock": {"pid": pid,
                                          "offset_s": offset}}) + "\n")
            for i, (name, ts, dur, parent) in enumerate(spans):
                f.write(json.dumps({
                    "id": f"{pid}:{i + 1}", "parent": parent, "name": name,
                    "ts": ts, "dur": dur, "pid": pid, "tid": 1,
                    "thread": "MainThread",
                    "args": {"i": i}}) + "\n")
            f.write("\n")
            f.write("not json\n")

    rng = np.random.default_rng(1601)
    host(100, 0.0, [("run.step", 100.0, 9.0, None)]
         + [("dag.node", float(100.5 + t), float(d), "100:1")
            for t, d in zip(rng.uniform(0, 8, 5), rng.uniform(0, 1, 5))])
    # host B's clock runs 5 s ahead
    host(200, 5.0, [("run.step", 105.2, 3.0, None),
                    ("input.h2d", 106.0, 0.0000001, "200:1")])


def test_merge_trace_writes_the_jax_bytes(tmp_path):
    tdir = str(tmp_path / "run1")
    _two_hosts(tdir)
    out = {}
    for name, trace in PACKAGES.items():
        path = str(tmp_path / f"{name}.trace.json")
        doc = trace.merge_trace(tdir, path)
        with open(path, "rb") as f:
            out[name] = f.read()
        assert json.loads(out[name]) == doc
    assert out["port"] == out["jax"]
    events = json.loads(out["port"])["traceEvents"]
    assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)
    # host B's clock offset is taken off its spans
    b_root = [e for e in events if e["pid"] == 200
              and e["name"] == "run.step"][0]
    assert b_root["ts"] == int((105.2 - 5.0) * 1e6)
    assert min(e["dur"] for e in events) == 1


# ---------------------------------------------------------------------------
# the disabled path
# ---------------------------------------------------------------------------

def test_knob_unset_records_nothing_and_writes_no_file(tmp_path):
    with ptrace.trace_run(str(tmp_path), "train") as run:
        assert run is None
        assert not ptrace.active()
        assert ptrace.span("input.h2d") is ptrace._NOOP
        assert ptrace.record_span("input.h2d", 0.0, 1.0) is None
        assert ptrace.open_spans() == []
    assert not os.path.exists(os.path.join(str(tmp_path), "tmp", "trace"))


def _work():
    s = 0
    for i in range(4000):
        s += i * i
    return s


def test_disabled_span_overhead_under_5_percent():
    """With the knob unset, wrapping the work in span() costs ≤ 5 % over
    the untraced loop. Plain and traced reps interleave, best-of-15
    against best-of-15 (GC pauses and preemptions fall out of the
    minima), with up to three attempts."""
    assert not ptrace.active()
    n = 100

    def plain():
        t0 = time.perf_counter()
        for _ in range(n):
            _work()
        return time.perf_counter() - t0

    def traced():
        t0 = time.perf_counter()
        for _ in range(n):
            with ptrace.span("input.h2d"):
                _work()
        return time.perf_counter() - t0

    plain(), traced()   # warm both paths
    last = None
    for _attempt in range(3):
        bases, wraps = [], []
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            for _ in range(15):
                bases.append(plain())
                wraps.append(traced())
        finally:
            if gc_was_enabled:
                gc.enable()
        last = (min(wraps), min(bases))
        if last[0] <= last[1] * 1.05:
            return
    assert last[0] <= last[1] * 1.05, last


def test_export_failure_never_fails_the_step(tmp_path, monkeypatch):
    from shifu_tpu_torch import resilience
    monkeypatch.setenv("SHIFU_TPU_TRACE", "1")
    monkeypatch.setenv("SHIFU_TPU_FAULT", "obs.export:oserror:1")
    resilience.reset_faults()
    try:
        with ptrace.trace_run(str(tmp_path), "train") as run:
            ptrace.record_span("input.h2d", 0.0, 1.0)
        assert not os.path.exists(os.path.join(
            str(tmp_path), "tmp", "trace", f"{run.run_id}.trace.json"))
    finally:
        monkeypatch.delenv("SHIFU_TPU_FAULT")
        resilience.reset_faults()
    assert "obs.export" in resilience.FAULT_SITES


def test_participant_exports_into_the_coordinators_workspace(
        tmp_path, monkeypatch):
    """With SHIFU_TPU_TRACE_DIR inherited (a DAG node process) the run
    adopts the coordinator's workspace and run id, exports its span
    file there and leaves the merge and the knob alone."""
    tdir = str(tmp_path / "tmp" / "trace" / "shared-run")
    os.makedirs(tdir)
    monkeypatch.setenv("SHIFU_TPU_TRACE", "1")
    monkeypatch.setenv("SHIFU_TPU_TRACE_DIR", tdir)
    with ptrace.trace_run(str(tmp_path), "norm") as run:
        assert run.run_id == "shared-run"
        assert not run.tracer.coordinator
    assert os.path.exists(os.path.join(tdir, f"spans.{os.getpid()}.jsonl"))
    assert not os.path.exists(tdir + ".trace.json")
    assert os.environ.get("SHIFU_TPU_TRACE_DIR") == tdir


# ---------------------------------------------------------------------------
# the span registry, both ways
# ---------------------------------------------------------------------------

def _emitted():
    """Every span name literal of a `span(...)` / `record_span(...)`
    call in the port's sources."""
    import ast
    names = set()
    for path in glob.glob(os.path.join(PORT_ROOT, "**", "*.py"),
                          recursive=True):
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", None)
            arg = node.args[0]
            if name in ("span", "record_span") and \
                    isinstance(arg, ast.Constant) and \
                    isinstance(arg.value, str):
                names.add(arg.value)
    return names


def test_span_registry_holds_both_ways():
    emitted = _emitted()
    unregistered = sorted(n for n in emitted if not ptrace.span_registered(n))
    assert not unregistered, unregistered
    registered = {f"{fam}.{st}" for fam, stages in
                  ptrace.SPAN_FAMILIES.items() for st in stages}
    assert registered - emitted == set(), sorted(registered - emitted)
    want = {k: v for k, v in jtrace.SPAN_FAMILIES.items() if k != "dist"}
    assert ptrace.SPAN_FAMILIES == want


# ---------------------------------------------------------------------------
# serving spans against the timing splits
# ---------------------------------------------------------------------------

def test_serving_spans_equal_the_timing_splits(tmp_path, monkeypatch):
    from tests.test_torch_serve import _nn_set
    from shifu_tpu_torch.serve.service import ScorerService
    models = str(tmp_path / "models")
    os.makedirs(models)
    _, norm, raw, dense = _nn_set(models, seed=16)
    monkeypatch.setenv("SHIFU_TPU_TRACE", "1")
    timings = []
    with ptrace.trace_run(str(tmp_path), "serve") as run:
        svc = ScorerService(models_dir=models, norm=norm, max_delay=0.002,
                            device="cpu").start(
            proto={"dense": dense[:1], "raw_dense": raw[:1]})
        try:
            for n in (1, 3, 17):
                _, timing = svc.submit_timed(dense=dense[:n],
                                             raw_dense=raw[:n],
                                             timeout=60.0)
                timings.append(timing)
        finally:
            svc.close()
        spans = run.tracer.spans()
    reqs = [s for s in spans if s["name"] == "serve.request"]
    assert len(reqs) == len(timings)
    for req, timing in zip(reqs, timings):
        kids = {s["name"]: s for s in spans if s["parent"] == req["id"]}
        assert set(kids) == {"serve.queue", "serve.pad", "serve.h2d",
                             "serve.device", "serve.d2h"}
        for stage in ("queue", "pad", "h2d", "device", "d2h"):
            assert kids[f"serve.{stage}"]["dur"] == pytest.approx(
                timing[f"{stage}_s"], abs=1e-9), stage
        assert req["dur"] == pytest.approx(timing["total_s"], abs=1e-9)
        assert req["thread"] == "serve"
    flush = [s for s in spans if s["name"] == "serve.flush"]
    assert flush and all(s["args"]["requests"] >= 1 for s in flush)


# ---------------------------------------------------------------------------
# the traced `test` verb: the JAX package's span tree
# ---------------------------------------------------------------------------

def _merged_tree(root):
    merged = glob.glob(os.path.join(root, "tmp", "trace", "*.trace.json"))
    assert len(merged) == 1, merged
    with open(merged[0], encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    roots = [e for e in events if e["name"] == "run.step"]
    assert len(roots) == 1
    rid = roots[0]["args"]["id"]
    nodes = {e["args"]["node"]: e for e in events if e["name"] == "dag.node"}
    kids = {}
    for e in events:
        if e["name"] in ("dag.queue", "dag.run"):
            owner = [n for n, ne in nodes.items()
                     if ne["args"]["id"] == e["args"]["parent"]]
            kids.setdefault(owner[0], []).append(e["name"])
    tree = {n: (e["args"]["parent"] == rid, e["args"]["state"],
                sorted(kids.get(n, [])))
            for n, e in nodes.items()}
    return merged[0], tree


def test_traced_test_verb_gives_the_jax_span_tree(tmp_path, monkeypatch,
                                                  capsys):
    import shutil

    from shifu_tpu.cli import main as jmain
    from shifu_tpu_torch import cli as pcli
    from tests.synth import make_model_set
    from tests.test_torch_pipeline_dag import serialize_jax_reads
    serialize_jax_reads(monkeypatch)
    src = make_model_set(tmp_path / "set", np.random.default_rng(1602),
                         n_rows=300)
    roots = {k: str(tmp_path / k) for k in PACKAGES}
    for r in roots.values():
        shutil.copytree(src, r)
    monkeypatch.setenv("SHIFU_TPU_TRACE", "1")
    assert jmain(["--dir", roots["jax"], "test"]) == 0
    assert pcli.main(["--dir", roots["port"], "test"]) == 0
    monkeypatch.delenv("SHIFU_TPU_TRACE")
    trees = {k: _merged_tree(r)[1] for k, r in roots.items()}
    assert trees["port"] == trees["jax"]
    assert set(trees["port"]) == {"test.config", "test.filter",
                                  "test.eval.Eval1", "test.plan"}
    assert all(v == (True, "done", ["dag.queue", "dag.run"])
               for v in trees["port"].values())
    # the step record's trace block, and no new trace untraced
    recs = [json.loads(line) for line in open(os.path.join(
        roots["port"], "tmp", "metrics", "steps.jsonl")) if line.strip()]
    block = [r for r in recs if r["step"] == "test"][-1]["trace"]
    assert tuple(block) == ("span_count", "dropped_spans", "top_self")
    assert block["span_count"] >= 1 + 3 * 4 and block["dropped_spans"] == 0
    merged = _merged_tree(roots["port"])[0]
    assert pcli.main(["--dir", roots["port"], "test"]) == 0
    assert glob.glob(os.path.join(roots["port"], "tmp", "trace",
                                  "*.trace.json")) == [merged]
