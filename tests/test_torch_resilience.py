"""The port's `resilience.py` against the JAX package's: retry and its
classification, the fault spec and its sites, atomic publication with
the ``atomic.commit`` site, the abort and preempt markers, preemption
(`graceful_shutdown`, `Preempted`, rc 75 from `cli.main`) and the
supervised restart loop. The units mirror `tests/test_resilience.py`
and the marker units of `tests/test_reshard.py` where they apply (the
collective watchdog and the markers a peer publishes and reads are
ROADMAP A8.3; the remote filesystem's parts are held by
`tests/test_torch_fs.py`, the retry counts by
`tests/test_torch_profiling.py`). Everything runs on the CPU; a
private `np.random.default_rng` each where data is drawn."""

import json
import logging
import os
import re
import signal
import time

import numpy as np
import pytest

from shifu_tpu_torch import fileio, resilience


@pytest.fixture(autouse=True)
def _fresh():
    resilience.reset_faults()
    resilience.clear_preempt()
    resilience.set_abort_scope(None)
    yield
    resilience.reset_faults()
    resilience.clear_preempt()
    resilience.set_abort_scope(None)


# ---------------------------------------------------------------------------
# classification, the fault spec, retry
# ---------------------------------------------------------------------------

def test_is_transient_classification():
    from shifu_tpu import resilience as jres
    errors = [FileNotFoundError("gone"), PermissionError("denied"),
              IsADirectoryError("dir"), ValueError("bad"),
              RuntimeError("no backend"), TimeoutError("slow"),
              ConnectionError("reset"), OSError("flake")]

    class FSTimeoutError(Exception):   # matched by name
        pass
    errors.append(FSTimeoutError("remote timeout"))
    assert [resilience.is_transient(e) for e in errors] == \
        [jres.is_transient(e) for e in errors] == \
        [False] * 5 + [True] * 4


def test_fault_spec_parsing_matches_jax():
    from shifu_tpu import resilience as jres
    raw = "a.b:oserror:1; c:timeout:2-5,d:kill:3+;e:preempt:2"
    assert resilience._parse_fault_spec(raw) == \
        [tuple(r) for r in jres._parse_fault_spec(raw)]
    assert [(r.site, r.kind, r.lo, r.hi)
            for r in resilience._parse_fault_spec(raw)][:3] == [
        ("a.b", "oserror", 1, 1), ("c", "timeout", 2, 5),
        ("d", "kill", 3, float("inf"))]


@pytest.mark.parametrize("bad", ["a:oserror", "a:frobnicate:1",
                                 "a:oserror:x", "a:oserror:1-"])
def test_fault_spec_parsing_rejects(bad):
    with pytest.raises(ValueError, match="SHIFU_TPU_FAULT"):
        resilience._parse_fault_spec(bad)


def test_fault_point_counts_per_site(monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_FAULT", "u.two:oserror:2;u.rng:timeout:1-2")
    resilience.fault_point("u.two")
    with pytest.raises(OSError, match="injected oserror at u.two"):
        resilience.fault_point("u.two")
    resilience.fault_point("u.two")
    for _ in range(2):
        with pytest.raises(TimeoutError, match="injected timeout"):
            resilience.fault_point("u.rng")
    resilience.fault_point("u.rng")
    resilience.fault_point("u.unlisted")


def _retried(caplog, site):
    """How many retries `retrying` logged for `site`."""
    return sum(1 for r in caplog.records
               if r.getMessage().startswith(f"{site}: transient")
               and "retrying" in r.getMessage())


def test_retry_recovers_and_logs(monkeypatch, caplog):
    monkeypatch.setenv("SHIFU_TPU_FAULT", "u.once:oserror:1")
    monkeypatch.setenv("SHIFU_TPU_RETRY_BASE_S", "0.001")
    calls = []
    with caplog.at_level(logging.WARNING, logger="shifu_tpu_torch"):
        assert resilience.retrying("u.once", lambda: calls.append(1)
                                   or "ok") == "ok"
    assert calls == [1]
    assert _retried(caplog, "u.once") == 1
    assert any("injected oserror at u.once (call 1)" in r.getMessage()
               for r in caplog.records)


def test_retry_gives_up_after_budget(monkeypatch, caplog):
    monkeypatch.setenv("SHIFU_TPU_FAULT", "u.always:timeout:1+")
    monkeypatch.setenv("SHIFU_TPU_RETRY_ATTEMPTS", "3")
    monkeypatch.setenv("SHIFU_TPU_RETRY_BASE_S", "0.001")
    with caplog.at_level(logging.WARNING, logger="shifu_tpu_torch"):
        with pytest.raises(TimeoutError, match="injected timeout"):
            resilience.retrying("u.always", lambda: "never")
    assert len([r for r in caplog.records
                if "retrying" in r.getMessage()]) == 2


def test_permanent_errors_not_retried(monkeypatch, caplog):
    monkeypatch.setenv("SHIFU_TPU_RETRY_BASE_S", "0.001")
    calls = []

    def missing(tag):
        calls.append(tag)
        raise FileNotFoundError("really gone")

    with caplog.at_level(logging.WARNING, logger="shifu_tpu_torch"):
        with pytest.raises(FileNotFoundError):
            resilience.retrying("u.perm", missing, "a")
        assert calls == ["a"] and _retried(caplog, "u.perm") == 0
        monkeypatch.setenv("SHIFU_TPU_FAULT", "u.two:oserror:1-2")
        assert resilience.retrying("u.two", lambda x: x * 2, 21) == 42
    assert _retried(caplog, "u.two") == 2


def test_every_fault_site_is_listed():
    """Every `fault_point("...")` literal of the port is in FAULT_SITES
    (`step.` sites are dynamic), every listed site fires somewhere, and
    the JAX package's sites missing here are exactly its collective ones
    (the trace export's `obs.export` and the remote filesystem's `fs.*`
    are ported)."""
    from shifu_tpu import resilience as jres
    root = os.path.dirname(resilience.__file__)
    found = set()
    pat = re.compile(r"""(?:fault_point|retrying)\(\s*["']([a-z_.]+)["']""")
    const = re.compile(r"""^[A-Z_]+_SITE\s*=\s*["']([a-z_.]+)["']""",
                       re.M)
    for d, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(d, name)) as f:
                    text = f.read()
                found |= set(pat.findall(text)) | set(const.findall(text))
    assert found == set(resilience.FAULT_SITES)
    missing = set(jres.FAULT_SITES) - set(resilience.FAULT_SITES)
    assert all(s.startswith("dist.") for s in missing), missing
    assert {s for s in jres.FAULT_SITES if s.startswith("dist.")} == missing
    assert "obs.export" in resilience.FAULT_SITES
    assert {"fs.exists", "fs.size", "fs.list", "fs.open"} <= \
        set(resilience.FAULT_SITES)
    assert set(resilience.FAULT_SITES) <= set(jres.FAULT_SITES)


# ---------------------------------------------------------------------------
# the sites on their paths
# ---------------------------------------------------------------------------

def test_atomic_write_publishes_and_commit_fault_keeps_old(tmp_path,
                                                          monkeypatch):
    p = str(tmp_path / "out.json")
    with fileio.atomic_write(p) as f:
        json.dump({"old": True}, f)
    monkeypatch.setenv("SHIFU_TPU_FAULT", "atomic.commit:oserror:1")
    with pytest.raises(OSError, match="atomic.commit"):
        with fileio.atomic_write(p) as f:
            json.dump({"new": True}, f)
    with open(p) as f:
        assert json.load(f) == {"old": True}
    with pytest.raises(OSError, match="atomic.commit"):
        monkeypatch.setenv("SHIFU_TPU_FAULT", "atomic.commit:oserror:2")
        with fileio.atomic_path(str(tmp_path / "a.npz")) as tmp:
            np.savez(tmp, a=np.arange(3))
    assert not os.path.exists(tmp_path / "a.npz")
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp.")]


def test_atomic_path_keeps_extension_and_replaces_directories(tmp_path):
    p = str(tmp_path / "arr.npz")
    with fileio.atomic_path(p) as tmp:
        assert tmp.endswith(".npz")
        np.savez(tmp, a=np.arange(3))
    with np.load(p) as z:
        np.testing.assert_array_equal(z["a"], np.arange(3))
    target = tmp_path / "bundle"
    target.mkdir()
    (target / "stale.txt").write_text("old")
    with fileio.atomic_path(str(target)) as tmp:
        os.makedirs(tmp)
        with open(os.path.join(tmp, "fresh.txt"), "w") as f:
            f.write("new")
    assert sorted(os.listdir(target)) == ["fresh.txt"]


def test_sweep_stale(tmp_path):
    (tmp_path / ".tmp.123.dead.npz").write_text("junk")
    os.makedirs(tmp_path / ".tmp.456.deaddir")
    (tmp_path / "keep.txt").write_text("keep")
    assert resilience.sweep_stale(str(tmp_path)) == 2
    assert sorted(os.listdir(tmp_path)) == ["keep.txt"]


@pytest.mark.parametrize("route", ["prefetch", "map_prefetch", "map_stream",
                                   "sequential"])
def test_pipeline_fetch_fault_reaches_the_consumer(monkeypatch, route):
    from shifu_tpu_torch.data import pipeline as pipe
    monkeypatch.setenv("SHIFU_TPU_FAULT", "pipeline.fetch:oserror:3")
    if route == "sequential":
        monkeypatch.setenv("SHIFU_TPU_PREFETCH_WORKERS", "0")
    got = []
    with pytest.raises(OSError, match="pipeline.fetch"):
        if route == "map_prefetch":
            for v in pipe.map_prefetch(lambda i: i * 10, range(6)):
                got.append(v)
        elif route == "map_stream":
            for v in pipe.map_stream(lambda i: i * 10, iter(range(6))):
                got.append(v)
        else:
            for v in pipe.prefetch(iter(range(6))):
                got.append(v)
    assert got == ([0, 10] if route in ("map_prefetch", "map_stream")
                   else [0, 1])


def test_serve_request_fault_rejects_the_submit(monkeypatch):
    from shifu_tpu_torch.serve.batcher import MicroBatcher

    def score(batch):
        for req in batch:
            req.resolve(req.n)
    mb = MicroBatcher(score, max_rows=8)
    mb.start()
    try:
        monkeypatch.setenv("SHIFU_TPU_FAULT", "serve.request:oserror:2")
        assert mb.submit({}, 3).wait(5.0) == 3
        with pytest.raises(OSError, match="serve.request"):
            mb.submit({}, 3)
        assert mb.submit({}, 2).wait(5.0) == 2
    finally:
        mb.close()


@pytest.mark.parametrize("native", [False, True])
def test_reader_sites_retry_a_transient_read(tmp_path, monkeypatch, caplog,
                                             native):
    """`reader.read` (the text route) and `reader.native` (the C
    route's row count) go through `retrying`: an injected transient
    error is retried and the table reads whole."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.data import reader
    rng = np.random.default_rng(3)
    data = tmp_path / "data"
    data.mkdir()
    vals = rng.normal(0, 1, (20, 2))
    with open(data / "part-0", "w") as f:
        f.write("a|b\n")
        for a, b in vals:
            f.write(f"{a:.6f}|{b:.6f}\n")
    mc = ModelConfig()
    mc.dataSet.dataPath = str(data)
    monkeypatch.setenv("SHIFU_TPU_RETRY_BASE_S", "0.001")
    site = "reader.native" if native else "reader.read"
    monkeypatch.setenv("SHIFU_TPU_FAULT", f"{site}:timeout:1")
    with caplog.at_level(logging.WARNING, logger="shifu_tpu_torch"):
        t = reader.read_raw_table(mc, numeric_columns=["a", "b"] if native
                                  else None)
    assert len(t) == 20
    np.testing.assert_allclose(np.asarray(t["a"], np.float64), vals[:, 0],
                               atol=1e-6)
    assert _retried(caplog, site) == 1


# ---------------------------------------------------------------------------
# markers
# ---------------------------------------------------------------------------

def _markers(scope, *names):
    """Marker files as a JAX run (or a peer) would have left them."""
    os.makedirs(scope, exist_ok=True)
    for name in names:
        with open(os.path.join(scope, name), "w") as f:
            json.dump({"site": "old", "process": 0}, f)


def test_clear_markers_in_the_scope(tmp_path):
    """`clear_abort` and `clear_preempt_marker` remove the JAX
    package's marker names from the scope and nothing else."""
    scope = str(tmp_path / "tmp")
    resilience.set_abort_scope(scope)
    _markers(scope, "abort.marker", "preempt.marker", "keep.json")
    resilience.clear_abort()
    assert sorted(os.listdir(scope)) == ["keep.json", "preempt.marker"]
    resilience.clear_preempt_marker()
    assert os.listdir(scope) == ["keep.json"]
    resilience.clear_abort()                    # nothing left: a no-op
    resilience.clear_preempt_marker()


def test_no_scope_touches_nothing(tmp_path, monkeypatch):
    """Without a scope the clears and the steps.jsonl append do
    nothing, wherever the process runs."""
    monkeypatch.chdir(tmp_path)
    _markers(str(tmp_path), "abort.marker", "preempt.marker")
    resilience.clear_abort()
    resilience.clear_preempt_marker()
    resilience._append_steps_jsonl({"event": "restart"})
    assert sorted(os.listdir(tmp_path)) == ["abort.marker",
                                            "preempt.marker"]


def test_remote_scope_raises_naming_a8_4():
    """A `scheme://` scope now keeps its markers there (ROADMAP A8.4 is
    ported): published, read and cleared through fsspec."""
    import fsspec
    scope = f"memory://scope{os.getpid()}/set/tmp"
    resilience.set_abort_scope(scope)
    try:
        resilience.publish_abort("dag.x", RuntimeError("boom"))
        assert resilience.check_abort()["error"] == "RuntimeError: boom"
        resilience.clear_abort()
        assert resilience.check_abort() is None
    finally:
        resilience.set_abort_scope(None)
        fsspec.filesystem("memory").rm(f"scope{os.getpid()}", recursive=True)


def test_steps_jsonl_appends_one_record_a_line(tmp_path):
    scope = str(tmp_path / "tmp")
    resilience.set_abort_scope(scope)
    for n in (1, 2):
        resilience._append_steps_jsonl({"event": "restart", "restart": n})
    with open(os.path.join(scope, "metrics", "steps.jsonl")) as f:
        assert [json.loads(line) for line in f] == [
            {"event": "restart", "restart": 1},
            {"event": "restart", "restart": 2}]


# ---------------------------------------------------------------------------
# preemption and supervised restarts
# ---------------------------------------------------------------------------

def test_preempt_fault_kind_sets_flag(monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_FAULT", "x.site:preempt:2")
    resilience.fault_point("x.site")
    assert not resilience.preempt_requested()
    resilience.fault_point("x.site")
    assert resilience.preempt_requested()


def test_graceful_shutdown_signal_flow_and_checkpoint_flush(monkeypatch):
    """The first SIGTERM sets the flag; a second escalates to
    KeyboardInterrupt; the handlers are restored and the checkpoint
    writer flushed on the way out."""
    from shifu_tpu_torch.train import checkpoint as ckpt
    flushed = []
    monkeypatch.setattr(ckpt, "flush_saves",
                        lambda reraise=True: flushed.append(reraise))
    prev = signal.getsignal(signal.SIGTERM)
    with resilience.graceful_shutdown("test"):
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.01)
        assert resilience.preempt_requested()
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.05)
    assert signal.getsignal(signal.SIGTERM) is prev
    assert flushed == [False]


def test_supervise_restarts_on_preempt_and_transient(tmp_path, monkeypatch):
    resilience.set_abort_scope(str(tmp_path))
    monkeypatch.setenv("SHIFU_TPU_MAX_RESTARTS", "3")
    monkeypatch.setenv("SHIFU_TPU_RETRY_BASE_S", "0.001")
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise resilience.Preempted("p")
        if len(calls) == 2:
            raise TimeoutError("transient")
        return "ok"

    assert resilience.supervise(flaky, step="t", device="cpu") == "ok"
    assert len(calls) == 3
    with open(tmp_path / "metrics" / "steps.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert [(e["step"], e["event"], e["restart"], e["devices"],
             e["error"].split(":")[0]) for e in events] == [
        ("t", "restart", 1, 1, "Preempted"),
        ("t", "restart", 2, 1, "TimeoutError")]


def test_supervise_permanent_error_and_exhausted_budget(monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_MAX_RESTARTS", "5")
    monkeypatch.setenv("SHIFU_TPU_RETRY_BASE_S", "0.001")

    def bad():
        raise ValueError("permanent")
    with pytest.raises(ValueError):
        resilience.supervise(bad, step="t")
    n = []

    def always_preempted():
        n.append(1)
        raise resilience.Preempted("again")
    monkeypatch.setenv("SHIFU_TPU_MAX_RESTARTS", "2")
    with pytest.raises(resilience.Preempted):
        resilience.supervise(always_preempted, step="t")
    assert len(n) == 3


def test_supervise_off_by_default_and_clears_markers(tmp_path):
    scope = str(tmp_path / "tmp")
    resilience.set_abort_scope(scope)
    _markers(scope, "abort.marker", "preempt.marker")
    resilience.request_preempt()
    n = []

    def once():
        n.append((sorted(os.listdir(scope)), resilience.preempt_requested()))
        raise resilience.Preempted("p")
    with pytest.raises(resilience.Preempted):
        resilience.supervise(once, step="t")
    assert n == [([], False)]
    assert not os.path.exists(os.path.join(scope, "metrics"))
    assert resilience.PREEMPT_RC == resilience.Preempted.rc == 75


def test_cli_returns_75_on_preemption(monkeypatch, capsys):
    from shifu_tpu_torch import cli

    def preempted(args):
        raise resilience.Preempted("train preempted after epoch 4/12")
    parser = cli.build_parser
    monkeypatch.setattr(cli, "build_parser", lambda: _with_fn(parser(),
                                                              preempted))
    assert cli.main(["version"]) == resilience.PREEMPT_RC


def _with_fn(parser, fn):
    real = parser.parse_args

    def parse_args(argv=None):
        args = real(argv)
        args.fn = fn
        return args
    parser.parse_args = parse_args
    return parser
