"""Remote filesystems in the port (`shifu_tpu_torch/data/fs.py`, the
remote halves of `fileio.py`, `resilience.py` and `data/ingest.py`)
against the JAX package's `shifu_tpu/data/fs.py` and `resilience.py`,
on fsspec's `memory://` and `file://` protocols (no network):

- the scheme test, the readahead hints and their knobs, the listing
  (marker and dot/underscore names skipped, URLs rebuilt), `exists`
  and `size` equal to the JAX package's;
- a transient `fs.open` fault retried, a permanent error not;
- the remote atomic write (a dot-prefixed temp key, committed with
  `mv`; a commit fault keeps the old object), the remote sweep, the
  abort markers on a remote scope (each package reads the other's);
- a row log on a `scheme://` root writes the JAX package's files byte
  for byte;
- a model set whose dataPath and eval set live behind `memory://` or
  `file://` runs `init → stats → norm → train → eval` through the port
  with the bytes of the same set read from local files, and `probe`
  checks a remote dataPath's existence.

Every generator is a private `np.random.default_rng(seed)` (C-ref-1).
"""

import filecmp
import json
import os
import shutil
import time
import uuid

import fsspec
import numpy as np
import pytest

from shifu_tpu import resilience as jres
from shifu_tpu.data import fs as jfs
from shifu_tpu.data import ingest as jingest
from shifu_tpu_torch import cli, fileio, resilience
from shifu_tpu_torch.data import fs, ingest


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    for k in ("SHIFU_TPU_FAULT", "SHIFU_TPU_FS_CACHE_TYPE",
              "SHIFU_TPU_FS_BLOCK_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SHIFU_TPU_RETRY_BASE_S", "0.01")
    resilience.reset_faults()
    jres.reset_faults()
    resilience.reset_retry_stats()
    yield
    resilience.set_abort_scope(None)
    jres.set_abort_scope(None)
    resilience.reset_faults()
    jres.reset_faults()


@pytest.fixture(params=["memory", "file"])
def remote(request, tmp_path):
    """A fresh remote directory URL on each protocol; the memory tree is
    removed afterwards."""
    if request.param == "memory":
        base = f"memory://fs{uuid.uuid4().hex[:12]}"
        yield base
        mem = fsspec.filesystem("memory")
        if mem.exists(base[len("memory://"):]):
            mem.rm(base[len("memory://"):], recursive=True)
    else:
        d = tmp_path / "remote"
        d.mkdir()
        yield "file://" + str(d)


def _put(url, data: bytes):
    with fsspec.open(url, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("path", [
    "s3://bucket/key", "hdfs://nn:8020/data", "memory://x/y", "gs://b/o",
    "file:///abs/path", "s3a://b/k", "/abs/path", "rel/path", "",
    "C:/windows", "not a url://x"])
def test_has_scheme_is_the_jax_packages(path):
    assert fs.has_scheme(path) == jfs.has_scheme(path) == \
        fileio.has_scheme(path)


def test_readahead_hints_defaults_and_knobs(monkeypatch):
    assert fs.readahead_hints() == jfs.readahead_hints() == {
        "cache_type": "readahead", "block_size": 4 * 1024 * 1024}
    for ct, bs in (("bytes", "1048576"), ("none", "0"), ("BLOCK", "-1"),
                   ("readahead", "junk")):
        monkeypatch.setenv("SHIFU_TPU_FS_CACHE_TYPE", ct)
        monkeypatch.setenv("SHIFU_TPU_FS_BLOCK_SIZE", bs)
        assert fs.readahead_hints() == jfs.readahead_hints(), (ct, bs)


def test_open_text_carries_hints_to_fsspec(remote, monkeypatch):
    """The hints reach `fsspec.open` as keyword arguments (memory:// and
    file:// ignore them), and the compression is inferred."""
    seen = []
    real_open = fsspec.open

    def spy(path, mode, **kw):
        seen.append(kw)
        return real_open(path, mode, **kw)

    _put(f"{remote}/part-0", b"a|b\n1|2\n")
    import gzip
    _put(f"{remote}/part-1.gz", gzip.compress(b"c|d\n"))
    monkeypatch.setattr(fsspec, "open", spy)
    with fs.open_text(f"{remote}/part-0") as f:
        assert f.readline().strip() == "a|b"
    with fs.open_text(f"{remote}/part-1.gz") as f:
        assert f.read() == "c|d\n"
    assert seen[0] == {"compression": "infer", "cache_type": "readahead",
                       "block_size": 4 * 1024 * 1024}
    monkeypatch.setenv("SHIFU_TPU_FS_CACHE_TYPE", "none")
    monkeypatch.setenv("SHIFU_TPU_FS_BLOCK_SIZE", "0")
    with fs.open_text(f"{remote}/part-0", "rb") as f:
        assert f.read() == b"a|b\n1|2\n"
    assert seen[-1] == {"compression": "infer"}


def test_listing_exists_and_size_equal_the_jax_packages(remote):
    skip = {"_SUCCESS", ".pig_header", ".pig_schema"}
    for name, data in (("part-00001", b"x\n" * 3), ("part-00000", b"y\n"),
                       ("_SUCCESS", b""), (".pig_header", b"a\n"),
                       (".tmp.9.part-2", b"z"), ("_logs", b"q"),
                       ("part-3.parquet", b"p" * 7)):
        _put(f"{remote}/data/{name}", data)
    want = jfs.list_data_files(f"{remote}/data", skip)
    got = fs.list_data_files(f"{remote}/data", skip)
    assert got == want
    assert [u.rsplit("/", 1)[1] for u in got] == \
        ["part-00000", "part-00001", "part-3.parquet"]
    assert all(fs.has_scheme(u) and u.startswith(remote.split("://")[0])
               for u in got)
    # a single file and a glob expand the same way
    assert fs.list_data_files(got[1], skip) == \
        jfs.list_data_files(got[1], skip) == [got[1]]
    assert fs.list_data_files(f"{remote}/data/part-0000*", skip) == \
        jfs.list_data_files(f"{remote}/data/part-0000*", skip) == got[:2]
    for u in got:
        assert fs.exists(u) and fs.size(u) == jfs.size(u)
    assert fs.size(got[1]) == 6
    assert not fs.exists(f"{remote}/data/nope") and \
        not jfs.exists(f"{remote}/data/nope")
    assert fs.size(f"{remote}/data/nope") == jfs.size(
        f"{remote}/data/nope") == 0


def test_missing_backend_names_what_to_install():
    with pytest.raises(RuntimeError) as e:
        fs.exists("nosuchproto://bucket/key")
    with pytest.raises(RuntimeError) as j:
        jfs.exists("nosuchproto://bucket/key")
    assert "no filesystem backend" in str(e.value)
    assert str(e.value).split(":")[0] == str(j.value).split(":")[0]


@pytest.mark.parametrize("site,kind", [("fs.open", "oserror"),
                                       ("fs.open", "timeout"),
                                       ("fs.list", "oserror"),
                                       ("fs.exists", "timeout"),
                                       ("fs.size", "oserror")])
def test_transient_fault_is_retried(remote, monkeypatch, site, kind):
    _put(f"{remote}/data/part-0", b"a\n")
    monkeypatch.setenv("SHIFU_TPU_FAULT", f"{site}:{kind}:1")
    part = f"{remote}/data/part-0"
    calls = {"fs.open": (lambda: fs.open_text(part).read(), "a\n"),
             "fs.list": (lambda: [u.rsplit("/", 1)[1] for u in
                                  fs.list_data_files(f"{remote}/data", ())],
                         ["part-0"]),
             "fs.exists": (lambda: fs.exists(part), True),
             "fs.size": (lambda: fs.size(part), 2)}
    call, want = calls[site]
    assert call() == want
    assert resilience.retry_stats()[site]["attempts"] == 1


def test_permanent_open_error_is_not_retried(remote, monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_FAULT", "fs.open:oserror:9")
    with pytest.raises(FileNotFoundError):
        fs.open_text(f"{remote}/nope/part-0").read()
    assert resilience.retry_stats() == {}


def _keys(url):
    f, p = fsspec.core.url_to_fs(url)
    return sorted(q.rstrip("/").rsplit("/", 1)[1]
                  for q in f.ls(p, detail=False))


def test_remote_atomic_write_commits_with_mv(remote, monkeypatch):
    path = f"{remote}/set/out.json"
    fsspec.filesystem(remote.split("://")[0]).makedirs(
        fsspec.core.url_to_fs(f"{remote}/set")[1], exist_ok=True)
    with fileio.atomic_write(path) as f:
        json.dump({"old": True}, f)
    with fsspec.open(path, "r") as f:
        assert json.load(f) == {"old": True}
    assert _keys(f"{remote}/set") == ["out.json"]
    # a commit fault, then an error in the body: the object keeps its
    # old bytes and no temp key is left
    monkeypatch.setenv("SHIFU_TPU_FAULT", "atomic.commit:oserror:1")
    with pytest.raises(OSError, match="atomic.commit"):
        with fileio.atomic_write(path) as f:
            json.dump({"new": True}, f)
    monkeypatch.delenv("SHIFU_TPU_FAULT")
    with pytest.raises(ValueError, match="body"):
        with fileio.atomic_write(path) as f:
            f.write("half")
            raise ValueError("body")
    with fsspec.open(path, "r") as f:
        assert json.load(f) == {"old": True}
    assert _keys(f"{remote}/set") == ["out.json"]
    # the JAX package's remote write and the port's name the temp alike
    assert fileio._remote_tmp_name(path) == jres._remote_tmp_name(path)


def test_remote_sweep_removes_dot_temps(remote):
    for name in (".tmp.1.a", ".tmp.2.b", "keep", ".hidden"):
        _put(f"{remote}/d/{name}", b"x")
    assert resilience.sweep_stale(f"{remote}/d") == 2
    assert _keys(f"{remote}/d") == [".hidden", "keep"]
    for name in (".tmp.3.c",):
        _put(f"{remote}/d/{name}", b"x")
    assert jres.sweep_stale(f"{remote}/d") == 1
    assert resilience.sweep_stale(f"{remote}/missing") == 0
    assert resilience.sweep_stale(f"{remote}/d") == 0


def test_abort_markers_on_a_remote_scope(remote):
    """The DAG's abort marker on a `scheme://` scope: the port publishes
    the JAX package's record, each package reads the other's, and the
    clears remove it; steps.jsonl stays local-only, as in the JAX
    package."""
    scope = f"{remote}/set/tmp"
    resilience.set_abort_scope(scope)
    jres.set_abort_scope(scope)
    assert resilience.check_abort() is None
    resilience.publish_abort("dag.train", RuntimeError("boom"))
    rec = jres.check_abort()
    assert resilience.check_abort() == rec
    assert (rec["site"], rec["process"], rec["error"]) == \
        ("dag.train", 0, "RuntimeError: boom")
    resilience.clear_abort()
    assert jres.check_abort() is None
    jres.publish_abort("dag.eval", ValueError("x"), process=0)
    assert resilience.check_abort()["site"] == "dag.eval"
    resilience.clear_abort()
    _put(f"{scope}/preempt.marker", b"{}")
    resilience.clear_preempt_marker()
    _put(f"{scope}/abort.marker", b"not json")
    assert resilience.check_abort()["site"] == "unknown"
    resilience._append_steps_jsonl({"event": "restart"})
    assert _keys(scope) == ["abort.marker"]


def test_fs_sites_are_listed():
    assert {"fs.exists", "fs.size", "fs.list", "fs.open"} <= \
        set(resilience.FAULT_SITES)
    assert [s for s in jres.FAULT_SITES if s.startswith("fs.")] == \
        [s for s in resilience.FAULT_SITES if s.startswith("fs.")]


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "strftime",
                        lambda fmt, *a: "2026-01-01T00:00:00")


def _tree(url):
    f, p = fsspec.core.url_to_fs(url)
    out = {}
    for q in sorted(f.find(p)):
        with f.open(q, "rb") as fh:
            out[q[len(p.rstrip("/")) + 1:]] = fh.read()
    return out


def test_row_log_on_a_remote_root_writes_the_jax_files(remote, fixed_clock):
    rng = np.random.default_rng(7)
    rows = [f"{a:.3f}|{b}" for a, b in zip(rng.normal(size=23),
                                          rng.integers(0, 9, 23))]
    logs = {}
    for name, mod in (("port", ingest), ("jax", jingest)):
        root = f"{remote}/{name}/log"
        lg = mod.RowLog(root, header=["a", "b"], partitions=2,
                        segment_rows=4, segment_age_s=1e9)
        lg.append(rows[:13])
        lg.append(rows[13:], part=1)
        lg.seal_all()
        win = lg.read_window("watch", max_rows=9)
        lg.commit("watch", win.end)
        logs[name] = (lg, win)
    assert _tree(f"{remote}/port/log") == _tree(f"{remote}/jax/log")
    (lg, win), (jlg, jwin) = logs["port"], logs["jax"]
    assert win.lines == jwin.lines and win.end == jwin.end
    assert lg.inventory()["consumers"] == jlg.inventory()["consumers"]
    # each package opens the other's log and reads the same window next
    other = ingest.RowLog(f"{remote}/jax/log")
    assert other.read_window("watch").lines == \
        jingest.RowLog(f"{remote}/port/log").read_window("watch").lines
    assert other.consumers() == ["watch"]
    assert not [k for k in _tree(f"{remote}/port/log")
                if k.rsplit("/", 1)[-1].startswith(".tmp.")]


# ---------------------------------------------------------------------------
# a model set behind scheme:// URLs
# ---------------------------------------------------------------------------

def _upload(local_dir, url):
    """The part file with its header as the first line (no headerPath)."""
    with open(os.path.join(local_dir, ".pig_header")) as f:
        header = f.read().strip()
    with open(os.path.join(local_dir, "part-00000")) as f:
        body = f.read()
    _put(f"{url}/part-00000", (header + "\n" + body).encode())
    _put(f"{url}/_SUCCESS", b"")


OUTPUTS = ("ColumnConfig.json", "tmp/CleanedData/data.npz",
           "tmp/NormalizedData/data.npz", "models/model0.gbt",
           "evals/Eval1/EvalScore.csv", "evals/Eval1/EvalPerformance.json")


@pytest.mark.parametrize("seed", [181])
def test_remote_model_set_runs_every_step_like_local_files(
        tmp_path, remote, seed):
    """The same set read from local part files (the C reader) and from
    `scheme://` URLs (the text route over fsspec): every step's outputs
    are the same bytes."""
    from tests.test_torch_stats import make_sets
    from tests.test_torch_train_tree import PARAMS
    _, local = make_sets(tmp_path, seed, n_rows=900, algorithm="GBT",
                         train_params=PARAMS["GBT"])
    far = str(tmp_path / "far")
    shutil.copytree(local, far)
    _upload(os.path.join(far, "data"), f"{remote}/ms/data")
    _upload(os.path.join(far, "evaldata"), f"{remote}/ms/evaldata")
    path = os.path.join(far, "ModelConfig.json")
    with open(path) as f:
        mc = json.load(f)
    mc["dataSet"].update(dataPath=f"{remote}/ms/data", headerPath="",
                         source="HDFS")
    mc["evals"][0]["dataSet"].update(dataPath=f"{remote}/ms/evaldata",
                                     headerPath="")
    with open(path, "w") as f:
        json.dump(mc, f)
    for root in (local, far):
        for cmd in (["init"], ["stats"], ["norm"], ["train"], ["eval"]):
            extra = [] if cmd == ["init"] else ["--device", "cpu"]
            assert cli.main(["--dir", root, *cmd, *extra]) == 0, cmd
    for rel in OUTPUTS:
        assert filecmp.cmp(os.path.join(local, rel), os.path.join(far, rel),
                           shallow=False), rel
    with open(os.path.join(far, OUTPUTS[-1])) as f:
        assert json.load(f)["areaUnderRoc"] > 0.85


def test_probe_checks_remote_existence(tmp_path, remote):
    from tests.synth import make_model_set
    from shifu_tpu_torch.config.inspector import ModelStep, probe
    from shifu_tpu_torch.config.model_config import ModelConfig
    root = make_model_set(tmp_path, np.random.default_rng(182), n_rows=100)
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as f:
        raw = json.load(f)
    raw["dataSet"]["dataPath"] = f"{remote}/nope/missing"
    with open(path, "w") as f:
        json.dump(raw, f)
    mc = ModelConfig.load(root)
    assert mc.resolve_path(raw["dataSet"]["dataPath"]) == \
        raw["dataSet"]["dataPath"]
    r = probe(mc, ModelStep.INIT)
    assert not r.status
    assert any("does not exist" in c for c in r.causes)
    _put(f"{remote}/nope/missing/part-0", b"a\n")
    assert not any("does not exist" in c
                   for c in probe(ModelConfig.load(root),
                                  ModelStep.INIT).causes)


def test_probe_defers_a_missing_backend_to_read_time(tmp_path):
    from tests.synth import make_model_set
    from shifu_tpu_torch.config.inspector import ModelStep, probe
    from shifu_tpu_torch.config.model_config import ModelConfig
    root = make_model_set(tmp_path, np.random.default_rng(183), n_rows=100)
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as f:
        raw = json.load(f)
    raw["dataSet"]["dataPath"] = "nosuchproto://bucket/data"
    with open(path, "w") as f:
        json.dump(raw, f)
    r = probe(ModelConfig.load(root), ModelStep.INIT)
    assert not any("dataPath" in c for c in r.causes)
