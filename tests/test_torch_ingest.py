"""The port's durable row log (`shifu_tpu_torch/data/ingest.py`) and
`watch --ingest` against the JAX package's `shifu_tpu/data/ingest.py`.

- the same appends, seals and commits write the same files byte for
  byte (`log.json`, each `part-K/manifest.json` with its segments'
  sha256, every `seg-NNNNNN.rows`, `offsets/<consumer>.json`), and each
  package reads the other's log;
- the exactly-once contract: an uncommitted window replays bitwise, a
  fault between read and commit replays the window in the watch loop,
  `read_range` over a committed range is byte-identical forever, a
  fault between the seal's two renames re-seals the same sequence and
  leaves no `.tmp.*`;
- the acceptance drill: shifted rows in the log → one `watch --ingest`
  tick → drift breach → the refresh controller retrains on its own
  committed window → the promoted manifest records the (segment,
  offset) range and `read_range` re-reads the training bytes; the same
  AUCs and decision as the JAX controller (1e-6);
- `ingest ls` and `watch --ingest` through the port's `cli.main`.

Every generator is a private `np.random.default_rng(seed)` (C-ref-1).
"""

import hashlib
import json
import os
import shutil
import time

import numpy as np
import pytest

from shifu_tpu import registry as jreg
from shifu_tpu import resilience as jres
from shifu_tpu.cli import main as jax_cli
from shifu_tpu.data import ingest as jingest
from shifu_tpu_torch import cli, registry, resilience
from shifu_tpu_torch.data import ingest
from shifu_tpu_torch.data import reader

AUC_TOL = 1e-6


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    for k in ("SHIFU_TPU_METRICS", "SHIFU_TPU_SLO_FILE", "SHIFU_TPU_FAULT",
              "SHIFU_TPU_INGEST_SEGMENT_ROWS",
              "SHIFU_TPU_INGEST_SEGMENT_AGE_S", "SHIFU_TPU_ALERT_WEBHOOK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SHIFU_TPU_RETRY_BASE_S", "0.01")
    resilience.reset_faults()
    jres.reset_faults()
    yield
    resilience.reset_faults()
    jres.reset_faults()


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both packages stamp `sealed`/`committed` with time.strftime: one
    fixed stamp makes their files comparable byte for byte."""
    monkeypatch.setattr(time, "strftime",
                        lambda fmt, *a: "2026-01-01T00:00:00")


def _batch(n=10, tag=""):
    return [f"{i}|v{tag}{i}" for i in range(n)]


def _files(root):
    out = {}
    for d, _dirs, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _no_tmp_residue(root):
    return [os.path.join(d, f) for d, _dirs, fs in os.walk(root)
            for f in fs if f.startswith(".tmp.")]


def _sha(lines):
    return hashlib.sha256("\n".join(lines).encode("utf-8")).hexdigest()


def _drive(mod, root, partitions, segment_rows):
    """One scripted writer/reader session against a package's RowLog;
    returns the windows it read."""
    lg = mod.RowLog(root, header=["a", "b"], partitions=partitions,
                    segment_rows=segment_rows)
    lg.append(_batch(11))
    lg.append(["x|ü-ß", "y|", "|z"], part=partitions - 1)
    lg.seal_all()
    w1 = lg.read_window("watch", max_rows=7)
    lg.commit("watch", w1.end)
    w2 = lg.read_window("watch")
    lg.commit("watch", w2.end)
    w3 = lg.read_window("refresh", max_rows=5)
    lg.commit("refresh", w3.end)
    lg.append(_batch(4, tag="late"))
    lg.seal_all()
    return [(w.lines, w.start, w.end) for w in (w1, w2, w3)]


# ---------------------------------------------------------------------------
# the log itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partitions,segment_rows", [(1, 4), (2, 3), (3, 2)])
def test_log_bytes_sha256_and_offsets_equal_jax(tmp_path, fixed_clock,
                                                partitions, segment_rows):
    ja, po = str(tmp_path / "jax"), str(tmp_path / "port")
    assert _drive(jingest, ja, partitions, segment_rows) == \
        _drive(ingest, po, partitions, segment_rows)
    fj, fp = _files(ja), _files(po)
    assert fj == fp
    for k in range(partitions):
        man = json.loads(fp[os.path.join(f"part-{k}", "manifest.json")])
        for seg in man["segments"]:
            data = fp[os.path.join(f"part-{k}", seg["name"])]
            assert hashlib.sha256(data).hexdigest() == seg["sha256"]
    assert ingest.RowLog(po).inventory() == jingest.RowLog(ja).inventory() \
        | {"root": po}


def test_round_trip_exactly_once_and_replay(tmp_path):
    root = str(tmp_path / "log")
    lg = ingest.RowLog(root, header=["a", "b"], segment_rows=4)
    lg.append(_batch(10))
    lg.seal_all()
    assert lg.sealed_rows() == 10 and lg.open_rows() == 0
    # an uncommitted window REPLAYS bitwise — reading moves nothing
    w1 = lg.read_window(ingest.WATCH_CONSUMER)
    w2 = lg.read_window(ingest.WATCH_CONSUMER)
    assert w1.lines == w2.lines == _batch(10)
    assert (w1.start, w1.end) == (w2.start, w2.end)
    assert lg.lag(ingest.WATCH_CONSUMER) == 10
    lg.commit(ingest.WATCH_CONSUMER, w1.end)
    assert lg.lag(ingest.WATCH_CONSUMER) == 0
    assert lg.consumed_rows(ingest.WATCH_CONSUMER) == 10
    assert lg.read_window(ingest.WATCH_CONSUMER) is None
    # consumers are independent
    assert lg.read_window(ingest.EVAL_CONSUMER).lines == _batch(10)
    # max_rows caps the window; the rest stays for the next tick
    lg.append(_batch(6, tag="x"))
    lg.seal_all()
    w4 = lg.read_window(ingest.WATCH_CONSUMER, max_rows=4)
    assert len(w4.lines) == 4
    lg.commit(ingest.WATCH_CONSUMER, w4.end)
    w5 = lg.read_window(ingest.WATCH_CONSUMER)
    assert w4.lines + w5.lines == _batch(6, tag="x")
    assert not _no_tmp_residue(root)


def test_seal_by_age_bounds_trickle_staleness(tmp_path):
    lg = ingest.RowLog(str(tmp_path / "log"), header=["a", "b"],
                       segment_rows=10_000, segment_age_s=0.05)
    lg.append(["1|one"])
    assert lg.sealed_rows() == 0 and lg.open_rows() == 1
    time.sleep(0.06)
    # the NEXT append finds the open segment over age and seals it
    lg.append(["2|two"])
    assert lg.sealed_rows() == 2 and lg.open_rows() == 0
    assert lg.read_window(ingest.WATCH_CONSUMER).lines == ["1|one", "2|two"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_log_bitwise(tmp_path, writer):
    root = str(tmp_path / "log")
    wmod, rmod = (jingest, ingest) if writer == "jax" else (ingest, jingest)
    lg = wmod.RowLog(root, header=["a", "b"], partitions=2, segment_rows=3)
    lg.append(_batch(11))
    lg.seal_all()
    start = lg.committed_offset("watch")
    w = lg.read_window("watch")
    lg.commit("watch", w.end)
    other = rmod.RowLog(root)
    assert (other.header, other.delimiter, other.partitions) == \
        (["a", "b"], "|", 2)
    assert other.read_range(start, w.end) == w.lines
    assert other.lag("watch") == 0
    # the range stays byte-identical after the other package GROWS it
    other.append(_batch(5, tag="later"))
    other.seal_all()
    assert _sha(wmod.RowLog(root).read_range(start, w.end)) == _sha(w.lines)
    assert wmod.RowLog(root).read_window("watch").lines == \
        [f"{i}|vlater{i}" for i in (0, 2, 4, 1, 3)]


def test_multi_partition_order_is_deterministic_and_jax_equal(tmp_path):
    rows = _batch(13)
    out = []
    for mod, name in ((jingest, "jax"), (ingest, "port")):
        root = str(tmp_path / name)
        lg = mod.RowLog(root, header=["a", "b"], partitions=3,
                        segment_rows=2)
        for r in rows:
            lg.append([r])
        lg.seal_all()
        out.append(mod.RowLog(root).read_window("watch").lines)
    assert out[0] == out[1]
    assert sorted(out[1]) == sorted(rows)


def test_truncated_segment_is_refused_loudly(tmp_path):
    root = str(tmp_path / "log")
    lg = ingest.RowLog(root, header=["a", "b"], segment_rows=4)
    lg.append(_batch(4))
    lg.seal_all()
    seg = os.path.join(root, "part-0", "seg-000001.rows")
    with open(seg, encoding="utf-8") as f:
        first = f.readline()
    with open(seg, "w", encoding="utf-8") as f:
        f.write(first)   # 1 row where the manifest promises 4
    with pytest.raises(RuntimeError, match="corrupt"):
        ingest.RowLog(root).read_window(ingest.WATCH_CONSUMER)


def test_frame_round_trip_preserves_missing_tokens_like_jax():
    import pandas as pd
    df = pd.DataFrame({"a": ["1.5", "", "x"], "b": ["", "?", "z"]})
    table = reader.Table({"a": np.array(["1.5", "", "x"]),
                          "b": np.array(["", "?", "z"])})
    lines = ingest.rows_from_frame(table, "|")
    assert lines == jingest.rows_from_frame(df, "|") == ["1.5|", "|?", "x|z"]
    back = ingest.frame_from_rows(lines, ["a", "b"], "|")
    want = jingest.frame_from_rows(lines, ["a", "b"], "|")
    assert back.columns == list(want.columns)
    for c in back.columns:
        assert back[c].tolist() == want[c].tolist()
    num = reader.Table({"v": np.array([1.5, np.nan], np.float32)})
    assert ingest.rows_from_frame(num) == ["1.5", ""]


@pytest.mark.parametrize("case", ["remote", "multi_host"])
def test_remote_root_and_multi_host_shard_raise_naming_their_item(
        tmp_path, case):
    if case == "remote":
        with pytest.raises(NotImplementedError, match="ROADMAP A8.4"):
            ingest.RowLog("memory://twin/log", header=["a"])
    else:
        lg = ingest.RowLog(str(tmp_path / "log"), header=["a"], partitions=4)
        assert lg.owned_partitions((0, 1)) == [0, 1, 2, 3]
        with pytest.raises(NotImplementedError, match="ROADMAP A8.3"):
            lg.owned_partitions((1, 2))


def test_fault_sites_and_append_fault_loses_nothing(tmp_path, monkeypatch):
    for site in ("ingest.append", "ingest.seal", "ingest.offset"):
        assert site in resilience.FAULT_SITES and site in jres.FAULT_SITES
    lg = ingest.RowLog(str(tmp_path / "log"), header=["a", "b"],
                       segment_rows=100)
    monkeypatch.setenv("SHIFU_TPU_FAULT", "ingest.append:oserror:1")
    resilience.reset_faults()
    with pytest.raises(OSError, match="ingest.append"):
        lg.append(_batch(3))
    assert lg.open_rows() == 0
    assert lg.append(_batch(3)) == 3   # the producer's retry
    assert lg.open_rows() == 3


@pytest.mark.parametrize("nth", [1, 2])
def test_seal_fault_reseals_the_same_sequence_like_jax(tmp_path, monkeypatch,
                                                       fixed_clock, nth):
    """A fault at either rename of a seal (nth 1: before the segment
    file, 2: between the segment file and the manifest): the rerun
    re-seals sequence 1 over any orphan, and the tree equals the JAX
    package's after the same fault, with no `.tmp.*` left."""
    trees = []
    for mod, res, name in ((jingest, jres, "jax"),
                           (ingest, resilience, "port")):
        root = str(tmp_path / name)
        monkeypatch.setenv("SHIFU_TPU_FAULT", f"ingest.seal:oserror:{nth}")
        res.reset_faults()
        lg = mod.RowLog(root, header=["a", "b"], segment_rows=100)
        lg.append(_batch(5))
        with pytest.raises(OSError):
            lg.seal_all()
        orphan = os.path.exists(os.path.join(root, "part-0",
                                             "seg-000001.rows"))
        assert orphan == (nth == 2)
        assert mod.RowLog(root).sealed_rows() == 0
        monkeypatch.delenv("SHIFU_TPU_FAULT")
        res.reset_faults()
        assert lg.seal_all() == [(0, 1)]
        assert mod.RowLog(root).read_window("watch").lines == _batch(5)
        assert not _no_tmp_residue(root)
        trees.append(_files(root))
    assert trees[0] == trees[1]


# ---------------------------------------------------------------------------
# watch --ingest: exactly once through the loop
# ---------------------------------------------------------------------------

def _drift_slo(ms):
    with open(os.path.join(ms, "slo.json"), "w") as f:
        json.dump({"slos": [
            {"name": "drift", "metric": "drift.psi_max", "op": "<=",
             "warn": 0.02, "breach": 0.05, "window_s": 86400.0,
             "agg": "last"}]}, f)


def _shifted_rows(ms, delta=0.5):
    """The set's training rows with every num_* value moved by delta —
    the same shift the JAX package's tests apply through pandas."""
    with open(os.path.join(ms, "data", ".pig_header")) as f:
        hdr = f.read().strip().split("|")
    with open(os.path.join(ms, "data", "part-00000")) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    cols = [i for i, c in enumerate(hdr) if c.startswith("num_")]
    out = []
    for ln in lines:
        toks = ln.split("|")
        for i in cols:
            try:
                toks[i] = f"{float(toks[i]) + delta:.6f}"
            except ValueError:
                pass
        out.append("|".join(toks))
    return hdr, out


def _stats_set(tmp_path, seed=9, n_rows=300):
    from tests.synth import make_model_set
    ms = make_model_set(str(tmp_path), np.random.default_rng(seed),
                        n_rows=n_rows)
    for cmd in ("init", "stats"):
        assert jax_cli(["--dir", ms, cmd]) == 0
    _drift_slo(ms)
    return ms


def _drift_points(root):
    from shifu_tpu_torch.obs.health import store
    return [(p["name"], p["value"], p["tags"])
            for p in store.MetricsStore(root).read_points()
            if p["name"].startswith("drift.")]


def test_offset_fault_between_read_and_commit_replays_the_window(
        tmp_path, monkeypatch):
    """An `ingest.offset` fault after the drift observe: the window is
    absorbed uncommitted, the next tick replays it whole, and the drift
    points equal the JAX loop's under the same fault."""
    from shifu_tpu.obs.health import watch as jwatch
    from shifu_tpu.processor.base import ProcessorContext as JaxCtx
    from shifu_tpu_torch.obs.health import watch
    from shifu_tpu_torch.processor.base import ProcessorContext
    ms = _stats_set(tmp_path / "set")
    hdr, shifted = _shifted_rows(ms, delta=5.0)
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    got = {}
    for name in ("jax", "port"):
        root = shutil.copytree(ms, str(tmp_path / f"ms_{name}"))
        log_root = str(tmp_path / f"log_{name}")
        mod = jingest if name == "jax" else ingest
        lg = mod.RowLog(log_root, header=hdr, segment_rows=64)
        lg.append(shifted)
        lg.seal_all()
        monkeypatch.setenv("SHIFU_TPU_FAULT", "ingest.offset:oserror:1")
        jres.reset_faults()
        resilience.reset_faults()
        if name == "jax":
            jwatch.run_monitor(JaxCtx.load(root), interval_s=0.0,
                               iterations=1, ingest_log=lg)
        else:
            watch.run_monitor(ProcessorContext.load(root), interval_s=0.0,
                              iterations=1, ingest_log=lg, device="cpu")
        assert lg.lag("watch") == len(shifted)   # absorbed, not committed
        monkeypatch.delenv("SHIFU_TPU_FAULT")
        if name == "jax":
            jwatch.run_monitor(JaxCtx.load(root), interval_s=0.0,
                               iterations=2, ingest_log=lg)
        else:
            watch.run_monitor(ProcessorContext.load(root), interval_s=0.0,
                              iterations=2, ingest_log=lg, device="cpu")
        assert lg.lag("watch") == 0
        got[name] = _drift_points(root)
    assert got["port"] and got["port"] == got["jax"]
    # the first tick observed, the replay observed the same rows again
    psi = [v for n, v, _ in got["port"] if n == "drift.psi_max"]
    assert len(psi) == 2 and psi[0] == psi[1] > 0.05


def test_legacy_tail_never_delivers_a_torn_row(tmp_path):
    from shifu_tpu_torch.obs.health.watch import _production_window
    from shifu_tpu_torch.processor.base import ProcessorContext
    from tests.synth import make_model_set
    ms = make_model_set(str(tmp_path), np.random.default_rng(5), n_rows=60)
    assert jax_cli(["--dir", ms, "init"]) == 0
    ctx = ProcessorContext.load(ms)
    part = os.path.join(ms, "data", "part-00000")
    with open(part, encoding="utf-8") as f:
        template = f.readline().strip()
    df, tail = _production_window(ctx, {})
    assert len(df) == 48
    half = len(template) // 2
    with open(part, "a", encoding="utf-8") as f:
        f.write(template + "\n" + template[:half])
    df, tail = _production_window(ctx, tail)
    assert len(df) == 1   # the torn row held back
    assert [df[c][0] for c in df.columns] == template.split("|")
    df, tail = _production_window(ctx, tail)
    assert df is None
    with open(part, "a", encoding="utf-8") as f:
        f.write(template[half:] + "\n" + template + "\n")
    df, tail = _production_window(ctx, tail)
    assert len(df) == 2
    for i in range(2):
        assert [df[c][i] for c in df.columns] == template.split("|")


# ---------------------------------------------------------------------------
# acceptance drill: log → watch --ingest → breach → refresh → audit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained_set(tmp_path_factory):
    """ONE trained tiny GBT set (the JAX package's init → stats → norm →
    train, private rng) for the module; tests copy it."""
    from tests.synth import make_model_set
    base = tmp_path_factory.mktemp("ingest_base")
    ms = make_model_set(str(base), np.random.default_rng(23), n_rows=400,
                        algorithm="GBT",
                        train_params={"TreeNum": 4, "MaxDepth": 3,
                                      "LearningRate": 0.1, "Loss": "log"})
    for cmd in ("init", "stats", "norm", "train"):
        assert jax_cli(["--dir", ms, cmd]) == 0, cmd
    return ms


def test_watch_ingest_breach_refresh_records_auditable_range(
        trained_set, tmp_path, monkeypatch):
    from shifu_tpu.obs.health import watch as jwatch
    from shifu_tpu.obs.health.refresh import RefreshController as JaxCtl
    from shifu_tpu.processor.base import ProcessorContext as JaxCtx
    from shifu_tpu_torch.obs.health import watch
    from shifu_tpu_torch.obs.health.refresh import RefreshController
    from shifu_tpu_torch.processor.base import ProcessorContext
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    hdr, shifted = _shifted_rows(trained_set)
    out = {}
    for name in ("jax", "port"):
        ms = shutil.copytree(trained_set, str(tmp_path / f"ms_{name}"))
        _drift_slo(ms)
        reg = str(tmp_path / f"reg_{name}")
        pub = jreg.publish if name == "jax" else registry.publish
        v1 = pub(reg, "m", os.path.join(ms, "models"), ladder=(1, 4))
        root = str(tmp_path / f"rowlog_{name}")
        mod = jingest if name == "jax" else ingest
        lg = mod.RowLog(root, header=hdr, segment_rows=128)
        lg.append(shifted)
        lg.seal_all()
        if name == "jax":
            ctx = JaxCtx.load(ms)
            ctl = JaxCtl(ctx, registry_root=reg, model_name="m",
                         tolerance=0.2, cooldown_s=0.0, ingest_log=lg)
            rc = jwatch.run_monitor(ctx, interval_s=0.0, iterations=1,
                                    refresh=ctl, ingest_log=lg)
            man = jreg.resolve(reg, "m")[2]
        else:
            ctx = ProcessorContext.load(ms)
            ctl = RefreshController(ctx, registry_root=reg, model_name="m",
                                    tolerance=0.2, cooldown_s=0.0,
                                    ingest_log=lg, device="cpu")
            rc = watch.run_monitor(ctx, interval_s=0.0, iterations=1,
                                   refresh=ctl, ingest_log=lg,
                                   device="cpu")
            man = registry.resolve(reg, "m")[2]
        assert rc == 0 and ctl.last_outcome == "promoted", ctl.stats()
        assert man["refresh"]["refreshed_from"] == v1
        iw = man["refresh"]["ingest_window"]
        assert iw["log"] == root and iw["rows"] == len(shifted)
        replay = ingest.RowLog(root).read_range(iw["start"], iw["end"])
        wdir = os.path.join(ms, "tmp", "refresh", "run0001", "window")
        with open(os.path.join(wdir, "part-00000"), encoding="utf-8") as f:
            trained_on = [ln.rstrip("\n") for ln in f]
        assert replay == trained_on == shifted
        assert lg.lag("watch") == 0 and lg.lag("refresh") == 0
        assert not _no_tmp_residue(root) and not _no_tmp_residue(reg)
        out[name] = man["refresh"]
    for k in ("incumbent_auc", "challenger_auc"):
        assert abs(out["port"][k] - out["jax"][k]) <= AUC_TOL, (k, out)
    for k in ("start", "end", "rows"):
        assert out["port"]["ingest_window"][k] == \
            out["jax"]["ingest_window"][k]


def test_cli_watch_ingest_and_inventory(tmp_path, monkeypatch, capsys,
                                        fixed_clock):
    """`watch --monitor-only --ingest LOG` through the port's CLI
    consumes the drifted window (breach in the store, offset
    committed), and `ingest ls` prints what the JAX package's prints
    for the same log."""
    from shifu_tpu_torch.obs.health import store
    ms = _stats_set(tmp_path / "set")
    hdr, shifted = _shifted_rows(ms, delta=5.0)
    root = str(tmp_path / "rowlog")
    lg = ingest.RowLog(root, header=hdr, segment_rows=64)
    lg.append(shifted)
    lg.seal_all()
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    assert cli.main(["--dir", ms, "watch", "--monitor-only", "--ingest",
                     root, "--iterations", "1", "--interval-s", "0",
                     "--device", "cpu"]) == 0
    st = store.MetricsStore(ms)
    assert st.series("drift.psi_max")[-1][1] > 0.05
    assert {"event.drift", "event.breach"} <= \
        {e["name"] for e in st.events(limit=20)}
    capsys.readouterr()
    assert cli.main(["ingest", "ls", "--log", root]) == 0
    inv = json.loads(capsys.readouterr().out)
    assert jax_cli(["--dir", ms, "ingest", "ls", "--log", root]) == 0
    assert inv == json.loads(capsys.readouterr().out)
    assert inv["sealed_rows"] == len(shifted)
    row = next(c for c in inv["consumers"] if c["name"] == "watch")
    assert row["lag_rows"] == 0 and row["committed_rows"] == len(shifted)
