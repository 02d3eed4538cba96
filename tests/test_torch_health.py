"""The port's health plane (`shifu_tpu_torch/obs/health`) against the
JAX package's on the same inputs.

- the store: the same emits with fixed `ts` give equal JSONL files,
  after a rollup too, and each package reads the other's file;
- SLO transitions with hysteresis, the alert records and `health_state`
  over the same series;
- `RollingDrift` snapshots over the same windows (the port bins on the
  CPU here; the card's bins are integers, so they are the CPU's), and
  `mean_psi_vs_global` against the one-shot `stats -psi`, within 1e-8;
- `run_monitor` over injected windows: equal drift points and events;
- `eval` writes the same `eval.*` points, resident and streaming;
- the serving flusher's `serve.*` points, `/healthz`, `watch
  --monitor-only` and `health` (rc 1 on a breach) through the CLI, the
  webhook sink through its retry, and the health plane's fault sites
  absorbed.

Every generator is a private `np.random.default_rng(seed)` (C-ref-1).
"""

import json
import os
import shutil
import urllib.request

import numpy as np
import pytest

from shifu_tpu import resilience as jres
from shifu_tpu.cli import main as jax_cli
from shifu_tpu.obs.health import store as jstore
from shifu_tpu.processor.base import ProcessorContext as JaxCtx
from shifu_tpu_torch import cli, resilience
from shifu_tpu_torch.data import reader
from shifu_tpu_torch.obs.health import store as pstore
from shifu_tpu_torch.processor.base import ProcessorContext

TOL = 1e-8
_DRIFT_SLO = {"slos": [{"name": "drift", "metric": "drift.psi_max",
                        "op": "<=", "warn": 0.05, "breach": 0.2,
                        "window_s": 86400.0, "agg": "last"}]}


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    for k in ("SHIFU_TPU_METRICS", "SHIFU_TPU_METRICS_ROLLUP",
              "SHIFU_TPU_SLO_FILE", "SHIFU_TPU_ALERT_WEBHOOK",
              "SHIFU_TPU_FAULT", "SHIFU_TPU_TRACE"):
        monkeypatch.delenv(k, raising=False)
    resilience.reset_faults()
    jres.reset_faults()
    yield
    resilience.reset_faults()
    jres.reset_faults()


# ---------------------------------------------------------------------------
# model sets and windows
# ---------------------------------------------------------------------------

def _model_set(tmp_path, n_rows=600, seed=13, psi_cohort=False):
    """A synth model set through the JAX package's `init` and `stats`
    (and, with `psi_cohort`, a `month` cohort and `stats -psi`)."""
    from tests.synth import make_model_set
    root = make_model_set(str(tmp_path), np.random.default_rng(seed),
                          n_rows=n_rows)
    if psi_cohort:
        lines, header = _lines(root)
        lines = [ln + ("|m1" if i % 2 == 0 else "|m2")
                 for i, ln in enumerate(lines)]
        _write_lines(root, lines)
        with open(os.path.join(root, "data", ".pig_header"), "w") as f:
            f.write("|".join(header + ["month"]) + "\n")
        path = os.path.join(root, "ModelConfig.json")
        mc = json.load(open(path))
        mc["stats"]["psiColumnName"] = "month"
        with open(mc["dataSet"]["metaColumnNameFile"], "a") as f:
            f.write("month\n")
        json.dump(mc, open(path, "w"))
    steps = [["init"], ["stats"]] + ([["stats", "-psi"]] if psi_cohort
                                     else [])
    for cmd in steps:
        assert jax_cli(["--dir", root] + cmd) == 0
    return root


def _lines(root):
    with open(os.path.join(root, "data", ".pig_header")) as f:
        header = f.read().strip().split("|")
    with open(os.path.join(root, "data", "part-00000")) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    return lines, header


def _write_lines(root, lines):
    with open(os.path.join(root, "data", "part-00000"), "w") as f:
        f.write("".join(ln + "\n" for ln in lines))


def _shift(lines, header, delta=5.0):
    """Every num_* value moved by +delta (missing tokens kept)."""
    cols = [i for i, c in enumerate(header) if c.startswith("num_")]
    out = []
    for ln in lines:
        toks = ln.split("|")
        for i in cols:
            try:
                toks[i] = f"{float(toks[i]) + delta:.6f}"
            except ValueError:
                pass
        out.append("|".join(toks))
    return out


def _windows(lines, header):
    """The same rows as the JAX package's frame and the port's Table."""
    from shifu_tpu.data.ingest import frame_from_rows
    return (frame_from_rows(lines, header, "|"),
            reader._rows_table(lines, header, "|", "window"))


def _copy_set(src, dst):
    shutil.copytree(src, dst)
    path = os.path.join(dst, "ModelConfig.json")
    text = open(path).read().replace(src, str(dst))
    open(path, "w").write(text)
    return str(dst)


def _close(a, b, tol=TOL, where="snapshot"):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _close(a[k], b[k], tol, f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, tol, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(float(a) - float(b)) <= tol, (where, a, b)
    else:
        assert a == b, (where, a, b)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def _emit_all(st):
    st.emit("serve.p99_ms", 12.5, ts=100.0)
    st.emit("serve.p99_ms", 14, ts=101.0, model="nn")
    st.counter("serve.rejected", 3, priority="low")
    st.event("drift", features="num_0,num_1", psi_max=0.41, window=2)
    st.emit("health.drift", 2, ts=103.25, metric="drift.psi_max",
            value_seen=0.41)


def test_store_files_equal_and_each_package_reads_the_other(
        tmp_path, monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    ja, po = str(tmp_path / "jax"), str(tmp_path / "port")
    for st in (jstore.MetricsStore(ja), pstore.MetricsStore(po)):
        _emit_all(st)
        assert st.flush() == 5
    # counter/event points take time.time(): compare them without ts
    j_lines = open(jstore.metrics_path(ja)).read().splitlines()
    p_lines = open(pstore.metrics_path(po)).read().splitlines()
    for a, b in zip(j_lines, p_lines):
        a, b = json.loads(a), json.loads(b)
        if a["kind"] in ("gauge",):
            assert a == b
        else:
            a.pop("ts"), b.pop("ts")
            assert a == b
    assert len(j_lines) == len(p_lines) == 5
    assert tuple(json.loads(p_lines[0])) == pstore.METRIC_FIELDS
    from shifu_tpu.profiling import METRIC_FIELDS
    assert pstore.METRIC_FIELDS == METRIC_FIELDS
    # cross reads: each package's reader over the other's file
    for root in (ja, po):
        j, p = jstore.MetricsStore(root), pstore.MetricsStore(root)
        assert j.series("serve.p99_ms") == p.series("serve.p99_ms")
        assert j.read_points() == p.read_points()
        assert j.events(names=["drift"]) == p.events(names=["drift"])


def test_rollup_files_equal_and_cross_read(tmp_path, monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    monkeypatch.setenv("SHIFU_TPU_METRICS_ROLLUP", "1500")
    ja, po = str(tmp_path / "jax"), str(tmp_path / "port")
    base = 1_786_000_000.0
    for st in (jstore.MetricsStore(ja), pstore.MetricsStore(po)):
        for i in range(300):
            st.emit("serve.p99_ms", float(i), ts=base + 10.0 * i,
                    model="m" if i % 3 else "n")
            if i % 25 == 0:
                st.flush()
        st.flush()
    a = open(jstore.metrics_path(ja)).read()
    b = open(pstore.metrics_path(po)).read()
    assert '"kind": "rollup"' in a and a == b
    for root in (ja, po):
        assert jstore.MetricsStore(root).series("serve.p99_ms") == \
            pstore.MetricsStore(root).series("serve.p99_ms")


def test_disabled_store_writes_nothing(tmp_path):
    st = pstore.MetricsStore(str(tmp_path))
    st.emit("serve.p99_ms", 1.0)
    st.counter("x")
    assert st.flush() == 0
    assert not os.path.exists(os.path.join(str(tmp_path), "tmp"))


# ---------------------------------------------------------------------------
# SLOs
# ---------------------------------------------------------------------------

_LAT_SLO = {"name": "lat", "metric": "serve.p99_ms", "op": "<=",
            "warn": 50.0, "breach": 200.0, "window_s": 3600.0,
            "agg": "last"}
_AUC_SLO = {"name": "auc", "metric": "eval.auc", "op": ">=",
            "warn": 0.75, "breach": 0.70, "window_s": 3600.0}


def test_slo_transitions_and_health_state_match_jax(tmp_path, monkeypatch):
    from shifu_tpu.obs.health import slo as jslo
    from shifu_tpu_torch.obs.health import slo as pslo
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    ja, po = str(tmp_path / "jax"), str(tmp_path / "port")
    rules = [dict(_LAT_SLO), dict(_AUC_SLO)]
    for root in (ja, po):
        os.makedirs(root)
        with open(os.path.join(root, "slo.json"), "w") as f:
            json.dump({"slos": rules}, f)
    evs = (jslo.SloEvaluator(ja, clear=2), pslo.SloEvaluator(po, clear=2))
    stores = (jstore.store(ja), pstore.store(po))
    lat = [None, 10.0, 120.0, 500.0, 10.0, 10.0, 60.0, 10.0, 10.0]
    auc = [None, 0.9, 0.72, 0.6, 0.9, 0.9, 0.65, 0.8, 0.8]
    for lv, av in zip(lat, auc):
        recs = []
        for ev, st in zip(evs, stores):
            if lv is not None:
                st.emit("serve.p99_ms", lv)
                st.emit("eval.auc", av)
            recs.append(ev.evaluate())
        assert recs[0] == recs[1]
        tj, tp = (ev.drain_transitions() for ev in evs)
        for r in tj + tp:
            r.pop("ts")
        assert tj == tp
    for st in stores:
        st.flush()
    hj, hp = jslo.health_state(ja), pslo.health_state(po)
    assert hj["status"] == hp["status"] and hj["slos"] == hp["slos"]
    strip = [[(e["name"], e["tags"]) for e in h["recent_events"]]
             for h in (hj, hp)]
    assert strip[0] == strip[1]
    from shifu_tpu.profiling import HEALTH_FIELDS
    assert pslo.HEALTH_FIELDS == HEALTH_FIELDS
    # the alert file sinks wrote the same transitions
    files = [[{k: v for k, v in json.loads(ln).items() if k != "ts"}
              for ln in open(os.path.join(r, "tmp", "metrics",
                                          "alerts.jsonl"))]
             for r in (ja, po)]
    assert files[0] == files[1] and files[0]


def test_load_slos_precedence_matches_jax(tmp_path, monkeypatch):
    from shifu_tpu.obs.health import slo as jslo
    from shifu_tpu_torch.obs.health import slo as pslo
    root = str(tmp_path)
    assert pslo.load_slos(root) == jslo.load_slos(root)
    with open(os.path.join(root, "slo.json"), "w") as f:
        json.dump({"slos": [dict(_LAT_SLO)]}, f)
    assert pslo.load_slos(root) == jslo.load_slos(root)
    other = tmp_path / "override.json"
    other.write_text(json.dumps([dict(_LAT_SLO, name="ovr")]))
    monkeypatch.setenv("SHIFU_TPU_SLO_FILE", str(other))
    assert [s["name"] for s in pslo.load_slos(root)] == ["ovr"]
    other.write_text(json.dumps([{"name": "x", "metric": "m"}]))
    with pytest.raises(ValueError, match="missing"):
        pslo.load_slos(root)


# ---------------------------------------------------------------------------
# drift
# ---------------------------------------------------------------------------

def test_rolling_drift_snapshots_match_jax(tmp_path):
    from shifu_tpu.obs.health.drift import RollingDrift as JaxDrift
    from shifu_tpu_torch.obs.health.drift import RollingDrift
    root = _model_set(tmp_path)
    lines, header = _lines(root)
    jd = JaxDrift(JaxCtx.load(root))
    pd_ = RollingDrift(ProcessorContext.load(root), device="cpu")
    assert pd_.n_features == jd.n_features
    rng = np.random.default_rng(5)
    windows = [lines, _shift(lines, header),
               [lines[i] for i in rng.choice(len(lines), 150, False)],
               _shift(lines[:200], header, 0.7)]
    for win in windows:
        jw, pw = _windows(win, header)
        a, b = jd.observe(jw), pd_.observe(pw)
        _close(a, b)
    assert b["psi_max"] > 0.0 and a["drifted"] == b["drifted"]
    _close(jd.mean_psi_vs_global(), pd_.mean_psi_vs_global())


def test_mean_psi_vs_global_reproduces_one_shot_psi(tmp_path):
    from shifu_tpu.config.column_config import load_column_configs
    from shifu_tpu_torch.obs.health.drift import RollingDrift
    root = _model_set(tmp_path, n_rows=1000, seed=11, psi_cohort=True)
    lines, _ = _lines(root)
    with open(os.path.join(root, "data", ".pig_header")) as f:
        header = f.read().strip().split("|")
    drift = RollingDrift(ProcessorContext.load(root), device="cpu")
    for cohort in ("m1", "m2"):
        win = [ln for ln in lines if ln.endswith("|" + cohort)]
        snap = drift.observe(_windows(win, header)[1])
        assert snap["rows"] > 0 and snap["psi_max"] < 0.05
    rolling = drift.mean_psi_vs_global()
    compared = {"num": 0, "cat": 0}
    for cc in load_column_configs(os.path.join(root, "ColumnConfig.json")):
        if cc.columnStats.psi is None or cc.columnName not in rolling:
            continue
        assert abs(rolling[cc.columnName] - cc.columnStats.psi) <= TOL, \
            cc.columnName
        compared["cat" if cc.is_categorical else "num"] += 1
    assert compared["num"] >= 4 and compared["cat"] >= 2, compared


def test_drift_needs_frozen_bins(tmp_path):
    from shifu_tpu_torch.obs.health.drift import RollingDrift
    from tests.synth import make_model_set
    root = make_model_set(str(tmp_path), np.random.default_rng(7),
                          n_rows=300)
    assert jax_cli(["--dir", root, "init"]) == 0
    with pytest.raises(ValueError, match="run `stats` first"):
        RollingDrift(ProcessorContext.load(root), device="cpu")


def _drift_points(root, read):
    return [(p["name"], p["value"], p["tags"])
            for p in read(root).read_points()
            if p["name"].startswith(("drift.", "event.drift",
                                     "event.breach", "health."))]


def test_run_monitor_over_injected_windows_matches_jax(tmp_path,
                                                       monkeypatch):
    from shifu_tpu.obs.health import watch as jwatch
    from shifu_tpu_torch.obs.health import watch as pwatch
    root = _model_set(tmp_path / "src")
    ja = _copy_set(root, tmp_path / "jax")
    po = _copy_set(root, tmp_path / "port")
    lines, header = _lines(root)
    wins = [lines[:300], _shift(lines[:300], header), _shift(lines, header,
                                                            2.0)]
    for r in (ja, po):
        json.dump(_DRIFT_SLO, open(os.path.join(r, "slo.json"), "w"))
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    assert jwatch.run_monitor(JaxCtx.load(ja), interval_s=0.0,
                              iterations=3,
                              windows=[_windows(w, header)[0]
                                       for w in wins]) == 0
    assert pwatch.run_monitor(ProcessorContext.load(po), interval_s=0.0,
                              iterations=3,
                              windows=[_windows(w, header)[1]
                                       for w in wins], device="cpu") == 0
    a = _drift_points(ja, jstore.MetricsStore)
    b = _drift_points(po, pstore.MetricsStore)
    assert len(a) == len(b) > 3 * 4
    _close(a, b, where="points")
    assert ("event.breach", 1.0, {"slo": "drift", "from": "ok",
                                  "to": "breach"}) in b


# ---------------------------------------------------------------------------
# eval and serving write their points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("streaming", [False, True])
def test_eval_writes_the_metrics_jax_writes(tmp_path, monkeypatch,
                                            streaming):
    from shifu_tpu.processor import eval as jeval
    from tests.test_torch_eval import copy_set, trained_set
    src = trained_set(tmp_path / "src", "GBT", 93)
    ja = copy_set(src, tmp_path / "jax")
    po = copy_set(src, tmp_path / "port")
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    if streaming:
        monkeypatch.setenv("SHIFU_TPU_EVAL_CHUNK_ROWS", "64")
    assert jeval.run(JaxCtx.load(ja)) == 0
    assert cli.main(["--dir", po, "eval", "--device", "cpu"]) == 0
    want = [(p["name"], p["tags"], p["value"])
            for p in jstore.store(ja).read_points()
            if p["name"].startswith("eval.")]
    got = [(p["name"], p["tags"], p["value"])
           for p in pstore.MetricsStore(po).read_points()
           if p["name"].startswith("eval.")]
    assert [w[:2] for w in want] == [g[:2] for g in got]
    assert {w[0] for w in want} >= {"eval.auc", "eval.weighted_auc"}
    for (_, _, a), (_, _, b) in zip(want, got):
        assert abs(a - b) <= 1e-6


def test_serving_flusher_writes_the_points_jax_writes(tmp_path,
                                                      monkeypatch):
    from shifu_tpu.serve.service import ScorerService as JaxService
    from shifu_tpu_torch.serve.service import ScorerService
    from tests.test_torch_serve_swap import _dense, _nn_dir
    models = _nn_dir(str(tmp_path / "models"), 1)
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    monkeypatch.setenv("SHIFU_TPU_METRICS_FLUSH_S", "0.05")
    names = []
    for cls, root, kw in ((JaxService, str(tmp_path / "jax"), {}),
                          (ScorerService, str(tmp_path / "port"),
                           {"device": "cpu"})):
        svc = cls(models_dir=models, workspace_root=root,
                  metrics_tags={"model": "m"}, **kw).start()
        for n in (1, 3, 9):
            svc.submit(dense=_dense(n, n))
        svc.close()
        pts = (jstore.MetricsStore if cls is JaxService
               else pstore.MetricsStore)(root).read_points()
        names.append({(p["name"], json.dumps(p["tags"], sort_keys=True))
                      for p in pts})
    assert names[0] == names[1]
    assert ("serve.p99_ms", '{"model": "m"}') in names[1]


def test_healthz_reports_the_slo_state(tmp_path, monkeypatch):
    from shifu_tpu_torch.serve.http import HttpFrontEnd
    from shifu_tpu_torch.serve.service import ScorerService
    from tests.test_torch_serve_swap import _nn_dir
    models = _nn_dir(str(tmp_path / "models"), 1)
    root = str(tmp_path / "ws")
    os.makedirs(root)
    json.dump(_DRIFT_SLO, open(os.path.join(root, "slo.json"), "w"))
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    st = pstore.store(root)
    st.emit("drift.psi_max", 0.6)
    st.flush()
    svc = ScorerService(models_dir=models, device="cpu",
                        workspace_root=root).start()
    front = HttpFrontEnd(svc, host="127.0.0.1", port=0).start()
    try:
        host, port = front.address
        with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                    timeout=10) as resp:
            body = json.loads(resp.read())
        assert body["ok"] is True and body["status"] == "breach"
        assert body["slo"][0]["name"] == "drift"
    finally:
        front.close()
        svc.close()


# ---------------------------------------------------------------------------
# the verbs
# ---------------------------------------------------------------------------

def test_watch_monitor_only_then_health_exits_1(tmp_path, monkeypatch,
                                                capsys):
    root = _model_set(tmp_path)
    lines, header = _lines(root)
    _write_lines(root, _shift(lines, header))
    json.dump(_DRIFT_SLO, open(os.path.join(root, "slo.json"), "w"))
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    assert cli.main(["--dir", root, "watch", "--monitor-only",
                     "--iterations", "2", "--interval-s", "0",
                     "--device", "cpu"]) == 0
    st = pstore.MetricsStore(root)
    names = {e["name"] for e in st.events(limit=20)}
    assert {"event.drift", "event.breach"} <= names
    # one window: the header-less file tailed once, then nothing new
    assert len(st.series("drift.psi_max")) == 1
    assert st.series("drift.psi_max")[-1][1] > 0.2
    monkeypatch.delenv("SHIFU_TPU_METRICS")
    capsys.readouterr()
    assert cli.main(["--dir", root, "health"]) == 1
    out = capsys.readouterr().out
    assert "status: BREACH" in out and "drift.psi_max" in out
    assert "recent events:" in out
    assert jax_cli(["--dir", root, "health"]) == 1
    assert capsys.readouterr().out.splitlines()[:3] == out.splitlines()[:3]


@pytest.mark.parametrize("argv", [["watch"], ["watch", "--monitor-only",
                                              "--ingest", "log"]])
def test_watch_full_mode_and_ingest_raise_naming_a74(tmp_path, argv,
                                                     monkeypatch):
    """Full `watch` (a refresh controller, report-only without a
    registry) and `watch --ingest LOG` run where they used to raise: one
    tick over the set's rows, the drift point landed, the log's watch
    consumer committed."""
    from shifu_tpu_torch.data.ingest import RowLog
    root = _model_set(tmp_path, n_rows=300, seed=17)
    lines, header = _lines(root)
    log_root = str(tmp_path / "log")
    lg = RowLog(log_root, header=header, segment_rows=64)
    lg.append(lines)
    lg.seal_all()
    argv = [log_root if a == "log" else a for a in argv]
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    assert cli.main(["--dir", root] + argv + [
        "--iterations", "1", "--interval-s", "0", "--device", "cpu"]) == 0
    assert len(pstore.MetricsStore(root).series("drift.psi_max")) == 1
    assert lg.lag("watch") == (0 if "--ingest" in argv else len(lines))


def test_help_lists_the_new_verbs(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    out = capsys.readouterr().out
    for verb in ("registry", "watch", "health", "serve"):
        assert verb in out


def test_health_sparkline_and_canary_lines(tmp_path, monkeypatch, capsys):
    root = str(tmp_path)
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    st = pstore.store(root)
    for i, v in enumerate((10.0, 20.0, 30.0)):
        st.emit("serve.p99_ms", v)
    st.event("canary", model="m", phase="shadow", version="v002")
    st.emit("serve.arm_p99_ms", 3.5, model="m", arm="canary")
    st.emit("canary.arm_psi", 0.01, model="m")
    st.flush()
    assert cli.main(["--dir", root, "health"]) == 0
    out = capsys.readouterr().out
    assert "▁▄█" in out and "canary arms:" in out
    assert "p99[canary]=3.500ms" in out and "arm_psi=0.0100" in out
    assert jax_cli(["--dir", root, "health"]) == 0
    want = capsys.readouterr().out
    assert [ln for ln in want.splitlines() if "  m:" in ln] == \
        [ln for ln in out.splitlines() if "  m:" in ln]


# ---------------------------------------------------------------------------
# faults and the webhook
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site", ["obs.metrics_flush", "obs.alert",
                                  "watch.window"])
def test_health_plane_faults_absorbed(tmp_path, monkeypatch, site):
    from shifu_tpu_torch.obs.health import watch as pwatch
    root = _model_set(tmp_path, n_rows=300, seed=7)
    lines, header = _lines(root)
    json.dump(_DRIFT_SLO, open(os.path.join(root, "slo.json"), "w"))
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    monkeypatch.setenv("SHIFU_TPU_FAULT", f"{site}:oserror:1")
    resilience.reset_faults()
    rc = pwatch.run_monitor(ProcessorContext.load(root), interval_s=0.0,
                            iterations=1,
                            windows=[_windows(_shift(lines, header),
                                              header)[1]], device="cpu")
    assert rc == 0
    monkeypatch.delenv("SHIFU_TPU_FAULT")
    st = pstore.MetricsStore(root)
    if site == "watch.window":
        assert st.series("watch.window_failed") != []
        assert st.series("drift.psi_max") == []
    else:
        assert st.series("drift.psi_max")[-1][1] > 0.2
        assert {e["name"] for e in st.events(limit=20)} >= \
            {"event.drift", "event.breach"}
    if site == "obs.alert":
        assert os.path.exists(os.path.join(root, "tmp", "metrics",
                                           "alerts.jsonl"))


def test_webhook_sink_posts_and_retries_through_fault(monkeypatch):
    import http.server
    import threading

    from shifu_tpu_torch.obs.health import slo as pslo
    received = []

    class _Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", "0"))
            received.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *_a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), _Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/alert"
        monkeypatch.setenv("SHIFU_TPU_ALERT_WEBHOOK", url)
        monkeypatch.setenv("SHIFU_TPU_RETRY_BASE_S", "0.01")
        pslo.webhook_sink({"slo": "drift", "state": "breach"})
        assert received[-1]["slo"] == "drift"
        monkeypatch.setenv("SHIFU_TPU_FAULT", "obs.webhook:oserror:1")
        resilience.reset_faults()
        pslo.webhook_sink({"slo": "auc", "state": "warn"})
        assert received[-1]["slo"] == "auc" and len(received) == 2
    finally:
        srv.shutdown()


def test_fault_spec_parser_matches_jax():
    for raw in ("registry.publish:oserror:1", "a:timeout:2-4;b:kill:3+",
                "obs.alert:preempt:1, watch.window:oserror:2"):
        assert [tuple(r) for r in resilience._parse_fault_spec(raw)] == \
            [tuple(r) for r in jres._parse_fault_spec(raw)]
    for bad in ("x:oserror", "x:boom:1", "x:oserror:z"):
        with pytest.raises(ValueError):
            resilience._parse_fault_spec(bad)
    assert set(resilience.FAULT_SITES) <= set(jres.FAULT_SITES)
    for exc in (TimeoutError(), ConnectionError(), OSError(),
                FileNotFoundError(), PermissionError(), ValueError()):
        assert resilience.is_transient(exc) == jres.is_transient(exc)


def test_datapath_tail_skips_the_in_file_header(tmp_path):
    """With no headerPath the first part file starts with the header
    line: the port's first window holds the data rows only, where the
    JAX package's tail also takes the header line as a row (C-ref-3)."""
    from shifu_tpu.obs.health import watch as jwatch
    from shifu_tpu_torch.obs.health import watch as pwatch
    root = _model_set(tmp_path)
    lines, header = _lines(root)
    _write_lines(root, ["|".join(header)] + lines)
    path = os.path.join(root, "ModelConfig.json")
    mc = json.load(open(path))
    mc["dataSet"]["headerPath"] = ""
    json.dump(mc, open(path, "w"))
    got, tail = pwatch._production_window(ProcessorContext.load(root), {})
    assert len(got) == len(lines)
    assert list(got[header[0]][:2]) == [ln.split("|")[0]
                                         for ln in lines[:2]]
    assert pwatch._production_window(ProcessorContext.load(root),
                                     tail)[0] is None
    want, _ = jwatch._production_window(JaxCtx.load(root), {})
    assert len(want) == len(lines) + 1
