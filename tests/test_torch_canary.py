"""The port's live promotion (`shifu_tpu_torch/obs/health/canary.py`, the
fleet's arms in `serve/fleet.py`), `FleetDriftWatch` and full `watch`
against the JAX package's, on the CPU.

- the drill: breach → warm retrain → the challenger warms as a fleet
  ARM (primary pinned) → shadow evidence → canary traffic → the LIVE
  verdict promotes, under a scoring client with zero failed requests;
  the manifest records the verdict and the observed window;
- a slow challenger breaches the live band and rolls back mid-canary;
- `arm_assign` equals the JAX function for every seq; the `decide`
  table equals the JAX rule's; a failing shadow plane never touches the
  primary; a fault at every `canary.*` site leaves the incumbent
  serving and recovers HEAD; SIGKILL mid-canary in a subprocess is
  rolled back by `recover`;
- `FleetDriftWatch`'s per-tenant drift under the refresh budget, and
  its absorbed poisoned window;
- `health`'s canary lines equal the JAX package's, the `X-Shifu-Arm`
  header names the real arm and the `shifu_canary_*` Prometheus lines
  equal the JAX renderer's; full `watch --registry --model-name`
  through `cli.main` recovers a stale canary and promotes.

Every generator is a private `np.random.default_rng(seed)` (C-ref-1).
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from shifu_tpu import resilience as jres
from shifu_tpu.cli import main as jax_cli
from shifu_tpu_torch import cli, registry, resilience
from shifu_tpu_torch.data import reader
from shifu_tpu_torch.data.ingest import rows_from_frame
from shifu_tpu_torch.obs.health import store as health_store
from shifu_tpu_torch.obs.health.canary import (CanaryController, read_state,
                                               state_path)
from shifu_tpu_torch.obs.health.refresh import RefreshController
from shifu_tpu_torch.processor.base import ProcessorContext
from shifu_tpu_torch.serve.fleet import FleetService, arm_assign

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LADDER = (1, 4)


@pytest.fixture(autouse=True)
def _canary_isolation(monkeypatch):
    for k in ("SHIFU_TPU_METRICS", "SHIFU_TPU_SLO_FILE",
              "SHIFU_TPU_ALERT_WEBHOOK", "SHIFU_TPU_TRACE",
              "SHIFU_TPU_FAULT", "SHIFU_TPU_SHADOW_PCT",
              "SHIFU_TPU_CANARY_PCT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SHIFU_TPU_RETRY_BASE_S", "0.01")
    resilience.reset_faults()
    jres.reset_faults()
    yield
    resilience.reset_faults()
    jres.reset_faults()


@pytest.fixture(scope="module")
def trained_set(tmp_path_factory):
    """ONE trained tiny NN set per module (the JAX package's steps,
    private rng); tests copy it."""
    from tests.synth import make_model_set
    base = tmp_path_factory.mktemp("canary_base")
    ms = make_model_set(str(base), np.random.default_rng(23), n_rows=400)
    cfg_path = os.path.join(ms, "ModelConfig.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["train"]["numTrainEpochs"] = 8
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)
    for cmd in ("init", "stats", "norm", "train"):
        assert jax_cli(["--dir", ms, cmd]) == 0, cmd
    return ms


def _clone_set(src, tmp_path, name="ModelSet"):
    return shutil.copytree(src, os.path.join(str(tmp_path), name))


def _table(ms, delta=None):
    with open(os.path.join(ms, "data", ".pig_header")) as f:
        hdr = f.read().strip().split("|")
    with open(os.path.join(ms, "data", "part-00000")) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    if delta is not None:
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
        lines = out
    return reader._rows_table(lines, hdr, "|", "window")


def _publish_incumbent(ms, tmp_path, name="m"):
    reg = os.path.join(str(tmp_path), "reg")
    v1 = registry.publish(reg, name, os.path.join(ms, "models"),
                          ladder=LADDER)
    return reg, v1


def _no_tmp_residue(root):
    return [os.path.join(d, f) for d, _dirs, fs in os.walk(root)
            for f in fs if f.startswith(".tmp.")]


def _drift_slo(ms):
    with open(os.path.join(ms, "slo.json"), "w") as f:
        json.dump({"slos": [
            {"name": "drift", "metric": "drift.psi_max", "op": "<=",
             "warn": 0.02, "breach": 0.05, "window_s": 86400.0,
             "agg": "last"}]}, f)


def _fleet(reg, ms):
    return FleetService(reg, workspace_root=ms, hbm_budget_mb=0,
                        device="cpu")


def _x(reg, n=3):
    man = registry.resolve(reg, "m")[2]
    return np.random.default_rng(3).normal(
        0, 1, (n, man["input_dim"])).astype(np.float32)


# wide PSI band: a warm-retrained twin scored on a tiny batch lands its
# mass in other 16-bin buckets (the rule is pinned by the decide table)
_CANARY_KW = dict(shadow_pct=0.5, canary_pct=0.5, min_requests=10,
                  window_s=60.0, psi_max=100.0, p99_factor=20.0,
                  slo_p99_ms=5000.0, poll_s=0.01)


def _live_client(fleet, x, stop, failures, served, arms_seen):
    while not stop.is_set():
        try:
            _, timing = fleet.submit_timed("m", dense=x, timeout=30.0)
            served[0] += 1
            arms_seen.add(timing.get("arm"))
        except Exception as e:  # noqa: BLE001 — any miss fails
            failures.append(e)


def _with_client(fleet, x, fn):
    stop, failures, served, arms = threading.Event(), [], [0], set()
    t = threading.Thread(target=_live_client,
                         args=(fleet, x, stop, failures, served, arms),
                         daemon=True)
    t.start()
    try:
        out = fn()
    finally:
        stop.set()
        t.join(timeout=30)
    return out, failures, served[0], arms


# ---------------------------------------------------------------------------
# the drills
# ---------------------------------------------------------------------------

def test_live_promotion_drill_end_to_end(trained_set, tmp_path,
                                         monkeypatch):
    from shifu_tpu_torch.obs.health import watch
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    ms = _clone_set(trained_set, tmp_path)
    reg, v1 = _publish_incumbent(ms, tmp_path)
    _drift_slo(ms)
    with _fleet(reg, ms) as fleet:
        x = _x(reg)
        before = fleet.submit("m", dense=x)["mean"]
        ctl = RefreshController(ProcessorContext.load(ms),
                                registry_root=reg, model_name="m",
                                fleet=fleet, cooldown_s=0.0,
                                canary=dict(_CANARY_KW), device="cpu")
        ctl.note_window(_table(ms))
        rc, failures, served, arms = _with_client(
            fleet, x, lambda: watch.run_monitor(
                ProcessorContext.load(ms), interval_s=0.0, iterations=1,
                windows=[_table(ms, delta=0.5)], refresh=ctl,
                device="cpu"))
        assert rc == 0 and ctl.last_outcome == "promoted", ctl.stats()
        assert registry.head(reg, "m") == "v002"
        man = registry.resolve(reg, "m")[2]
        assert man["canary"]["verdict"] == "promote"
        assert man["canary"]["baseline"] == v1
        win = man["canary"]["live_window"]
        assert win["requests"]["canary"] >= _CANARY_KW["min_requests"]
        assert win["requests"]["shadow"] >= _CANARY_KW["min_requests"]
        assert win["arm_psi"] is not None
        assert man["refresh"]["mode"] == "live"
        assert not failures and served > 0, failures[:3]
        assert {"primary", "canary"} <= arms
        assert fleet.arm_stats("m") is None
        assert not fleet._entries["m"].pinned
        assert not np.array_equal(before, fleet.submit("m", dense=x)["mean"])
        assert read_state(reg, "m") is None
    phases = [e["tags"]["phase"] for e in health_store.store(ms)
              .events(limit=50, names=["canary"])]
    for want in ("shadow", "canary", "promoted"):
        assert want in phases, phases
    assert not _no_tmp_residue(ms) and not _no_tmp_residue(reg)


def test_slow_challenger_rolls_back_mid_canary(trained_set, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    ms = _clone_set(trained_set, tmp_path)
    reg, v1 = _publish_incumbent(ms, tmp_path)
    with _fleet(reg, ms) as fleet:
        x = _x(reg)
        before = fleet.submit("m", dense=x)["mean"]
        orig_start = fleet.start_arms

        def sabotaged_start(name, challenger_dir, **kw):
            out = orig_start(name, challenger_dir, **kw)
            svc = fleet._arms[name].service
            orig_submit = svc.submit_timed

            def slow_submit(timeout=30.0, **blocks):
                time.sleep(0.4)
                out, timing = orig_submit(timeout=timeout, **blocks)
                timing["total_s"] += 0.4
                return out, timing

            svc.submit_timed = slow_submit
            return out

        monkeypatch.setattr(fleet, "start_arms", sabotaged_start)
        kw = dict(_CANARY_KW, slo_p99_ms=50.0, p99_factor=1.5,
                  min_requests=8)
        result, failures, served, _ = _with_client(
            fleet, x, lambda: CanaryController(
                fleet, reg, "m", store_root=ms, **kw).run(
                    os.path.join(ms, "models"), "sab01"))
        assert result["outcome"] == "rolled_back"
        assert "p99" in result["verdict"]["reason"]
        assert registry.head(reg, "m") == v1
        orphan = registry.resolve(reg, "m", result["version"])[2]
        assert orphan["canary"]["verdict"] == "rollback"
        assert not failures and served > 0, failures[:3]
        assert fleet.arm_stats("m") is None
        np.testing.assert_array_equal(before,
                                      fleet.submit("m", dense=x)["mean"])
        assert read_state(reg, "m") is None
    phases = [e["tags"]["phase"] for e in health_store.store(ms)
              .events(limit=50, names=["canary"])]
    assert "rolled_back" in phases, phases
    assert not _no_tmp_residue(ms) and not _no_tmp_residue(reg)


# ---------------------------------------------------------------------------
# determinism, the rule, shadow isolation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pct", [0.0, 0.05, 0.2, 0.25, 0.5, 1.0, 1.5])
def test_arm_assign_equals_jax_for_every_seq(pct):
    from shifu_tpu.serve.fleet import arm_assign as jax_arm_assign
    got = [arm_assign(i, pct) for i in range(20000)]
    assert got == [jax_arm_assign(i, pct) for i in range(20000)]
    if 0.0 < pct < 1.0:
        assert abs(sum(got) / len(got) - pct) < 0.01


@pytest.mark.parametrize("stats", [
    {"arm_psi": 0.01, "p99_ms": {"canary": 5.0, "primary": 5.0},
     "canary_fallbacks": 0},
    {"arm_psi": None, "p99_ms": {}, "canary_fallbacks": 0},
    {"arm_psi": 0.9, "p99_ms": {"canary": 5.0, "primary": 5.0},
     "canary_fallbacks": 0},
    {"arm_psi": 0.01, "p99_ms": {"canary": 200.0, "primary": 5.0},
     "canary_fallbacks": 0},
    {"arm_psi": 0.01, "p99_ms": {"canary": 5.0, "primary": 5.0},
     "canary_fallbacks": 2},
    {"arm_psi": 0.01, "p99_ms": {"canary": 9.0, "primary": 5.0},
     "canary_fallbacks": 0},
    {"arm_psi": 0.01, "p99_ms": {"canary": 80.0, "primary": None},
     "canary_fallbacks": 0},
])
def test_live_decide_table_equals_jax(stats):
    from shifu_tpu.obs.health.canary import CanaryController as JaxCanary
    kw = dict(psi_max=0.25, p99_factor=1.5, slo_p99_ms=50.0)
    assert CanaryController.decide(stats, **kw) == \
        JaxCanary.decide(stats, **kw)


def test_arm_psi_and_sketch_equal_jax():
    from shifu_tpu.serve.fleet import _ArmState as JaxArm
    from shifu_tpu_torch.serve.fleet import _ArmState
    rng = np.random.default_rng(8)
    arms = [cls("m", "v", "d", 0.5, 0.2, 64, 8) for cls in (JaxArm, _ArmState)]
    for _ in range(20):
        p = {"mean": rng.uniform(0, 1, 4)}
        c = {"mean": np.clip(rng.normal(0.6, 0.2, 4), -1, 2)}
        for a in arms:
            a.note("primary", 0.002, p)
            a.note("canary", 0.003, c)
    j, g = (a.stats() for a in arms)
    assert g == j
    assert g["arm_psi"] is not None and g["p99_ms"]["canary"] == 3.0


def test_shadow_failures_never_touch_the_primary(trained_set, tmp_path,
                                                 monkeypatch):
    ms = _clone_set(trained_set, tmp_path)
    reg, _v1 = _publish_incumbent(ms, tmp_path)
    with _fleet(reg, ms) as fleet:
        x = _x(reg)
        fleet.submit("m", dense=x)
        monkeypatch.setenv("SHIFU_TPU_FAULT", "shadow.score:oserror:1")
        resilience.reset_faults()
        fleet.start_arms("m", os.path.join(ms, "models"), version="sh01",
                         shadow_pct=1.0)
        for _ in range(20):
            fleet.submit("m", dense=x)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            a = fleet.arm_stats("m")
            if a["shadow_errors"] + a["requests"]["shadow"] \
                    + a["shadow_dropped"] >= 20:
                break
            time.sleep(0.02)
        a = fleet.arm_stats("m")
        assert a["shadow_errors"] >= 1, a
        assert a["requests"]["primary"] >= 20
        fleet.stop_arms("m")
        fleet.stop_arms("m")   # idempotent
        assert not fleet._entries["m"].pinned


# ---------------------------------------------------------------------------
# chaos and crash recovery
# ---------------------------------------------------------------------------

def _quick_controller(fleet, reg, ms, **kw):
    base = dict(_CANARY_KW, min_requests=0, window_s=10.0)
    base.update(kw)
    return CanaryController(fleet, reg, "m", store_root=ms, **base)


@pytest.mark.parametrize("site", ["canary.start", "canary.decide",
                                  "canary.rollback"])
def test_canary_fault_leaves_incumbent_serving(site, trained_set, tmp_path,
                                               monkeypatch):
    assert site in resilience.FAULT_SITES
    ms = _clone_set(trained_set, tmp_path)
    reg, v1 = _publish_incumbent(ms, tmp_path)
    with _fleet(reg, ms) as fleet:
        x = _x(reg)
        before = fleet.submit("m", dense=x)["mean"]
        monkeypatch.setenv("SHIFU_TPU_FAULT", f"{site}:oserror:1")
        resilience.reset_faults()
        with pytest.raises(OSError, match=site):
            _quick_controller(fleet, reg, ms).run(
                os.path.join(ms, "models"), "chaos1")
        assert fleet.arm_stats("m") is None
        np.testing.assert_array_equal(before,
                                      fleet.submit("m", dense=x)["mean"])
        registry.resolve(reg, "m")
        monkeypatch.delenv("SHIFU_TPU_FAULT")
        resilience.reset_faults()
        CanaryController.recover(reg, "m", fleet=fleet, store_root=ms)
        assert registry.head(reg, "m") == v1
        assert read_state(reg, "m") is None
        assert not fleet._entries["m"].pinned
        result = _quick_controller(fleet, reg, ms).run(
            os.path.join(ms, "models"), "chaos2")
        assert result["outcome"] == "rolled_back"
        assert registry.head(reg, "m") == v1
        assert read_state(reg, "m") is None
    assert not _no_tmp_residue(ms) and not _no_tmp_residue(reg)


_KILL_DRILL = textwrap.dedent("""\
    import os, sys
    ms, reg = sys.argv[1], sys.argv[2]
    from shifu_tpu_torch.obs.health.canary import CanaryController
    from shifu_tpu_torch.serve.fleet import FleetService
    with FleetService(reg, workspace_root=ms, hbm_budget_mb=0,
                      device="cpu") as fleet:
        ctl = CanaryController(fleet, reg, "m", store_root=ms,
                               shadow_pct=0.5, canary_pct=0.5,
                               min_requests=0, window_s=10.0,
                               psi_max=3.0, p99_factor=20.0,
                               slo_p99_ms=5000.0, poll_s=0.01)
        # the injected SIGKILL fires at canary.decide
        ctl.run(os.path.join(ms, "models"), "kill01")
    raise SystemExit("canary survived an injected kill")
""")


def test_sigkill_mid_canary_rerun_rolls_back(trained_set, tmp_path):
    ms = _clone_set(trained_set, tmp_path)
    reg, v1 = _publish_incumbent(ms, tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO,
               SHIFU_TPU_FAULT="canary.decide:kill:1")
    env.pop("SHIFU_TPU_METRICS", None)
    proc = subprocess.run([sys.executable, "-c", _KILL_DRILL, ms, reg],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == -9, (proc.returncode, proc.stderr[-2000:])
    state = read_state(reg, "m")
    assert state is not None and state["prev_head"] == v1
    assert state["phase"] in ("shadow", "canary")
    assert os.path.exists(state_path(reg, "m"))
    assert registry.head(reg, "m") == state["version"]
    assert CanaryController.recover(reg, "m") == "rolled_back"
    assert registry.head(reg, "m") == v1
    assert read_state(reg, "m") is None
    man = registry.resolve(reg, "m", state["version"])[2]
    assert man["canary"]["verdict"] == "rollback"
    assert "interrupted" in man["canary"]["reason"]
    assert CanaryController.recover(reg, "m") is None
    assert not _no_tmp_residue(ms) and not _no_tmp_residue(reg)


# ---------------------------------------------------------------------------
# per-tenant fleet drift
# ---------------------------------------------------------------------------

class _StubRefresh:
    def __init__(self):
        self.windows = 0
        self.breaches = []

    def note_window(self, df):
        self.windows += 1

    def handle_breach(self, rec):
        self.breaches.append(rec)
        return "promoted"


def test_fleet_drift_per_tenant_with_budget(trained_set, tmp_path,
                                            monkeypatch):
    """Three tenants drift in one tick: the budget schedules one a tick
    and defers the rest — the same outcomes, drift points and storm
    events as the JAX package's `FleetDriftWatch`."""
    import pandas as pd
    from shifu_tpu.obs.health.watch import FleetDriftWatch as JaxWatch
    from shifu_tpu.processor.base import ProcessorContext as JaxCtx
    from shifu_tpu_torch.obs.health.watch import FleetDriftWatch
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    shifted = _table(trained_set, delta=0.5)
    frame = pd.DataFrame({c: shifted[c] for c in shifted.columns})
    runs = {}
    for pkg in ("jax", "port"):
        roots, stubs = {}, {}
        for tenant in ("a", "b", "c"):
            ms = _clone_set(trained_set, tmp_path, f"{pkg}_{tenant}")
            _drift_slo(ms)
            roots[tenant], stubs[tenant] = ms, _StubRefresh()
        fw_root = os.path.join(str(tmp_path), f"{pkg}_fleet_ws")
        os.makedirs(fw_root)
        if pkg == "jax":
            fw = JaxWatch(fw_root, refresh_budget=1)
        else:
            fw = FleetDriftWatch(fw_root, refresh_budget=1, device="cpu")
        for tenant, ms in roots.items():
            ctx = (JaxCtx if pkg == "jax" else ProcessorContext).load(ms)
            fw.add_tenant(tenant, ctx, refresh=stubs[tenant])
        psi = [fw.observe(t, frame if pkg == "jax" else shifted)["psi_max"]
               for t in roots]
        ticks = [fw.tick() for _ in range(3)]
        stats = fw.stats()
        storms = [e["tags"] for e in health_store.store(fw_root).events(
            limit=20, names=["fleet_drift"])]
        runs[pkg] = (psi, ticks, stats, [s["budget"] for s in storms],
                     {t: (s.windows, [b["tenant"] for b in s.breaches])
                      for t, s in stubs.items()})
    assert runs["port"] == runs["jax"]
    psi, ticks, stats, budgets, stubs = runs["port"]
    assert min(psi) > 0.05
    assert [sorted(o.values()) for o in ticks] == [
        ["deferred", "deferred", "promoted"], ["deferred", "promoted"],
        ["promoted"]]
    assert stats["breaches"] == 3 and stats["scheduled"] == 3
    assert stats["pending"] == [] and budgets and budgets[0] == 1
    assert all(v == (1, [t]) for t, v in stubs.items())


def test_fleet_drift_poisoned_window_is_absorbed(trained_set, tmp_path,
                                                 monkeypatch):
    from shifu_tpu_torch.obs.health.watch import FleetDriftWatch
    ms = _clone_set(trained_set, tmp_path, "tenant_a")
    fw_root = os.path.join(str(tmp_path), "fleet_ws")
    os.makedirs(fw_root)
    fw = FleetDriftWatch(fw_root, device="cpu")
    assert fw.budget == 1   # SHIFU_TPU_FLEET_REFRESH_BUDGET's default
    fw.add_tenant("a", ProcessorContext.load(ms))
    monkeypatch.setenv("SHIFU_TPU_FAULT", "watch.window:oserror:1")
    resilience.reset_faults()
    assert fw.observe("a", _table(ms)) is None
    monkeypatch.delenv("SHIFU_TPU_FAULT")
    resilience.reset_faults()
    assert fw.observe("a", _table(ms)) is not None
    assert fw.stats()["tenants"]["a"]["windows"] == 1


# ---------------------------------------------------------------------------
# surfacing and the CLI
# ---------------------------------------------------------------------------

def test_health_canary_lines_equal_jax(trained_set, tmp_path, monkeypatch,
                                       capsys):
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    ms = _clone_set(trained_set, tmp_path)
    st = health_store.store(ms)
    st.event("canary", model="m", phase="canary", run="run0007",
             version="v002", canary_pct=0.05)
    st.emit("serve.arm_p99_ms", 4.2, kind="gauge", model="m", arm="primary")
    st.emit("serve.arm_p99_ms", 4.9, kind="gauge", model="m", arm="canary")
    st.emit("canary.arm_psi", 0.0123, kind="gauge", model="m")
    st.flush()
    monkeypatch.delenv("SHIFU_TPU_METRICS")
    capsys.readouterr()
    cli.main(["--dir", ms, "health"])
    out = capsys.readouterr().out
    assert "canary arms:" in out
    assert "phase=canary" in out and "canary_pct=0.05" in out
    assert "p99[primary]=4.200ms" in out and "p99[canary]=4.900ms" in out
    assert "arm_psi=0.0123" in out
    jax_cli(["--dir", ms, "health"])
    want = capsys.readouterr().out
    pick = (lambda text: [ln for ln in text.splitlines()
                          if ln.startswith("canary arms:")
                          or ln.startswith("  m: ")])
    assert pick(out) == pick(want) and len(pick(out)) == 2


def test_arm_header_and_canary_prometheus_lines(trained_set, tmp_path):
    import urllib.request

    from shifu_tpu.serve.http import prometheus_fleet_text as jtext
    from shifu_tpu_torch.serve.http import HttpFrontEnd, prometheus_fleet_text
    ms = _clone_set(trained_set, tmp_path)
    reg, _v1 = _publish_incumbent(ms, tmp_path)
    x = _x(reg)
    body = json.dumps({"dense": x.tolist()}).encode()
    with _fleet(reg, ms) as fleet:
        fleet.submit("m", dense=x)
        fleet.start_arms("m", os.path.join(ms, "models"), version="run0001",
                         shadow_pct=0.0, canary_pct=1.0)
        front = HttpFrontEnd(fleet=fleet, host="127.0.0.1", port=0).start()
        try:
            host, port = front.address
            arms = []
            for _ in range(10):
                req = urllib.request.Request(
                    f"http://{host}:{port}/score/m", data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30) as resp:
                    arms.append(resp.headers["X-Shifu-Arm"])
                    json.loads(resp.read())
            with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                        timeout=10) as resp:
                text = resp.read().decode()
        finally:
            front.close()
        assert arms == ["canary"] * 10
        assert 'shifu_canary_requests_total{model="m",arm="canary"} 10' \
            in text
        st = fleet.stats()
        assert st["canary"]["m"]["requests"]["canary"] == 10

        class _Stats:
            def stats(self):
                return st
        assert prometheus_fleet_text(_Stats()) == jtext(_Stats())
        fleet.stop_arms("m")


def test_full_watch_cli_recovers_then_promotes(trained_set, tmp_path,
                                               monkeypatch, capsys):
    """`watch --registry R --model-name m --iterations 1` through the
    port's CLI: the stale CANARY.json of a killed run is rolled back
    first, then a drift breach refreshes, guards and promotes."""
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    monkeypatch.setenv("SHIFU_TPU_REFRESH_TOLERANCE", "0.2")
    ms = _clone_set(trained_set, tmp_path)
    reg, v1 = _publish_incumbent(ms, tmp_path)
    _drift_slo(ms)
    stale = registry.publish(reg, "m", os.path.join(ms, "models"),
                             ladder=LADDER)
    with open(state_path(reg, "m"), "w") as f:
        json.dump({"model": "m", "run": "dead01", "version": stale,
                   "prev_head": v1, "phase": "shadow"}, f)
    # the shifted rows arrive at the tail of the copy's own dataPath
    cfg_path = os.path.join(ms, "ModelConfig.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["dataSet"]["dataPath"] = os.path.join(ms, "data")
    cfg["dataSet"]["headerPath"] = os.path.join(ms, "data", ".pig_header")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)
    part = os.path.join(ms, "data", "part-00000")
    shifted = _table(ms, delta=0.5)
    with open(part, "a") as f:
        f.write("".join(line + "\n" for line in rows_from_frame(shifted)))
    assert cli.main(["--dir", ms, "watch", "--registry", reg,
                     "--model-name", "m", "--eval-set", "Eval1",
                     "--iterations", "1", "--interval-s", "0",
                     "--device", "cpu"]) == 0
    assert read_state(reg, "m") is None
    assert registry.resolve(reg, "m", stale)[2]["canary"]["verdict"] \
        == "rollback"
    assert registry.head(reg, "m") == "v003"
    man = registry.resolve(reg, "m")[2]
    assert man["refresh"]["refreshed_from"] == v1
    events = [e["tags"].get("phase") for e in health_store.store(ms)
              .events(limit=50, names=["refresh", "canary"])]
    assert "recovered" in events and "promoted" in events
    monkeypatch.delenv("SHIFU_TPU_METRICS")
    capsys.readouterr()
    cli.main(["--dir", ms, "health"])
    out = capsys.readouterr().out
    assert "event.refresh" in out and "phase=promoted" in out
