"""The port's model registry (`shifu_tpu_torch/registry`) and fleet
(`shifu_tpu_torch/serve/fleet.py`) against the JAX package's.

- registry layouts and manifests equal but for the `created` stamp, and
  each package resolves, lists, rolls back and gc's the other's
  registry; a `registry.publish` fault before either rename keeps HEAD;
- `SloAutotuner` steps equal on the same p99 history;
- fleet routes bit-equal to a standalone service (and within rtol/atol
  1e-5 of the JAX fleet); LRU evict/re-warm; shed and recover;
  `swap_in_place`; the HTTP routes (404, 429 +
  Retry-After, the fleet's Prometheus text, `/healthz`), all on the CPU.

Every generator is a private `np.random.default_rng(seed)` (C-ref-1).
"""

import json
import os
import queue
import urllib.error
import urllib.request

import numpy as np
import pytest

from shifu_tpu import registry as jreg
from shifu_tpu import resilience as jres
from shifu_tpu_torch import cli, registry, resilience
from tests.test_serve import _tiny_nn_dir

LADDER = (1, 4)
NN_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_faults(monkeypatch):
    for k in ("SHIFU_TPU_FAULT", "SHIFU_TPU_METRICS"):
        monkeypatch.delenv(k, raising=False)
    resilience.reset_faults()
    jres.reset_faults()
    yield
    resilience.reset_faults()


def _src(tmp_path, name, seed, input_dim=12):
    return _tiny_nn_dir(str(tmp_path / f"src_{name}_{seed}"),
                        input_dim=input_dim, seed=seed)


def _publish(reg, name, tmp_path, seed=0, priority="high", ladder=LADDER,
             **kw):
    return registry.publish(reg, name, _src(tmp_path, name, seed),
                            priority=priority, ladder=ladder, **kw)


def _tree(root):
    out = []
    for dirpath, dirs, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        out += [os.path.join(rel, f) for f in files]
    return sorted(out)


def _manifests(root, name):
    out = {}
    for v in jreg.versions(root, name):
        m = dict(jreg.read_manifest(root, name, v))
        m.pop("created")
        out[v] = m
    return out


def _budget_mb_fitting(reg, names, fit):
    per = []
    for n in names:
        m = registry.read_manifest(reg, n)
        per.append(m["param_bytes"] + m["ladder"][-1]
                   * m["working_row_bytes"])
    return (sum(sorted(per)[:fit]) + min(per) / 2.0) / float(1 << 20)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_layout_and_manifests_equal_jax(tmp_path):
    ja, po = str(tmp_path / "jax"), str(tmp_path / "port")
    for i, (name, prio, delay) in enumerate((("a", "high", None),
                                             ("a", "low", 3.5),
                                             ("b", "high", None))):
        src = _src(tmp_path, name, i)
        assert jreg.publish(ja, name, src, priority=prio, ladder=LADDER,
                            max_delay_ms=delay) == \
            registry.publish(po, name, src, priority=prio, ladder=LADDER,
                             max_delay_ms=delay)
    assert _tree(ja) == _tree(po)
    for name in ("a", "b"):
        assert _manifests(ja, name) == _manifests(po, name)
    m = registry.read_manifest(po, "a")
    assert m["param_bytes"] > 0 and m["working_row_bytes"] > 0
    assert m["family"] == ["nn"] and m["priority"] == "low"
    # each package resolves the other's registry
    for root in (ja, po):
        for name in ("a", "b"):
            jv, jdir, jm = jreg.resolve(root, name)
            pv, pdir, pm = registry.resolve(root, name)
            assert (jv, jdir, jm) == (pv, pdir, pm)
        assert [dict(r, created=None) for r in jreg.ls(root)] == \
            [dict(r, created=None) for r in registry.ls(root)]


def test_rollback_and_gc_across_packages(tmp_path):
    reg = str(tmp_path / "reg")
    for seed in range(3):
        _publish(reg, "a", tmp_path, seed=seed)
    assert registry.rollback(reg, "a") == "v002"
    assert jreg.head(reg, "a") == "v002"
    assert registry.gc(reg, "a", keep=1) == ["v001"]
    assert jreg.versions(reg, "a") == ["v002", "v003"]
    assert jreg.rollback(reg, "a", to="v003") == "v003"
    assert registry.head(reg, "a") == "v003"
    with pytest.raises(FileNotFoundError):
        registry.rollback(reg, "a", to="v999")
    m = registry.annotate(reg, "a", "v003", {"verdict": "kept"})
    assert jreg.read_manifest(reg, "a", "v003")["verdict"] == "kept" == \
        m["verdict"]


@pytest.mark.parametrize("nth", [1, 2])
def test_publish_fault_keeps_head(tmp_path, monkeypatch, nth):
    """The `registry.publish` fault site fires before each rename; a
    fault at either leaves HEAD on the previous version, and a clean
    rerun succeeds without stage residue."""
    reg = str(tmp_path / "reg")
    _publish(reg, "a", tmp_path, seed=0)
    monkeypatch.setenv("SHIFU_TPU_FAULT", f"registry.publish:oserror:{nth}")
    resilience.reset_faults()
    with pytest.raises(OSError, match="injected oserror at registry"):
        _publish(reg, "a", tmp_path, seed=1)
    assert registry.head(reg, "a") == jreg.head(reg, "a") == "v001"
    monkeypatch.delenv("SHIFU_TPU_FAULT")
    v = _publish(reg, "a", tmp_path, seed=1)
    assert registry.head(reg, "a") == v != "v001"
    assert not [p for p in _tree(reg) if "/.tmp." in "/" + p]


def test_registry_verbs(tmp_path, capsys):
    ms = str(tmp_path / "ms")
    os.makedirs(ms)
    _tiny_nn_dir(os.path.join(ms, "models"), seed=3)
    reg = str(tmp_path / "reg")
    for _ in range(3):
        assert cli.main(["--dir", ms, "registry", "publish", "--registry",
                         reg, "--name", "a", "--priority", "low"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"name": "a", "version": "v003",
                                     "head": "v003"}
    assert cli.main(["--dir", ms, "registry", "ls", "--registry",
                     reg]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert rows[0]["name"] == "a" and rows[0]["priority"] == "low"
    assert cli.main(["--dir", ms, "registry", "rollback", "--registry",
                     reg, "--name", "a"]) == 0
    assert json.loads(capsys.readouterr().out)["head"] == "v002"
    assert cli.main(["--dir", ms, "registry", "gc", "--registry", reg,
                     "--keep", "1"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == [{"name": "a", "removed": ["v001"],
                    "versions": ["v002", "v003"]}]


# ---------------------------------------------------------------------------
# the autotuner
# ---------------------------------------------------------------------------

def test_autotuner_steps_equal_jax(tmp_path, monkeypatch):
    from shifu_tpu.obs.health import store as jstore
    from shifu_tpu.serve.fleet import FleetService as JaxFleet
    from shifu_tpu.serve.fleet import SloAutotuner as JaxTuner
    from shifu_tpu_torch.obs.health import store as pstore
    from shifu_tpu_torch.serve.fleet import FleetService, SloAutotuner
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    reg = str(tmp_path / "reg")
    _publish(reg, "a", tmp_path, seed=0, ladder=(1, 4, 16),
             max_delay_ms=4.0)
    _publish(reg, "b", tmp_path, seed=1, ladder=(1, 4, 16))
    ws = (str(tmp_path / "jax"), str(tmp_path / "port"))
    fleets = (JaxFleet(reg, workspace_root=ws[0], hbm_budget_mb=0),
              FleetService(reg, workspace_root=ws[1], hbm_budget_mb=0,
                           device="cpu"))
    tuners = (JaxTuner(fleets[0], slo_p99_ms=50.0),
              SloAutotuner(fleets[1], slo_p99_ms=50.0))
    stores = (jstore.store(ws[0]), pstore.store(ws[1]))
    history = [(120.0, 80.0), (5.0, 60.0), (30.0, 10.0), (30.0, 3.0),
               (400.0, 3.0), (24.0, 24.0)]
    for a, b in history:
        for st in stores:
            for _ in range(5):
                st.emit("serve.p99_ms", a, model="a")
                st.emit("serve.p99_ms", b, model="b")
            st.flush()
        for f in fleets:
            f._entries["a"].max_rows_seen = 3
        recs = [t.step() for t in tuners]
        assert recs[0] == recs[1]
    assert fleets[1]._entries["a"].ladder == fleets[0]._entries["a"].ladder
    for f in fleets:
        f.close()


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

def _fleet(reg, tmp_path, **kw):
    from shifu_tpu_torch.serve.fleet import FleetService
    kw.setdefault("hbm_budget_mb", 0)
    return FleetService(reg, workspace_root=str(tmp_path / "ws"),
                        device="cpu", **kw)


def test_fleet_routes_bit_equal_to_standalone_and_close_to_jax(tmp_path):
    from shifu_tpu.serve.fleet import FleetService as JaxFleet
    from shifu_tpu_torch.serve.service import ScorerService
    reg = str(tmp_path / "reg")
    _publish(reg, "a", tmp_path, seed=0)
    _publish(reg, "b", tmp_path, seed=1)
    x = np.random.default_rng(3).normal(0, 1, (3, 12)).astype(np.float32)
    with _fleet(reg, tmp_path) as fleet:
        got = {n: fleet.submit(n, dense=x) for n in ("a", "b")}
        with pytest.raises(KeyError):
            fleet.submit("nope", dense=x)
    with JaxFleet(reg, workspace_root=str(tmp_path / "jws"),
                  hbm_budget_mb=0) as jfleet:
        jgot = {n: jfleet.submit(n, dense=x) for n in ("a", "b")}
    for name in ("a", "b"):
        _, vdir, manifest = registry.resolve(reg, name)
        with ScorerService(models_dir=vdir, ladder=tuple(manifest["ladder"]),
                           device="cpu") as solo:
            want = solo.submit(dense=x)
        for k in want:
            assert np.array_equal(got[name][k], want[k])
            np.testing.assert_allclose(got[name][k], jgot[name][k],
                                       **NN_TOL)
    assert not np.array_equal(got["a"]["mean"], got["b"]["mean"])


def test_fleet_lru_evict_and_rewarm_roundtrip(tmp_path):
    reg = str(tmp_path / "reg")
    for i, name in enumerate(["a", "b", "c"]):
        _publish(reg, name, tmp_path, seed=i)
    budget = _budget_mb_fitting(reg, ["a", "b", "c"], fit=2)
    x = np.random.default_rng(4).normal(0, 1, (2, 12)).astype(np.float32)
    fleet = _fleet(reg, tmp_path, hbm_budget_mb=budget)
    try:
        fleet.start()
        assert fleet.resident() == ["b", "c"]
        before = fleet.submit("a", dense=x)["mean"]
        assert "a" in fleet.resident() and "b" not in fleet.resident()
        fl = fleet.stats()["fleet"]
        assert fl["models_resident"] == 2 and fl["evictions"] == 2
        assert fl["rewarm_s"] > 0.0
        fleet.submit("b", dense=x)
        again = fleet.submit("a", dense=x)["mean"]
        assert np.array_equal(before, again)
        assert fleet.stats()["fleet"]["evictions"] >= 3
        from shifu_tpu_torch.serve.fleet import FLEET_FIELDS
        assert set(fleet.stats()["fleet"]) == set(FLEET_FIELDS)
    finally:
        fleet.close()


def test_promote_then_swap_in_place(tmp_path):
    """A new HEAD of a resident model swaps in place (same shapes), a
    wrong-shaped one re-warms, a non-resident one is adopted cold."""
    reg = str(tmp_path / "reg")
    _publish(reg, "a", tmp_path, seed=0)
    _publish(reg, "b", tmp_path, seed=1)
    x = np.random.default_rng(7).normal(0, 1, (2, 12)).astype(np.float32)
    with _fleet(reg, tmp_path) as fleet:
        old = fleet.submit("a", dense=x)["mean"]
        assert fleet.swap_in_place("a") == "noop"
        _publish(reg, "a", tmp_path, seed=9)
        assert fleet.swap_in_place("a") == "swapped"
        new = fleet.submit("a", dense=x)["mean"]
        assert not np.array_equal(old, new)
        assert fleet.stats()["models"]["a"]["version"] == "v002"
        assert fleet.stats()["fleet"]["swaps"] == 1
        # another input width fails the structural gate: re-warm
        registry.publish(reg, "a", _tiny_nn_dir(
            str(tmp_path / "dim13"), input_dim=13, seed=5), ladder=LADDER)
        assert fleet.swap_in_place("a") == "rewarmed"
        assert fleet.stats()["models"]["a"]["version"] == "v003"
        assert fleet.submit("a", dense=np.zeros((1, 13), np.float32)
                            )["mean"].shape == (1,)


def test_fleet_route_fault_names_site_and_recovers(tmp_path, monkeypatch):
    reg = str(tmp_path / "reg")
    _publish(reg, "a", tmp_path, seed=0)
    x = np.zeros((2, 12), np.float32)
    with _fleet(reg, tmp_path) as fleet:
        monkeypatch.setenv("SHIFU_TPU_FAULT", "serve.route:oserror:1")
        resilience.reset_faults()
        with pytest.raises(OSError, match="injected oserror at serve.route"):
            fleet.submit("a", dense=x)
        monkeypatch.delenv("SHIFU_TPU_FAULT")
        assert fleet.submit("a", dense=x)["mean"].shape == (2,)


def test_low_priority_sheds_while_high_keeps_flowing(tmp_path):
    from shifu_tpu_torch.serve.fleet import ShedReject
    reg = str(tmp_path / "reg")
    _publish(reg, "hi", tmp_path, seed=0, priority="high")
    _publish(reg, "lo", tmp_path, seed=1, priority="low")
    x = np.zeros((2, 12), np.float32)
    with _fleet(reg, tmp_path, slo_p99_ms=50.0) as fleet:
        for _ in range(32):
            fleet._note_latency("high", 0.2)
        with pytest.raises(ShedReject) as ei:
            fleet.submit("lo", dense=x)
        assert isinstance(ei.value, queue.Full)
        assert ei.value.retry_after_s > 0
        assert fleet.submit("hi", dense=x)["mean"].shape == (2,)
        st = fleet.stats()
        assert st["shedding"] is True and st["fleet"]["shed_rate"] > 0
        assert st["rejected_by_class"]["low"] >= 1
        for _ in range(64):
            fleet._note_latency("high", 0.001)
        assert fleet.submit("lo", dense=x)["mean"].shape == (2,)
        assert fleet.stats()["shedding"] is False


def test_http_fleet_routing_shed_metrics_and_healthz(tmp_path):
    from shifu_tpu_torch.serve.http import HttpFrontEnd
    reg = str(tmp_path / "reg")
    _publish(reg, "a", tmp_path, seed=0, priority="high")
    _publish(reg, "lo", tmp_path, seed=1, priority="low")
    x = np.random.default_rng(6).normal(0, 1, (3, 12)).astype(np.float32)
    body = json.dumps({"dense": x.tolist()}).encode()
    hdrs = {"Content-Type": "application/json"}
    with _fleet(reg, tmp_path, slo_p99_ms=50.0) as fleet:
        want = fleet.submit("a", dense=x)["mean"]
        front = HttpFrontEnd(fleet=fleet, host="127.0.0.1", port=0).start()
        try:
            host, port = front.address
            base = f"http://{host}:{port}"
            req = urllib.request.Request(base + "/score/a", data=body,
                                         headers=hdrs)
            with urllib.request.urlopen(req, timeout=30) as resp:
                payload = json.loads(resp.read())
                assert resp.headers["X-Shifu-Arm"] == "primary"
            np.testing.assert_allclose(
                np.asarray(payload["scores"]["mean"], np.float64), want,
                rtol=1e-6, atol=1e-7)
            for path in ("/score/nope", "/score"):
                bad = urllib.request.Request(base + path, data=body,
                                             headers=hdrs)
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(bad, timeout=10)
                assert ei.value.code == 404
            for _ in range(32):
                fleet._note_latency("high", 0.2)
            shed = urllib.request.Request(base + "/score/lo", data=body,
                                          headers=hdrs)
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(shed, timeout=10)
            assert ei.value.code == 429
            assert int(ei.value.headers["Retry-After"]) >= 1
            with urllib.request.urlopen(base + "/metrics",
                                        timeout=10) as resp:
                text = resp.read().decode()
            assert "shifu_fleet_models_resident" in text
            assert 'shifu_serve_requests_total{model="a",' \
                   'priority="high"}' in text
            assert 'shifu_serve_rejected_total{priority="low"}' in text
            with urllib.request.urlopen(base + "/healthz",
                                        timeout=10) as resp:
                health = json.loads(resp.read())
            assert health["ok"] is True and health["status"] == "ok"
            assert set(health["models"]) == {"a", "lo"}
        finally:
            front.close()


def test_fleet_text_matches_jax_for_the_same_stats(tmp_path):
    """The fleet's Prometheus text: the port's renderer over a stats dict
    gives the JAX package's lines."""
    from shifu_tpu.serve.http import prometheus_fleet_text as jtext
    from shifu_tpu_torch.serve.http import prometheus_fleet_text

    class _Stats:
        def __init__(self, st):
            self._st = st

        def stats(self):
            return self._st
    reg = str(tmp_path / "reg")
    _publish(reg, "a", tmp_path, seed=0)
    with _fleet(reg, tmp_path) as fleet:
        fleet.submit("a", dense=np.zeros((1, 12), np.float32))
        st = fleet.stats()
    assert prometheus_fleet_text(_Stats(st)) == jtext(_Stats(st))


def test_serve_registry_verb_on_cpu(tmp_path, capsys):
    reg = str(tmp_path / "reg")
    _publish(reg, "a", tmp_path, seed=0)
    _publish(reg, "b", tmp_path, seed=1)
    assert cli.main(["--dir", str(tmp_path), "serve", "--registry", reg,
                     "--models", "b", "--no-http", "--duration-s", "0.2",
                     "--device", "cpu"]) == 0
    st = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(st["models"]) == {"b"}
    assert st["fleet"]["models_resident"] == 0    # closed at exit
