"""The port's refresh controller (`shifu_tpu_torch/obs/health/refresh.py`)
against the JAX package's `shifu_tpu/obs/health/refresh.py`, on the CPU.

- the drill: a shifted window at the watch loop → PSI breach → warm
  retrain in a challenger workspace → guardrail → atomic publish →
  in-place swap into a live fleet, under a scoring client with zero
  failed requests and the same service object; the guardrail's AUCs
  and decision equal the JAX controller's on the same set (1e-6);
- the guardrail on one challenger directory, NN (K1's plain route) and
  GBT (K2's), equal to the JAX controller's within 1e-6, and the
  `decide` table equal to the JAX rule's;
- a GBT warm start appends trees: the swap takes the evict + re-warm
  branch; an NN refresh swaps in place;
- a sabotaged challenger is held; an eval fault fails closed; a fault
  at every `refresh.*` site leaves HEAD and the incumbent, and the rerun
  promotes; a swap fault rolls back at once; SIGKILL at the promote
  point in a subprocess leaves HEAD; breaches coalesce and `health`
  shows it; the drift window stays bounded.

Every generator is a private `np.random.default_rng(seed)` (C-ref-1).
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

from shifu_tpu import resilience as jres
from shifu_tpu.cli import main as jax_cli
from shifu_tpu_torch import cli, registry, resilience
from shifu_tpu_torch.data import reader
from shifu_tpu_torch.obs.health import store as health_store
from shifu_tpu_torch.obs.health.refresh import RefreshController
from shifu_tpu_torch.processor.base import ProcessorContext
from shifu_tpu_torch.serve.fleet import FleetService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LADDER = (1, 4)
AUC_TOL = 1e-6
GBT_PARAMS = {"TreeNum": 4, "MaxDepth": 3, "LearningRate": 0.1,
              "Loss": "log"}


@pytest.fixture(autouse=True)
def _refresh_isolation(monkeypatch):
    for k in ("SHIFU_TPU_METRICS", "SHIFU_TPU_SLO_FILE",
              "SHIFU_TPU_ALERT_WEBHOOK", "SHIFU_TPU_TRACE",
              "SHIFU_TPU_FAULT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SHIFU_TPU_RETRY_BASE_S", "0.01")
    resilience.reset_faults()
    jres.reset_faults()
    yield
    resilience.reset_faults()
    jres.reset_faults()


def _trained(base, algorithm):
    from tests.synth import make_model_set
    params = GBT_PARAMS if algorithm == "GBT" else None
    ms = make_model_set(str(base), np.random.default_rng(11), n_rows=400,
                        algorithm=algorithm, train_params=params)
    cfg_path = os.path.join(ms, "ModelConfig.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["train"]["numTrainEpochs"] = 8
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)
    for cmd in ("init", "stats", "norm", "train"):
        assert jax_cli(["--dir", ms, cmd]) == 0, cmd
    return ms


@pytest.fixture(scope="module")
def trained_set(tmp_path_factory):
    """ONE trained tiny NN set per module (the JAX package's steps,
    private rng); tests copy it."""
    return _trained(tmp_path_factory.mktemp("refresh_nn"), "NN")


@pytest.fixture(scope="module")
def gbt_set(tmp_path_factory):
    return _trained(tmp_path_factory.mktemp("refresh_gbt"), "GBT")


def _clone_set(src, tmp_path, name="ModelSet"):
    return shutil.copytree(src, os.path.join(str(tmp_path), name))


def _lines(ms):
    with open(os.path.join(ms, "data", ".pig_header")) as f:
        hdr = f.read().strip().split("|")
    with open(os.path.join(ms, "data", "part-00000")) as f:
        return hdr, [ln.rstrip("\n") for ln in f if ln.strip()]


def _shift(hdr, lines, delta):
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
    return out


def _windows(ms, delta=None):
    """The set's training rows (shifted by `delta`) as the port's Table
    and the JAX package's frame."""
    from shifu_tpu.data.ingest import frame_from_rows
    hdr, lines = _lines(ms)
    if delta is not None:
        lines = _shift(hdr, lines, delta)
    return (reader._rows_table(lines, hdr, "|", "window"),
            frame_from_rows(lines, hdr, "|"))


def _publish_incumbent(ms, tmp_path, name="m"):
    reg = os.path.join(str(tmp_path), "reg")
    v1 = registry.publish(reg, name, os.path.join(ms, "models"),
                          ladder=LADDER)
    return reg, v1


def _no_tmp_residue(root):
    return [os.path.join(d, f) for d, _dirs, fs in os.walk(root)
            for f in fs if f.startswith(".tmp.")]


def _controller(ms, reg, fleet=None, **kw):
    kw.setdefault("tolerance", 0.2)
    kw.setdefault("cooldown_s", 0.0)
    return RefreshController(ProcessorContext.load(ms), registry_root=reg,
                             model_name="m", fleet=fleet, device="cpu",
                             **kw)


def _drift_slo(ms):
    with open(os.path.join(ms, "slo.json"), "w") as f:
        json.dump({"slos": [
            {"name": "drift", "metric": "drift.psi_max", "op": "<=",
             "warn": 0.02, "breach": 0.05, "window_s": 86400.0,
             "agg": "last"}]}, f)


def _jax_refresh(ms, tmp_path, window, **kw):
    """The JAX controller on a copy of the same set: its verdict."""
    from shifu_tpu import registry as jreg
    from shifu_tpu.obs.health.refresh import RefreshController as JaxCtl
    from shifu_tpu.processor.base import ProcessorContext as JaxCtx
    jms = _clone_set(ms, tmp_path, "jax_set")
    jreg_root = os.path.join(str(tmp_path), "jax_reg")
    jreg.publish(jreg_root, "m", os.path.join(jms, "models"), ladder=LADDER)
    ctl = JaxCtl(JaxCtx.load(jms), registry_root=jreg_root, model_name="m",
                 tolerance=kw.get("tolerance", 0.2), cooldown_s=0.0,
                 post_train=kw.get("post_train"))
    ctl.note_window(window)
    outcome = ctl.handle_breach({"slo": "drift", "state": "breach"})
    return outcome, jreg.resolve(jreg_root, "m")[2].get("refresh")


# ---------------------------------------------------------------------------
# the drill
# ---------------------------------------------------------------------------

def test_refresh_drill_end_to_end(trained_set, tmp_path, monkeypatch):
    from shifu_tpu_torch.obs.health import watch
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    ms = _clone_set(trained_set, tmp_path)
    reg, v1 = _publish_incumbent(ms, tmp_path)
    _drift_slo(ms)
    base, jbase = _windows(ms)
    shifted, jshifted = _windows(ms, delta=0.5)
    with FleetService(reg, workspace_root=ms, hbm_budget_mb=0,
                      device="cpu") as fleet:
        man = registry.resolve(reg, "m")[2]
        x = np.random.default_rng(3).normal(
            0, 1, (3, man["input_dim"])).astype(np.float32)
        before = fleet.submit("m", dense=x)["mean"]
        svc_before = fleet._entries["m"].service
        ctl = _controller(ms, reg, fleet=fleet)
        ctl.note_window(base)
        stop, failures, served = threading.Event(), [], [0]

        def client():
            while not stop.is_set():
                try:
                    fleet.submit("m", dense=x, timeout=30.0)
                    served[0] += 1
                except Exception as e:  # noqa: BLE001 — any miss fails
                    failures.append(e)

        t = threading.Thread(target=client, daemon=True)
        t.start()
        try:
            rc = watch.run_monitor(ProcessorContext.load(ms), interval_s=0.0,
                                   iterations=1, windows=[shifted],
                                   refresh=ctl, device="cpu")
        finally:
            stop.set()
            t.join(timeout=30)
        assert rc == 0 and ctl.last_outcome == "promoted", ctl.stats()
        assert registry.head(reg, "m") == "v002"
        man2 = registry.resolve(reg, "m")[2]
        assert man2["refresh"]["refreshed_from"] == v1
        # an NN keeps its shape: the same service object, swapped in place
        assert fleet._entries["m"].service is svc_before
        assert fleet.stats()["fleet"]["swaps"] == 1
        assert not failures and served[0] > 0, failures[:3]
        assert not np.array_equal(before,
                                  fleet.submit("m", dense=x)["mean"])
    st = health_store.store(ms)
    names = [e["name"] for e in st.events(limit=50)]
    for want in ("event.drift", "event.breach", "event.refresh"):
        assert want in names, names
    phases = [e["tags"]["phase"] for e in st.events(limit=50,
                                                    names=["refresh"])]
    for want in ("scheduled", "guardrail", "promoted"):
        assert want in phases, phases
    assert not _no_tmp_residue(ms) and not _no_tmp_residue(reg)
    # the JAX controller on the same set and window decides alike
    import pandas as pd
    outcome, jblock = _jax_refresh(
        trained_set, tmp_path, pd.concat([jbase, jshifted],
                                         ignore_index=True))
    assert outcome == "promoted"
    for k in ("incumbent_auc", "challenger_auc"):
        assert abs(man2["refresh"][k] - jblock[k]) <= AUC_TOL, (k, jblock)


@pytest.mark.parametrize("which", ["nn", "gbt"])
def test_guardrail_aucs_and_decision_equal_jax(trained_set, gbt_set,
                                               tmp_path, which):
    """Both controllers score the same incumbent and the same challenger
    (a JAX-trained set of another seed) over the same eval set."""
    from shifu_tpu.obs.health.refresh import RefreshController as JaxCtl
    from shifu_tpu.processor.base import ProcessorContext as JaxCtx
    src = trained_set if which == "nn" else gbt_set
    ms = _clone_set(src, tmp_path)
    chal = os.path.join(str(tmp_path), "challenger")
    shutil.copytree(os.path.join(ms, "models"), chal)
    # a worse challenger: the incumbent's params scrambled
    from shifu_tpu_torch.models.spec import list_models, load_model, \
        save_model
    p = list_models(chal)[0]
    kind, meta, params = load_model(p)
    if kind == "gbt":
        leaf = np.asarray(params["trees"]["leaf_value"])
        params["trees"]["leaf_value"] = leaf + np.random.default_rng(
            5).normal(0, 1.0, leaf.shape).astype(leaf.dtype)
    else:
        noise = np.random.default_rng(5)
        params = [{"w": np.asarray(l["w"]) + noise.normal(
                       0, 2.0, np.shape(l["w"])).astype(np.float32),
                   "b": np.asarray(l["b"])} for l in params]
    save_model(p, kind, meta, params)
    got = RefreshController(ProcessorContext.load(ms), tolerance=0.005,
                            device="cpu").guardrail(chal)
    want = JaxCtl(JaxCtx.load(ms), tolerance=0.005).guardrail(chal)
    for k in ("incumbent", "challenger", "delta"):
        assert abs(got[k] - want[k]) <= AUC_TOL, (k, got, want)
    assert (got["decision"], got["reason"]) == \
        (want["decision"], want["reason"])
    assert got["challenger"] < got["incumbent"]


@pytest.mark.parametrize("incumbent,challenger,tolerance", [
    (0.80, 0.85, 0.005), (0.80, 0.80, 0.005), (0.80, 0.798, 0.005),
    (0.80, 0.70, 0.005), (0.80, 0.79, 0.0), (0.5, 0.5 - 1e-9, 0.0),
])
def test_guardrail_decision_table_equals_jax(incumbent, challenger,
                                             tolerance):
    from shifu_tpu.obs.health.refresh import RefreshController as JaxCtl
    assert RefreshController.decide(incumbent, challenger, tolerance) == \
        JaxCtl.decide(incumbent, challenger, tolerance)


def test_gbt_warm_start_swaps_by_rewarm(gbt_set, tmp_path, monkeypatch):
    """A GBT refresh appends trees, so the fleet cannot copy into the
    resident service: `swap_in_place` evicts and re-warms, and the fleet
    then scores what a standalone service over HEAD scores."""
    from shifu_tpu_torch.models.spec import list_models, load_model
    from shifu_tpu_torch.serve.service import ScorerService
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    ms = _clone_set(gbt_set, tmp_path)
    reg, v1 = _publish_incumbent(ms, tmp_path)
    rng = np.random.default_rng(4)
    req = {"raw_dense": rng.normal(0, 1, (4, 6)).astype(np.float32),
           "raw_codes": rng.integers(0, 2, (4, 2)).astype(np.int32)}
    with FleetService(reg, workspace_root=ms, hbm_budget_mb=0,
                      device="cpu") as fleet:
        ctl = _controller(ms, reg, fleet=fleet)
        ctl.note_window(_windows(ms, delta=0.5)[0])
        assert ctl.handle_breach({"slo": "drift"}) == "promoted"
        assert fleet.stats()["fleet"]["swaps"] == 0   # not in place
        vdir = registry.resolve(reg, "m")[1]
        old_dir = registry.resolve(reg, "m", v1)[1]
        new_trees = load_model(list_models(vdir)[0])[2]["trees"]
        old_trees = load_model(list_models(old_dir)[0])[2]["trees"]
        assert len(new_trees["leaf_value"]) > len(old_trees["leaf_value"])
        swaps = [e["tags"].get("swap") for e in health_store.store(ms)
                 .events(limit=20, names=["refresh"])
                 if e["tags"].get("phase") == "promoted"]
        assert swaps == ["rewarmed"], swaps
        assert fleet._entries["m"].version == "v002"
        assert fleet.swap_in_place("m") == "noop"
        got = fleet.submit("m", **req)
        with ScorerService(models_dir=vdir, device="cpu") as solo:
            want = solo.submit(**req)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# held, failed and rolled back
# ---------------------------------------------------------------------------

def _sabotage(clone):
    from shifu_tpu_torch.models.spec import list_models, load_model, \
        save_model
    p = list_models(os.path.join(clone, "models"))[0]
    kind, meta, params = load_model(p)
    save_model(p, kind, meta, [{k: np.zeros_like(np.asarray(v)) - 3.0
                                for k, v in layer.items()}
                               for layer in params])


def test_sabotaged_challenger_is_held_by_guardrail(trained_set, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    ms = _clone_set(trained_set, tmp_path)
    reg, v1 = _publish_incumbent(ms, tmp_path)
    with FleetService(reg, workspace_root=ms, hbm_budget_mb=0,
                      device="cpu") as fleet:
        man = registry.resolve(reg, "m")[2]
        x = np.random.default_rng(3).normal(
            0, 1, (3, man["input_dim"])).astype(np.float32)
        before = fleet.submit("m", dense=x)["mean"]
        ctl = _controller(ms, reg, fleet=fleet, post_train=_sabotage,
                          tolerance=0.005)
        ctl.note_window(_windows(ms)[0])
        assert ctl.handle_breach({"slo": "drift", "state": "breach"}) \
            == "held"
        assert ctl.stats()["held"] == 1
        assert registry.head(reg, "m") == v1
        assert fleet.stats()["fleet"]["swaps"] == 0
        np.testing.assert_array_equal(before,
                                      fleet.submit("m", dense=x)["mean"])
    decisions = [e["tags"].get("decision") for e in health_store.store(ms)
                 .events(limit=20, names=["refresh"])
                 if e["tags"].get("phase") == "guardrail"]
    assert decisions == ["hold"]
    assert not _no_tmp_residue(ms) and not _no_tmp_residue(reg)


def test_guardrail_eval_fault_fails_closed_and_events(trained_set, tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    ms = _clone_set(trained_set, tmp_path)
    reg, v1 = _publish_incumbent(ms, tmp_path)
    ctl = _controller(ms, reg)
    ctl.note_window(_windows(ms)[0])
    monkeypatch.setenv("SHIFU_TPU_FAULT", "refresh.guardrail:oserror:1")
    resilience.reset_faults()
    assert ctl.handle_breach({"slo": "auc", "state": "breach"}) == "failed"
    assert registry.head(reg, "m") == v1
    recs = health_store.store(ms).events(limit=20, names=["refresh"])
    assert any(e["tags"].get("phase") == "failed" and
               "refresh.guardrail" in e["tags"].get("error", "")
               for e in recs), recs


@pytest.mark.parametrize("site", ["refresh.schedule", "refresh.guardrail",
                                  "refresh.promote"])
def test_refresh_fault_leaves_head_unmoved_and_rerun_recovers(
        site, trained_set, tmp_path, monkeypatch):
    assert site in resilience.FAULT_SITES
    ms = _clone_set(trained_set, tmp_path)
    reg, v1 = _publish_incumbent(ms, tmp_path)
    ctl = _controller(ms, reg)
    window = _windows(ms)[0]
    ctl.note_window(window)
    monkeypatch.setenv("SHIFU_TPU_FAULT", f"{site}:oserror:1")
    resilience.reset_faults()
    assert ctl.handle_breach({"slo": "drift", "state": "breach"}) == "failed"
    assert registry.head(reg, "m") == v1
    assert not _no_tmp_residue(ms) and not _no_tmp_residue(reg)
    monkeypatch.delenv("SHIFU_TPU_FAULT")
    resilience.reset_faults()
    ctl.note_window(window)
    assert ctl.handle_breach({"slo": "drift", "state": "breach"}) \
        == "promoted"
    assert registry.head(reg, "m") == "v002"
    assert not _no_tmp_residue(ms) and not _no_tmp_residue(reg)


def test_swap_fault_rolls_back_instantly(trained_set, tmp_path, monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    ms = _clone_set(trained_set, tmp_path)
    reg, v1 = _publish_incumbent(ms, tmp_path)
    with FleetService(reg, workspace_root=ms, hbm_budget_mb=0,
                      device="cpu") as fleet:
        man = registry.resolve(reg, "m")[2]
        x = np.random.default_rng(3).normal(
            0, 1, (3, man["input_dim"])).astype(np.float32)
        before = fleet.submit("m", dense=x)["mean"]
        ctl = _controller(ms, reg, fleet=fleet)
        window = _windows(ms)[0]
        ctl.note_window(window)
        monkeypatch.setenv("SHIFU_TPU_FAULT", "refresh.swap:oserror:1")
        resilience.reset_faults()
        assert ctl.handle_breach({"slo": "drift", "state": "breach"}) \
            == "rolled_back"
        assert ctl.stats()["rolled_back"] == 1
        assert registry.head(reg, "m") == v1
        np.testing.assert_array_equal(before,
                                      fleet.submit("m", dense=x)["mean"])
        phases = [e["tags"]["phase"] for e in health_store.store(ms)
                  .events(limit=20, names=["refresh"])]
        assert "rolled_back" in phases
        monkeypatch.delenv("SHIFU_TPU_FAULT")
        resilience.reset_faults()
        ctl.note_window(window)
        assert ctl.handle_breach({"slo": "drift", "state": "breach"}) \
            == "promoted"
        assert registry.head(reg, "m") == "v003"
        assert fleet.stats()["fleet"]["swaps"] == 1
    assert not _no_tmp_residue(ms) and not _no_tmp_residue(reg)


_KILL_DRILL = textwrap.dedent("""\
    import os, sys
    ms, reg = sys.argv[1], sys.argv[2]
    from shifu_tpu_torch.data import reader
    from shifu_tpu_torch.obs.health.refresh import RefreshController
    from shifu_tpu_torch.processor.base import ProcessorContext
    data = os.path.join(ms, "data")
    hdr = open(os.path.join(data, ".pig_header")).read().strip().split("|")
    lines = [l.rstrip("\\n") for l in open(os.path.join(data, "part-00000"))]
    ctl = RefreshController(ProcessorContext.load(ms), registry_root=reg,
                            model_name="m", tolerance=0.2, cooldown_s=0.0,
                            device="cpu")
    ctl.note_window(reader._rows_table(lines, hdr, "|", "w"))
    # the injected SIGKILL fires inside refresh_once
    ctl.refresh_once({"slo": "drift", "state": "breach"})
    raise SystemExit("refresh survived an injected kill")
""")


def test_sigkill_mid_refresh_incumbent_survives(trained_set, tmp_path):
    ms = _clone_set(trained_set, tmp_path)
    reg, v1 = _publish_incumbent(ms, tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO,
               SHIFU_TPU_FAULT="refresh.promote:kill:1")
    proc = subprocess.run([sys.executable, "-c", _KILL_DRILL, ms, reg],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == -9, (proc.returncode, proc.stderr[-2000:])
    assert registry.head(reg, "m") == v1
    registry.resolve(reg, "m")
    assert not _no_tmp_residue(ms) and not _no_tmp_residue(reg)
    ctl = _controller(ms, reg)
    ctl.note_window(_windows(ms)[0])
    assert ctl.handle_breach({"slo": "drift", "state": "breach"}) \
        == "promoted"
    assert registry.head(reg, "m") == "v002"


# ---------------------------------------------------------------------------
# hysteresis and the window
# ---------------------------------------------------------------------------

def test_breach_storm_coalesces_and_is_visible(trained_set, tmp_path,
                                               monkeypatch, capsys):
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    ms = _clone_set(trained_set, tmp_path)
    ctl = RefreshController(ProcessorContext.load(ms), cooldown_s=3600.0,
                            device="cpu")
    reentrant = []

    def fake_refresh(rec):
        reentrant.append(ctl.handle_breach({"slo": "auc",
                                            "state": "breach"}))
        return "promoted"

    monkeypatch.setattr(ctl, "refresh_once", fake_refresh)
    assert ctl.handle_breach({"slo": "drift", "state": "breach"}) \
        == "promoted"
    assert reentrant == ["coalesced"]
    assert ctl.handle_breach({"slo": "drift", "state": "breach"}) \
        == "coalesced"
    assert ctl.stats()["coalesced"] == 2
    st = health_store.store(ms)
    coal = [e for e in st.events(limit=20, names=["refresh"])
            if e["tags"].get("phase") == "coalesced"]
    assert len(coal) == 2 and coal[-1]["tags"]["count"] == 2
    assert st.series("refresh.coalesced")
    monkeypatch.delenv("SHIFU_TPU_METRICS")
    capsys.readouterr()
    cli.main(["--dir", ms, "health"])
    out = capsys.readouterr().out
    assert "refresh" in out and "phase=coalesced" in out


def test_window_accumulation_is_bounded(trained_set, tmp_path):
    ms = _clone_set(trained_set, tmp_path)
    ctl = RefreshController(ProcessorContext.load(ms), window_rows=100,
                            device="cpu")
    table = reader.Table({"a": np.arange(60).astype(str)})
    for _ in range(5):
        ctl.note_window(table)
    assert ctl.stats()["window_rows_pending"] <= 160   # ≤ cap + 1 table
    got = ctl._take_window()   # the newest 100 rows of the two kept
    assert got["a"].tolist() == [str(i) for i in range(20, 60)] + \
        [str(i) for i in range(60)]
    assert ctl.stats()["window_rows_pending"] == 0
