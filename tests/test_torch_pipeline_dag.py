"""The port's pipeline DAG (`shifu_tpu_torch/pipeline/`) against the JAX
package's (`shifu_tpu/pipeline/`): synthetic graphs of in-process
callables run through both packages' `run_dag` (terminal states,
poisoned sets, the first failure, the report's keys, validation,
admission, the card leases and the two fault drills); the node builders
over one model set; the step registry against the port's `step_guard`
call sites; and the scheduled pipeline on the CPU against its
sequential walk, with a RESUME leg. Every scheduler test runs its body
under a thread deadline (`within_timeout`), so a scheduler that hangs
fails instead of stalling the run.
"""

import hashlib
import json
import os
import re
import shutil
import threading
import time

import numpy as np
import pytest

from shifu_tpu import resilience as jres
from shifu_tpu.pipeline import nodes as jnodes
from shifu_tpu.pipeline import scheduler as jsched
from shifu_tpu_torch import resilience as pres
from shifu_tpu_torch.pipeline import nodes as pnodes
from shifu_tpu_torch.pipeline import scheduler as psched

TIMEOUT_S = 60.0
# the deadline of a body that runs port processes (each imports torch):
# a hang guard, far above the seconds they take on an idle CPU
SUBPROCESS_S = 180.0
PACKAGES = {"jax": (jsched, jres), "port": (psched, pres)}


def within_timeout(fn, timeout=TIMEOUT_S):
    """Run `fn` on a daemon thread; fail if it is not done in time, and
    raise again whatever it raised."""
    out = {}

    def body():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — raised below
            out["error"] = e
    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"did not finish within {timeout} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def read_marker(scope):
    """The abort marker's record under `scope` (a model set's tmp/),
    or None when there is none."""
    path = os.path.join(str(scope), "abort.marker")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _states(report):
    return {r["node"]: r["state"] for r in report["nodes"]}


def _shape(report):
    """The report without its run times: summary keys, and each node's
    record minus queue_s, run_s and critical_path."""
    timed = ("wall_s", "critical_path_s", "occupancy")
    return ({k: v for k, v in report.items()
             if k not in timed and k != "nodes"},
            [{k: v for k, v in r.items()
              if k not in ("queue_s", "run_s", "critical_path")}
             for r in report["nodes"]])


@pytest.fixture()
def timeshared(monkeypatch):
    """Both packages timeshared (the JAX package's test rig shows 8
    fake devices, which its auto mode would lease from)."""
    monkeypatch.setenv("SHIFU_TPU_DAG_SLICE", "0")


@pytest.fixture()
def sliced8(monkeypatch):
    """Both packages leasing from a declared 8-card pool."""
    monkeypatch.setenv("SHIFU_TPU_DAG_SLICE", "1")
    monkeypatch.setenv("SHIFU_TPU_DAG_DEVICES", "8")


def _failing_graph(sched):
    ran = []

    def ok(name):
        return lambda: ran.append(name)

    def boom():
        raise OSError("synthetic")
    return ran, [
        sched.Node("a", ok("a")),
        sched.Node("b", boom, deps=("a",)),
        sched.Node("c", ok("c"), deps=("b",)),
        sched.Node("d", ok("d"), deps=("a",)),
        sched.Node("e", ok("e")),
        sched.Node("h", ok("h"), deps=("c",), device=False),
    ]


def test_failure_poisons_descendants_as_the_jax_package(tmp_path,
                                                        timeshared):
    """b fails: its descendants c and h are poisoned, the independent
    d/e branch runs, DagError names b with the report, and the abort
    marker's record is the JAX package's."""
    got = {}
    for name, (sched, res) in PACKAGES.items():
        ran, nodes = _failing_graph(sched)
        root = tmp_path / name
        with pytest.raises(sched.DagError) as ei:
            within_timeout(lambda: sched.run_dag(
                nodes, workers=2, root=str(root), label="t"))
        marker = read_marker(root / "tmp")
        res.clear_abort()
        res.set_abort_scope(None)
        got[name] = (ei.value, sorted(ran), marker)
    (jerr, jran, jmark), (perr, pran, pmark) = got["jax"], got["port"]
    assert _states(perr.report) == _states(jerr.report) == {
        "a": "done", "b": "failed", "c": "poisoned", "d": "done",
        "e": "done", "h": "poisoned"}
    assert pran == jran == ["a", "d", "e"]
    assert str(perr) == str(jerr)
    assert isinstance(perr.__cause__, OSError)
    assert _shape(perr.report) == _shape(jerr.report)
    assert perr.report["failed"] == "b"
    assert set(pmark) == set(jmark) == {"site", "process", "error", "time"}
    assert pmark["site"] == jmark["site"] == "dag.b"
    assert pmark["error"] == jmark["error"] == "OSError: synthetic"
    assert pmark["process"] == 0


def test_abort_markers_read_across_packages(tmp_path):
    """The port's abort marker is the JAX package's: the JAX package's
    `check_abort` reads the port's, both files hold the same record
    (time aside), and each package's `clear_abort` removes the
    other's."""
    recs = {}
    for writer, other in ((pres, jres), (jres, pres)):
        scope = str(tmp_path / writer.__name__)
        writer.set_abort_scope(scope)
        writer.publish_abort("dag.x", ValueError("boom"), process=0)
        writer.set_abort_scope(None)
        recs[writer] = read_marker(scope)
        if writer is pres:
            jres.set_abort_scope(scope)
            got = jres.check_abort()
            jres.set_abort_scope(None)
            assert (got["site"], got["process"], got["error"]) == \
                ("dag.x", 0, "ValueError: boom")
        other.set_abort_scope(scope)
        other.clear_abort()
        other.set_abort_scope(None)
        assert read_marker(scope) is None
    assert set(recs[pres]) == set(recs[jres]) == {
        "site", "process", "error", "time"}
    assert {k: v for k, v in recs[pres].items() if k != "time"} == \
        {k: v for k, v in recs[jres].items() if k != "time"}


def test_report_schema_and_cached_as_the_jax_package(timeshared):
    """A true done_check parks the node as cached without calling its
    body; the report carries the JAX package's summary and node
    fields."""
    reps = {}
    for name, (sched, _) in PACKAGES.items():
        calls = []
        nodes = [
            sched.Node("a", lambda: calls.append("a")),
            sched.Node("b", lambda: calls.append("b"), deps=("a",),
                       done_check=lambda: True),
            sched.Node("c", lambda: calls.append("c"), deps=("b",)),
            sched.Node("d", lambda: calls.append("d"), deps=("a",),
                       done_check=lambda: 1 / 0),   # a raising check runs
        ]
        reps[name] = within_timeout(lambda: sched.run_dag(nodes, workers=2))
        assert sorted(calls) == ["a", "c", "d"]
    from shifu_tpu import profiling
    assert psched.DAG_FIELDS == profiling.DAG_FIELDS
    assert psched.DAG_SUMMARY_FIELDS == profiling.DAG_SUMMARY_FIELDS
    assert tuple(reps["port"]) == psched.DAG_SUMMARY_FIELDS
    for rec in reps["port"]["nodes"]:
        assert tuple(rec) == psched.DAG_FIELDS
    assert _shape(reps["port"]) == _shape(reps["jax"])
    assert _states(reps["port"]) == {"a": "done", "b": "cached",
                                     "c": "done", "d": "done"}


@pytest.mark.parametrize("bad,match", [
    ("duplicate", "duplicate"), ("unknown", "unknown node"),
    ("cycle", "cycle")])
def test_validation_errors_match(bad, match):
    for sched, _ in PACKAGES.values():
        n = sched.Node
        graph = {"duplicate": [n("a", lambda: None), n("a", lambda: None)],
                 "unknown": [n("a", lambda: None, deps=("ghost",))],
                 "cycle": [n("a", lambda: None, deps=("b",)),
                           n("b", lambda: None, deps=("a",))]}[bad]
        with pytest.raises(ValueError, match=match):
            sched.run_dag(graph)


def test_host_nodes_bypass_the_device_cap(timeshared):
    """One device slot held by a trainer that waits on a host node: the
    host node is admitted anyway."""
    release = threading.Event()

    def device_fn():
        assert release.wait(timeout=30), \
            "host-only node queued behind the device worker cap"

    rep = within_timeout(lambda: psched.run_dag([
        psched.Node("trainer", device_fn, device=True),
        psched.Node("host", release.set, device=False)], workers=1))
    assert _states(rep) == {"trainer": "done", "host": "done"}
    assert rep["max_concurrent"] == 1


@pytest.mark.parametrize("workers", [1, 2])
def test_device_cap_holds(timeshared, workers):
    active, peak = [0], [0]
    lock = threading.Lock()
    both = threading.Barrier(2)

    def fn():
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        if workers == 2:
            both.wait(timeout=30)   # breaks unless the two overlap
        time.sleep(0.05)
        with lock:
            active[0] -= 1

    rep = within_timeout(lambda: psched.run_dag(
        [psched.Node(x, fn) for x in "xyzw"[:2 * workers]],
        workers=workers))
    assert peak[0] == workers == rep["max_concurrent"] == rep["workers"]
    assert rep["total_devices"] is None
    assert all(r["devices"] is None for r in rep["nodes"])


def test_default_admission_is_timeshared_without_a_card(monkeypatch):
    """With no card and no knob the port timeshares; SHIFU_TPU_DAG_SLICE=1
    with no inventory raises; a bad mode raises."""
    monkeypatch.delenv("SHIFU_TPU_DAG_SLICE", raising=False)
    monkeypatch.delenv("SHIFU_TPU_DAG_DEVICES", raising=False)
    monkeypatch.setattr(psched, "_card_count", lambda: 0)
    rep = within_timeout(lambda: psched.run_dag(
        [psched.Node("x", lambda: None)]))
    assert rep["total_devices"] is None and rep["workers"] == 2
    monkeypatch.setattr(psched, "_card_count", lambda: 1)
    assert psched._resolve_slicing([psched.Node("x", None)]) == (False, None)
    monkeypatch.setattr(psched, "_card_count", lambda: 4)
    assert psched._resolve_slicing([psched.Node("x", None)]) == (True, 4)
    assert psched._resolve_slicing(
        [psched.Node("x", None, device=False)]) == (False, None)
    monkeypatch.setattr(psched, "_card_count", lambda: 0)
    monkeypatch.setenv("SHIFU_TPU_DAG_SLICE", "1")
    with pytest.raises(RuntimeError, match="SHIFU_TPU_DAG_DEVICES"):
        psched.run_dag([psched.Node("x", lambda: None)])
    monkeypatch.setenv("SHIFU_TPU_DAG_SLICE", "sometimes")
    for sched, _ in PACKAGES.values():
        with pytest.raises(ValueError, match="want auto, 1 or 0"):
            sched.run_dag([sched.Node("x", lambda: None)])


def test_timeshared_demand_exports_nothing(timeshared):
    """Timeshared, a declared demand gives the port's node no lease
    environment (the JAX package's mesh cap has no counterpart on one
    card)."""
    seen = {}

    def fn(lease_env=None):
        seen["env"] = lease_env

    within_timeout(lambda: psched.run_dag(
        [psched.Node("x", fn, devices=2)], workers=1))
    assert seen == {"env": None}


def test_sliced_leases_disjoint_and_env_exported(sliced8, monkeypatch):
    """Two demand-4 nodes on an 8-card pool run at once (the barrier
    breaks otherwise) on disjoint leases, each with
    CUDA_VISIBLE_DEVICES set to the JAX package's lease; the report equals
    the JAX package's."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    reps, envs = {}, {}
    for name, (sched, _) in PACKAGES.items():
        seen = {}
        barrier = threading.Barrier(2)

        def fn(node, seen=seen, barrier=barrier):
            def run(lease_env=None):
                seen[node] = lease_env
                barrier.wait(timeout=30)
            return run
        reps[name] = within_timeout(lambda: sched.run_dag(
            [sched.Node("a", fn("a"), devices=4),
             sched.Node("b", fn("b"), devices=4)], workers=4))
        envs[name] = seen
    rep = reps["port"]
    assert rep["total_devices"] == 8 and rep["max_concurrent"] == 2
    assert _shape(rep) == _shape(reps["jax"])
    slices = {}
    for node, env in envs["port"].items():
        assert set(env) == {"CUDA_VISIBLE_DEVICES"}
        ids = env["CUDA_VISIBLE_DEVICES"]
        assert ids == envs["jax"][node]["SHIFU_TPU_DEVICE_SLICE"]
        slices[node] = {int(x) for x in ids.split(",")}
    assert len(slices["a"]) == len(slices["b"]) == 4
    assert slices["a"].isdisjoint(slices["b"])
    assert all(r["devices"] == 4 for r in rep["nodes"])


def test_lease_maps_through_the_parents_visible_cards(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5,6,7,2")
    assert psched._lease_env((1, 3)) == {"CUDA_VISIBLE_DEVICES": "6,2"}


def test_sliced_oversize_demand_raises(sliced8):
    for sched, _ in PACKAGES.values():
        with pytest.raises(ValueError, match="demands 9"):
            sched.run_dag([sched.Node("big", lambda: None, devices=9)])


def test_sliced_demand_defaults_to_the_whole_pool(sliced8):
    """A device node without `devices` leases the whole pool, as in the
    JAX package; a host node leases nothing."""
    reps = {}
    for name, (sched, _) in PACKAGES.items():
        reps[name] = within_timeout(lambda: sched.run_dag(
            [sched.Node("all", lambda lease_env=None: None),
             sched.Node("two", lambda lease_env=None: None, devices=2),
             sched.Node("host", lambda: None, device=False)]))
    got = {r["node"]: r["devices"] for r in reps["port"]["nodes"]}
    assert got == {r["node"]: r["devices"] for r in reps["jax"]["nodes"]}
    assert got["all"] == 8 and got["two"] == 2


def test_sliced_lease_returned_on_failure(sliced8, tmp_path):
    """A failing whole-pool node returns its lease: the independent
    whole-pool sibling runs after it, the failed node's descendant is
    poisoned without a lease; states and leases equal the JAX
    package's."""
    reps = {}
    for name, (sched, res) in PACKAGES.items():
        ran = []

        def boom(lease_env=None):
            raise OSError("synthetic")
        nodes = [
            sched.Node("a", boom, devices=8),
            sched.Node("c", lambda lease_env=None: ran.append("c"),
                       deps=("a",), devices=8),
            sched.Node("b", lambda lease_env=None: ran.append("b"),
                       devices=8),
        ]
        with pytest.raises(sched.DagError) as ei:
            within_timeout(lambda: sched.run_dag(
                nodes, workers=2, root=str(tmp_path / name), label="t"))
        res.clear_abort()
        res.set_abort_scope(None)
        assert ran == ["b"]
        reps[name] = ei.value.report
    assert _states(reps["port"]) == {"a": "failed", "b": "done",
                                     "c": "poisoned"}
    assert _shape(reps["port"]) == _shape(reps["jax"])
    by = {r["node"]: r["devices"] for r in reps["port"]["nodes"]}
    assert by == {"a": 8, "b": 8, "c": 0}


def test_sliced_dispatch_largest_demand_first(sliced8):
    for sched, _ in PACKAGES.values():
        order = []
        lock = threading.Lock()

        def fn(node, order=order, lock=lock):
            def run(lease_env=None):
                with lock:
                    order.append(node)
            return run
        rep = within_timeout(lambda: sched.run_dag(
            [sched.Node("small", fn("small"), devices=2),
             sched.Node("big", fn("big"), devices=8)], workers=4))
        assert order[0] == "big"
        assert _states(rep) == {"small": "done", "big": "done"}


# ---------------------------------------------------------------------------
# the fault drills (tests/test_chaos.py:132-215 of the JAX package)
# ---------------------------------------------------------------------------

@pytest.fixture()
def synth_set(tmp_path):
    from tests.synth import make_model_set
    return make_model_set(tmp_path / "set", np.random.default_rng(401),
                          n_rows=300)


def serialize_jax_reads(monkeypatch):
    """The JAX package's `test` verb reads the raw set on concurrent DAG
    workers through pandas, whose pyarrow string conversion is not safe
    across threads in one process (it crashes this process now and
    then): one lock around the JAX reader keeps its nodes concurrent and
    its reads one at a time."""
    import jax
    from shifu_tpu.data import reader as jreader
    # the JAX abort marker asks jax for the process index: its backend
    # comes up here, not on the dispatcher thread
    jax.process_index()
    lock = threading.Lock()
    real = jreader.read_raw_table

    def read(*a, **kw):
        with lock:
            return real(*a, **kw)
    monkeypatch.setattr(jreader, "read_raw_table", read)


@pytest.mark.parametrize("nth,failing,poisoned", [
    (1, "test.config", ["test.eval.Eval1", "test.filter", "test.plan"]),
    (2, "test.filter", []),
])
def test_dag_node_fault_drill_matches(synth_set, monkeypatch, nth, failing,
                                      poisoned):
    """`dag.node:oserror:<nth>` through both packages' `test` verbs:
    exactly one node fails, exactly its descendants are poisoned, the
    abort marker names it in both, and a clean rerun passes."""
    from shifu_tpu.cli import main as jmain
    from shifu_tpu_torch import cli as pcli
    serialize_jax_reads(monkeypatch)
    monkeypatch.setenv("SHIFU_TPU_FAULT", f"dag.node:oserror:{nth}")
    got = {}
    for name, (sched, res), main in (("jax", PACKAGES["jax"], jmain),
                                     ("port", PACKAGES["port"], pcli.main)):
        res.reset_faults()
        with pytest.raises(sched.DagError) as ei:
            within_timeout(lambda: main(["--dir", synth_set, "test"]))
        assert "injected oserror at dag.node" in str(ei.value.__cause__)
        res.set_abort_scope(os.path.join(synth_set, "tmp"))
        marker = read_marker(os.path.join(synth_set, "tmp"))
        res.clear_abort()
        res.set_abort_scope(None)
        got[name] = (ei.value.report, marker)
    (jrep, jmark), (prep, pmark) = got["jax"], got["port"]
    states = _states(prep)
    assert prep["failed"] == jrep["failed"] == failing
    assert sorted(k for k, v in states.items() if v == "poisoned") \
        == poisoned
    assert states == _states(jrep)
    assert pmark["site"] == jmark["site"] == f"dag.{failing}"
    monkeypatch.delenv("SHIFU_TPU_FAULT")
    pres.reset_faults()
    assert within_timeout(lambda: pcli.main(["--dir", synth_set,
                                             "test"])) == 0


def test_dag_slice_fault_drill_matches(sliced8, tmp_path, monkeypatch):
    """`dag.slice:oserror:1`: the first leased node fails and returns
    its lease, the whole-pool sibling runs on it, only the failed
    node's descendant is poisoned; a clean rerun leases everything."""
    monkeypatch.setenv("SHIFU_TPU_FAULT", "dag.slice:oserror:1")
    reps, marks = {}, {}
    for name, (sched, res) in PACKAGES.items():
        res.reset_faults()
        ran = []
        nodes = [
            sched.Node("a", lambda lease_env=None: ran.append("a"),
                       devices=8),
            sched.Node("b", lambda lease_env=None: ran.append("b"),
                       deps=("a",), devices=4),
            sched.Node("c", lambda lease_env=None: ran.append("c"),
                       devices=8),
        ]
        with pytest.raises(sched.DagError) as ei:
            within_timeout(lambda: sched.run_dag(
                nodes, workers=2, root=str(tmp_path / name), label="t"))
        assert "injected oserror at dag.slice" in str(ei.value.__cause__)
        assert ran == ["c"]
        reps[name] = ei.value.report
        marks[name] = read_marker(tmp_path / name / "tmp")["site"]
        res.clear_abort()
        res.set_abort_scope(None)
    assert _states(reps["port"]) == {"a": "failed", "b": "poisoned",
                                     "c": "done"}
    assert _shape(reps["port"]) == _shape(reps["jax"])
    assert marks["port"] == marks["jax"] == "dag.a"
    monkeypatch.delenv("SHIFU_TPU_FAULT")
    pres.reset_faults()
    ran = []
    rep = within_timeout(lambda: psched.run_dag([
        psched.Node("a", lambda lease_env=None: ran.append("a"), devices=8),
        psched.Node("b", lambda lease_env=None: ran.append("b"),
                    deps=("a",), devices=4),
        psched.Node("c", lambda lease_env=None: ran.append("c"),
                    devices=8)], workers=2))
    assert sorted(ran) == ["a", "b", "c"]
    assert [r["devices"] for r in rep["nodes"]] == [8, 4, 8]


# ---------------------------------------------------------------------------
# the node builders
# ---------------------------------------------------------------------------

def _record_commands(monkeypatch, module, nodes):
    """Each node's (root, command) from calling its body with the
    module's `_run_cli` replaced by a recorder."""
    calls = {}

    def record(root, cmd, node, env_extra=None):
        calls[node] = (root, list(cmd))
    monkeypatch.setattr(module, "_run_cli", record)
    for n in nodes:
        n.fn()
    return calls


@pytest.mark.parametrize("pool", ["8", "1"])
def test_builders_match_the_jax_package(tmp_path, monkeypatch, pool):
    """pipeline_nodes (two segment expressions, two algorithms, two
    eval sets, posttrain) and grid_nodes give the JAX package's node
    names, deps, device flags and demands; the commands differ only in
    `--device cpu`."""
    from tests.synth import make_model_set
    monkeypatch.setenv("SHIFU_TPU_DAG_DEVICES", pool)
    root = make_model_set(tmp_path, np.random.default_rng(402),
                          n_rows=200, seg_expressions=["num_1 > 0",
                                                       "num_0 > 0"])
    builds = [
        lambda m, **kw: m.pipeline_nodes(
            root, eval_sets=["Eval1", "Eval2"], algorithms=["NN", "GBT"],
            posttrain=True, resume=False, **kw),
        lambda m, **kw: m.grid_nodes(
            root, [{"LearningRate": 0.1}, {"LearningRate": 0.2}],
            resume=False, **kw)]
    for build in builds:
        jn, pn = build(jnodes), build(pnodes, device="cpu")
        assert [(n.name, n.deps, n.device, n.devices) for n in pn] == \
            [(n.name, n.deps, n.device, n.devices) for n in jn]
        jcmd = _record_commands(monkeypatch, jnodes, jn)
        pcmd = _record_commands(monkeypatch, pnodes, pn)
        assert set(pcmd) == set(jcmd) == {n.name for n in pn}
        for name, (proot, cmd) in pcmd.items():
            jroot, want = jcmd[name]
            assert proot == jroot, name
            if want[0] in ("stats", "norm", "train", "eval", "posttrain"):
                want = want + ["--device", "cpu"]
            assert cmd == want, name
    names = [n.name for n in builds[0](pnodes, device="cpu")]
    assert names[:5] == ["init", "stats", "stats.seg.1", "stats.seg.2",
                         "stats.segmerge"]
    if pool == "8":
        assert {n.name: n.devices for n in
                builds[0](pnodes)}["train.GBT"] == 4
    # a clone shares the parent's data and keeps reading its files
    clone = pnodes.variant_dir(root, "train.GBT")
    with open(os.path.join(clone, "ModelConfig.json")) as f:
        mc = json.load(f)
    assert mc["train"]["algorithm"] == "GBT"
    assert mc["basic"]["name"] == "SynthTest:train.GBT"
    assert os.path.isabs(mc["dataSet"]["segExpressionFile"])


def test_absolutize_matches_and_refresh_uses_it():
    from shifu_tpu_torch.obs.health import refresh
    raw = {"dataSet": {"dataPath": "data", "headerPath": "/abs/h",
                       "segExpressionFile": "s3://b/x", "name": "keep"},
           "evals": [{"dataSet": {"dataPath": "e"}}],
           "varSelect": {"forceSelectColumnNameFile": "columns/f"}}
    assert pnodes._absolutize(raw, "/data/set") == \
        jnodes._absolutize(raw, "/data/set")
    assert not hasattr(refresh, "_absolutize")


_GUARD = re.compile(r"step_guard\(\s*ctx,\s*(f?)[\"']([^\"']+)[\"']")


def test_step_registry_matches_the_step_guards():
    """The counterpart of the JAX package's `unregistered-dag-step` lint
    rule over the port: every `step_guard` name maps to a registry
    entry (a family entry for an f-string name), and every
    manifest-bearing entry has a call site; the registry is the JAX
    package's."""
    assert pnodes.STEP_REGISTRY == jnodes.STEP_REGISTRY
    import shifu_tpu_torch
    pkg = os.path.dirname(shifu_tpu_torch.__file__)
    used = set()
    for d, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(d, name)) as f:
                    text = f.read()
                for fstr, guard in _GUARD.findall(text):
                    key = guard.split("{")[0].rstrip(".") if fstr else guard
                    spec = pnodes.STEP_REGISTRY.get(key)
                    assert spec is not None and spec.manifest, guard
                    assert spec.family == bool(fstr), guard
                    used.add(key)
    assert used == {k for k, s in pnodes.STEP_REGISTRY.items()
                    if s.manifest}


# ---------------------------------------------------------------------------
# the pipeline on the CPU: scheduled against its sequential walk
# ---------------------------------------------------------------------------

def _hash_outputs(root, algs):
    """sha256 over ColumnConfig.json, the normalized data, models/ and
    evals/ of the model set and models/ of each fan-out clone."""
    h = hashlib.sha256()
    with open(os.path.join(root, "ColumnConfig.json"), "rb") as f:
        h.update(f.read())
    trees = [("", root, ("models", "evals", "tmp/NormalizedData"))]
    trees += [(f"train.{a}:", pnodes.variant_dir(root, f"train.{a}"),
               ("models",)) for a in algs[1:]]
    for prefix, base, subs in trees:
        for sub in subs:
            top = os.path.join(base, sub)
            for dirpath, dirs, files in os.walk(top):
                dirs.sort()
                for f in sorted(files):
                    p = os.path.join(dirpath, f)
                    h.update(f"{prefix}{sub}/{os.path.relpath(p, top)}"
                             .encode())
                    with open(p, "rb") as fh:
                        h.update(fh.read())
    return h.hexdigest()


def _reset_outputs(root):
    for f in ("ColumnConfig.json", "featureimportance.csv"):
        p = os.path.join(root, f)
        if os.path.exists(p):
            os.remove(p)
    for d in ("models", "modelsBackup", "evals", "tmp"):
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)


def test_scheduled_pipeline_equals_sequential_walk_and_resumes(
        tmp_path, monkeypatch, capsys):
    """NN + GBT fan-out and an eval set: the steps walked in order in
    this process (`cli.main`) and the DAG's subprocesses write the same
    bytes; with SHIFU_TPU_RESUME=1 and eval.Eval1's manifest removed,
    only eval.Eval1 runs again, to the same bytes."""
    from shifu_tpu_torch import cli
    from tests.synth import make_model_set
    monkeypatch.setenv("SHIFU_TPU_DAG_SLICE", "0")
    root = make_model_set(tmp_path, np.random.default_rng(403),
                          n_rows=600,
                          train_params={"NumHiddenLayers": 1,
                                        "NumHiddenNodes": [6],
                                        "ActivationFunc": ["tanh"],
                                        "LearningRate": 0.1,
                                        "Propagation": "ADAM",
                                        "TreeNum": 5, "MaxDepth": 3})
    mc_path = os.path.join(root, "ModelConfig.json")
    with open(mc_path) as f:
        mc = json.load(f)
    mc["train"]["numTrainEpochs"] = 4
    with open(mc_path, "w") as f:
        json.dump(mc, f, indent=2)
    algs = ["NN", "GBT"]

    def build(resume):
        return pnodes.pipeline_nodes(root, eval_sets=["Eval1"],
                                     algorithms=algs, resume=resume,
                                     device="cpu")

    def in_process(root_, cmd, node, env_extra=None):
        assert cli.main(["--dir", root_, *cmd]) == 0
    with monkeypatch.context() as m:
        m.setattr(pnodes, "_run_cli", in_process)
        for n in build(False):
            n.fn()
    seq = _hash_outputs(root, algs)
    capsys.readouterr()

    _reset_outputs(root)
    rep = within_timeout(lambda: psched.run_dag(
        build(False), workers=2, root=root, label="pipeline"),
        SUBPROCESS_S)
    assert _states(rep) == {"init": "done", "stats": "done", "norm": "done",
                            "train.NN": "done", "train.GBT": "done",
                            "eval.Eval1": "done"}
    assert rep["max_concurrent"] == 2
    assert _hash_outputs(root, algs) == seq
    for alg, base in (("NN", root),
                      ("GBT", pnodes.variant_dir(root, "train.GBT"))):
        with open(os.path.join(base, "tmp", "dag_logs",
                               f"train.{alg}.log")) as f:
            line = json.loads([ln for ln in f if ln.startswith("{")][-1])
        assert (line["device"], line["algorithm"]) == ("cpu", alg)

    monkeypatch.setenv("SHIFU_TPU_RESUME", "1")
    os.remove(os.path.join(root, "tmp", "manifests", "eval.Eval1.json"))
    rep = within_timeout(lambda: psched.run_dag(
        build(None), workers=2, root=root, label="pipeline"), SUBPROCESS_S)
    assert _states(rep) == {"init": "cached", "stats": "cached",
                            "norm": "cached", "train.NN": "cached",
                            "train.GBT": "cached", "eval.Eval1": "done"}
    assert _hash_outputs(root, algs) == seq


def test_posttrain_stales_the_upstream_manifests_in_both_packages(
        tmp_path, capsys):
    """C-ref-4: posttrain rewrites ColumnConfig.json (binAvgScore), an
    input of every manifest's fingerprint, so after it the stats, norm
    and train manifests no longer match in either package, and a RESUME
    run re-runs them; posttrain's own manifest matches."""
    from shifu_tpu.processor import init, norm, posttrain, stats, train
    from shifu_tpu.processor.base import ProcessorContext as JCtx
    from shifu_tpu.processor.base import manifest_complete as jdone
    from shifu_tpu_torch.processor.base import ProcessorContext as PCtx
    from shifu_tpu_torch.processor.base import manifest_complete as pdone
    from tests.test_torch_stats import make_sets, run_port
    root, port = make_sets(tmp_path, 404, n_rows=400, algorithm="GBT",
                           train_params={"TreeNum": 2, "MaxDepth": 2})
    for p in (init, stats, norm, train):
        assert p.run(JCtx.load(root)) == 0
    run_port(port, ("init", "stats", "norm", "train"))
    steps = ("stats", "norm", "train")
    before = [(jdone(JCtx.load(root), s), pdone(PCtx.load(port), s))
              for s in steps]
    assert before == [(True, True)] * 3
    assert posttrain.run(JCtx.load(root)) == 0
    run_port(port, ("posttrain",))
    after = [(jdone(JCtx.load(root), s), pdone(PCtx.load(port), s))
             for s in steps + ("posttrain",)]
    assert after == [(False, False)] * 3 + [(True, True)]
