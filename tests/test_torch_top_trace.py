"""The port's `top` and `trace ls` verbs and `obs.trace.trace_ls`
against the JAX package's over the same `tmp/` tree: step records with
and without a `trace` block, a merged trace run, a run still in flight,
a profile without a trace, and the health plane's canary arms and
events. Each package reads its own copy of the tree (a verb appends its
own step record on the way out), and the output must be the same
text. Everything runs on the CPU; a private `np.random.default_rng`
draws the records."""

import json
import os
import shutil

import numpy as np
import pytest

from shifu_tpu import cli as jcli
from shifu_tpu.obs import trace as jtrace
from shifu_tpu_torch import cli as pcli
from shifu_tpu_torch.obs import trace as ptrace


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    for name in ("SHIFU_TPU_TRACE", "SHIFU_TPU_TRACE_DIR"):
        monkeypatch.delenv(name, raising=False)


def _tree(root, monkeypatch, seed=1621, health=True):
    """A workspace tmp/ tree both packages read."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "tmp", "metrics"))
    recs = []
    for i, step in enumerate(("init", "stats", "norm", "train", "eval",
                              "test", "posttrain", "varsel", "export",
                              "encode", "combo", "serve")):
        rec = {"step": step, "startedAt": 1.7e9 + i,
               "wallSeconds": round(float(rng.uniform(0, 90)), 3)}
        if i % 3:
            rec["rc"] = int(i % 5 == 4)
        if i % 2:
            rec["trace"] = {"span_count": int(rng.integers(1, 500)),
                            "dropped_spans": int(rng.integers(0, 3)),
                            "top_self": [
                                {"name": n, "self_s": round(float(s), 6)}
                                for n, s in zip(("dag.run", "input.h2d",
                                                 "serve.device")[:i % 4],
                                                rng.uniform(0, 5, 3))]}
        recs.append(rec)
    with open(os.path.join(root, "tmp", "metrics", "steps.jsonl"), "w") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")
        f.write("not json\n")
    tdir = os.path.join(root, "tmp", "trace")
    for rid, merged, files in (("train-1700000003-11", True, 3),
                               ("serve-1700000011-12", False, 2),
                               ("test-1700000005-13", True, 0)):
        d = os.path.join(tdir, rid)
        os.makedirs(d)
        for k in range(files):
            with open(os.path.join(d, f"spans.{100 + k}.jsonl"), "w") as f:
                f.write("{}\n")
        if merged:
            with open(os.path.join(tdir, rid + ".trace.json"), "w") as f:
                f.write('{"traceEvents": []}')
    for rid in ("train-1700000003-11", "eval-1700000004-14"):
        os.makedirs(os.path.join(root, "tmp", "profile", rid))
    if health:
        from shifu_tpu_torch.obs.health import store as pstore
        monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
        st = pstore.MetricsStore(root)
        st.event("drift", features="f0,f3", psi_max=0.41, window=3)
        st.event("canary", model="m", phase="canary", run="run0001",
                 version="v002", canary_pct=0.05)
        st.emit("serve.arm_p99_ms", 1.75, model="m", arm="canary")
        st.emit("serve.arm_p99_ms", 1.5, model="m", arm="primary")
        st.emit("canary.arm_psi", 0.0123, model="m")
        st.event("breach", slo="psi", observed=0.41)
        st.flush()
        monkeypatch.delenv("SHIFU_TPU_METRICS")


def _copies(tmp_path, monkeypatch, **kw):
    src = str(tmp_path / "src")
    _tree(src, monkeypatch, **kw)
    out = {}
    for name in ("jax", "port"):
        out[name] = str(tmp_path / name)
        shutil.copytree(src, out[name])
    return out


def test_trace_ls_pairs_as_the_jax_package(tmp_path, monkeypatch):
    roots = _copies(tmp_path, monkeypatch, health=False)
    got = ptrace.trace_ls(roots["port"])
    want = jtrace.trace_ls(roots["jax"])
    strip = lambda rows, r: json.dumps(rows).replace(r, "<root>")  # noqa: E731
    assert strip(got, roots["port"]) == strip(want, roots["jax"])
    by = {r["run_id"]: r for r in got}
    assert by["train-1700000003-11"]["trace"] and \
        by["train-1700000003-11"]["profile"]
    assert by["eval-1700000004-14"]["trace"] is None
    assert by["serve-1700000011-12"]["span_files"] == 2
    assert ptrace.trace_ls(str(tmp_path / "empty")) == []


@pytest.mark.parametrize("verb", [["trace", "ls"], ["top"]])
def test_verb_prints_what_the_jax_package_prints(tmp_path, monkeypatch,
                                                 capsys, verb):
    roots = _copies(tmp_path, monkeypatch)
    out = {}
    for name, main in (("jax", jcli.main), ("port", pcli.main)):
        capsys.readouterr()
        assert main(["--dir", roots[name], *verb]) == 0
        out[name] = capsys.readouterr().out.replace(roots[name], "<root>")
    assert out["port"] == out["jax"]
    if verb == ["top"]:
        assert "live trace runs:" in out["port"]
        assert "canary arms:" in out["port"]
        assert "health/drift events:" in out["port"]
    else:
        assert "run_id" in out["port"] and "train-1700000003-11" in \
            out["port"]


def test_top_render_on_an_empty_workspace(tmp_path):
    root = str(tmp_path)
    assert pcli._top_render(root) == jcli._top_render(root)
    assert pcli._top_render(root).startswith("no step records yet")
