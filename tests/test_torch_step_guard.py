"""The port's per-step completion manifests (`processor/base.step_guard`)
and `SHIFU_TPU_RESUME` against the JAX package's, on the CPU:

- `_inputs_fingerprint` gives the same hex digest in both packages for
  one model set (before and after `init`, over one part file and over
  several with marker files), and `expand_data_files` lists the files
  in the same order;
- the port's `init → stats → varsel → norm → train → posttrain → eval →
  export` writes the manifests the JAX package writes, with the same
  output lists (relative to each set's root), and the two packages'
  `manifest_complete` agree on every manifest;
- the resume skip and its invalidation through `cli.main`; the killed
  step at ``atomic.commit:kill:1`` in a subprocess of each package:
  the published files stay, no manifest appears, a clean rerun passes
  and writes the same manifest;
- step entry: the markers cleared, temp residue swept, the
  ``step.<name>`` site; a missing declared output writes no manifest;
  `step_completed` counts the step in the metrics store.

A private `np.random.default_rng` each (C-ref-1)."""

import json
import logging
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest

from shifu_tpu_torch import cli, resilience
from shifu_tpu_torch.processor import base

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NN = {"NumHiddenLayers": 1, "NumHiddenNodes": [4], "ActivationFunc":
      ["tanh"], "LearningRate": 0.1, "Propagation": "ADAM"}


@pytest.fixture(autouse=True)
def _fresh():
    resilience.reset_faults()
    resilience.set_abort_scope(None)
    yield
    resilience.reset_faults()
    resilience.set_abort_scope(None)


def _set(tmp_path, seed, n_rows=400):
    from tests.synth import make_model_set
    root = make_model_set(tmp_path, np.random.default_rng(seed),
                          n_rows=n_rows, train_params=dict(NN))
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as f:
        mc = json.load(f)
    mc["train"].update(numTrainEpochs=3, baggingNum=1)
    with open(path, "w") as f:
        json.dump(mc, f, indent=2)
    return root


def _copy(src, dst):
    shutil.copytree(src, dst)
    path = os.path.join(dst, "ModelConfig.json")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace(src, dst))
    return dst


def _ctxs(root):
    from shifu_tpu.processor.base import ProcessorContext as JCtx
    return base.ProcessorContext.load(root), JCtx.load(root)


def _port(root, *args):
    return cli.main(["--dir", root, *args, "--device", "cpu"])


def _host(root, *args):
    return cli.main(["--dir", root, *args])


def _manifests(root):
    d = os.path.join(root, "tmp", "manifests")
    out = {}
    for name in sorted(os.listdir(d)) if os.path.isdir(d) else []:
        with open(os.path.join(d, name)) as f:
            man = json.load(f)
        out[name] = (man["step"],
                     [os.path.relpath(p, root) for p in man["outputs"]])
    return out


# ---------------------------------------------------------------------------
# the fingerprint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["one", "parts"])
def test_fingerprint_equals_the_jax_digest(tmp_path, layout):
    from shifu_tpu.data import reader as jreader
    from shifu_tpu.processor import base as jbase
    from shifu_tpu.processor import init as jinit
    from shifu_tpu_torch.data import reader
    root = _set(tmp_path, 51)
    data = os.path.join(root, "data")
    if layout == "parts":
        with open(os.path.join(data, "part-00000")) as f:
            lines = f.readlines()
        for i in range(3):
            with open(os.path.join(data, f"part-0000{i + 1}"), "w") as f:
                f.writelines(lines[i::3])
        for marker in ("_SUCCESS", ".crc"):
            open(os.path.join(data, marker), "w").close()
    assert reader.expand_data_files(data) == jreader.expand_data_files(data)
    ctx, jctx = _ctxs(root)
    digest = base._inputs_fingerprint(ctx)
    assert digest == jbase._inputs_fingerprint(jctx)
    assert jinit.run(jctx) == 0
    ctx, jctx = _ctxs(root)
    assert base._inputs_fingerprint(ctx) == jbase._inputs_fingerprint(jctx) \
        != digest


# ---------------------------------------------------------------------------
# the steps' manifests
# ---------------------------------------------------------------------------

def test_every_step_writes_the_jax_manifests(tmp_path):
    """Each step of the port writes the JAX package's manifest names and
    output lists, and the two packages' `manifest_complete` agree on
    every manifest of either set (the last is complete; earlier ones
    went stale when posttrain rewrote ColumnConfig.json)."""
    from shifu_tpu.cli import main as jmain
    from shifu_tpu.processor import base as jbase
    src = _set(tmp_path / "src", 52)
    jroot = _copy(src, str(tmp_path / "jax"))
    proot = _copy(src, str(tmp_path / "port"))
    steps = (["init"], ["stats"], ["varsel"], ["norm"], ["train"],
             ["posttrain"], ["eval"], ["export", "-t", "columnstats"])
    for step in steps:
        assert jmain(["--dir", jroot, *step]) == 0, step
        run = _host if step[0] in ("init", "export") else _port
        assert run(proot, *step) == 0, step
    want = _manifests(jroot)
    want_names = list(want)
    assert sorted(want) == ["eval.Eval1.json", "export.columnstats.json",
                            "norm.json", "posttrain.json", "stats.json",
                            "train.json", "varselect.json"]
    assert _manifests(proot) == want
    done = {}
    for root in (proot, jroot):
        ctx, jctx = _ctxs(root)
        done[root] = [base.manifest_complete(ctx, name[:-len(".json")])
                      for name in want]
        assert done[root] == [jbase.manifest_complete(
            jctx, name[:-len(".json")]) for name in want]
    assert done[proot] == done[jroot]
    assert done[proot][want_names.index("export.columnstats.json")]


def test_resume_skips_and_an_edit_invalidates(tmp_path, monkeypatch, caplog):
    root = _set(tmp_path, 53)
    assert _host(root, "init") == 0
    assert _port(root, "stats") == 0
    assert _port(root, "norm") == 0
    man = os.path.join(root, "tmp", "manifests", "stats.json")
    assert os.path.exists(man)
    cc_path = os.path.join(root, "ColumnConfig.json")
    with open(cc_path) as f:
        cc_before = f.read()
    meta = os.path.join(root, "tmp", "NormalizedData", "meta.json")
    stamp = os.stat(meta).st_mtime_ns
    monkeypatch.setenv("SHIFU_TPU_RESUME", "1")
    with caplog.at_level(logging.INFO, logger="shifu_tpu_torch"):
        assert _port(root, "stats") == 0
        assert _port(root, "norm") == 0
    skips = [r.getMessage() for r in caplog.records
             if "skipping" in r.getMessage()]
    assert len(skips) == 2 and skips[0].startswith("step stats")
    with open(cc_path) as f:
        assert f.read() == cc_before
    assert os.stat(meta).st_mtime_ns == stamp
    with open(os.path.join(root, "ModelConfig.json"), "a") as f:
        f.write("\n")
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="shifu_tpu_torch"):
        assert _port(root, "norm") == 0
    msgs = [r.getMessage() for r in caplog.records]
    assert any("re-running" in m for m in msgs)
    assert not any("skipping" in m for m in msgs)
    assert os.stat(meta).st_mtime_ns != stamp
    # a removed output makes the manifest incomplete
    os.remove(meta)
    assert not base.manifest_complete(base.ProcessorContext.load(root),
                                      "norm")


def _run_cli(pkg, root, cmd, fault):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    env.pop("SHIFU_TPU_FAULT", None)
    if fault:
        env["SHIFU_TPU_FAULT"] = fault
    argv = ["--dir", root, cmd] + (["--device", "cpu"] if pkg ==
                                   "shifu_tpu_torch" else [])
    code = (f"import sys; from {pkg}.cli import main; "
            f"sys.exit(main({argv!r}))")
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          timeout=600, capture_output=True, text=True)


@pytest.mark.parametrize("pkg", ["shifu_tpu", "shifu_tpu_torch"])
def test_killed_step_leaves_no_manifest(tmp_path, pkg):
    """SIGKILL at the first atomic commit of `stats` (its ColumnConfig)
    and of `norm` (a block before meta.json): what was published stays,
    no manifest appears, a clean rerun passes. Both packages end with
    the same manifest names and output lists."""
    root = _set(tmp_path / "set", 54)
    assert _host(root, "init") == 0
    cc_path = os.path.join(root, "ColumnConfig.json")
    with open(cc_path) as f:
        cc_init = f.read()
    man = os.path.join(root, "tmp", "manifests")
    r = _run_cli(pkg, root, "stats", "atomic.commit:kill:1")
    assert r.returncode == -signal.SIGKILL, r.stderr[-2000:]
    with open(cc_path) as f:
        assert f.read() == cc_init
    assert not os.path.exists(os.path.join(man, "stats.json"))
    assert _run_cli(pkg, root, "stats", None).returncode == 0
    norm_dir = os.path.join(root, "tmp", "NormalizedData")
    r = _run_cli(pkg, root, "norm", "atomic.commit:kill:1")
    assert r.returncode == -signal.SIGKILL, r.stderr[-2000:]
    assert not os.path.exists(os.path.join(norm_dir, "meta.json"))
    assert not os.path.exists(os.path.join(man, "norm.json"))
    assert _run_cli(pkg, root, "norm", None).returncode == 0
    assert _manifests(root) == {
        "norm.json": ("norm", ["tmp/NormalizedData/meta.json"]),
        "stats.json": ("stats", ["ColumnConfig.json"])}


# ---------------------------------------------------------------------------
# step entry and exit
# ---------------------------------------------------------------------------

def test_step_entry_clears_markers_and_sweeps(tmp_path, monkeypatch):
    root = _set(tmp_path, 55)
    assert _host(root, "init") == 0
    scope = os.path.join(root, "tmp")
    os.makedirs(scope, exist_ok=True)
    for name in ("abort.marker", "preempt.marker"):
        with open(os.path.join(scope, name), "w") as f:
            f.write("{}")
    residue = os.path.join(root, ".tmp.999.ColumnConfig.json")
    with open(residue, "w") as f:
        f.write("half")
    monkeypatch.setenv("SHIFU_TPU_FAULT", "step.stats:oserror:1")
    with pytest.raises(OSError, match="step.stats"):
        _port(root, "stats")
    # the markers are gone; what is left is the CLI's step records
    assert sorted(os.listdir(scope)) == ["metrics"]
    assert os.listdir(os.path.join(scope, "metrics")) == ["steps.jsonl"]
    assert not os.path.exists(residue)
    assert not os.path.exists(os.path.join(scope, "manifests",
                                           "stats.json"))
    assert _port(root, "stats") == 0


def test_missing_output_writes_no_manifest(tmp_path, caplog):
    root = _set(tmp_path, 56)
    ctx = base.ProcessorContext.load(root, need_columns=False)
    with caplog.at_level(logging.WARNING, logger="shifu_tpu_torch"):
        with base.step_guard(ctx, "unit", outputs=[
                os.path.join(root, "never.txt")]) as go:
            assert go
    assert any("manifest not written" in r.getMessage()
               for r in caplog.records)
    assert not os.path.exists(ctx.path_finder.manifest_path("unit"))
    with base.step_guard(ctx, "unit", outputs=[]) as go:
        assert go
    assert os.path.exists(ctx.path_finder.manifest_path("unit"))


def test_step_completed_counts_the_step(tmp_path, monkeypatch):
    from shifu_tpu_torch.obs.health import store as hstore
    root = _set(tmp_path, 57)
    monkeypatch.setenv("SHIFU_TPU_METRICS", "1")
    assert _host(root, "init") == 0
    assert _port(root, "stats") == 0
    pts = hstore.store(root).read_points(names=["step.completed"])
    assert [(p["value"], p["tags"]["step"]) for p in pts] == [(1.0, "stats")]
    monkeypatch.setenv("SHIFU_TPU_FAULT", "obs.metrics_flush:oserror:1+")
    hstore.step_completed(root, "norm")      # never raises


def test_edits_stay_outside_the_guard(tmp_path, capsys):
    root = _set(tmp_path, 58)
    assert _host(root, "init") == 0
    assert _port(root, "stats") == 0
    assert _port(root, "varsel", "-list") == 0
    assert _port(root, "varsel", "-reset") == 0
    assert "varselect.json" not in _manifests(root)
