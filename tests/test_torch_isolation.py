"""The port stands alone: it imports neither JAX nor the JAX package,
nor JAX's optimizer, network and checkpoint libraries (optax, flax,
orbax), nor pandas. Two optional packages are allowed where a user's
data or model needs them, and only inside functions, so that no other
verb loads them: `pyarrow` in `data/parquet.py` (parquet part files)
and `tensorflow` in `eval/scorer.py` and `processor/export.py` (the
`tf` SavedModel kind).

The runtime checks run in subprocesses, because this test process has
JAX loaded already (tests/conftest.py imports it): `import
shifu_tpu_torch` and its CLI load neither optional package, nor does a
run of the port's modules that reads no parquet and scores no
SavedModel. The source scan covers every file of `shifu_tpu_torch/`
and `chip_smoke.py`; the mutable-static scan covers the CUDA sources
and the C reader.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
import numpy as np
import pytest
import torch
import shifu_tpu_torch.cli, shifu_tpu_torch.weights, shifu_tpu_torch._build
import shifu_tpu_torch.serve.http
import shifu_tpu_torch.processor.train, shifu_tpu_torch.fileio
import shifu_tpu_torch.processor.init, shifu_tpu_torch.processor.stats
import shifu_tpu_torch.processor.norm, shifu_tpu_torch.data.native_reader
import shifu_tpu_torch.data.segment, shifu_tpu_torch.data.sampling
import shifu_tpu_torch.config.inspector, shifu_tpu_torch.train.grid_search
import shifu_tpu_torch.processor.eval, shifu_tpu_torch.processor.posttrain
import shifu_tpu_torch.processor.varselect, shifu_tpu_torch.processor.chunking
import shifu_tpu_torch.eval.model_runner, shifu_tpu_torch.eval.gain_chart
import shifu_tpu_torch.processor.export, shifu_tpu_torch.processor.encode
import shifu_tpu_torch.processor.manage, shifu_tpu_torch.processor.psi
import shifu_tpu_torch.pmml, shifu_tpu_torch.portable
from shifu_tpu_torch.ops import rebin
from shifu_tpu_torch.processor import correlation, datestat
from shifu_tpu_torch.eval import csv_out
from shifu_tpu_torch.ops import metrics
from shifu_tpu_torch.models import gbdt
from shifu_tpu_torch.ops import best_splits, level_hist
from shifu_tpu_torch.eval.scorer import Scorer
from shifu_tpu_torch.models.spec import save_model
from shifu_tpu_torch.serve.service import ScorerService
from shifu_tpu_torch.train import optimizers, trainer
import shifu_tpu_torch.resilience, shifu_tpu_torch.registry
import shifu_tpu_torch.serve.fleet, shifu_tpu_torch.serve.aot
from shifu_tpu_torch.obs.health import drift, slo, store, watch
from shifu_tpu_torch.obs.health import canary, refresh
from shifu_tpu_torch.data import ingest, fs, parquet
import shifu_tpu_torch.pipeline, shifu_tpu_torch.processor.combo
root = sys.argv[1]
log = ingest.RowLog(root + "/rowlog", header=["a", "b"], segment_rows=2)
log.append(["1|x", "2|", "3|z"])
log.seal_all()
assert len(ingest.frame_from_rows(log.read_window("watch").lines,
                                  log.header)) == 3
rng = np.random.default_rng(0)
save_model(root + "/model0.nn", "nn",
           {"spec": {"input_dim": 3, "hidden_dims": [4],
                     "activations": ["relu"]}},
           [{"w": rng.normal(size=(3, 4)).astype(np.float32),
             "b": np.zeros(4, np.float32)},
            {"w": rng.normal(size=(4, 1)).astype(np.float32),
             "b": np.zeros(1, np.float32)}])
norm = {"mean": np.zeros(3, np.float32), "std": np.ones(3, np.float32),
        "cutoff": 4.0}
x = rng.normal(size=(5, 3)).astype(np.float32)
svc = ScorerService(models_dir=root, norm=norm, device="cpu")
svc.start(proto={"dense": x[:1], "raw_dense": x[:1]})
try:
    out = svc.submit(dense=x, raw_dense=x)
finally:
    svc.close()
assert out["mean"].shape == (5,)
from shifu_tpu_torch import registry
assert registry.publish(root + "/reg", "m", root,
                        ladder=(1, 4)) == "v001"
from shifu_tpu_torch.serve.fleet import FleetService
with FleetService(root + "/reg", device="cpu", hbm_budget_mb=0) as fleet:
    assert fleet.submit("m", dense=x[:4])["mean"].shape == (4,)
st = store.MetricsStore(root)
assert slo.health_state(root)["status"] == "ok"
bins = rng.integers(0, 8, (60, 3)).astype(np.int32)
y = (bins[:, 0] > 3).astype(np.float32)
trees = gbdt.build_rf(gbdt.TreeConfig(max_depth=2, n_bins=8), bins, y,
                      np.ones_like(y), 2, "ALL", 1.0, 0, device="cpu")
assert trees["feature"].shape == (2, 7)
from shifu_tpu_torch.config.inspector import ModelStep, probe
from shifu_tpu_torch.config.model_config import ModelConfig
from shifu_tpu_torch.data.purifier import DataPurifier
from shifu_tpu_torch.data.reader import Table
for step in ModelStep:
    probe(ModelConfig.from_dict({"basic": {"name": "x"}}), step)
t = Table({"a": np.array(["1", "2", "3"]), "b": np.array(["x", "y", "x"])})
assert DataPurifier("a > 1 && b == 'x'").apply(t).tolist() == \
    [False, False, True]
perf = metrics.performance_result(out["mean"], np.array([0, 1, 0, 1, 1]),
                                  np.ones(5), device="cpu")
assert 0.0 <= perf["areaUnderRoc"] <= 1.0
assert csv_out.format_block([np.arange(2), np.ones(2)], ["%d", "%.1f"]) \
    == "0,1.0\n1,1.0"
from shifu_tpu_torch.config.model_config import ModelTrainConf
conf = ModelTrainConf()
conf.params = {"NumHiddenNodes": [4], "Propagation": "ADAM"}
conf.numTrainEpochs, conf.baggingNum = 3, 2
res = trainer.train_nn(conf, x, (x[:, 0] > 0).astype(np.float32),
                       np.ones(5, np.float32), device="cpu")
assert res.val_errors.shape == (2, 3)
from shifu_tpu_torch.train import checkpoint
from shifu_tpu_torch.processor import base
res = trainer.train_nn(conf, x, (x[:, 0] > 0).astype(np.float32),
                       np.ones(5, np.float32), device="cpu",
                       checkpoint_dir=root + "/ck", checkpoint_interval=2)
assert checkpoint.latest_step(root + "/ck") == 3
assert base.step_guard and shifu_tpu_torch.resilience.PREEMPT_RC == 75
m, s, ss, p = correlation.pearson_moments(torch.as_tensor(x))
assert correlation.pearson_from_moments(m, s, ss, p).shape == (3, 3)
ds = datestat.compute_date_stats(x, np.ones(5), np.array([0, 1, 0, 1, 1]),
                                 2, device="cpu")
assert ds["count"].tolist() == [[2.0] * 3, [3.0] * 3]
nodes = gbdt.leaf_indices(gbdt._trees_on(trees, "cpu"),
                          torch.as_tensor(bins.T.copy()), 2, 8)
assert nodes.shape == (2, 60)
import shifu_tpu_torch.portable as portable
from shifu_tpu_torch.models.spec import spec_to_bundle, bundle_to_spec
spec_to_bundle(root + "/model0.nn", root + "/b.zip")
bundle_to_spec(root + "/b.zip", root + "/back.nn")
assert portable.score_model(*portable.load_model(root + "/back.nn"),
                            dense=x).shape == (5,)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "shifu_tpu", "pandas",
                                    "pyarrow", "optax", "flax", "orbax",
                                    "tensorflow"))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def _run_probe(code, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code, *args],
                          capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=120)


def test_port_runs_without_jax_in_a_subprocess(tmp_path):
    proc = _run_probe(_PROBE, str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


_OPTIONAL_PROBE = r"""
import sys
{body}
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}
                       & {{"pyarrow", "tensorflow"}}))
"""


@pytest.mark.parametrize("body", [
    "import shifu_tpu_torch, shifu_tpu_torch.cli",
    "import shifu_tpu_torch.data.parquet, shifu_tpu_torch.data.reader",
    "import shifu_tpu_torch.eval.scorer, shifu_tpu_torch.processor.export",
    "from shifu_tpu_torch import cli; cli.main(['version'])",
    "from shifu_tpu_torch import cli; cli.main(['knobs'])"])
def test_import_loads_neither_pyarrow_nor_tensorflow(body):
    proc = _run_probe(_OPTIONAL_PROBE.format(body=body))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


# static imports, and dynamic ones through importlib / __import__
_JAX_IMPORT = re.compile(
    r"^\s*(import|from)\s+jax\b|import_module\(\s*[\"']jax\b"
    r"|__import__\(\s*[\"']jax\b", re.M)
_PKG_IMPORT = re.compile(
    r"^\s*(import|from)\s+\bshifu_tpu\b(?!_torch)"
    r"|import_module\(\s*[\"']\bshifu_tpu\b(?!_torch)"
    r"|__import__\(\s*[\"']\bshifu_tpu\b(?!_torch)", re.M)


# pandas: the port's reader has none; optax, flax and orbax: JAX's own
# libraries
_FOREIGN_IMPORT = re.compile(
    r"^\s*(import|from)\s+(pandas|optax|flax|orbax)\b"
    r"|(import_module|__import__)\(\s*[\"'](pandas|optax|flax"
    r"|orbax)\b", re.M)

# the optional packages: any import of them, and the modules allowed one
_OPTIONAL_IMPORT = {
    "pyarrow": re.compile(
        r"^(\s*)(import|from)\s+pyarrow\b"
        r"|(import_module|__import__)\(\s*[\"']pyarrow\b", re.M),
    "tensorflow": re.compile(
        r"^(\s*)(import|from)\s+tensorflow\b"
        r"|(import_module|__import__)\(\s*[\"']tensorflow\b", re.M),
}
_OPTIONAL_HOMES = {
    "pyarrow": {"shifu_tpu_torch/data/parquet.py"},
    "tensorflow": {"shifu_tpu_torch/eval/scorer.py",
                   "shifu_tpu_torch/processor/export.py"},
}


def _port_sources():
    pkg = os.path.join(REPO, "shifu_tpu_torch")
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(pkg):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def test_source_scan_finds_no_jax_or_jax_package_import():
    files = _port_sources()
    assert len(files) > 15, "walker found suspiciously few files"
    for path in files:
        with open(path) as f:
            text = f.read()
        assert not _JAX_IMPORT.search(text), f"{path} imports jax"
        assert not _PKG_IMPORT.search(text), f"{path} imports shifu_tpu"
        assert not _FOREIGN_IMPORT.search(text), \
            f"{path} imports pandas, optax, flax or orbax"


@pytest.mark.parametrize("package", sorted(_OPTIONAL_IMPORT))
def test_optional_packages_only_in_their_modules_inside_functions(package):
    """`pyarrow` only in `data/parquet.py`, `tensorflow` only in
    `eval/scorer.py` and `processor/export.py` (whose export takes it
    from the scorer's `tensorflow_module`), and there only as an
    indented (function-local) import, never a dynamic one."""
    pat = _OPTIONAL_IMPORT[package]
    homes = _OPTIONAL_HOMES[package]
    seen = set()
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)
        with open(path) as f:
            text = f.read()
        for m in pat.finditer(text):
            assert rel in homes, f"{rel} imports {package}"
            assert m.group(1), f"{rel} imports {package} at module level"
            seen.add(rel)
    assert seen and seen <= homes, (package, seen)


def test_source_scan_covers_the_serving_and_health_planes():
    files = {os.path.relpath(p, REPO) for p in _port_sources()}
    for rel in ("shifu_tpu_torch/resilience.py",
                "shifu_tpu_torch/registry/registry.py",
                "shifu_tpu_torch/serve/fleet.py",
                "shifu_tpu_torch/obs/health/store.py",
                "shifu_tpu_torch/obs/health/slo.py",
                "shifu_tpu_torch/obs/health/drift.py",
                "shifu_tpu_torch/obs/health/watch.py",
                "shifu_tpu_torch/obs/health/refresh.py",
                "shifu_tpu_torch/obs/health/canary.py",
                "shifu_tpu_torch/data/ingest.py",
                "shifu_tpu_torch/train/checkpoint.py",
                "shifu_tpu_torch/processor/base.py"):
        assert rel in files, rel


def test_foreign_import_pattern():
    for bad in ("import pandas as pd", "  from pandas import Series",
                "importlib.import_module('pandas')", "__import__(\"optax\")",
                "import optax", "from flax import linen",
                "import orbax.checkpoint as ocp",
                "importlib.import_module('optax')"):
        assert _FOREIGN_IMPORT.search(bad), bad
    for fine in ("import pandasx", "# pandas is not imported",
                 "x = 'pandas'", "import optaxy", "# optax semantics",
                 "import pyarrow", "    import tensorflow as tf"):
        assert not _FOREIGN_IMPORT.search(fine), fine
    for pkg, pat in _OPTIONAL_IMPORT.items():
        assert pat.search(f"import {pkg}").group(1) == ""
        assert pat.search(f"    from {pkg} import x").group(1) == "    "
        assert pat.search(f"importlib.import_module('{pkg}')")
        assert not pat.search(f"import {pkg}x")


# a `static` declaration that is not a constant: process-wide state that
# outlives a launch and knows nothing of the device it was set on
_MUTABLE_STATIC = re.compile(r"\bstatic\b(?!\s+(constexpr|const)\b)")


def _code(text):
    """C++ source without its comments and string literals."""
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    return re.sub(r'"(\\.|[^"\\])*"', '""', text)


def test_kernel_sources_keep_no_mutable_static_state():
    """A kernel attribute or an occupancy is per device: the wrappers set
    and read them once per card from Python (`fused_score._prepare`,
    `fused_trees._prepare`, `level_hist._max_clusters`), so no CUDA
    source of the port may keep a mutable `static` that would remember
    the first card only."""
    for bad in ("  static bool attr_set = false;",
                "static int limit[2] = {0, 0};",
                "  static __device__ int hits;"):
        assert _MUTABLE_STATIC.search(_code(bad)), bad
    for fine in ("static constexpr int BYTES = 4;", "static_cast<int>(x)",
                 "static const float K = 1.f;", "// static int note;",
                 "static_assert(true);"):
        assert not _MUTABLE_STATIC.search(_code(fine)), fine
    files = []
    for sub, ext in (("csrc", (".cu", ".cuh")), ("native", (".c",))):
        d = os.path.join(REPO, "shifu_tpu_torch", sub)
        files += [os.path.join(d, f) for f in sorted(os.listdir(d))
                  if f.endswith(ext)]
    assert len(files) >= 6, files
    for f in files:
        with open(f) as fh:
            code = _code(fh.read())
        for i, line in enumerate(code.splitlines(), 1):
            assert not _MUTABLE_STATIC.search(line), \
                f"{f}:{i}: mutable static state: {line.strip()}"


def test_fast_reader_builds_with_cc_and_parses(tmp_path):
    """The port's `native/fast_reader.c` builds with the host compiler
    into a build directory of the caller's and parses one small file:
    numeric columns to float32 (missing and junk NaN), the rest to
    trimmed strings, blank lines skipped, the in-file header dropped."""
    from shifu_tpu_torch.data import native_reader
    build = str(tmp_path / "build")
    lib = native_reader.build(build)
    assert os.path.dirname(lib) == build and os.path.exists(lib)
    assert native_reader.build(build) == lib            # built once
    path = str(tmp_path / "part-00000")
    with open(path, "w") as f:
        f.write("a|b|c\n1.5| x |7\n\n?|y|1e3\r\n-2|z|abc\n")
    t = native_reader.read_files_native([path], ["a", "b", "c"], "|",
                                        ["a", "c"], skip_first_row_of=path,
                                        build_dir=build)
    assert t.columns == ["a", "b", "c"] and len(t) == 3
    np.testing.assert_array_equal(
        t["a"], np.array([1.5, np.nan, -2.0], np.float32))
    np.testing.assert_array_equal(
        t["c"], np.array([7.0, 1000.0, np.nan], np.float32))
    assert t["b"].tolist() == ["x", "y", "z"]
