"""The port stands alone: it imports neither JAX nor the JAX package.

The runtime check runs in a subprocess, because this test process has
JAX loaded already (tests/conftest.py imports it). The source scan
covers every file of `shifu_tpu_torch/` and `chip_smoke.py`.
"""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
import numpy as np
import torch
import shifu_tpu_torch.cli, shifu_tpu_torch.weights, shifu_tpu_torch._build
import shifu_tpu_torch.serve.http
import shifu_tpu_torch.processor.train, shifu_tpu_torch.fileio
from shifu_tpu_torch.models import gbdt
from shifu_tpu_torch.ops import best_splits, level_hist
from shifu_tpu_torch.eval.scorer import Scorer
from shifu_tpu_torch.models.spec import save_model
from shifu_tpu_torch.serve.service import ScorerService
root = sys.argv[1]
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
bins = rng.integers(0, 8, (60, 3)).astype(np.int32)
y = (bins[:, 0] > 3).astype(np.float32)
trees = gbdt.build_rf(gbdt.TreeConfig(max_depth=2, n_bins=8), bins, y,
                      np.ones_like(y), 2, "ALL", 1.0, 0, device="cpu")
assert trees["feature"].shape == (2, 7)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "shifu_tpu" or m.startswith("shifu_tpu."))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_port_runs_without_jax_in_a_subprocess(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(tmp_path)],
                          capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


# static imports, and dynamic ones through importlib / __import__
_JAX_IMPORT = re.compile(
    r"^\s*(import|from)\s+jax\b|import_module\(\s*[\"']jax\b"
    r"|__import__\(\s*[\"']jax\b", re.M)
_PKG_IMPORT = re.compile(
    r"^\s*(import|from)\s+\bshifu_tpu\b(?!_torch)"
    r"|import_module\(\s*[\"']\bshifu_tpu\b(?!_torch)"
    r"|__import__\(\s*[\"']\bshifu_tpu\b(?!_torch)", re.M)


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
    csrc = os.path.join(REPO, "shifu_tpu_torch", "csrc")
    files = sorted(f for f in os.listdir(csrc)
                   if f.endswith((".cu", ".cuh")))
    assert len(files) >= 5, files
    for f in files:
        with open(os.path.join(csrc, f)) as fh:
            code = _code(fh.read())
        for i, line in enumerate(code.splitlines(), 1):
            assert not _MUTABLE_STATIC.search(line), \
                f"{f}:{i}: mutable static state: {line.strip()}"
