"""Port parity for the streaming tree builders (`train#trainOnDisk`).

The port's `build_gbt_streaming` / `build_rf_streaming` run on the CPU
(the plain routes of K3 and K5) against the JAX package's streaming
builders on the same memory-mapped bin matrix (a private
`np.random.default_rng` each), chunks a few hundred rows long:

- RF and one-round squared GBT have integer gradients, so every tree
  array is bit-exact; later squared rounds and log-loss GBT are held by
  `test_torch_train_tree._close`'s structure-exact, values-within-1e-5
  rule;
- both row-state tiers (SHIFU_TPU_GBT_RESIDENT_STATE=1 and =0) grow the
  same trees, and the device tier reads nothing on the host inside a
  level;
- the `train` verb on a synth set with trainOnDisk against the JAX
  `train` (GBT with validation and early stop, RF), and the cached
  `bins.npy`: reused while its key holds, replaced when the layout
  changes.

Every JAX reference here (the streaming builders' trees and the JAX
steps' model sets) is computed in a fresh child process that loads JAX
and the JAX package alone (`_jax_child`), and compared in this one: an
xdist worker that had run torch and JAX side by side aborted (SIGABRT)
now and then inside the JAX package's CPU dispatch.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from shifu_tpu.models import gbdt as jgbdt
from shifu_tpu.models.spec import load_model as jload_model
from shifu_tpu_torch import cli
from shifu_tpu_torch.models import gbdt as tgbdt
from shifu_tpu_torch.models.spec import load_model
from tests.test_torch_train_tree import _close, _cfgs, _exact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the child: JAX and the JAX package only, never torch; one job a call
_CHILD = r"""
import json
import os
import sys

import numpy as np

job = json.loads(sys.argv[1])
if job["kind"] == "set":
    from shifu_tpu.processor import init, norm, stats, train
    from shifu_tpu.processor.base import ProcessorContext
    from tests.synth import make_model_set
    root = make_model_set(job["dir"], np.random.default_rng(job["seed"]),
                          n_rows=1200, algorithm=job["alg"],
                          train_params=job["params"])
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as f:
        mc = json.load(f)
    mc["train"]["trainOnDisk"] = True
    with open(path, "w") as f:
        json.dump(mc, f, indent=2)
    for proc in (init, stats, norm):
        assert proc.run(ProcessorContext.load(root)) == 0
    import shutil
    shutil.copytree(root, job["copy"])
    if job["train"]:
        assert train.run(ProcessorContext.load(root)) == 0
    print(json.dumps({"root": root}))
    sys.exit(0)
from shifu_tpu.models import gbdt as jgbdt
z = np.load(job["inputs"])
bins = np.load(job["bins"], mmap_mode="r")
kw = dict(job["kw"])
init = {k[5:]: z[k] for k in z.files if k.startswith("init.")}
if init:
    kw["init_trees"] = init
out = getattr(jgbdt, job["fn"])(jgbdt.TreeConfig(**job["cfg"]), bins,
                                z["y"], z["w"], *job["args"], **kw)
trees, errs = out if isinstance(out, tuple) else (out, None)
np.savez(job["out"], **{k: np.asarray(v) for k, v in trees.items()})
print(json.dumps({"errs": None if errs is None
                  else np.asarray(errs, np.float64).tolist()}))
"""


def _jax_child(job):
    """Run one job of `_CHILD` in a fresh ``python`` with
    JAX_PLATFORMS=cpu (this process's XLA_FLAGS and knobs inherited);
    returns its JSON line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(job)],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _jax_build(tmp_path, fn, cfg, bins, y, w, *args, init_trees=None,
               **kw):
    """`jgbdt.<fn>(TreeConfig(**cfg), bins, y, w, *args, **kw)` in a
    child process over the same memory-mapped bin file → (trees as
    numpy, the validation errors or None)."""
    n = len(os.listdir(tmp_path))
    inputs, out = str(tmp_path / f"in{n}.npz"), str(tmp_path / f"out{n}.npz")
    np.savez(inputs, y=y, w=w, **{f"init.{k}": np.asarray(v)
                                  for k, v in (init_trees or {}).items()})
    line = _jax_child({"kind": "build", "fn": fn, "cfg": cfg,
                       "bins": bins.filename, "inputs": inputs, "out": out,
                       "args": list(args), "kw": kw})
    with np.load(out) as z:
        trees = {k: z[k] for k in z.files}
    errs = None if line["errs"] is None else np.asarray(line["errs"])
    return trees, errs


def _layout(tmp_path, seed, n=700, c=6, n_bins=16, weights="int"):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins, (n, c)).astype(np.uint8)
    bins[rng.random((n, c)) < 0.05] = n_bins - 1
    y = ((bins[:, 0] + 0.5 * bins[:, 1] + rng.normal(0, 3, n))
         > n_bins * 0.7).astype(np.float32)
    w = (rng.integers(1, 3, n) if weights == "int"
         else rng.uniform(0.5, 2.0, n)).astype(np.float32)
    path = str(tmp_path / f"bins{seed}.npy")
    np.save(path, bins)
    return np.load(path, mmap_mode="r"), y, w


def _tcfg(**kw):
    return kw, _cfgs(**kw)[1]


@pytest.mark.parametrize("tier", ["0", "1"])
@pytest.mark.parametrize("n_trees,chunk", [(1, 128), (3, 160), (2, 1024)])
def test_streaming_squared_gbt_bit_exact(tmp_path, monkeypatch, tier,
                                         n_trees, chunk):
    """The first round's gradients are integers: the chunk partial sums
    are exact, so each tier's first tree equals the JAX builder's bit
    for bit; later rounds (leaf values -G/(H+λ)) hold the structure
    exactly and the values within 1e-5 (the one-chunk case, 2 × 1024,
    too)."""
    monkeypatch.setenv("SHIFU_TPU_GBT_RESIDENT_STATE", tier)
    bins, y, w = _layout(tmp_path, 3)
    jcfg, tcfg = _tcfg(max_depth=3, n_bins=16, learning_rate=0.5,
                       loss="squared")
    want, jerr = _jax_build(tmp_path, "build_gbt_streaming", jcfg, bins, y,
                            w, n_trees, valid_rate=0.2, chunk_rows=chunk)
    got, terr = tgbdt.build_gbt_streaming(tcfg, bins, y, w, n_trees,
                                          valid_rate=0.2, chunk_rows=chunk,
                                          device="cpu")
    _exact({k: v[:1] for k, v in got.items()},
           {k: v[:1] for k, v in want.items()})
    _close(got, want)
    np.testing.assert_allclose(terr, jerr, rtol=1e-6)


@pytest.mark.parametrize("tier", ["0", "1"])
def test_streaming_log_loss_gbt(tmp_path, monkeypatch, tier):
    monkeypatch.setenv("SHIFU_TPU_GBT_RESIDENT_STATE", tier)
    bins, y, w = _layout(tmp_path, 5, weights="real")
    jcfg, tcfg = _tcfg(max_depth=3, n_bins=16, learning_rate=0.3,
                       loss="log")
    want, jerr = _jax_build(tmp_path, "build_gbt_streaming", jcfg, bins, y,
                            w, 3, valid_rate=0.1, chunk_rows=200)
    got, terr = tgbdt.build_gbt_streaming(tcfg, bins, y, w, 3,
                                          valid_rate=0.1, chunk_rows=200,
                                          device="cpu")
    _close(got, want)
    np.testing.assert_allclose(terr, jerr, rtol=1e-5)


def test_both_tiers_grow_the_same_trees(tmp_path, monkeypatch):
    """Squared loss on real-valued weights: the two tiers compute every
    gradient and update with the same f32 operations."""
    bins, y, w = _layout(tmp_path, 6, weights="real")
    _, cfg = _cfgs(max_depth=3, n_bins=16, learning_rate=0.3,
                   loss="squared")
    out = {}
    for tier in ("0", "1"):
        monkeypatch.setenv("SHIFU_TPU_GBT_RESIDENT_STATE", tier)
        out[tier] = tgbdt.build_gbt_streaming(
            cfg, bins, y, w, 4, valid_rate=0.2, chunk_rows=150,
            early_stop_window=2, device="cpu")
    _exact(out["1"][0], out["0"][0])
    assert out["1"][1] == out["0"][1]


def test_streaming_resume_from_init_trees(tmp_path, monkeypatch):
    bins, y, w = _layout(tmp_path, 8)
    jcfg, tcfg = _tcfg(max_depth=3, n_bins=16, learning_rate=0.5,
                       loss="squared")
    first, _ = _jax_build(tmp_path, "build_gbt_streaming", jcfg, bins, y,
                          w, 1, valid_rate=0.2, chunk_rows=128)
    for tier in ("0", "1"):
        monkeypatch.setenv("SHIFU_TPU_GBT_RESIDENT_STATE", tier)
        want, jerr = _jax_build(
            tmp_path, "build_gbt_streaming", jcfg, bins, y, w, 2,
            valid_rate=0.2, chunk_rows=128, init_trees=first)
        got, terr = tgbdt.build_gbt_streaming(
            tcfg, bins, y, w, 2, valid_rate=0.2, chunk_rows=128,
            init_trees=first, device="cpu")
        _close(got, want)
        np.testing.assert_allclose(terr, jerr, rtol=1e-6)


@pytest.mark.parametrize("subset,seed", [("ALL", 1), ("SQRT", 2)])
def test_streaming_rf_bit_exact(tmp_path, subset, seed):
    bins, y, w = _layout(tmp_path, 10 + seed)
    jcfg, tcfg = _tcfg(max_depth=4, n_bins=16)
    want, _ = _jax_build(tmp_path, "build_rf_streaming", jcfg, bins, y, w,
                         3, subset, 0.8, seed, chunk_rows=150)
    got = tgbdt.build_rf_streaming(tcfg, bins, y, w, 3, subset, 0.8, seed,
                                   chunk_rows=150, device="cpu")
    _exact(got, want)


def test_resident_tier_reads_nothing_on_the_host_inside_a_level(
        tmp_path, monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_GBT_RESIDENT_STATE", "1")
    orig = tgbdt._build_tree_streaming_device
    calls = []

    def refuse(name):
        def fn(*_a, **_k):
            raise AssertionError(f"host read {name} inside a level")
        return fn

    def guarded(*args, **kw):
        calls.append(1)
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "numpy", "cpu", "__bool__",
                         "__float__", "__int__"):
                m.setattr(torch.Tensor, name, refuse(name))
            return orig(*args, **kw)

    monkeypatch.setattr(tgbdt, "_build_tree_streaming_device", guarded)
    bins, y, w = _layout(tmp_path, 9)
    _, cfg = _cfgs(max_depth=3, n_bins=16, learning_rate=0.3, loss="log")
    trees, errs = tgbdt.build_gbt_streaming(cfg, bins, y, w, 2,
                                            valid_rate=0.2, chunk_rows=128,
                                            device="cpu")
    assert len(calls) == 2 and len(errs) == 2


def test_resident_state_mode_knobs(monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_GBT_RESIDENT_STATE", "0")
    assert not tgbdt.gbt_resident_state_mode(10)
    monkeypatch.setenv("SHIFU_TPU_GBT_RESIDENT_STATE", "1")
    assert tgbdt.gbt_resident_state_mode(10 ** 12)
    monkeypatch.setenv("SHIFU_TPU_GBT_RESIDENT_STATE", "auto")
    monkeypatch.setenv("SHIFU_TPU_GBT_STATE_BUDGET_MB", "1")
    assert tgbdt.gbt_resident_state_mode(40_000)
    assert not tgbdt.gbt_resident_state_mode(50_000)
    for n in (40_000, 50_000):
        assert tgbdt.gbt_resident_state_mode(n) == \
            jgbdt.gbt_resident_state_mode(n)


# ---------------------------------------------------------------------------
# the `train` verb with trainOnDisk
# ---------------------------------------------------------------------------

STREAM_PARAMS = {
    "GBT": {"TreeNum": 4, "MaxDepth": 3, "LearningRate": 0.3,
            "Loss": "log", "ChunkRows": 300, "EnableEarlyStop": True},
    "RF": {"TreeNum": 4, "MaxDepth": 4, "FeatureSubsetStrategy": "SQRT",
           "ChunkRows": 300},
}


def _stream_set(tmp_path, alg, seed, train=False):
    """A synth set with trainOnDisk through the JAX package's init →
    stats → norm (then its `train`, with `train`) in a child process,
    and the port's copy, taken after `norm`."""
    port_root = str(tmp_path / "port")
    root = _jax_child({"kind": "set", "dir": str(tmp_path / "jax"),
                       "seed": seed, "alg": alg, "copy": port_root,
                       "params": STREAM_PARAMS[alg], "train": train})["root"]
    return root, port_root


@pytest.mark.parametrize("alg,seed", [("GBT", 31), ("RF", 32)])
def test_streaming_train_verb_matches_jax(tmp_path, capsys, alg, seed):
    root, port_root = _stream_set(tmp_path, alg, seed, train=True)
    assert cli.main(["--dir", port_root, "train", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["algorithm"] == alg and line["device"] == "cpu"
    ext = "gbt" if alg == "GBT" else "rf"
    name = os.path.join("models", f"model0.{ext}")
    jkind, jmeta, jparams = jload_model(os.path.join(root, name))
    kind, meta, params = load_model(os.path.join(port_root, name))
    assert (kind, meta) == (jkind, jmeta)
    _exact(params["tables"], jparams["tables"])
    _close(params["trees"], jparams["trees"])
    clean = os.path.join(port_root, "tmp", "CleanedData")
    assert np.array_equal(np.load(os.path.join(clean, "bins.npy")),
                          np.load(os.path.join(root, "tmp", "CleanedData",
                                               "bins.npy")))


def test_bins_cache_reused_and_replaced(tmp_path, monkeypatch):
    _, port_root = _stream_set(tmp_path, "RF", 33)
    calls = []
    orig = tgbdt.bin_dataset

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(tgbdt, "bin_dataset", counted)
    train = ["--dir", port_root, "train", "--device", "cpu"]
    clean = os.path.join(port_root, "tmp", "CleanedData")
    meta_path = os.path.join(clean, "bins.meta.json")
    # the copied layout lives at another path: its key differs from the
    # JAX run's cache, so the first run bins (4 chunks of 300 rows)
    assert cli.main(train) == 0
    assert len(calls) == 4
    with open(meta_path) as f:
        key = json.load(f)["key"]
    model = os.path.join(port_root, "models", "model0.rf")
    first = load_model(model)[2]["trees"]
    calls.clear()
    assert cli.main(train) == 0      # the key holds: nothing rebins
    assert calls == []
    # a rewritten layout file changes the key: the matrix is rebuilt
    dense_p = os.path.join(clean, "dense.npy")
    st = os.stat(dense_p)
    os.utime(dense_p, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    assert cli.main(train) == 0
    assert len(calls) == 4
    with open(meta_path) as f:
        assert json.load(f)["key"] != key
    _exact(load_model(model)[2]["trees"], first)


def test_streaming_builders_default_to_the_card(tmp_path, monkeypatch):
    bins, y, w = _layout(tmp_path, 34, n=60)
    cfg = tgbdt.TreeConfig(max_depth=2, n_bins=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tgbdt.build_gbt_streaming(cfg, bins, y, w, 1)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tgbdt.build_rf_streaming(cfg, bins, y, w, 1, "ALL", 1.0, 0)
