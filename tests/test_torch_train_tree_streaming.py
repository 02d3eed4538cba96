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
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from shifu_tpu.models import gbdt as jgbdt
from shifu_tpu.models.spec import load_model as jload_model
from shifu_tpu_torch import cli
from shifu_tpu_torch.models import gbdt as tgbdt
from shifu_tpu_torch.models.spec import load_model
from tests.test_torch_train_tree import _close, _cfgs, _exact


def _np(trees):
    return jax.tree.map(np.asarray, trees)


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
    jcfg, tcfg = _cfgs(max_depth=3, n_bins=16, learning_rate=0.5,
                       loss="squared")
    want, jerr = jgbdt.build_gbt_streaming(jcfg, bins, y, w, n_trees,
                                           valid_rate=0.2, chunk_rows=chunk)
    got, terr = tgbdt.build_gbt_streaming(tcfg, bins, y, w, n_trees,
                                          valid_rate=0.2, chunk_rows=chunk,
                                          device="cpu")
    want = _np(want)
    _exact({k: v[:1] for k, v in got.items()},
           {k: v[:1] for k, v in want.items()})
    _close(got, want)
    np.testing.assert_allclose(terr, jerr, rtol=1e-6)


@pytest.mark.parametrize("tier", ["0", "1"])
def test_streaming_log_loss_gbt(tmp_path, monkeypatch, tier):
    monkeypatch.setenv("SHIFU_TPU_GBT_RESIDENT_STATE", tier)
    bins, y, w = _layout(tmp_path, 5, weights="real")
    jcfg, tcfg = _cfgs(max_depth=3, n_bins=16, learning_rate=0.3,
                       loss="log")
    want, jerr = jgbdt.build_gbt_streaming(jcfg, bins, y, w, 3,
                                           valid_rate=0.1, chunk_rows=200)
    got, terr = tgbdt.build_gbt_streaming(tcfg, bins, y, w, 3,
                                          valid_rate=0.1, chunk_rows=200,
                                          device="cpu")
    _close(got, _np(want))
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
    jcfg, tcfg = _cfgs(max_depth=3, n_bins=16, learning_rate=0.5,
                       loss="squared")
    first, _ = jgbdt.build_gbt_streaming(jcfg, bins, y, w, 1,
                                         valid_rate=0.2, chunk_rows=128)
    first = _np(first)
    for tier in ("0", "1"):
        monkeypatch.setenv("SHIFU_TPU_GBT_RESIDENT_STATE", tier)
        want, jerr = jgbdt.build_gbt_streaming(
            jcfg, bins, y, w, 2, valid_rate=0.2, chunk_rows=128,
            init_trees=first)
        got, terr = tgbdt.build_gbt_streaming(
            tcfg, bins, y, w, 2, valid_rate=0.2, chunk_rows=128,
            init_trees=first, device="cpu")
        _close(got, _np(want))
        np.testing.assert_allclose(terr, jerr, rtol=1e-6)


@pytest.mark.parametrize("subset,seed", [("ALL", 1), ("SQRT", 2)])
def test_streaming_rf_bit_exact(tmp_path, subset, seed):
    bins, y, w = _layout(tmp_path, 10 + seed)
    jcfg, tcfg = _cfgs(max_depth=4, n_bins=16)
    want = jgbdt.build_rf_streaming(jcfg, bins, y, w, 3, subset, 0.8, seed,
                                    chunk_rows=150)
    got = tgbdt.build_rf_streaming(tcfg, bins, y, w, 3, subset, 0.8, seed,
                                   chunk_rows=150, device="cpu")
    _exact(got, _np(want))


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


def _stream_set(tmp_path, alg, seed):
    from shifu_tpu.processor import init as init_proc
    from shifu_tpu.processor import norm as norm_proc
    from shifu_tpu.processor import stats as stats_proc
    from shifu_tpu.processor.base import ProcessorContext
    from tests.synth import make_model_set
    root = make_model_set(tmp_path / "jax", np.random.default_rng(seed),
                          n_rows=1200, algorithm=alg,
                          train_params=STREAM_PARAMS[alg])
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as f:
        mc = json.load(f)
    mc["train"]["trainOnDisk"] = True
    with open(path, "w") as f:
        json.dump(mc, f, indent=2)
    for proc in (init_proc, stats_proc, norm_proc):
        proc.run(ProcessorContext.load(root))
    port_root = str(tmp_path / "port")
    shutil.copytree(root, port_root)
    return root, port_root


@pytest.mark.parametrize("alg,seed", [("GBT", 31), ("RF", 32)])
def test_streaming_train_verb_matches_jax(tmp_path, capsys, alg, seed):
    from shifu_tpu.processor import train as jtrain
    from shifu_tpu.processor.base import ProcessorContext
    root, port_root = _stream_set(tmp_path, alg, seed)
    assert jtrain.run(ProcessorContext.load(root)) == 0
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
