"""Port parity for the tree-training slice (GBT / RF / DT).

The port's builders run on the CPU (the plain routes of K3, K4 and K5)
against the JAX builders on the same numpy inputs, a few hundred rows at
depth 3-4 and 16-64 bins:

- RF and one-round GBT have integer (or dyadic) gradients, so every
  tree array must be bit-exact;
- multi-round log-loss GBT: structure (feature and is_leaf, bin and
  default_left of split nodes) exact on the seeds named here, leaf
  values within rtol 1e-5, scores within atol 1e-5 — the histogram and
  cumsum sums are taken in other orders, and later rounds' gradients
  inherit that;
- the SHIFU_TPU_HIST_FUSED route (K4 over raw values) grows the same
  trees as the pre-binned route (K3).

The whole slice: a GBT, an RF and a DT model set made by `tests/synth.py`
and the JAX package's init → stats → norm, trained by the JAX package's
`train` and by the port's `train` verb on two copies; the saved files
must have the same keys, bit-exact tables and trees within the same
tolerances, and the port's `serve` must score the port-trained file
like the JAX scorer does.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shifu_tpu.models import gbdt as jgbdt
from shifu_tpu.models.spec import load_model as jload_model
from shifu_tpu.serve.service import ScorerService as JaxService
from shifu_tpu_torch import cli
from shifu_tpu_torch.models import gbdt as tgbdt
from shifu_tpu_torch.models.spec import load_model
from shifu_tpu_torch.ops import level_hist
from shifu_tpu_torch.serve.service import ScorerService


def _data(seed, n=400, c=6, n_bins=16):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins, (n, c)).astype(np.int32)
    bins[rng.random((n, c)) < 0.05] = n_bins - 1           # missing
    y = ((bins[:, 0] + 0.5 * bins[:, 1] + rng.normal(0, 3, n))
         > n_bins * 0.7).astype(np.float32)
    return bins, y


def _cfgs(**kw):
    return jgbdt.TreeConfig(**kw), tgbdt.TreeConfig(**kw)


def _np(trees):
    return jax.tree.map(np.asarray, trees)


def _exact(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)


def _close(got, want):
    """Structure exact: feature and is_leaf everywhere, bin and
    default_left at split nodes. (A leaf's bin and default_left are
    written too, from the argmax over gains that are all at or below
    min_info_gain — near zero, so the sum order picks among them; they
    route nothing.) Leaf values within rtol 1e-5; a gain is a
    difference of sums of squares far larger than itself, so gains
    agree within 1e-5 of the largest gain of the ensemble."""
    assert set(got) == set(want)
    for k in ("feature", "is_leaf"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    split = np.asarray(want["feature"]) >= 0
    for k in ("bin", "default_left"):
        np.testing.assert_array_equal(got[k][split],
                                      np.asarray(want[k])[split], err_msg=k)
    np.testing.assert_allclose(got["leaf_value"],
                               np.asarray(want["leaf_value"]), rtol=1e-5,
                               atol=1e-6, err_msg="leaf_value")
    gain = np.asarray(want["gain"])
    np.testing.assert_allclose(got["gain"], gain, rtol=1e-5,
                               atol=1e-5 * float(np.abs(gain).max()),
                               err_msg="gain")


@pytest.mark.parametrize("subtract", [True, False])
@pytest.mark.parametrize("n_bins", [16, 64])
def test_build_tree_bit_exact(subtract, n_bins):
    bins, y = _data(1, n_bins=n_bins)
    jcfg, tcfg = _cfgs(max_depth=4, n_bins=n_bins, min_instances_per_node=3)
    fm = np.ones(bins.shape[1], np.float32)
    fm[2] = 0.0
    want = jgbdt.build_tree(jcfg, jnp.asarray(bins.T), jnp.asarray(-y),
                            jnp.ones_like(jnp.asarray(y)), jnp.asarray(fm),
                            subtract=subtract)
    got = tgbdt.build_tree(tcfg, torch.as_tensor(np.ascontiguousarray(bins.T)),
                           torch.as_tensor(-y), torch.ones(len(y)),
                           torch.as_tensor(fm), subtract=subtract)
    _exact({k: v.numpy() for k, v in got.items()}, _np(want))
    assert not (got["feature"] == 2).any()


@pytest.mark.parametrize("subset,seed", [("SQRT", 7), ("TWOTHIRDS", 3),
                                         ("ALL", 11)])
def test_build_rf_bit_exact(subset, seed):
    bins, y = _data(seed)
    jcfg, tcfg = _cfgs(max_depth=4, n_bins=16)
    w = np.ones_like(y)
    want = jgbdt.build_rf(jcfg, bins, y, w, 5, subset, 1.0, seed)
    got = tgbdt.build_rf(tcfg, bins, y, w, 5, subset, 1.0, seed,
                         device="cpu")
    _exact(got, _np(want))


@pytest.mark.parametrize("stratified,neg_only", [(True, False),
                                                 (False, True)])
def test_build_rf_sampling_flags_bit_exact(stratified, neg_only):
    bins, y = _data(5)
    jcfg, tcfg = _cfgs(max_depth=3, n_bins=16)
    w = np.ones_like(y)
    want = jgbdt.build_rf(jcfg, bins, y, w, 4, "HALF", 0.7, 5,
                          stratified=stratified, neg_only=neg_only)
    got = tgbdt.build_rf(tcfg, bins, y, w, 4, "HALF", 0.7, 5,
                         stratified=stratified, neg_only=neg_only,
                         device="cpu")
    _exact(got, _np(want))


@pytest.mark.parametrize("loss", ["squared", "log"])
def test_first_gbt_round_bit_exact(loss):
    bins, y = _data(2)
    jcfg, tcfg = _cfgs(max_depth=4, n_bins=16, learning_rate=0.3,
                       loss=loss, min_instances_per_node=2)
    want, _ = jgbdt.build_gbt(jcfg, bins, y, np.ones_like(y), 1)
    got, errs = tgbdt.build_gbt(tcfg, bins, y, np.ones_like(y), 1,
                                device="cpu")
    _exact(got, _np(want))
    assert errs == []


def _scores(trees, bins, cfg):
    per_tree = tgbdt.predict_trees(
        {k: torch.as_tensor(v) for k, v in trees.items()},
        torch.as_tensor(np.ascontiguousarray(bins.T)), cfg.max_depth,
        cfg.n_bins)
    return cfg.learning_rate * per_tree.sum(0).numpy()


@pytest.mark.parametrize("seed", [0, 2, 7])
def test_multi_round_log_loss_gbt(seed):
    bins, y = _data(seed)
    jcfg, tcfg = _cfgs(max_depth=4, n_bins=16, learning_rate=0.3,
                       loss="log", min_instances_per_node=2)
    want, _ = jgbdt.build_gbt(jcfg, bins, y, np.ones_like(y), 6)
    got, _ = tgbdt.build_gbt(tcfg, bins, y, np.ones_like(y), 6,
                             device="cpu")
    _close(got, _np(want))
    np.testing.assert_allclose(_scores(got, bins, tcfg),
                               _scores(_np(want), bins, tcfg), atol=1e-5)


def test_gbt_validation_early_stop_and_resume():
    bins, y = _data(6, n=500)
    vbins, vy = _data(8, n=150)
    jcfg, tcfg = _cfgs(max_depth=3, n_bins=16, learning_rate=0.5,
                       loss="log")
    w = np.ones_like(y)
    want, want_errs = jgbdt.build_gbt(jcfg, bins, y, w, 12,
                                      val_data=(vbins, vy),
                                      early_stop_window=2)
    got, errs = tgbdt.build_gbt(tcfg, bins, y, w, 12, val_data=(vbins, vy),
                                early_stop_window=2, device="cpu")
    assert len(errs) == len(want_errs) and len(errs) < 12
    np.testing.assert_allclose(errs, want_errs, rtol=1e-5)
    _close(got, _np(want))
    # resume: two more rounds on top of the JAX ensemble, as continuous
    # training appends them
    init = _np(want)
    want2, want2_errs = jgbdt.build_gbt(
        jcfg, bins, y, w, 2, init_trees=jax.tree.map(jnp.asarray, init),
        val_data=(vbins, vy))
    got2, errs2 = tgbdt.build_gbt(tcfg, bins, y, w, 2, init_trees=init,
                                  val_data=(vbins, vy), device="cpu")
    assert got2["feature"].shape[0] == init["feature"].shape[0] + 2
    np.testing.assert_allclose(errs2, want2_errs, rtol=1e-5)
    _close(got2, _np(want2))
    want3, _ = jgbdt.build_gbt(jcfg, bins, y, w, 2,
                               init_trees=jax.tree.map(jnp.asarray, init))
    got3, _ = tgbdt.build_gbt(tcfg, bins, y, w, 2, init_trees=init,
                              device="cpu")
    _close(got3, _np(want3))


def test_gbt_bagged_lockstep():
    bins, y = _data(9)
    vbins, vy = _data(10, n=120)
    jcfg, tcfg = _cfgs(max_depth=3, n_bins=16, learning_rate=0.3,
                       loss="log")
    rng = np.random.default_rng(9)
    w_T = rng.poisson(1.0, (3, len(y))).astype(np.float32)
    for val in (None, (vbins, vy)):
        want = jgbdt.build_gbt_bagged(jcfg, bins, y, w_T, 3, val_data=val,
                                      early_stop_window=2)
        got = tgbdt.build_gbt_bagged(tcfg, bins, y, w_T, 3, val_data=val,
                                     early_stop_window=2, device="cpu")
        assert len(got) == 3
        for (gt, ge), (wt, we) in zip(got, want):
            _close(gt, _np(wt))
            np.testing.assert_allclose(ge, we, rtol=1e-5)


def test_fused_route_grows_the_same_trees(monkeypatch):
    """FusedBins (raw values + cuts; K4 and on-the-fly routing) grow the
    trees the pre-binned route (K3 over bin_dataset's matrix) grows."""
    rng = np.random.default_rng(12)
    n, cn, cc, n_bins = 500, 4, 2, 16
    dense = rng.normal(0, 1, (n, cn)).astype(np.float32)
    dense[rng.random((n, cn)) < 0.06] = np.nan
    dense[:3, 1] = np.inf
    codes = rng.integers(0, 6, (n, cc)).astype(np.int32)
    codes[rng.random((n, cc)) < 0.06] = -1
    num_cuts = np.nanquantile(np.where(np.isinf(dense), np.nan, dense),
                              np.linspace(0, 1, n_bins - 1)[1:-1],
                              axis=0).astype(np.float32)
    tables = tgbdt.make_bin_tables(
        num_cuts, [rng.permutation(6).astype(np.int32) for _ in range(cc)],
        n_bins)
    y = ((np.nan_to_num(dense[:, 0]) + 0.3 * codes[:, 0]) > 0.4) \
        .astype(np.float32)
    bins = tgbdt.bin_dataset(tables, dense, codes, n_bins)
    fb = tgbdt.make_fused_inputs(tables, dense, codes, n_bins, device="cpu")
    cfg = tgbdt.TreeConfig(max_depth=4, n_bins=n_bins, learning_rate=0.3,
                           loss="log")
    w = np.ones_like(y)
    binned, _ = tgbdt.build_gbt(cfg, bins, y, w, 3, device="cpu")
    before = level_hist.launches, level_hist.fused_launches
    fused, _ = tgbdt.build_gbt(cfg, fb, y, w, 3, device="cpu")
    assert (level_hist.launches, level_hist.fused_launches) == before
    _exact(fused, binned)
    # and the JAX fused route (XLA binning on the CPU) agrees
    jfb = jgbdt.make_fused_inputs(tables, dense, codes, n_bins)
    want, _ = jgbdt.build_gbt(jgbdt.TreeConfig(**cfg.__dict__), jfb, y, w, 3)
    _close(fused, _np(want))


def test_builders_default_to_the_card(monkeypatch):
    bins, y = _data(13, n=50)
    cfg = tgbdt.TreeConfig(max_depth=2, n_bins=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tgbdt.build_gbt(cfg, bins, y, np.ones_like(y), 1)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tgbdt.build_rf(cfg, bins, y, np.ones_like(y), 1, "ALL", 1.0, 0)


# ---------------------------------------------------------------------------
# The whole slice: JAX init/stats/norm, then both packages' `train`
# ---------------------------------------------------------------------------

PARAMS = {
    "GBT": {"TreeNum": 4, "MaxDepth": 3, "LearningRate": 0.3,
            "Loss": "log"},
    "RF": {"TreeNum": 5, "MaxDepth": 4,
           "FeatureSubsetStrategy": "TWOTHIRDS"},
    "DT": {"MaxDepth": 4},
}


def _model_set(tmp_path, alg, seed):
    from shifu_tpu.processor import init as init_proc
    from shifu_tpu.processor import norm as norm_proc
    from shifu_tpu.processor import stats as stats_proc
    from shifu_tpu.processor.base import ProcessorContext
    from tests.synth import make_model_set
    root = make_model_set(tmp_path / "jax", np.random.default_rng(seed),
                          n_rows=1200, algorithm=alg,
                          train_params=PARAMS[alg])
    for proc in (init_proc, stats_proc, norm_proc):
        proc.run(ProcessorContext.load(root))
    port_root = str(tmp_path / "port")
    shutil.copytree(root, port_root)
    return root, port_root


@pytest.mark.parametrize("alg,seed", [("GBT", 21), ("RF", 22), ("DT", 25)])
def test_train_verb_matches_jax_train(tmp_path, capsys, monkeypatch, alg,
                                     seed):
    from shifu_tpu.processor import train as jtrain
    from shifu_tpu.processor.base import ProcessorContext
    root, port_root = _model_set(tmp_path, alg, seed)
    jtrain.run(ProcessorContext.load(root))
    assert cli.main(["--dir", port_root, "train", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["algorithm"] == alg and report["device"] == "cpu"

    ext = "gbt" if alg == "GBT" else "rf"
    name = os.path.join("models", f"model0.{ext}")
    jkind, jmeta, jparams = jload_model(os.path.join(root, name))
    kind, meta, params = load_model(os.path.join(port_root, name))
    assert (kind, meta) == (jkind, jmeta)
    _exact(params["tables"], jparams["tables"])
    _close(params["trees"], jparams["trees"])
    # the JAX package reads the port's file
    assert jload_model(os.path.join(port_root, name))[0] == kind

    # the port's serve scores the port-trained file like the JAX scorer
    data = np.load(os.path.join(port_root, "tmp", "CleanedData",
                                "data.npz"))
    blk = {"raw_dense": data["dense"][:64].astype(np.float32),
           "raw_codes": data["index"][:64].astype(np.int32)}
    proto = {k: v[:1] for k, v in blk.items()}
    models = os.path.join(port_root, "models")
    port = ScorerService(models_dir=models, max_delay=0.002,
                         device="cpu").start(proto=proto)
    ref = JaxService(models_dir=models, max_delay=0.002,
                     aot_compile=False).start(proto=proto)
    try:
        got, want = port.submit(**blk), ref.submit(**blk)
    finally:
        port.close()
        ref.close()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)

    if alg == "GBT":
        # SHIFU_TPU_HIST_FUSED=1: the same `train` through K4's route
        # (raw values, categorical identity cuts) saves the same trees
        fused_root = str(tmp_path / "fused")
        shutil.copytree(port_root, fused_root)
        monkeypatch.setenv("SHIFU_TPU_HIST_FUSED", "1")
        assert cli.main(["--dir", fused_root, "train", "--device",
                         "cpu"]) == 0
        _, _, fused = load_model(os.path.join(fused_root, name))
        _exact(fused["trees"], params["trees"])
