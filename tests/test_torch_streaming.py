"""Port parity for `train#trainOnDisk`: the streaming trainer core, its
NN/WDL/MTL wrappers, `norm`'s `.npy` layout and the `train` verb's
streaming branches.

- `_chunk_bag_weights` (numpy Philox keyed ``seed + 7919·b`` at counter
  ``start``) equals the JAX package's to the bit, for every bagging
  mode, neg-only with NaN labels included;
- the port's streaming NN (f32 and an f16 chunk store), WDL and MTL
  against the JAX streaming trainers on the same in-memory chunks
  (a private `np.random.default_rng` each), the port handed the JAX
  package's initial parameters (`trainer.initial_params`): every array
  of every bag within 1e-5 of its largest entry, the per-epoch train
  and validation errors within 1e-5 relative, best epochs equal;
- `norm` with trainOnDisk: the `.npy` files and meta.json of both
  directories against the JAX package's (the same rows in the same
  shuffle, FLOAT16 stored as f16, MTL's task tags): equal to the bit
  but for the z-scored dense block, held within 1e-5 as
  `test_torch_norm.py` holds data.npz;
- the `train` verb on trainOnDisk sets (NN, WDL, MTL) against the JAX
  `train`; the k-fold refusal, and CheckpointInterval on the streaming
  NN, WDL and MTL (the checkpoints removed once the models are saved).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from shifu_tpu.models import mtl as jmtl
from shifu_tpu.models import nn as jnn
from shifu_tpu.models import wdl as jwdl
from shifu_tpu.train import streaming as jstream
from shifu_tpu_torch.models import mtl as tmtl
from shifu_tpu_torch.models import nn as tnn
from shifu_tpu_torch.models import wdl as twdl
from shifu_tpu_torch.train import streaming as tstream
from shifu_tpu_torch.train import trainer as ttrainer
from tests.test_torch_stats import make_sets, run_jax, run_port
from tests.test_torch_trainer import _confs
from tests.test_torch_wdl_mtl import (_close, _t, assert_same_models,
                                      jax_initial, made_set, pair, port)


@pytest.mark.parametrize("n_bags,rate,repl,neg_only", [
    (1, 1.0, False, False), (1, 0.7, False, False), (3, 0.8, True, False),
    (2, 0.6, False, True), (3, 1.2, True, True)])
def test_chunk_bag_weights_equal_to_the_bit(n_bags, rate, repl, neg_only):
    rng = np.random.default_rng(71)
    labels = (rng.random(500) < 0.3).astype(np.float32)
    labels[rng.random(500) < 0.1] = np.nan
    for start, stop in ((0, 500), (137, 400)):
        lab = labels[start:stop]
        want = jstream._chunk_bag_weights(n_bags, rate, repl, 12306, start,
                                          stop, labels=lab,
                                          neg_only=neg_only)
        got = tstream._chunk_bag_weights(n_bags, rate, repl, 12306, start,
                                         stop, labels=lab, neg_only=neg_only)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _jax_stacked(init, spec, seed, n_bags):
    keys = jax.random.split(jax.random.PRNGKey(seed), n_bags)
    return _t(jax.vmap(lambda k: init(spec, k))(keys))


def _assert_results(got, want, rel=1e-5):
    assert len(got.params_per_bag) == len(want.params_per_bag)
    for pg, pw in zip(got.params_per_bag, want.params_per_bag):
        lg, lw = jax.tree.leaves(pg), jax.tree.leaves(pw)
        assert len(lg) == len(lw)
        for a, b in zip(lg, lw):
            _close(a, b, rel)
    for k in ("train_errors", "val_errors", "best_val"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=rel, atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(got.best_epoch, want.best_epoch)


def _chunks(*arrays):
    return lambda a, b: tuple(x[a:b] for x in arrays)


@pytest.mark.parametrize("store", ["f32", "f16"])
def test_streaming_nn_matches_jax(monkeypatch, store):
    rng = np.random.default_rng(72)
    n, c = 520, 7
    x = rng.normal(0, 1, (n, c)).astype(np.float32)
    y = (x[:, 0] - 0.6 * x[:, 1] + rng.normal(0, 0.5, n) > 0).astype(
        np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    if store == "f16":
        x = x.astype(np.float16)
    params = {"NumHiddenLayers": 1, "NumHiddenNodes": [6],
              "ActivationFunc": ["tanh"], "LearningRate": 0.05,
              "Propagation": "ADAM"}
    jconf, tconf = _confs(params, epochs=5, bags=2,
                          sampleNegOnly=store == "f32",
                          earlyStoppingRounds=3)
    spec = tnn.MLPSpec.from_train_params(params, c)
    jspec = jnn.MLPSpec(**dataclasses.asdict(spec))
    monkeypatch.setattr(ttrainer, "initial_params", lambda f, s, b:
                        _jax_stacked(jnn.init_params, jspec, s, b))
    labels = lambda a, b: y[a:b]   # noqa: E731
    want = jstream.train_nn_streaming(jconf, _chunks(x, y, w), n, c,
                                      seed=5, chunk_rows=96, n_val=100,
                                      bag_labels=labels)
    got = tstream.train_nn_streaming(tconf, _chunks(x, y, w), n, c, seed=5,
                                     chunk_rows=96, n_val=100,
                                     bag_labels=labels, device="cpu")
    _assert_results(got, want)


def test_streaming_wdl_matches_jax(monkeypatch):
    rng = np.random.default_rng(73)
    n = 480
    dense = rng.normal(0, 1, (n, 4)).astype(np.float32)
    idx = rng.integers(0, 6, (n, 2)).astype(np.int32)
    y = ((idx[:, 0] >= 3) ^ (rng.random(n) < 0.1)).astype(np.float32)
    w = np.ones(n, np.float32)
    spec = twdl.WDLSpec(dense_dim=4, n_cat=2, vocab_size=7, embed_size=3,
                        hidden_dims=(6,), activations=("relu",), l2=1e-3)
    jspec = jwdl.WDLSpec(**dataclasses.asdict(spec))
    jconf, tconf = _confs({"Propagation": "ADAM", "LearningRate": 0.05},
                          epochs=5, bags=2)
    monkeypatch.setattr(ttrainer, "initial_params", lambda f, s, b:
                        _jax_stacked(jwdl.init_params, jspec, s, b))
    want = jstream.train_wdl_streaming(jconf, _chunks(dense, idx, y, w), n,
                                       jspec, seed=6, chunk_rows=100)
    got = tstream.train_wdl_streaming(tconf, _chunks(dense, idx, y, w), n,
                                      spec, seed=6, chunk_rows=100,
                                      device="cpu")
    _assert_results(got, want)


def test_streaming_mtl_matches_jax(monkeypatch):
    import jax.numpy as jnp
    rng = np.random.default_rng(74)
    n = 450
    x = rng.normal(0, 1, (n, 5)).astype(np.float32)
    y = np.stack([(x[:, 0] > 0), (x[:, 1] + x[:, 2] > 0)],
                 1).astype(np.float32)
    y[rng.random(n) < 0.25, 1] = np.nan
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    spec = tmtl.MTLSpec(input_dim=5, n_tasks=2, hidden_dims=(6, 4),
                        activations=("tanh", "relu"))
    jspec = jmtl.MTLSpec(**dataclasses.asdict(spec))
    jconf, tconf = _confs({"Propagation": "ADAM", "LearningRate": 0.05},
                          epochs=5, bags=2)
    monkeypatch.setattr(ttrainer, "initial_params", lambda f, s, b:
                        _jax_stacked(jmtl.init_params, jspec, s, b))

    def jloss(params, inputs, w_, key_):
        return jmtl.loss_fn(jspec, params, *inputs, w_)

    def jerr(params, inputs, w_):
        p = jmtl.forward(jspec, params, inputs[0])
        yv = inputs[1]
        valid = ~jnp.isnan(yv)
        e = jnp.where(valid, jnp.square(jnp.where(valid, yv, 0.0) - p), 0.0)
        return jnp.sum(e * w_[:, None])

    want = jstream.train_streaming_core(
        jconf, _chunks(x, y, w), n, seed=8, chunk_rows=90,
        init_fn=lambda k: jmtl.init_params(jspec, k), loss_fn=jloss,
        metric_sum_fn=jerr, spec=jspec,
        metric_mass_fn=lambda i, w_: jnp.sum((~jnp.isnan(i[1]))
                                             * w_[:, None]))
    got = tstream.train_streaming_core(
        tconf, _chunks(x, y, w), n, seed=8, chunk_rows=90,
        init_fn=lambda g: tmtl.init_params(spec, g),
        loss_fn=lambda p, i, w_, g: tmtl.loss_fn(spec, p, *i, w_),
        metric_sum_fn=lambda p, i, w_: tmtl.error_sum(spec, p, *i, w_),
        metric_mass_fn=lambda i, w_: tmtl.labelled_mass(i[1], w_),
        spec=spec, device="cpu")
    _assert_results(got, want)


# ---------------------------------------------------------------------------
# norm's streaming layout
# ---------------------------------------------------------------------------

def assert_layout(jax_root, port_root, zscored=True):
    for sub in ("CleanedData", "NormalizedData"):
        jdir = os.path.join(jax_root, "tmp", sub)
        tdir = os.path.join(port_root, "tmp", sub)
        names = sorted(f for f in os.listdir(jdir) if f.endswith(".npy"))
        assert sorted(f for f in os.listdir(tdir)
                      if f.endswith(".npy")) == names
        assert {"dense.npy", "tags.npy", "weights.npy"} <= set(names)
        for name in names:
            want = np.load(os.path.join(jdir, name))
            got = np.load(os.path.join(tdir, name))
            assert got.dtype == want.dtype and got.shape == want.shape, name
            if sub == "NormalizedData" and name == "dense.npy" and zscored:
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
        with open(os.path.join(jdir, "meta.json")) as f:
            want_meta = json.load(f)
        with open(os.path.join(tdir, "meta.json")) as f:
            got_meta = json.load(f)
        assert got_meta == want_meta
        assert got_meta["streaming"] and got_meta["shuffleSeed"] == 0x5F00D


@pytest.mark.parametrize("norm,precision", [("WOE", "FLOAT16"),
                                            ("ZSCALE_INDEX", "FLOAT32")])
def test_norm_layout_matches_jax(tmp_path, norm, precision):
    def edit(mc):
        mc["train"]["trainOnDisk"] = True
        mc["normalize"]["precisionType"] = precision
    root, tport = make_sets(tmp_path, 75, n_rows=600, norm_type=norm,
                            edit=edit)
    run_jax(root)
    run_port(tport)
    assert_layout(root, tport, zscored=norm != "WOE")
    dense = np.load(os.path.join(tport, "tmp", "NormalizedData",
                                 "dense.npy"))
    assert dense.dtype == (np.float16 if precision == "FLOAT16"
                           else np.float32)


def test_norm_layout_with_task_tags_matches_jax(tmp_path):
    root = made_set(tmp_path / "jax", "MTL", 76, n_rows=500, on_disk=True)
    tport = str(tmp_path / "port")
    import shutil
    shutil.copytree(root, tport)
    path = os.path.join(tport, "ModelConfig.json")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace(root, tport))
    run_port(tport, ("norm",))
    assert_layout(root, tport)
    tags = np.load(os.path.join(tport, "tmp", "NormalizedData",
                                "task_tags.npy"))
    assert tags.shape[1] == 2 and np.isnan(tags[:, 1]).any()


# ---------------------------------------------------------------------------
# the `train` verb with trainOnDisk
# ---------------------------------------------------------------------------

def _nn_set(tmp_dir, seed):
    from shifu_tpu.processor import init, norm, stats
    from shifu_tpu.processor.base import ProcessorContext
    from tests.synth import make_model_set
    from tests.test_torch_wdl_mtl import _edit
    root = make_model_set(tmp_dir, np.random.default_rng(seed), n_rows=600,
                          algorithm="NN", train_params={
                              "NumHiddenLayers": 1, "NumHiddenNodes": [6],
                              "ActivationFunc": ["tanh"],
                              "LearningRate": 0.05, "Propagation": "ADAM",
                              "ChunkRows": 128})

    def cut(mc):
        mc["train"].update(numTrainEpochs=5, baggingNum=2, trainOnDisk=True,
                           baggingWithReplacement=True,
                           baggingSampleRate=0.9)
    _edit(root, cut)
    for proc in (init, stats, norm):
        assert proc.run(ProcessorContext.load(root)) == 0
    return root


@pytest.mark.parametrize("alg", ["NN", "WDL", "MTL"])
def test_streaming_train_verb_matches_jax(tmp_path, capsys, monkeypatch,
                                          alg):
    from shifu_tpu.processor import train as jtrain
    from shifu_tpu.processor.base import ProcessorContext
    if alg == "NN":
        src = _nn_set(tmp_path / "src", 77)
    else:
        src = made_set(tmp_path / "src", alg, 78, n_rows=600, on_disk=True,
                       chunk_rows=128)
    want, got = pair(src, tmp_path)
    assert jtrain.run(ProcessorContext.load(want)) == 0
    if alg == "NN":
        from shifu_tpu.processor import norm as jnorm
        meta = jnorm.load_normalized_meta(os.path.join(
            got, "tmp", "NormalizedData"))
        with open(os.path.join(got, "ModelConfig.json")) as f:
            params = json.load(f)["train"]["params"]
        jspec = jnn.MLPSpec.from_train_params(params,
                                              len(meta["denseNames"]))
        monkeypatch.setattr(ttrainer, "initial_params", lambda f, s, b:
                            _jax_stacked(jnn.init_params, jspec, s, b))
    else:
        jax_initial(monkeypatch, got)
    line = port(got, "train", capsys=capsys)
    assert line["algorithm"] == alg and line["bags"] == 2
    assert_same_models(got, want)
    if alg == "NN":
        with open(os.path.join(got, "tmp", "valerr.json")) as f:
            got_v = json.load(f)
        with open(os.path.join(want, "tmp", "valerr.json")) as f:
            want_v = json.load(f)
        assert got_v["bestEpoch"] == want_v["bestEpoch"]
        np.testing.assert_allclose(got_v["bestValError"],
                                   want_v["bestValError"], rtol=1e-5)


def test_streaming_refusals(tmp_path, monkeypatch):
    """k-fold with trainOnDisk still raises; CheckpointInterval (refused
    until checkpoints were ported) trains the streaming NN, WDL and MTL
    through the `train` verb to the models of an uncheckpointed run;
    each route saved every interval, and its checkpoint directory is
    gone once its models are saved."""
    from shifu_tpu_torch.models.spec import load_model
    from shifu_tpu_torch.train import checkpoint as tckpt
    from tests.test_torch_wdl_mtl import _edit
    src = _nn_set(tmp_path / "src", 79)
    plain, got = pair(src, tmp_path)
    _edit(got, lambda mc: mc["train"].update(numKFold=3))
    with pytest.raises(ValueError, match="numKFold is not supported with "
                                         "trainOnDisk"):
        port(got, "train")
    _edit(got, lambda mc: mc["train"].update(numKFold=-1))
    mtl_src = made_set(tmp_path / "mtl_src", "MTL", 83, n_rows=600,
                       on_disk=True, chunk_rows=128)
    mtl = pair(mtl_src, tmp_path / "mtl")
    cleaned = []
    real = tstream.cleanup_checkpoints

    def cleanup(d):
        cleaned.append(d and (os.path.basename(d), tckpt.latest_step(d)))
        real(d)
    monkeypatch.setattr(tstream, "cleanup_checkpoints", cleanup)
    for alg, route, kind in (("NN", "streaming", "nn"),
                             ("WDL", "streaming-wdl", "wdl"),
                             ("MTL", "streaming-mtl", "mtl")):
        pl, gt = mtl if alg == "MTL" else (plain, got)
        _edit(gt, lambda mc: mc["train"]["params"].update(
            CheckpointInterval=2))
        for root in (pl, gt):
            _edit(root, lambda mc: mc["train"].update(algorithm=alg))
            port(root, "train")
        epochs = load_json(gt)["train"]["numTrainEpochs"]
        assert cleaned[-2:] == [None, (route, epochs - epochs % 2)], cleaned
        assert not os.path.exists(os.path.join(gt, "tmp", "checkpoints",
                                               "bag0", route))
        for b in range(2):
            name = f"model{b}.{kind}"
            pg = jax.tree.leaves(load_model(os.path.join(
                gt, "models", name))[2])
            pw = jax.tree.leaves(load_model(os.path.join(
                pl, "models", name))[2])
            assert len(pg) == len(pw) > 0
            for a, w in zip(pg, pw):
                np.testing.assert_array_equal(a, w)


def load_json(root):
    with open(os.path.join(root, "ModelConfig.json")) as f:
        return json.load(f)


def test_new_entry_points_default_to_the_card(monkeypatch):
    """The streaming trainers and the WDL/MTL scorers take the card
    unless told otherwise, and raise without one."""
    rng = np.random.default_rng(80)
    x = rng.normal(0, 1, (40, 3)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    w = np.ones(40, np.float32)
    _, tconf = _confs({"Propagation": "ADAM"}, epochs=1, bags=1)
    spec = twdl.WDLSpec(dense_dim=3, n_cat=0, vocab_size=1,
                        hidden_dims=(4,), activations=("relu",))
    params = ttrainer.tree_map(lambda v: v.numpy(), twdl.init_params(
        spec, torch.Generator().manual_seed(0)))
    mspec = tmtl.MTLSpec(input_dim=3, n_tasks=2, hidden_dims=(4,),
                         activations=("relu",))
    mparams = ttrainer.tree_map(lambda v: v.numpy(), tmtl.init_params(
        mspec, torch.Generator().manual_seed(0)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tstream.train_nn_streaming(tconf, _chunks(x, y, w), 40, 3)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tstream.train_wdl_streaming(
            tconf, _chunks(x, np.zeros((40, 0), np.int32), y, w), 40, spec)
    with pytest.raises(RuntimeError, match="no CUDA"):
        twdl.predict({"spec": dataclasses.asdict(spec)}, params, x, None)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tmtl.predict({"spec": dataclasses.asdict(mspec)}, mparams, x)
