"""Port parity for the WDL and MTL model families and their `train`,
`eval` and `posttrain` paths.

The model functions (forward, loss, mse, and their gradients), one
model's params and bag-stacked ones, are held against the JAX package's
on the same numpy inputs (a private `np.random.default_rng` each).
Then synth model sets (`tests/synth.py`) made by the JAX package's
`init → stats → norm` — WDL over ZSCALE_INDEX, MTL with a second task
whose tag is missing on some rows — are copied twice; the JAX `train`
runs on one copy and the port's `train --device cpu` on the other,
the port handed the JAX package's initial parameters through
`monkeypatch` (`trainer.initial_params`; `jax.random` and torch
generators differ). Gates: every model file has the JAX file's kind and
meta and its arrays within 1e-5 of each array's largest entry (f32, ≤ 8
epochs, as the NN trainer is held), the JAX package's `load_model`
reads the port's files, and `eval` and `posttrain` of the JAX-trained
model files give the JAX package's outputs (scores within 1e-6, the
bucket rules of `chip_smoke.compare_eval_dir`; importance within 1e-5
relative). The embedding rows of ids no training row uses keep their
initial values.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from shifu_tpu.models import mtl as jmtl
from shifu_tpu.models import wdl as jwdl
from shifu_tpu_torch import cli
from shifu_tpu_torch.models import mtl as tmtl
from shifu_tpu_torch.models import wdl as twdl
from shifu_tpu_torch.train import trainer as ttrainer

WDL_PARAMS = {"NumHiddenNodes": [8], "ActivationFunc": ["relu"],
              "EmbedSize": 4, "LearningRate": 0.05, "Propagation": "ADAM"}
MTL_PARAMS = {"NumHiddenNodes": [8, 6], "ActivationFunc": ["tanh"],
              "LearningRate": 0.05, "Propagation": "ADAM"}


def _t(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a, np.float32)),
                        tree)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _close(got, want, rel=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) <= rel * scale, \
        float(np.max(np.abs(got - want))) / scale


def _wdl_case(seed, l2=0.0, n=40):
    rng = np.random.default_rng(seed)
    spec = twdl.WDLSpec(dense_dim=5, n_cat=3, vocab_size=7, embed_size=4,
                        hidden_dims=(8, 4), activations=("relu", "tanh"),
                        l2=l2)
    jspec = jwdl.WDLSpec(**dataclasses.asdict(spec))
    dense = rng.normal(0, 1, (n, 5)).astype(np.float32)
    idx = rng.integers(-1, 9, (n, 3)).astype(np.int32)   # clamped ids too
    y = (rng.random(n) < 0.4).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return spec, jspec, dense, idx, y, w


@pytest.mark.parametrize("l2", [0.0, 0.01])
def test_wdl_functions_match_jax(l2):
    spec, jspec, dense, idx, y, w = _wdl_case(1, l2)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    bags = [_np(jwdl.init_params(jspec, k)) for k in keys]
    jd, ji, jy, jw = map(jnp.asarray, (dense, idx, y, w))
    td, ti, ty, tw = map(torch.as_tensor, (dense, idx, y, w))
    stacked = ttrainer.stack_params(bags)
    got_p = twdl.forward(spec, stacked, td, ti)
    for b, params in enumerate(bags):
        jp = jax.tree.map(jnp.asarray, params)
        _close(twdl.forward(spec, _t(params), td, ti),
               jwdl.forward(jspec, jp, jd, ji))
        _close(got_p[b], jwdl.forward(jspec, jp, jd, ji))
        _close(twdl.loss_fn(spec, _t(params), td, ti, ty, tw),
               jwdl.loss_fn(jspec, jp, jd, ji, jy, jw))
        _close(twdl.mse(spec, _t(params), td, ti, ty, tw),
               jwdl.mse(jspec, jp, jd, ji, jy, jw))
        # gradients, bag by bag, through the stacked loss
        jg = jax.grad(lambda p: jwdl.loss_fn(jspec, p, jd, ji, jy, jw))(jp)
        leaves = [v.clone().requires_grad_(True)
                  for v in ttrainer._flat(stacked)]
        tw_bags = torch.stack([tw, tw])
        loss = twdl.loss_fn(spec, ttrainer._unflat(stacked, leaves), td, ti,
                            ty, tw_bags)
        grads = ttrainer._unflat(stacked, torch.autograd.grad(loss.sum(),
                                                              leaves))
        for g, want in zip(ttrainer._flat(grads), ttrainer._flat(_np(jg))):
            _close(g[b], want, 1e-5)


def test_mtl_functions_match_jax():
    rng = np.random.default_rng(2)
    spec = tmtl.MTLSpec(input_dim=6, n_tasks=3, hidden_dims=(8, 5),
                        activations=("tanh", "relu"), l2=0.01)
    jspec = jmtl.MTLSpec(**dataclasses.asdict(spec))
    x = rng.normal(0, 1, (30, 6)).astype(np.float32)
    y = (rng.random((30, 3)) < 0.5).astype(np.float32)
    y[rng.random((30, 3)) < 0.3] = np.nan
    w = rng.uniform(0.5, 2.0, 30).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    bags = [_np(jmtl.init_params(jspec, k)) for k in keys]
    stacked = ttrainer.stack_params(bags)
    tx, ty, tw = map(torch.as_tensor, (x, y, w))
    got = tmtl.forward(spec, stacked, tx)
    for b, params in enumerate(bags):
        jp = jax.tree.map(jnp.asarray, params)
        want = jmtl.forward(jspec, jp, jnp.asarray(x))
        _close(got[b], want)
        _close(tmtl.forward(spec, _t(params), tx), want)
        _close(tmtl.loss_fn(spec, _t(params), tx, ty, tw),
               jmtl.loss_fn(jspec, jp, jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(w)))
        _close(tmtl.mse(spec, _t(params), tx, ty, tw),
               jmtl.mse(jspec, jp, jnp.asarray(x), jnp.asarray(y),
                        jnp.asarray(w)))
        jg = jax.grad(lambda p: jmtl.loss_fn(
            jspec, p, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)))(jp)
        leaves = [v.clone().requires_grad_(True)
                  for v in ttrainer._flat(stacked)]
        loss = tmtl.loss_fn(spec, ttrainer._unflat(stacked, leaves), tx, ty,
                            torch.stack([tw, tw]))
        grads = torch.autograd.grad(loss.sum(), leaves)
        assert all(torch.isfinite(g).all() for g in grads)
        for g, want in zip(grads, ttrainer._flat(_np(jg))):
            _close(g[b], want, 1e-5)
    _close(tmtl.predict({"spec": dataclasses.asdict(spec)}, bags[0], x,
                        device="cpu"),
           jmtl.predict({"spec": dataclasses.asdict(jspec)}, bags[0], x))


# ---------------------------------------------------------------------------
# the train / eval / posttrain verbs
# ---------------------------------------------------------------------------

def _edit(root, fn):
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as f:
        mc = json.load(f)
    fn(mc)
    with open(path, "w") as f:
        json.dump(mc, f, indent=2)


def add_second_task(root, rng, gap_rate=0.2):
    """A second tag column (`second_tag`, from num_0, missing on some
    rows) in the raw data and eval data; the targets become
    `diagnosis|second_tag`."""
    for sub in ("data", "evaldata"):
        hpath = os.path.join(root, sub, ".pig_header")
        dpath = os.path.join(root, sub, "part-00000")
        with open(hpath) as f:
            header = f.read().strip().split("|")
        with open(dpath) as f:
            rows = [line.rstrip("\n").split("|") for line in f if line.strip()]
        j = header.index("num_0")
        vals = np.array([float(r[j]) if r[j] != "?" else 0.0 for r in rows])
        tag = np.where(vals > np.median(vals), "M", "B")
        tag[rng.random(len(rows)) < gap_rate] = "?"
        with open(dpath, "w") as f:
            for r, t in zip(rows, tag):
                f.write("|".join(r + [t]) + "\n")
        with open(hpath, "w") as f:
            f.write("|".join(header + ["second_tag"]) + "\n")
    _edit(root, lambda mc: mc["dataSet"].update(
        targetColumnName="diagnosis|second_tag"))


def made_set(tmp_dir, alg, seed, n_rows=700, on_disk=False, chunk_rows=0):
    """A synth set through the JAX package's init → stats → norm."""
    from shifu_tpu.processor import init, norm, stats
    from shifu_tpu.processor.base import ProcessorContext
    from tests.synth import make_model_set
    rng = np.random.default_rng(seed)
    params = dict(WDL_PARAMS if alg == "WDL" else MTL_PARAMS)
    if chunk_rows:
        params["ChunkRows"] = chunk_rows
    root = make_model_set(
        tmp_dir, rng, n_rows=n_rows, algorithm=alg,
        norm_type="ZSCALE_INDEX" if alg == "WDL" else "ZSCALE",
        train_params=params)
    if alg == "MTL":
        add_second_task(root, rng)

    def cut(mc):
        mc["train"]["numTrainEpochs"] = 6
        mc["train"]["baggingNum"] = 2
        mc["train"]["baggingWithReplacement"] = True
        mc["train"]["baggingSampleRate"] = 0.9
        mc["train"]["trainOnDisk"] = on_disk
    _edit(root, cut)
    for proc in (init, stats, norm):
        assert proc.run(ProcessorContext.load(root)) == 0
    return root


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    made = {}

    def get(alg):
        if alg not in made:
            made[alg] = made_set(tmp_path_factory.mktemp(alg), alg,
                                 {"WDL": 81, "MTL": 82}[alg])
        return made[alg]
    return get


def pair(src, tmp_path):
    out = []
    for side in ("jax", "port"):
        dst = str(tmp_path / side)
        shutil.copytree(src, dst)
        path = os.path.join(dst, "ModelConfig.json")
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(text.replace(src, dst))
        out.append(dst)
    return out


def port(root, *args, capsys=None):
    assert cli.main(["--dir", root, *args, "--device", "cpu"]) == 0
    if capsys is not None:
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return None


def jax_initial(monkeypatch, root):
    """The port's WDL/MTL trainers draw the JAX package's initial
    params: the JAX `vmap(init_params)` over the split train seed, for
    the spec the JAX step derives from the same set."""
    from shifu_tpu.processor import norm as jnorm
    from shifu_tpu.processor.base import ProcessorContext
    ctx = ProcessorContext.load(root)
    mc = ctx.model_config
    path = ctx.path_finder.normalized_data_path()
    meta = jnorm.load_normalized_meta(path)
    dense_dim = len(meta["denseNames"])
    if mc.train.algorithm.value == "WDL":
        spec = jwdl.WDLSpec.from_train_params(
            mc.train.params, dense_dim, len(meta["indexNames"]),
            max(meta["indexVocabSizes"], default=1))
        init = jwdl.init_params
    else:
        n_tasks = len(mc.dataSet.targetColumnName.split("|"))
        spec = jmtl.MTLSpec.from_train_params(mc.train.params, dense_dim,
                                              n_tasks)
        init = jmtl.init_params

    def initial_params(init_fn, seed, n_bags):
        keys = jax.random.split(jax.random.PRNGKey(seed), n_bags)
        return _t(jax.vmap(lambda k: init(spec, k))(keys))
    monkeypatch.setattr(ttrainer, "initial_params", initial_params)
    return initial_params


def model_files(root):
    d = os.path.join(root, "models")
    return sorted(os.listdir(d))


def assert_same_models(got_root, want_root, rel=1e-5):
    from shifu_tpu.models.spec import load_model as jload
    names = model_files(want_root)
    assert model_files(got_root) == names and names
    for name in names:
        kg, mg, pg = jload(os.path.join(got_root, "models", name))
        kw, mw, pw = jload(os.path.join(want_root, "models", name))
        assert kg == kw and mg == mw
        lg, lw = jax.tree.leaves(pg), jax.tree.leaves(pw)
        assert len(lg) == len(lw)
        for a, b in zip(lg, lw):
            _close(a, b, rel)


@pytest.mark.parametrize("alg", ["WDL", "MTL"])
def test_train_matches_jax(sets, tmp_path, capsys, monkeypatch, alg):
    from shifu_tpu.processor import train as jtrain
    from shifu_tpu.processor.base import ProcessorContext
    want, got = pair(sets(alg), tmp_path)
    assert jtrain.run(ProcessorContext.load(want)) == 0
    jax_initial(monkeypatch, got)
    line = port(got, "train", capsys=capsys)
    assert line["algorithm"] == alg and line["device"] == "cpu"
    assert line["bags"] == 2 and line["epochs"] == 6
    assert_same_models(got, want)


@pytest.mark.parametrize("alg", ["WDL", "MTL"])
def test_eval_and_posttrain_match_jax(sets, tmp_path, capsys, alg):
    """Both packages score the JAX-trained model files."""
    from shifu_tpu.processor import eval as jeval
    from shifu_tpu.processor import posttrain as jpost
    from shifu_tpu.processor import train as jtrain
    from shifu_tpu.processor.base import ProcessorContext
    want, got = pair(sets(alg), tmp_path)
    assert jtrain.run(ProcessorContext.load(want)) == 0
    shutil.rmtree(os.path.join(got, "models"), ignore_errors=True)
    shutil.copytree(os.path.join(want, "models"), os.path.join(got, "models"))
    assert jeval.run(ProcessorContext.load(want)) == 0
    line = port(got, "eval", capsys=capsys)
    assert line["rows"] > 0
    out = cs.compare_eval_dir(got, want, "Eval1", 1e-6)
    assert out["auc_err"] <= 1e-6, out
    assert jpost.run(ProcessorContext.load(want)) == 0
    port(got, "posttrain")
    print(alg, cs.compare_posttrain(got, want, 1e-5, 1e-6))


def test_unused_embedding_rows_keep_their_initial_values():
    """Ids no training row uses get a zero gradient, so under ADAM their
    embedding rows stay where they started (no L2)."""
    from shifu_tpu_torch.train.optimizers import optimizer_from_params
    rng = np.random.default_rng(5)
    spec = twdl.WDLSpec(dense_dim=3, n_cat=2, vocab_size=9, embed_size=4,
                        hidden_dims=(6,), activations=("relu",))
    n = 200
    dense = rng.normal(0, 1, (n, 3)).astype(np.float32)
    idx = rng.integers(0, 5, (n, 2)).astype(np.int32)   # ids 5..8 unused
    y = (rng.random(n) < 0.5).astype(np.float32)
    stacked = ttrainer.initial_params(
        lambda g: twdl.init_params(spec, g), 7, 2)
    before = stacked["embed"].clone()
    ones = torch.ones_like
    best, errs, _, _, _ = ttrainer.train_bags(
        lambda p, i, w, g: twdl.loss_fn(spec, p, *i, w),
        lambda p, i, w: twdl.mse(spec, p, *i, w),
        optimizer_from_params({"Propagation": "ADAM", "LearningRate": 0.1}),
        5, 0, 0.0, stacked,
        (dense, idx, y), np.ones((2, n), np.float32), (dense, idx, y),
        np.ones(n, np.float32),
        ttrainer.tree_map(lambda v: ones(v[0]), stacked), device="cpu")
    after = best["embed"]
    assert torch.equal(after[:, :, 5:], before[:, :, 5:])
    assert not torch.equal(after[:, :, :5], before[:, :, :5])
