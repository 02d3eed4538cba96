"""Port parity for `train/trainer.py`: the port's `train_nn` against the
JAX package's `train_nn` on the same rows, with the same initial
parameters (`jax.random` and torch generators differ, so the JAX
package's own per-bag init — `vmap(init_params)` over
`split(PRNGKey(seed), bags + 1)[:-1]`, exactly what its `train_nn`
draws — is handed to the port as bag-stacked `init_params`).

At small widths (8 inputs, 6 → 4 hidden, 2 bags, Poisson bagging,
≤ 10 epochs) and f32, both packages add the same products in other
orders (the JAX side also shards rows over the tests' 8 CPU devices):
train and validation curves and the best parameters within 1e-5
relative (of each array's largest entry), best epochs and the stop
epochs equal. That holds for every Propagation here, RPROP and QuickProp
included: on the CPU, over ten epochs, no gradient entry sits close
enough to zero for the sign-driven rules to part (on the card they may;
`chip_smoke.py` gates those by metrics). bf16 rounds every stored
activation and cotangent to 2^-8: curves within 1e-3, params within
1e-2 of their largest entry.

Also covered: window and convergence stops (a stopped bag's params and
optimizer state freeze), FixedLayers and an element-wise grad_mask,
validSetRate 0, mini-batch mode with the JAX package's batch order
replayed, the epoch loop's not reading any tensor on the host, the
checkpoint refusal and the card default.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from shifu_tpu.config.model_config import ModelTrainConf as JConf
from shifu_tpu.models import nn as jnn
from shifu_tpu.train import trainer as jtrainer
from shifu_tpu_torch.config.model_config import ModelTrainConf as TConf
from shifu_tpu_torch.models import nn as tnn
from shifu_tpu_torch.train import trainer as ttrainer

BASE = {"NumHiddenLayers": 2, "NumHiddenNodes": [6, 4],
        "ActivationFunc": ["tanh", "sigmoid"], "LearningRate": 0.1}


def _data(seed, n=320, c=8, n_classes=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, c)).astype(np.float32)
    logit = x[:, 0] - 0.7 * x[:, 1] + 0.4 * x[:, 2] * x[:, 3]
    if n_classes > 1:
        y = np.digitize(logit + rng.normal(0, 0.3, n),
                        [-0.5, 0.5]).astype(np.float32)
    else:
        y = (logit + rng.normal(0, 0.5, n) > 0).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return x, y, w


def _confs(params, epochs=8, bags=2, **kw):
    out = []
    for cls in (JConf, TConf):
        conf = cls()
        conf.params = dict(params)
        conf.numTrainEpochs = epochs
        conf.baggingNum = bags
        conf.validSetRate = 0.2
        conf.baggingSampleRate = 0.9
        conf.baggingWithReplacement = True
        for k, v in kw.items():
            setattr(conf, k, v)
        out.append(conf)
    return out


def jax_init(spec, seed, n_bags):
    """The JAX train_nn's own initial params, bag-stacked numpy."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_bags + 1)
    jspec = jnn.MLPSpec(**dataclasses.asdict(spec))
    return jax.tree.map(np.asarray, jax.vmap(
        lambda k: jnn.init_params(jspec, k))(keys[:-1]))


def jax_batch_order(seed, n_bags, n_epochs, n_batches):
    """The JAX trainer's mini-batch order (epochs, bags, batches): each
    bag's key splits once for the epoch, once for the permutation, once
    a batch (`train_bags_carry`)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_bags + 1)[:-1]
    out = np.zeros((n_epochs, n_bags, n_batches), np.int64)
    for b in range(n_bags):
        key = keys[b]
        for e in range(n_epochs):
            key, _ = jax.random.split(key)
            key, pkey = jax.random.split(key)
            out[e, b] = np.asarray(jax.random.permutation(pkey, n_batches))
            for _ in range(n_batches):
                key, _ = jax.random.split(key)
    return out


def both(params, data, seed=5, epochs=8, bags=2, spec_kw=None,
         jax_kw=None, port_kw=None, **conf_kw):
    x, y, w = data
    jconf, tconf = _confs(params, epochs, bags, **conf_kw)
    spec = tnn.MLPSpec.from_train_params(params, x.shape[1])
    if spec_kw:
        spec = dataclasses.replace(spec, **spec_kw)
    jspec = jnn.MLPSpec(**dataclasses.asdict(spec))
    jr = jtrainer.train_nn(jconf, x, y, w, seed=seed, spec=jspec,
                           **(jax_kw or {}))
    port_kw = dict(port_kw or {})
    port_kw.setdefault("init_params", jax_init(spec, seed, max(bags, 1)))
    tr = ttrainer.train_nn(tconf, x, y, w, seed=seed, spec=spec,
                           device="cpu", **port_kw)
    return jr, tr


def _rel(got, want, rel, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def check(jr, tr, rel=1e-5, prel=None):
    _rel(tr.train_errors, jr.train_errors, rel, "train errors")
    _rel(tr.val_errors, jr.val_errors, rel, "val errors")
    _rel(tr.best_val, jr.best_val, rel, "best val")
    np.testing.assert_array_equal(tr.best_epoch, jr.best_epoch)
    assert len(tr.params_per_bag) == len(jr.params_per_bag)
    for got, want in zip(tr.params_per_bag, jr.params_per_bag):
        for gl, wl in zip(got, want):
            for k in wl:
                assert gl[k].shape == np.asarray(wl[k]).shape
                _rel(gl[k], wl[k], prel or rel, k)


@pytest.mark.parametrize("prop,decay", [
    ("B", 0.0), ("M", 0.02), ("N", 0.0), ("ADAM", 0.02), ("ADAGRAD", 0.0),
    ("RMSPROP", 0.0), ("R", 0.0), ("Q", 0.0)])
def test_train_nn_matches_jax_for_every_propagation(prop, decay):
    params = dict(BASE, Propagation=prop, LearningDecay=decay,
                  RegularizedConstant=0.001)
    jr, tr = both(params, _data(1))
    assert tr.train_errors.shape == (2, 8)
    check(jr, tr)


def test_softmax_head_and_log_loss_match_jax():
    params = dict(BASE, Propagation="ADAM", LearningRate=0.05)
    jr, tr = both(params, _data(2, n_classes=3), epochs=6,
                  spec_kw={"output_dim": 3, "output_activation": "softmax",
                           "loss": "log"})
    assert tr.params_per_bag[0][-1]["w"].shape == (4, 3)
    check(jr, tr)


def test_window_and_convergence_stops_freeze_a_bag():
    """Window 2 with a rate that overshoots, then a convergence bound
    one bag reaches first: the curves after a stop repeat the frozen
    params' errors, and both packages stop the same bags at the same
    epochs."""
    params = dict(BASE, Propagation="M", LearningRate=2.0)
    jr, tr = both(params, _data(3), epochs=10, earlyStoppingRounds=2)
    check(jr, tr)
    frozen = np.diff(tr.val_errors, axis=1) == 0
    assert frozen.any() and not frozen[:, 0].any(), "no window stop"
    params = dict(BASE, Propagation="ADAM", LearningRate=0.05)
    jr0, _ = both(params, _data(4), epochs=10)
    bound = float(np.sort(jr0.train_errors[:, 5])[0]) * 1.0001
    jr, tr = both(params, _data(4), epochs=10, convergenceThreshold=bound)
    check(jr, tr)
    assert (np.diff(tr.train_errors, axis=1) == 0).any()


def test_fixed_layers_and_grad_mask_match_jax():
    params = dict(BASE, Propagation="M")
    spec = tnn.MLPSpec.from_train_params(params, 8)
    init = jax_init(spec, 5, 2)
    one = [{k: v[0] for k, v in l.items()} for l in init]
    # continuous training hands the JAX trainer one network's params
    jr, tr = both(params, _data(6), jax_kw={"init_params": one,
                                            "fixed_layers": [1]},
                  port_kw={"init_params": one, "fixed_layers": [1]})
    check(jr, tr)
    for bag in tr.params_per_bag:
        np.testing.assert_array_equal(bag[0]["w"], one[0]["w"])
        assert not np.array_equal(bag[1]["w"], one[1]["w"])
    rng = np.random.default_rng(7)
    mask = [{k: (rng.random(np.shape(v)) < 0.5).astype(np.float32)
             for k, v in l.items()} for l in one]
    jr, tr = both(params, _data(6), jax_kw={"init_params": one,
                                            "grad_mask": mask},
                  port_kw={"init_params": one, "grad_mask": mask})
    check(jr, tr)
    frozen = mask[0]["w"] == 0
    np.testing.assert_array_equal(tr.params_per_bag[1][0]["w"][frozen],
                                  one[0]["w"][frozen])


def test_bf16_compute_matches_jax():
    params = dict(BASE, Propagation="ADAM", ComputeDtype="bfloat16",
                  LearningRate=0.05)
    jr, tr = both(params, _data(8), epochs=6)
    assert tr.spec.compute_dtype == "bfloat16"
    check(jr, tr, rel=1e-3, prel=1e-2)


def test_no_validation_set_matches_jax():
    params = dict(BASE, Propagation="ADAGRAD")
    jr, tr = both(params, _data(9), epochs=5, validSetRate=0.0)
    assert (tr.val_errors == 0).all()
    check(jr, tr)


@pytest.mark.parametrize("batch_rows", [64, 100])
def test_mini_batches_in_the_jax_order_match_jax(batch_rows):
    params = dict(BASE, Propagation="ADAM", LearningRate=0.05,
                  MiniBatchRows=batch_rows)
    data = _data(10)
    n_train = int(ttrainer.split_validation(len(data[1]), 0.2, 5)[0].sum())
    n_batches = -(-n_train // batch_rows)
    order = jax_batch_order(5, 2, 6, n_batches)
    jr, tr = both(params, data, epochs=6,
                  port_kw={"batch_order": order})
    check(jr, tr)
    # the port's own order (a CPU generator seeded by the train seed)
    # is a permutation an epoch and a bag, the same on every call
    again = [ttrainer.train_nn(_confs(params, 2)[1], *data, seed=5,
                               device="cpu") for _ in range(2)]
    np.testing.assert_array_equal(again[0].train_errors,
                                  again[1].train_errors)


def test_epoch_loop_never_reads_a_tensor_on_the_host(monkeypatch):
    """Errors, stops and the best tracker stay tensors until the run
    ends: no `.item()`, `bool(t)`, `.cpu()`, `.numpy()`, `.tolist()`
    inside `train_bags_carry` (on the card each would wait for it)."""
    orig = ttrainer.train_bags_carry
    calls = []

    def refuse(name):
        def fn(*_a, **_k):
            raise AssertionError(f"host read {name} in the epoch loop")
        return fn

    def guarded(*args, **kw):
        calls.append(1)
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "numpy", "cpu", "__bool__",
                         "__float__", "__int__"):
                m.setattr(torch.Tensor, name, refuse(name))
            return orig(*args, **kw)

    monkeypatch.setattr(ttrainer, "train_bags_carry", guarded)
    params = dict(BASE, Propagation="Q", MiniBatchRows=100,
                  DropoutRate=0.2)
    conf = _confs(params, 4, 2, earlyStoppingRounds=1,
                  convergenceThreshold=0.2)[1]
    x, y, w = _data(11, n_classes=3)
    spec = dataclasses.replace(
        tnn.MLPSpec.from_train_params(params, 8), output_dim=3,
        output_activation="softmax", loss="log")
    res = ttrainer.train_nn(conf, x, y, w, seed=3, spec=spec, device="cpu")
    assert calls and res.val_errors.shape == (2, 4)


def test_checkpoints_refused_and_the_card_is_the_default(monkeypatch):
    conf = _confs(BASE)[1]
    x, y, w = _data(12, n=40)
    with pytest.raises(NotImplementedError, match="A8"):
        ttrainer.train_nn(conf, x, y, w, device="cpu",
                          checkpoint_dir="ck", checkpoint_interval=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        ttrainer.train_nn(conf, x, y, w)
