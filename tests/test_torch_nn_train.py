"""Port parity for the training half of `models/nn.py`.

The port's `forward` / `loss_fn` / `mse` and their gradients against
the JAX package's (`jax.value_and_grad`) on the same numpy params and
rows, for every activation, every loss, the multi-class softmax head,
L1/L2 and both compute dtypes. Tolerances: f32 values within rtol 1e-5
(atol 1e-6) and gradients within 1e-5 of the largest gradient entry —
the two packages add the same products in other orders. bf16 widens
bf16 operands into f32 products in both packages, but a product's
cotangent is rounded back to bf16 at each cast, where one ulp of f32
order noise can move a value by one bf16 ulp (2^-8 relative): values
within rtol 1e-3, gradients within 2e-2 of the largest entry.

The bag-stacked forms (params (B, in, out)) are held against a loop over
the bags: the stacked loss is each bag's own loss, and one backward of
their sum gives each bag its own gradient. Also: `init_params`'
distributions, dropout's keep rate and 1/(1 − p) scale, `MLPSpec.
from_train_params` and the compute-dtype precedence, `compare_structure`
and `absorb_params` against the JAX package's.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shifu_tpu.models import nn as jnn
from shifu_tpu_torch.models import nn as tnn

ACTS = ["sigmoid", "tanh", "relu", "leakyrelu", "swish", "gaussian", "log",
        "sin", "linear", "ptanh"]


def _params(rng, dims, n_bags=None):
    lead = () if n_bags is None else (n_bags,)
    return [{"w": rng.normal(0, 0.6, lead + (a, b)).astype(np.float32),
             "b": rng.normal(0, 0.2, lead + (b,)).astype(np.float32)}
            for a, b in zip(dims[:-1], dims[1:])]


def _specs(**kw):
    return jnn.MLPSpec(**kw), tnn.MLPSpec(**kw)


def _torch(params):
    return [{k: torch.tensor(v, requires_grad=True) for k, v in l.items()}
            for l in params]


def _data(rng, n, c, n_classes=1):
    x = rng.normal(0, 1, (n, c)).astype(np.float32)
    if n_classes > 1:
        y = rng.integers(0, n_classes, n).astype(np.float32)
    else:
        y = (rng.random(n) < 0.4).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return x, y, w


def _value_and_grads(jspec, tspec, params, x, y, w):
    jl, jg = jax.value_and_grad(
        lambda p: jnn.loss_fn(jspec, p, jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(w)))(
        jax.tree.map(jnp.asarray, params))
    tp = _torch(params)
    tl = tnn.loss_fn(tspec, tp, torch.tensor(x), torch.tensor(y),
                     torch.tensor(w))
    tl.backward()
    return (float(jl), jax.tree.map(np.asarray, jg), float(tl.detach()),
            [{k: v.grad.numpy() for k, v in l.items()} for l in tp])


def _check_grads(got, want, rel):
    scale = max(float(np.abs(l[k]).max()) for l in want for k in l)
    for gl, wl in zip(got, want):
        for k in wl:
            np.testing.assert_allclose(gl[k], wl[k], rtol=0,
                                       atol=rel * scale, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_forward_loss_and_gradients_match_jax(act, dtype):
    rng = np.random.default_rng(ACTS.index(act) + 10 * (dtype == "bfloat16"))
    dims = [7, 6, 5, 1]
    jspec, tspec = _specs(input_dim=7, hidden_dims=(6, 5),
                          activations=(act, "tanh"), loss="squared",
                          compute_dtype=dtype)
    params = _params(rng, dims)
    x, y, w = _data(rng, 64, 7)
    x[:, 0] = np.abs(x[:, 0]) + 0.1       # log's both branches
    rtol, grel = (1e-5, 1e-5) if dtype == "float32" else (1e-3, 2e-2)
    want = np.asarray(jnn.forward(jspec, jax.tree.map(jnp.asarray, params),
                                  jnp.asarray(x)))
    with torch.no_grad():
        got = tnn.forward(tspec, _torch(params), torch.tensor(x)).numpy()
    assert got.shape == (64,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)
    jl, jg, tl, tg = _value_and_grads(jspec, tspec, params, x, y, w)
    assert math.isclose(tl, jl, rel_tol=rtol, abs_tol=1e-7)
    _check_grads(tg, jg, grel)
    with torch.no_grad():
        got = tnn.mse(tspec, _torch(params), torch.tensor(x),
                      torch.tensor(y), torch.tensor(w))
    want = jnn.mse(jspec, jax.tree.map(jnp.asarray, params),
                   jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    assert math.isclose(float(got), float(want), rel_tol=rtol)


@pytest.mark.parametrize("seed,loss,l1,l2,n_classes", [
    (30, "squared", 0.0, 0.01, 1), (31, "log", 0.0, 0.0, 1),
    (32, "absolute", 0.02, 0.0, 1), (33, "log", 0.0, 0.01, 3),
    (34, "squared", 0.01, 0.0, 4)])
def test_losses_regularizers_and_softmax_head_match_jax(seed, loss, l1, l2,
                                                        n_classes):
    rng = np.random.default_rng(seed)
    head = {} if n_classes == 1 else {"output_dim": n_classes,
                                      "output_activation": "softmax"}
    jspec, tspec = _specs(input_dim=5, hidden_dims=(4,),
                          activations=("relu",), loss=loss, l1=l1, l2=l2,
                          **head)
    params = _params(rng, [5, 4, n_classes])
    x, y, w = _data(rng, 48, 5, n_classes)
    jl, jg, tl, tg = _value_and_grads(jspec, tspec, params, x, y, w)
    assert math.isclose(tl, jl, rel_tol=1e-5)
    _check_grads(tg, jg, 1e-5)
    with torch.no_grad():
        got = tnn.mse(tspec, _torch(params), torch.tensor(x),
                      torch.tensor(y), torch.tensor(w))
        pred = tnn.forward(tspec, _torch(params), torch.tensor(x)).numpy()
    want = jnn.mse(jspec, jax.tree.map(jnp.asarray, params),
                   jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    assert math.isclose(float(got), float(want), rel_tol=1e-5)
    assert pred.shape == ((48,) if n_classes == 1 else (48, n_classes))


@pytest.mark.parametrize("shared_rows", [True, False])
@pytest.mark.parametrize("n_classes", [1, 3])
def test_bag_stacked_loss_is_each_bags_own(shared_rows, n_classes):
    """One backward of the summed (B,) losses = each bag's own gradient,
    over rows shared by the bags (full batch) or a batch a bag."""
    rng = np.random.default_rng(7 + n_classes + 2 * shared_rows)
    n_bags = 3
    head = {} if n_classes == 1 else {"output_dim": n_classes,
                                      "output_activation": "softmax"}
    spec = tnn.MLPSpec(input_dim=6, hidden_dims=(5, 4),
                       activations=("tanh", "sigmoid"), loss="log", l2=0.01,
                       l1=0.005, **head)
    stacked = _params(rng, [6, 5, 4, n_classes], n_bags)
    if shared_rows:
        x, y, _ = _data(rng, 40, 6, n_classes)
        xs, ys = [x] * n_bags, [y] * n_bags
        tx, ty = torch.tensor(x), torch.tensor(y)
    else:
        parts = [_data(rng, 40, 6, n_classes) for _ in range(n_bags)]
        xs, ys = [p[0] for p in parts], [p[1] for p in parts]
        tx, ty = torch.tensor(np.stack(xs)), torch.tensor(np.stack(ys))
    w = rng.poisson(1.0, (n_bags, 40)).astype(np.float32)
    tp = _torch(stacked)
    losses = tnn.loss_fn(spec, tp, tx, ty, torch.tensor(w))
    assert losses.shape == (n_bags,)
    losses.sum().backward()
    for b in range(n_bags):
        one = _torch([{k: v[b] for k, v in l.items()} for l in stacked])
        loss = tnn.loss_fn(spec, one, torch.tensor(xs[b]),
                           torch.tensor(ys[b]), torch.tensor(w[b]))
        loss.backward()
        assert math.isclose(float(losses[b].detach()), float(loss.detach()),
                            rel_tol=1e-6)
        for sl, ol in zip(tp, one):
            for k in ol:
                np.testing.assert_allclose(sl[k].grad[b].numpy(),
                                           ol[k].grad.numpy(), rtol=1e-5,
                                           atol=1e-7)
        with torch.no_grad():
            got = tnn.mse(spec, tp, tx, ty, torch.tensor(w))[b]
            want = tnn.mse(spec, one, torch.tensor(xs[b]),
                           torch.tensor(ys[b]), torch.tensor(w[b]))
        assert math.isclose(float(got), float(want), rel_tol=1e-6)


@pytest.mark.parametrize("init", ["xavier", "he", "lecun", "zero",
                                  "default"])
def test_init_params_distributions(init):
    spec = tnn.MLPSpec(input_dim=200, hidden_dims=(300,),
                       activations=("tanh",), weight_init=init)
    params = tnn.init_params(spec, torch.Generator().manual_seed(3))
    again = tnn.init_params(spec, torch.Generator().manual_seed(3))
    jparams = jnn.init_params(jnn.MLPSpec(**dataclasses.asdict(spec)),
                              jax.random.PRNGKey(3))
    for layer, same, jl, (fan_in, fan_out) in zip(
            params, again, jparams, [(200, 300), (300, 1)]):
        w = layer["w"].numpy()
        assert w.shape == (fan_in, fan_out) and w.dtype == np.float32
        assert w.shape == np.asarray(jl["w"]).shape
        assert (layer["b"].numpy() == 0).all()
        np.testing.assert_array_equal(w, same["w"].numpy())
        if init == "zero":
            assert (w == 0).all()
            continue
        if init in ("he", "lecun"):
            std = math.sqrt((2.0 if init == "he" else 1.0) / fan_in)
            assert abs(w.std() / std - 1) < 0.1
            assert abs(w.mean()) < 0.1 * std
        else:
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            assert w.min() >= -lim and w.max() <= lim
            # uniform(-lim, lim): std lim/sqrt(3), like the JAX draw
            assert abs(w.std() / (lim / math.sqrt(3)) - 1) < 0.1
            assert abs(w.std() / np.asarray(jl["w"]).std() - 1) < 0.15


def test_dropout_keeps_one_minus_p_and_scales():
    p = 0.3
    spec = tnn.MLPSpec(input_dim=50, hidden_dims=(400,),
                       activations=("linear",), output_activation="linear",
                       dropout_rate=p)
    params = [{"w": torch.eye(50, 400), "b": torch.ones(400)},
              {"w": torch.ones(400, 1), "b": torch.zeros(1)}]
    x = torch.zeros(200, 50)
    # hidden units are 1 before dropout: the output counts the kept
    # units, each scaled by 1/(1 − p)
    kept = tnn.forward(spec, params, x, torch.Generator().manual_seed(1))
    share = kept / (400 / (1 - p))
    assert abs(float(share.mean()) - (1 - p)) < 0.01
    units = kept * (1 - p)
    np.testing.assert_allclose(units.numpy(), np.round(units.numpy()),
                               atol=1e-3)
    np.testing.assert_allclose(tnn.forward(spec, params, x).numpy(), 400.0)


def test_from_train_params_and_compute_dtype_precedence(monkeypatch):
    params = {"NumHiddenLayers": 3, "NumHiddenNodes": [8, 4],
              "ActivationFunc": "relu", "RegularizedConstant": 0.01,
              "L1orL2": "l1", "DropoutRate": 0.1, "loss": "Log",
              "WeightInitializer": "He"}
    for env in ({}, {"SHIFU_TPU_COMPUTE_DTYPE": "bf16"},
                {"SHIFU_TPU_COMPUTE_DTYPE": "bf16",
                 "SHIFU_TPU_NN_COMPUTE": "float32"}):
        for k in ("SHIFU_TPU_COMPUTE_DTYPE", "SHIFU_TPU_NN_COMPUTE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for p in (params, dict(params, ComputeDtype="bfloat16")):
            got = tnn.MLPSpec.from_train_params(p, 12, 3)
            want = jnn.MLPSpec.from_train_params(p, 12, 3)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hidden_dims == (8, 4, 4) and got.l1 == 0.01


def test_compare_structure_and_absorb_params_match_jax():
    cases = [([5, 4, 1], [5, 4, 1]), ([5, 4, 1], [6, 8, 1]),
             ([5, 4, 1], [5, 4, 3, 1]), ([5, 4, 1], [5, 3, 1]),
             ([5, 4, 1], [5, 4, 2]), ([5, 4, 3, 1], [5, 4, 1]),
             ([5, 1], [5, 4, 1]), ([5, 6, 1], [5, 4, 2, 1])]
    for old, new in cases:
        assert tnn.compare_structure(old, new) == \
            jnn.compare_structure(old, new), (old, new)
    rng = np.random.default_rng(4)
    old = _params(rng, [5, 4, 1])
    fresh = _params(rng, [6, 8, 3, 1])
    for fixed in (None, [1], [1, 2]):
        got, gmask = tnn.absorb_params(
            old, [{k: torch.tensor(v) for k, v in l.items()}
                  for l in fresh], fixed_layers=fixed)
        want, wmask = jnn.absorb_params(
            old, jax.tree.map(jnp.asarray, fresh), fixed_layers=fixed)
        for g, m, wl, wm in zip(got, gmask, want, wmask):
            for k in wl:
                np.testing.assert_array_equal(g[k].numpy(),
                                              np.asarray(wl[k]))
                np.testing.assert_array_equal(m[k].numpy(),
                                              np.asarray(wm[k]))
    # the absorbed corner reproduces the old model's output exactly
    x = rng.normal(0, 1, (10, 6)).astype(np.float32)
    spec = tnn.MLPSpec(input_dim=6, hidden_dims=(8,), activations=("tanh",))
    old_spec = tnn.MLPSpec(input_dim=5, hidden_dims=(4,),
                           activations=("tanh",))
    grown, _ = tnn.absorb_params(
        old, [{k: torch.tensor(v) for k, v in l.items()}
              for l in _params(rng, [6, 8, 1])])
    with torch.no_grad():
        got = tnn.forward(spec, grown, torch.tensor(x))
        want = tnn.forward(old_spec, _torch(old), torch.tensor(x[:, :5]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
