"""Port parity for `train/optimizers.py`: each of the eight Propagations
against the JAX package's `make_optimizer` (optax 0.2.6's sgd / momentum
/ nesterov / adam / adagrad / rmsprop and its own rprop / quickprop),
fed the SAME gradient sequence, so the optimizers' own arithmetic is
held apart from any difference in the gradients.

Every case runs 7 steps over two parameter leaves and two bags, with
gradients that change sign, repeat exactly and hit zero (RPROP's and
QuickProp's branches), with and without LearningDecay. Bag 1 is frozen
at steps 2 and 3 (`optimizers.freeze`, as a stopped bag is): its
reference is the JAX optimizer that never sees those steps. Updates
within 1e-6 of the largest update of the step (the two packages round
`decay**count` and `rsqrt` in their own libraries); the frozen steps
leave bag 1's state bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shifu_tpu.train.optimizers import make_optimizer as jmake
from shifu_tpu_torch.train import optimizers as topt

PROPS = ["B", "Q", "R", "M", "N", "ADAM", "ADAGRAD", "RMSPROP"]
SHAPES = [(3, 4), (4,)]
FROZEN = {2, 3}


def _grads(rng, steps):
    out = []
    prev = None
    for t in range(steps):
        g = [rng.normal(0, 1, s).astype(np.float32) for s in SHAPES]
        if prev is not None and t % 3 == 2:
            g = [p.copy() for p in prev]          # a repeated gradient
        g[0][0, 0] = 0.0                          # an exact zero
        g[1][1] = (-1.0) ** t                     # a sign flip each step
        out.append(g)
        prev = g
    return out


@pytest.mark.parametrize("decay", [0.0, 0.05])
@pytest.mark.parametrize("prop", PROPS)
def test_propagation_matches_jax_on_equal_gradients(prop, decay):
    rng = np.random.default_rng(PROPS.index(prop) + (decay > 0) * 10)
    steps = 7
    grads = [_grads(rng, steps), _grads(rng, steps)]      # one a bag
    kw = dict(learning_rate=0.1, learning_decay=decay, momentum=0.7,
              adam_beta1=0.8, adam_beta2=0.95)
    jopt = jmake(prop, **kw)
    topt_ = topt.make_optimizer(prop, **kw)
    params0 = [[rng.normal(0, 1, s).astype(np.float32) for s in SHAPES]
               for _ in range(2)]
    jstate = [jopt.init([jnp.asarray(p) for p in params0[b]])
              for b in range(2)]
    jparams = [[jnp.asarray(p) for p in params0[b]] for b in range(2)]
    tparams = [torch.tensor(np.stack([params0[0][i], params0[1][i]]))
               for i in range(len(SHAPES))]
    tstate = topt_.init(tparams)
    for t in range(steps):
        g = [torch.tensor(np.stack([grads[0][t][i], grads[1][t][i]]))
             for i in range(len(SHAPES))]
        upd, new_state = topt_.update(g, tstate)
        stopped = torch.tensor([False, t in FROZEN])
        frozen_state = topt.freeze(stopped, new_state, tstate)
        for b in range(2):
            if b == 1 and t in FROZEN:
                for k, v in frozen_state.items():
                    old = tstate[k]
                    for a, o in (zip(v, old) if isinstance(v, list)
                                 else [(v, old)]):
                        np.testing.assert_array_equal(a[b].numpy(),
                                                      o[b].numpy())
                continue
            jupd, jstate[b] = jopt.update(
                [jnp.asarray(x) for x in grads[b][t]], jstate[b],
                jparams[b])
            jparams[b] = optax.apply_updates(jparams[b], jupd)
            scale = max(float(np.abs(np.asarray(u)).max()) for u in jupd)
            for i in range(len(SHAPES)):
                np.testing.assert_allclose(
                    upd[i][b].numpy(), np.asarray(jupd[i]), rtol=0,
                    atol=1e-6 * max(scale, 1e-30),
                    err_msg=f"{prop} step {t} bag {b} leaf {i}")
        tparams = [torch.where(stopped.reshape((2,) + (1,) * (p.dim() - 1)),
                               p, p + u) for p, u in zip(tparams, upd)]
        tstate = frozen_state
    for b in range(2):
        for i in range(len(SHAPES)):
            np.testing.assert_allclose(tparams[i][b].numpy(),
                                       np.asarray(jparams[b][i]),
                                       rtol=1e-6, atol=1e-6)
    # a frozen bag's count stood still while the other's ran on
    assert tstate["count"].tolist() == [steps, steps - len(FROZEN)]


def test_unknown_propagation_raises():
    with pytest.raises(ValueError, match="Propagation"):
        topt.make_optimizer("XYZ", 0.1)


@pytest.mark.parametrize("params", [
    {"propagation": "adam", "LEARNINGRATE": 0.5, "AdamBeta1": 0.5},
    {"Propagation": "m", "Momentum": 0.0, "LearningRate": 0.0},
    {}])
def test_optimizer_from_params_reads_keys_like_jax(params):
    """Case-insensitive keys and the JAX package's falsy-means-default
    reads (Momentum 0 and LearningRate 0 take 0.5 and 0.1; no
    Propagation is QuickProp)."""
    from shifu_tpu.train.optimizers import optimizer_from_params as jfrom
    g = np.array([[0.3, -2.0]], np.float32)
    opt, jopt = topt.optimizer_from_params(params), jfrom(params)
    state, jstate = opt.init([torch.zeros(1, 2)]), \
        jopt.init([jnp.zeros(2)])
    for _ in range(3):
        upd, state = opt.update([torch.tensor(g)], state)
        jupd, jstate = jopt.update([jnp.asarray(g[0])], jstate)
        np.testing.assert_allclose(upd[0][0].numpy(), np.asarray(jupd[0]),
                                   rtol=1e-6)
