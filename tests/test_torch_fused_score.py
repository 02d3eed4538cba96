"""Port parity for kernel K1 (fused z-score + first-layer matmul).

`shifu_tpu_torch.ops.fused_score` on CPU tensors runs its plain PyTorch
route; it is held against the JAX package's `pallas_score` — the
Pallas kernel in interpret mode and the XLA route — on the same numpy
inputs. Tolerance rtol 1e-5 / atol 1e-5: both sides are f32 and differ
only in the order of the matmul's sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shifu_tpu.models import nn as jnn
from shifu_tpu.ops import pallas_score
from shifu_tpu.ops.normalize import STD_EPS
from shifu_tpu_torch.models import nn as tnn
from shifu_tpu_torch.ops import fused_score

CUTOFF = 4.0
TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, n=96, c=20, h=16):
    """Raw values with NaN cells and whole NaN rows, a tiny-std column
    (index 3) and outliers beyond the clamp."""
    rng = np.random.default_rng(seed)
    values = rng.normal(2.0, 3.0, (n, c)).astype(np.float32)
    values[rng.random((n, c)) < 0.1] = np.nan
    values[7] = np.nan
    values[:5, 0] = 1e6
    mean = rng.normal(0, 1, c).astype(np.float32)
    std = rng.uniform(0.5, 2.0, c).astype(np.float32)
    std[3] = STD_EPS / 10
    w = rng.normal(0, 0.3, (c, h)).astype(np.float32)
    b = rng.normal(0, 0.1, h).astype(np.float32)
    return values, mean, std, w, b


def _port(values, mean, std, w, b):
    t = [torch.as_tensor(a) for a in (values, mean, std, w, b)]
    return fused_score.fused_first_layer(t[0], t[1], t[2], CUTOFF, t[3],
                                         t[4]).numpy()


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_first_layer_matches_jax(mode):
    values, mean, std, w, b = _case(0)
    kw = dict(row_tile=32, col_tile=8, interpret=True) \
        if mode == "pallas" else {}
    ref = pallas_score.fused_first_layer(
        *(jnp.asarray(a) for a in (values, mean, std)), CUTOFF,
        jnp.asarray(w), jnp.asarray(b), mode=mode, **kw)
    np.testing.assert_allclose(_port(values, mean, std, w, b),
                               np.asarray(ref), **TOL)


def test_tiny_std_columns_contribute_exactly_zero():
    """std < STD_EPS → z is exactly 0, so with every column tiny the
    output is the bias, whatever the raw values."""
    rng = np.random.default_rng(1)
    n, c, h = 40, 6, 8
    values = rng.normal(0, 100, (n, c)).astype(np.float32)
    values[3, 2] = np.nan
    mean = np.zeros(c, np.float32)
    std = np.full(c, STD_EPS / 2, np.float32)
    w = rng.normal(0, 1, (c, h)).astype(np.float32)
    b = rng.normal(0, 1, h).astype(np.float32)
    out = _port(values, mean, std, w, b)
    np.testing.assert_array_equal(out, np.broadcast_to(b, (n, h)))


def test_nan_rows_score_as_the_mean_row():
    """A row of NaNs normalizes to all zeros → bias only; the same holds
    on the JAX route."""
    values, mean, std, w, b = _case(2)
    out = _port(values, mean, std, w, b)
    np.testing.assert_allclose(out[7], b, rtol=0, atol=1e-6)
    ref = pallas_score.fused_first_layer(
        *(jnp.asarray(a) for a in (values, mean, std)), CUTOFF,
        jnp.asarray(w), jnp.asarray(b), mode="xla")
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_padding_invariance():
    """Rows repeated to a bucket (the serving pad) leave the real rows'
    outputs bit-identical."""
    values, mean, std, w, b = _case(3, n=37)
    base = _port(values, mean, std, w, b)
    padded = np.concatenate([values, np.repeat(values[-1:], 27, 0)])
    out = _port(padded, mean, std, w, b)
    np.testing.assert_array_equal(out[:37], base)


@pytest.mark.parametrize("out_act,out_dim", [("sigmoid", 1), ("linear", 1),
                                             ("softmax", 3),
                                             ("sigmoid", 2)])
def test_score_nn_matches_jax(out_act, out_dim):
    """Whole MLP over raw inputs: the port's `score_nn` against the JAX
    `score_nn` (XLA route) on the same weights."""
    values, mean, std, _, _ = _case(4, n=64, c=12)
    spec = jnn.MLPSpec(input_dim=12, hidden_dims=(10, 6),
                       activations=("relu", "tanh"), output_dim=out_dim,
                       output_activation=out_act)
    params = jax.tree.map(np.asarray,
                          jnn.init_params(spec, jax.random.PRNGKey(4)))
    ref = pallas_score.score_nn(
        spec, jax.tree.map(jnp.asarray, params), jnp.asarray(values),
        jnp.asarray(mean), jnp.asarray(std), CUTOFF, mode="xla")
    mlp = tnn.MLP(tnn.MLPSpec.from_meta(spec.__dict__), params)
    got = fused_score.score_nn(mlp, torch.as_tensor(values),
                               torch.as_tensor(mean), torch.as_tensor(std),
                               CUTOFF)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_wrapper_checks_inputs():
    """Shape and type errors are caught before any route is taken."""
    values, mean, std, w, b = _case(5, n=8, c=4, h=2)
    t = [torch.as_tensor(a) for a in (values, mean, std, w, b)]
    with pytest.raises(ValueError):
        fused_score.fused_first_layer(t[0], t[1], t[2], CUTOFF, t[3][:3],
                                      t[4])
    with pytest.raises(TypeError):
        fused_score.fused_first_layer(t[0].double(), t[1], t[2], CUTOFF,
                                      t[3], t[4])
