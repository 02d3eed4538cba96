"""Port parity for kernel K1 (fused z-score + first-layer matmul).

`shifu_tpu_torch.ops.fused_score` on CPU tensors runs its plain PyTorch
route; it is held against the JAX package's `pallas_score` — the
Pallas kernel in interpret mode and the XLA route — on the same numpy
inputs. Tolerance rtol 1e-5 / atol 1e-5: both sides are f32 and differ
only in the order of the matmul's sums.
"""

import os
import sys

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
from shifu_tpu_torch.ops.normalize import zscore

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

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


# ---------------------------------------------------------------------------
# The tensor-core kernel's operand layout and arithmetic, rehearsed on the
# CPU: `pack_weights`, the 3xTF32 product, and `_k1_plan`
# ---------------------------------------------------------------------------

def _unpack(pk, c, h):
    """(k-tile, hi/lo, k8 step, K chunk, H8, 4) → (2, H8, Cpad) planes."""
    kt, _, steps, chunks, h8, four = pk.shape
    return pk.permute(1, 4, 0, 2, 3, 5).reshape(2, h8, kt * steps * chunks
                                                * four)


@pytest.mark.parametrize("c,h", [(600, 512), (37, 16), (20, 1)])
def test_pack_weights_layout(c, h):
    """K-major (four consecutive k of one row per 16 bytes), C padded to
    whole k-tiles and H to a multiple of 8 with zeros, `hi` a TF32 value
    (low 13 mantissa bits zero) and hi + lo within 2^-21·|w| of w."""
    rng = np.random.default_rng(10)
    w = torch.as_tensor(rng.normal(0, 0.5, (c, h)).astype(np.float32))
    pk = fused_score.pack_weights(w)
    kt, h8 = fused_score.k_tiles(c), -(-h // 8) * 8
    assert tuple(pk.shape) == (kt, 2, fused_score.BK // 8, 2, h8, 4)
    assert kt % fused_score.SPLIT_ALIGN == 0
    assert kt * fused_score.BK >= c > (kt - fused_score.SPLIT_ALIGN) \
        * fused_score.BK
    planes = _unpack(pk, c, h)
    # element (tile, p, step, chunk, n, e) is plane p at (n, k) with
    # k = tile·BK + 8·step + 4·chunk + e: K is the contiguous axis
    for tile, p, step, chunk, n, e in [(0, 0, 0, 0, 0, 1), (1, 1, 1, 1, 3, 2),
                                       (kt - 1, 0, 1, 0, h8 - 1, 3)]:
        k = tile * fused_score.BK + 8 * step + 4 * chunk + e
        assert pk[tile, p, step, chunk, n, e] == planes[p, n, k]
    hi, lo = planes[0], planes[1]
    assert not hi[h:].any() and not hi[:, c:].any()
    assert not lo[h:].any() and not lo[:, c:].any()
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    wt = w.T.double()
    err = (hi[:h, :c].double() + lo[:h, :c].double() - wt).abs()
    assert bool((err <= 2.0 ** -21 * wt.abs()).all())


def test_tf32_round_is_round_to_nearest_ties_away():
    """`cvt.rna.tf32.f32`: 10 mantissa bits kept, ties away from zero."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                      1 + 3 * ulp / 4, 0.0, -0.0, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 0.0, -0.0,
                         3.0], dtype=torch.float32)
    assert torch.equal(fused_score.tf32_round(x), want)


def _three_tf32(z, w):
    """The kernel's arithmetic: z and w split into TF32 hi and lo parts,
    lo·hi + hi·lo + hi·hi accumulated in f32."""
    zh = fused_score.tf32_round(z)
    zl = fused_score.tf32_round(z - zh)
    wh = fused_score.tf32_round(w)
    wl = fused_score.tf32_round(w - wh)
    acc = torch.matmul(zl, wh)
    acc = acc + torch.matmul(zh, wl)
    return acc + torch.matmul(zh, wh)


def test_three_tf32_product_holds_the_f32_tolerance_at_full_width():
    """At the served NN's full width (600 → 512), on the card checks'
    inputs (NaN cells, a NaN row, outliers, a tiny-std column), the
    3xTF32 product plus bias agrees with the plain f32 version and with
    the JAX XLA route within the unchanged 1e-5."""
    x, mean, std, w, b = cs.k1_inputs(1, 256, "cpu")
    got = _three_tf32(zscore(x, mean, std, cs.CUTOFF), w) + b
    plain = fused_score.fused_first_layer_plain(x, mean, std, cs.CUTOFF, w,
                                                b)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    ref = pallas_score.fused_first_layer(
        *(jnp.asarray(t.numpy()) for t in (x, mean, std)), cs.CUTOFF,
        jnp.asarray(w.numpy()), jnp.asarray(b.numpy()), mode="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("n", [1, 8, 37, 64, 512, 65536])
@pytest.mark.parametrize("c,h", [(600, 512), (37, 16), (20, 1)])
def test_k1_plan(n, c, h):
    """Enough blocks at every bucket of the wide NN, a cluster no larger
    than the portable 8, a K-split that divides the packed k-tiles and
    the tile's rows, and tile shapes the kernel instantiates."""
    plan = fused_score._k1_plan(n, c, h)
    assert plan.bm in (64, 128) and plan.bn in (8, 16, 32, 64, 128)
    assert 1 <= plan.split <= fused_score.MAX_SPLIT
    assert plan.split & (plan.split - 1) == 0
    assert fused_score.k_tiles(c) % plan.split == 0
    assert plan.bm % plan.split == 0
    assert plan.split <= -(-c // fused_score.BK)
    if (c, h) == (600, 512):
        assert plan.blocks(n, h) >= fused_score.TARGET_BLOCKS
    assert plan.bn <= max(8, 1 << (-(-h // 8) * 8 - 1).bit_length())


def test_model_carries_its_weight_pack():
    """`weights.to_torch` builds the first layer's pack once, and
    `score_nn` with it scores as the plain route does."""
    from shifu_tpu_torch import weights
    rng = np.random.default_rng(11)
    layers = [{"w": rng.normal(0, 0.3, (12, 5)).astype(np.float32),
               "b": rng.normal(0, 0.1, 5).astype(np.float32)},
              {"w": rng.normal(0, 0.3, (5, 1)).astype(np.float32),
               "b": np.zeros(1, np.float32)}]
    meta = {"spec": {"input_dim": 12, "hidden_dims": [5],
                     "activations": ["relu"]}}
    mlp = weights.to_torch("nn", meta, layers, "cpu")
    assert torch.equal(mlp.w0_pack, fused_score.pack_weights(mlp.w[0]))
    assert "w0_pack" not in mlp.state_dict()
    values, mean, std, _, _ = _case(12, n=30, c=12)
    t = [torch.as_tensor(a) for a in (values, mean, std)]
    got = fused_score.score_nn(mlp, *t, CUTOFF)
    want = mlp(zscore(t[0], t[1], t[2], CUTOFF))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_pack_norm_reciprocals_give_the_ieee_quotient():
    """Rows 4–5 of `pack_norm` are the f64 reciprocals of the safe std,
    and the kernel's f32(f64(v - mean) · f64(1/std)) equals the IEEE f32
    quotient (v - mean) / std bit for bit, over values of every scale."""
    rng = np.random.default_rng(13)
    c = 4096
    mean = torch.as_tensor(rng.normal(0, 10, c).astype(np.float32))
    std = torch.as_tensor((10.0 ** rng.uniform(-4.9, 6, c))
                          .astype(np.float32))
    std[:3] = torch.tensor([STD_EPS / 2, 1.0, 3.0])
    packed = fused_score.pack_norm(mean, std, CUTOFF)
    assert tuple(packed.shape) == (6, c)
    rcp = packed[4:].reshape(-1).view(torch.float64)
    safe = packed[1]
    assert torch.equal(rcp, 1.0 / safe.double())
    num = torch.as_tensor((rng.normal(0, 1, (256, c))
                           * 10.0 ** rng.uniform(-30, 30, (256, c)))
                          .astype(np.float32))
    want = num / safe
    got = (num.double() * rcp).float()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
