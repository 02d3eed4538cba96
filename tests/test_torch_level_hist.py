"""Port parity for kernels K3 and K4 (per-level G/H histograms).

`shifu_tpu_torch.ops.level_hist` on CPU tensors runs its plain PyTorch
route; it is held against the JAX package's `_local_level_histograms`
(the XLA scatter, f32) and against `level_histograms_pallas` /
`level_histograms_fused` in interpret mode under
SHIFU_TPU_HIST_PRECISION=highest (the TPU kernels' f32 route). Integer
grad/hess must match exactly (every partial sum is an exact integer);
real ones within rtol 1e-5 and atol 1e-5·Σ|grad| (the sums are taken in
other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shifu_tpu.models import gbdt as jgbdt
from shifu_tpu.ops import pallas_hist
from shifu_tpu_torch.ops import level_hist


def _rows(seed, c=5, r=300, n_slots=4, n_bins=16, integer=False, trees=0):
    """binsT (C, R), slot with dump-slot rows and -1, grad/hess; with
    `trees` > 0 the per-row arrays carry a leading (T, R) axis."""
    rng = np.random.default_rng(seed)
    lead = (trees,) if trees else ()
    binsT = rng.integers(0, n_bins, (c, r)).astype(np.int32)
    slot = rng.integers(-1, n_slots + 1, lead + (r,)).astype(np.int32)
    if integer:
        grad = rng.integers(-3, 4, lead + (r,)).astype(np.float32)
        hess = rng.integers(0, 3, lead + (r,)).astype(np.float32)
    else:
        grad = rng.normal(0, 1, lead + (r,)).astype(np.float32)
        hess = rng.uniform(0.1, 1, lead + (r,)).astype(np.float32)
    return binsT, slot, grad, hess


def _values(seed, c=5, r=300, n_bins=16, n_cat=2):
    """Raw (C, R) values with NaN and ±inf, numeric quantile cuts plus
    categorical identity cuts, +inf padded — make_fused_inputs' layout."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(0, 1, (c, r)).astype(np.float32)
    vals[rng.random((c, r)) < 0.08] = np.nan
    vals[0, :4] = np.inf
    vals[1, 4:8] = -np.inf
    n_num = c - n_cat
    cuts = np.full((c, n_bins - 2), np.inf, np.float32)
    qs = np.linspace(0, 1, n_bins - 3)[1:-1]
    cuts[:n_num, :len(qs)] = np.quantile(rng.normal(0, 1, 4000), qs)
    cuts[n_num:] = 0.5 + np.arange(n_bins - 2, dtype=np.float32)
    codes = rng.integers(0, n_bins - 1, (n_cat, r)).astype(np.float32)
    codes[rng.random(codes.shape) < 0.1] = np.nan
    vals[n_num:] = codes
    return vals, cuts


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _jax_scatter(binsT, slot, grad, hess, n_slots, n_bins):
    args = [jnp.asarray(a) for a in (binsT, slot, grad, hess)]
    if slot.ndim == 2:
        g, h = jax.vmap(lambda s, gr, he: jgbdt._local_level_histograms(
            args[0], s, gr, he, n_slots, n_bins))(*args[1:])
    else:
        g, h = jgbdt._local_level_histograms(*args, n_slots, n_bins)
    return np.asarray(g), np.asarray(h)


def _close(got, want, grad, integer):
    got = got.numpy()
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        atol = 1e-5 * float(np.abs(grad).sum())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n_slots,n_bins", [(1, 16), (4, 16), (8, 64)])
def test_plain_k3_matches_xla_scatter(integer, n_slots, n_bins):
    binsT, slot, grad, hess = _rows(n_slots * 7 + n_bins, n_slots=n_slots,
                                    n_bins=n_bins, integer=integer)
    g, h = level_hist.level_histograms(*_torch(binsT, slot, grad, hess),
                                       n_slots, n_bins)
    assert g.shape == (n_slots, binsT.shape[0], n_bins)
    want_g, want_h = _jax_scatter(binsT, slot, grad, hess, n_slots, n_bins)
    _close(g, want_g, grad, integer)
    _close(h, want_h, hess, integer)


@pytest.mark.parametrize("integer", [True, False])
def test_plain_k3_matches_pallas_interpret_highest(integer, monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_HIST_PRECISION", "highest")
    binsT, slot, grad, hess = _rows(3, c=6, r=200, n_slots=4,
                                    integer=integer)
    g, h = level_hist.level_histograms(*_torch(binsT, slot, grad, hess),
                                       4, 16)
    want_g, want_h = pallas_hist.level_histograms_pallas(
        *[jnp.asarray(a) for a in (binsT, slot, grad, hess)], 4, 16,
        interpret=True)
    _close(g, np.asarray(want_g), grad, integer)
    _close(h, np.asarray(want_h), hess, integer)


@pytest.mark.parametrize("integer", [True, False])
def test_plain_k3_forest_axis(integer):
    binsT, slot, grad, hess = _rows(11, n_slots=4, integer=integer,
                                    trees=3)
    g, h = level_hist.level_histograms(*_torch(binsT, slot, grad, hess),
                                       4, 16)
    assert g.shape == (3, 4, binsT.shape[0], 16)
    want_g, want_h = _jax_scatter(binsT, slot, grad, hess, 4, 16)
    _close(g, want_g, grad, integer)
    _close(h, want_h, hess, integer)
    for t in range(3):   # each tree alone gives its slice of the forest
        gt, _ = level_hist.level_histograms(
            *_torch(binsT, slot[t], grad[t], hess[t]), 4, 16)
        np.testing.assert_array_equal(gt.numpy(), g[t].numpy())


def test_dropped_rows_and_bins_add_nothing():
    binsT, slot, grad, hess = _rows(5, n_slots=4, integer=True)
    slot[:] = np.where(np.arange(slot.size) % 2 == 0, -1, 4)
    g, h = level_hist.level_histograms(*_torch(binsT, slot, grad, hess),
                                       4, 16)
    assert not g.any() and not h.any()
    binsT, slot, grad, hess = _rows(6, n_slots=4, integer=True)
    slot[:] = 0
    binsT[:, :10] = 16                   # out-of-range bins are dropped
    g, _ = level_hist.level_histograms(*_torch(binsT, slot, grad, hess),
                                       4, 16)
    np.testing.assert_array_equal(g[0].sum(1).numpy(),
                                  np.full(binsT.shape[0],
                                          grad[10:].sum(), np.float32))


def test_bins_from_values_matches_jax():
    vals, cuts = _values(7)
    got = level_hist.bins_from_values_plain(*_torch(vals, cuts), 16)
    want = pallas_hist.bins_from_values(jnp.asarray(vals),
                                        jnp.asarray(cuts), 16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[np.isnan(vals)] == 15).all()


@pytest.mark.parametrize("integer", [True, False])
def test_plain_k4_matches_fused_interpret_and_xla(integer, monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_HIST_PRECISION", "highest")
    vals, cuts = _values(8)
    _, slot, grad, hess = _rows(9, c=vals.shape[0], r=vals.shape[1],
                                n_slots=4, integer=integer)
    g, h = level_hist.level_histograms_fused(
        *_torch(vals, cuts, slot, grad, hess), 4, 16)
    jargs = [jnp.asarray(a) for a in (vals, cuts, slot, grad, hess)]
    want_g, want_h = pallas_hist.level_histograms_fused(*jargs, 4, 16,
                                                        interpret=True)
    _close(g, np.asarray(want_g), grad, integer)
    _close(h, np.asarray(want_h), hess, integer)
    xg, xh = jgbdt._local_level_histograms(
        jgbdt.FusedBins(jargs[0], jargs[1]), *jargs[2:], 4, 16)
    _close(g, np.asarray(xg), grad, integer)
    _close(h, np.asarray(xh), hess, integer)


def test_k4_equals_k3_over_binned_values():
    vals, cuts = _values(10)
    _, slot, grad, hess = _rows(12, c=vals.shape[0], r=vals.shape[1],
                                n_slots=2, trees=2)
    tv, tc, ts, tg, th = _torch(vals, cuts, slot, grad, hess)
    fused = level_hist.level_histograms_fused(tv, tc, ts, tg, th, 2, 16)
    binned = level_hist.level_histograms(
        level_hist.bins_from_values_plain(tv, tc, 16), ts, tg, th, 2, 16)
    for a, b in zip(fused, binned):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_tiles_fit_the_shared_memory_budget():
    """The kernel's tile choice: whole levels of the HIGGS shape split
    columns; slots split only when one column does not fit."""
    assert level_hist.tiles(28, 1, 64) == (28, 1)
    assert level_hist.tiles(28, 32, 64) == (6, 32)
    col, slots = level_hist.tiles(28, 512, 64)
    assert col == 1 and 8 * slots * 64 <= level_hist.SMEM_BUDGET
    col, _ = level_hist.tiles(28, 32, 64, k=63)
    assert 8 * 32 * 64 * col + 4 * 63 * col <= level_hist.SMEM_BUDGET


def test_cuda_route_never_falls_back_to_plain():
    """A tensor on a device without a kernel is refused, not sent to the
    plain route; mismatched shapes raise before any launch."""
    binsT, slot, grad, hess = _torch(*_rows(13))
    with pytest.raises(ValueError, match="no kernel"):
        level_hist.level_histograms(binsT.to("meta"), slot.to("meta"),
                                    grad.to("meta"), hess.to("meta"), 4, 16)
    with pytest.raises(ValueError, match="does not match"):
        level_hist.level_histograms(binsT, slot, grad[:-1], hess, 4, 16)
