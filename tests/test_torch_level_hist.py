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
    """The kernel's tile choice (`_k3_plan`): the HIGGS root level fits
    one block; the leaf level splits its columns over a cluster; slots
    split only when one column's slots do not fit any block."""
    root = level_hist._k3_plan(28, 1, 64, rows=2_000_000)
    assert (root.cluster, root.col_tile, root.slot_tile) == (1, 28, 1)
    leaf = level_hist._k3_plan(28, 32, 64, rows=2_000_000)
    assert (leaf.cluster, leaf.col_tile, leaf.slot_tile) == (4, 7, 32)
    wide = level_hist._k3_plan(28, 512, 64, es=4, rows=50_000, trees=3)
    assert wide.slot_tile < 512 and wide.cluster <= level_hist.MAX_CLUSTER
    k4 = level_hist._k3_plan(28, 32, 64, k=62, es=4, rows=2_000_000)
    assert k4.slot_tile == 32
    for plan in (root, leaf, wide, k4):
        assert plan.smem <= level_hist.SMEM_MAX


_KINDS = {"u8": (0, 1), "i32": (0, 4), "k4": (None, 4)}


@pytest.mark.parametrize("kind", sorted(_KINDS))
@pytest.mark.parametrize("n_bins", [16, 64, 256])
@pytest.mark.parametrize("n_slots", [1, 2, 16, 32, 64])
@pytest.mark.parametrize("c", [1, 7, 28, 300])
def test_k3_plan_fits_and_covers(c, n_slots, n_bins, kind):
    """Every plan fits one block's shared memory with its ring, keeps
    the cluster portable and covers every column and slot; `smem` is
    `smem_bytes` of it."""
    k, es = _KINDS[kind]
    k = n_bins - 2 if k is None else k
    p = level_hist._k3_plan(c, n_slots, n_bins, k=k, es=es,
                            rows=2_000_000)
    assert p.smem == level_hist.smem_bytes(p.col_tile, p.slot_tile, n_bins,
                                           k, p.chunk, p.stages, es,
                                           p.copies)
    assert 1 <= p.copies <= level_hist.CONSUMER_WARPS
    assert p.copies & (p.copies - 1) == 0
    assert p.smem <= level_hist.SMEM_MAX
    assert 1 <= p.cluster <= level_hist.MAX_CLUSTER
    assert 2 <= p.stages <= level_hist.MAX_STAGES
    assert p.chunk % level_hist.MIN_CHUNK == 0
    assert level_hist.MIN_CHUNK <= p.chunk <= level_hist.MAX_CHUNK
    groups = -(-c // (p.cluster * p.col_tile))
    assert groups * p.cluster * p.col_tile >= c      # every column
    assert (groups - 1) * p.cluster * p.col_tile < c  # no empty group
    if groups == 1:                          # no block of a lone cluster
        assert (p.cluster - 1) * p.col_tile < c      # is left idle
    assert -(-n_slots // p.slot_tile) * p.slot_tile >= n_slots
    assert p.slot_tile <= n_slots


@pytest.mark.parametrize("cluster,copies", [(1, None), (2, 4), (4, 8),
                                            (7, 16), (None, 1), (8, 2)])
@pytest.mark.parametrize("n_slots", [1, 4, 32])
def test_k3_plan_forced_variants(n_slots, cluster, copies):
    """A forced cluster sets the column tile (C / cluster); forced
    replicas are kept as given; the slot tile is as many slots as fit
    beside them; each variant fits, covers every column and slot, or is
    refused when not even one slot fits."""
    c, n_bins = 28, 64
    try:
        p = level_hist._k3_plan(c, n_slots, n_bins, rows=2_000_000,
                                cluster=cluster, copies=copies)
    except ValueError:
        with pytest.raises(ValueError):   # refused: one slot of the
            level_hist._k3_plan(c, 1, n_bins, rows=2_000_000,  # tile
                                cluster=cluster, copies=copies)
        assert copies and copies > 1
        return
    free = level_hist._k3_plan(c, n_slots, n_bins, rows=2_000_000)
    if cluster:
        assert (p.cluster, p.col_tile) == (cluster, -(-c // cluster))
    else:
        assert (p.cluster, p.col_tile) == (free.cluster, free.col_tile)
    assert p.copies == (copies or free.copies)
    assert p.smem <= level_hist.SMEM_MAX
    assert p.smem == level_hist.smem_bytes(p.col_tile, p.slot_tile, n_bins,
                                           0, p.chunk, p.stages, 1,
                                           p.copies)
    assert p.cluster * p.col_tile >= c
    assert 1 <= p.slot_tile <= n_slots
    if level_hist.smem_bytes(p.col_tile, n_slots, n_bins, 0,
                             level_hist.MIN_CHUNK, 2, 1,
                             p.copies) <= level_hist.SMEM_MAX:
        assert p.slot_tile == n_slots


@pytest.mark.parametrize("n_bins", [16, 64, 256])
def test_device_bins_out_of_a_byte_stay_int32_and_drop(n_bins):
    """A bin below 0 or above 255 keeps the matrix int32 (a narrowing
    would wrap it into [0, n_bins)), and K3 drops it: the result is the
    int32 matrix's, and for bins past the top the JAX scatter's (which
    drops those too; it wraps a negative index instead). Bins in
    [n_bins, 256) narrow and are dropped as well."""
    from shifu_tpu_torch.models import gbdt
    binsT, slot, grad, hess = _rows(n_bins, c=4, n_slots=3, n_bins=n_bins,
                                    integer=True)
    _, ts, tg, th = _torch(binsT, slot, grad, hess)
    for bad in (-1, 256, 300, 255):
        b = binsT.copy()
        b[1, ::5] = bad
        want = level_hist.level_histograms(torch.as_tensor(b), ts, tg, th,
                                           3, n_bins)
        if bad >= 0:
            jg, jh = _jax_scatter(b, slot, grad, hess, 3, n_bins)
            _close(want[0], jg, grad, True)
            _close(want[1], jh, hess, True)
        for given in (np.ascontiguousarray(b.T), torch.as_tensor(b)):
            got = gbdt._device_bins(given, torch.device("cpu"), n_bins)
            assert got.dtype == (torch.uint8 if 0 <= bad <= 255
                                 else torch.int32)
            np.testing.assert_array_equal(got.numpy(), b)
            g, h = level_hist.level_histograms(got, ts, tg, th, 3, n_bins)
            assert torch.equal(g, want[0]) and torch.equal(h, want[1])
    dropped = binsT.copy()
    dropped[1, ::5] = -1
    g, _ = level_hist.level_histograms(torch.as_tensor(dropped), ts, tg, th,
                                       3, n_bins)
    kept = (slot >= 0) & (slot < 3) & (np.arange(slot.size) % 5 != 0)
    assert float(g[:, 1].sum()) == float(grad[kept].sum())


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("trees", [0, 3])
def test_plain_k3_uint8_bins_match_int32_and_xla(trees, integer):
    """The builders' one-byte bins give the int32 result exactly, and
    the JAX scatter's, for one tree and the forest."""
    binsT, slot, grad, hess = _rows(17 + trees, c=6, n_slots=4, n_bins=64,
                                    integer=integer, trees=trees)
    binsT[:, ::7] = 63                      # the missing bin
    _, ts, tg, th = _torch(binsT, slot, grad, hess)
    g8, h8 = level_hist.level_histograms(
        torch.as_tensor(binsT.astype(np.uint8)), ts, tg, th, 4, 64)
    g32, h32 = level_hist.level_histograms(
        torch.as_tensor(binsT), ts, tg, th, 4, 64)
    assert torch.equal(g8, g32) and torch.equal(h8, h32)
    want_g, want_h = _jax_scatter(binsT, slot, grad, hess, 4, 64)
    _close(g8, want_g, grad, integer)
    _close(h8, want_h, hess, integer)


@pytest.mark.parametrize("n_bins,dtype", [(16, torch.uint8),
                                          (64, torch.uint8),
                                          (256, torch.uint8),
                                          (257, torch.int32),
                                          (1024, torch.int32)])
def test_device_bins_are_one_byte_up_to_256_bins(n_bins, dtype):
    from shifu_tpu_torch.models import gbdt
    rng = np.random.default_rng(n_bins)
    bins = rng.integers(0, n_bins, (50, 3)).astype(np.int32)
    assert gbdt.bin_dtype(n_bins) == dtype
    for given in (bins, torch.as_tensor(np.ascontiguousarray(bins.T))):
        got = gbdt._device_bins(given, torch.device("cpu"), n_bins)
        assert got.dtype == dtype and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), bins.T)


def test_uint8_bins_route_and_walk_like_int32():
    """uint8 bins against int32 split bins promote (no wrap): the route
    step and the walk land every row where int32 bins do, at 256 bins
    (bins up to 255, the missing one; split bins up to 254)."""
    from shifu_tpu_torch.models import gbdt
    rng = np.random.default_rng(3)
    cfg = gbdt.TreeConfig(max_depth=3, n_bins=256)
    c, r, t = 4, 400, 2
    bins = rng.integers(0, 256, (c, r)).astype(np.int32)
    bins[:, :8] = 255
    trees = gbdt._empty_trees(cfg, t, "cpu")
    trees["feature"][:, :7] = torch.as_tensor(
        rng.integers(0, c, (t, 7)), dtype=torch.int32)
    trees["bin"][:, :7] = torch.as_tensor(rng.integers(0, 255, (t, 7)),
                                          dtype=torch.int32)
    trees["bin"][:, 0] = 254
    trees["default_left"][:, :7] = torch.as_tensor(
        rng.integers(0, 2, (t, 7)).astype(bool))
    trees["is_leaf"][:, 7:] = True
    node = torch.zeros((t, r), dtype=torch.long)
    b8 = torch.as_tensor(bins.astype(np.uint8))
    b32 = torch.as_tensor(bins)
    for depth in range(cfg.max_depth):
        n8 = gbdt._route_level(cfg, trees, b8, node, depth)
        n32 = gbdt._route_level(cfg, trees, b32, node, depth)
        assert torch.equal(n8, n32)
        node = n32
    assert torch.equal(gbdt._walk_trees(trees, b8, 3, 256),
                       gbdt._walk_trees(trees, b32, 3, 256))
    assert torch.equal(gbdt._walk_trees(trees, b8, 3, 256), node)


def _staged_cuts(cuts: torch.Tensor) -> torch.Tensor:
    """(C, K) cuts → (C, search_span(K)) as K4 stages them in shared
    memory (`stage_cuts` of csrc/binning.cuh): the K cuts, then NaN,
    which no value counts, in the slots the binary search can reach
    past them."""
    from shifu_tpu_torch.ops.fused_trees import search_span
    c, k = cuts.shape
    pad = torch.full((c, search_span(k) - k), float("nan"),
                     dtype=cuts.dtype)
    return torch.cat([cuts, pad], dim=1)


@pytest.mark.parametrize("k", [1, 2, 3, 7, 62, 254])
def test_staged_cuts_mirror_and_binary_lifting(k):
    """`_staged_cuts` holds K cuts then NaN up to search_span(K)
    slots; a binary lifting over it (K4's `bin_of_sorted`) gives
    `bins_from_values_plain` on duplicates, ±inf pads, NaN values and
    values equal to a cut."""
    from shifu_tpu_torch.ops.fused_trees import search_span
    n_bins = k + 2
    rng = np.random.default_rng(k)
    cuts = np.sort(rng.normal(0, 1, (3, k)).astype(np.float32), axis=1)
    if k >= 3:
        cuts[0, 1] = cuts[0, 0]             # a duplicate
        cuts[1, -1] = np.inf                # an +inf pad
    if k >= 2:
        cuts[2, 0] = -np.inf
    vals = rng.normal(0, 1, (3, 300)).astype(np.float32)
    vals[:, :k] = cuts                      # values equal to a cut
    vals[:, -4:] = [np.nan, np.inf, -np.inf, 0.0]
    staged = _staged_cuts(torch.as_tensor(cuts)).numpy()
    span = search_span(k)
    top = 1 << (k.bit_length() - 1)         # the first step, <= K
    assert staged.shape == (3, span) and span == 2 * top - 1
    assert k <= span < 2 * k                 # every reachable slot
    np.testing.assert_array_equal(staged[:, :k], cuts)
    assert np.isnan(staged[:, k:]).all()
    got = np.empty(vals.shape, np.int32)
    for col in range(3):
        for i, v in enumerate(vals[col]):
            if np.isnan(v):
                got[col, i] = n_bins - 1
                continue
            q, step = 0, top
            while step:
                if staged[col, q + step - 1] <= v:
                    q += step
                step >>= 1
            got[col, i] = min(q, n_bins - 2)
    want = level_hist.bins_from_values_plain(
        torch.as_tensor(vals), torch.as_tensor(cuts), n_bins).numpy()
    np.testing.assert_array_equal(got, want)


def test_cuda_route_never_falls_back_to_plain():
    """A tensor on a device without a kernel is refused, not sent to the
    plain route; mismatched shapes raise before any launch."""
    binsT, slot, grad, hess = _torch(*_rows(13))
    with pytest.raises(ValueError, match="no kernel"):
        level_hist.level_histograms(binsT.to("meta"), slot.to("meta"),
                                    grad.to("meta"), hess.to("meta"), 4, 16)
    with pytest.raises(ValueError, match="does not match"):
        level_hist.level_histograms(binsT, slot, grad[:-1], hess, 4, 16)
