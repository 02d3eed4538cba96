"""Port parity for kernel K2 (fused GBT/RF ensemble inference).

`shifu_tpu_torch.ops.fused_trees.predict_ensemble` on CPU tensors runs
its plain PyTorch route; it is held against the JAX package's
`pallas_trees.predict_ensemble` in interpret mode and `gbdt.predict`'s
`xla` walk, on trees the JAX builders grow. Leaf routing is integer
work and must match exactly; scores within rtol 1e-6 / atol 1e-6 (the
leaf sum and the sigmoid round differently at f32 ulp scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shifu_tpu.models import gbdt as jgbdt
from shifu_tpu.models.gbdt import TreeConfig
from shifu_tpu.ops import pallas_trees
from shifu_tpu_torch import weights
from shifu_tpu_torch.models import gbdt as tgbdt
from shifu_tpu_torch.ops import fused_trees

TOL = dict(rtol=1e-6, atol=1e-6)
N_BINS = 16


def _dataset(seed, n=600, cn=5, cc=2, vocab=6, miss=0.08):
    """Raw cleaned blocks (NaN-missing numeric + coded categoricals,
    with -1 and out-of-vocab codes) and their binning tables."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(0, 1, (n, cn)).astype(np.float32)
    dense[rng.random((n, cn)) < miss] = np.nan
    dense[:3, 1] = np.inf
    dense[3:6, 2] = -np.inf
    codes = rng.integers(0, vocab, (n, cc)).astype(np.int32)
    codes[rng.random((n, cc)) < miss] = -1
    codes[6:9, 0] = vocab + 3                  # out of vocabulary
    qs = np.linspace(0, 1, N_BINS)[1:-1]
    num_cuts = np.nanquantile(np.where(np.isinf(dense), np.nan, dense),
                              qs, axis=0).astype(np.float32)
    tables = jgbdt.make_bin_tables(
        num_cuts, [rng.permutation(vocab).astype(np.int32)
                   for _ in range(cc)], N_BINS)
    y = ((np.nan_to_num(dense[:, 0], posinf=1, neginf=-1)
          + 0.4 * codes[:, 0]) > 0.5).astype(np.float32)
    return dense, codes, tables, y


def _model(kind, loss="squared", seed=0, n_trees=4, depth=4):
    dense, codes, tables, y = _dataset(seed)
    bins = jgbdt.bin_dataset(tables, dense, codes, N_BINS)
    cfg = TreeConfig(max_depth=depth, n_bins=N_BINS, learning_rate=0.2,
                     loss=loss)
    if kind == "rf":
        trees = jgbdt.build_rf(cfg, bins, y, np.ones_like(y), n_trees,
                               "SQRT", 1.0, 7)
    else:
        trees, _ = jgbdt.build_gbt(cfg, bins, y, np.ones_like(y), n_trees)
    meta = {"kind": kind,
            "treeConfig": {"max_depth": cfg.max_depth, "n_bins": N_BINS,
                           "learning_rate": cfg.learning_rate,
                           "loss": cfg.loss}}
    params = {"trees": jax.tree.map(np.asarray, trees), "tables": tables}
    return meta, params, dense, codes


def _port_kernel_route(meta, params, dense, codes):
    ens = weights.to_torch(meta["kind"], meta, params, "cpu")
    fb = tgbdt.make_fused_inputs(ens.tables, dense, codes, N_BINS,
                                 device="cpu")
    return fused_trees.predict_ensemble(ens.nodes, fb.valuesT, fb.cuts,
                                        **ens.statics, return_leaves=True)


@pytest.mark.parametrize("kind,loss", [("gbt", "squared"), ("gbt", "log"),
                                       ("rf", "squared")])
def test_matches_pallas_interpret_and_xla_walk(kind, loss):
    meta, params, dense, codes = _model(kind, loss)
    score, leaves = _port_kernel_route(meta, params, dense, codes)

    fb = jgbdt.make_fused_inputs(params["tables"], dense, codes, N_BINS)
    packed, _ = pallas_trees.pack_ensemble(params["trees"])
    ref_pallas = pallas_trees.predict_ensemble(
        jnp.asarray(packed), jnp.asarray(fb.valuesT), jnp.asarray(fb.cuts),
        n_trees=params["trees"]["feature"].shape[0], kind=kind, loss=loss,
        learning_rate=0.2, max_depth=4, n_bins=N_BINS, interpret=True)
    np.testing.assert_allclose(score.numpy(), np.asarray(ref_pallas), **TOL)
    ref_xla = jgbdt.predict(meta, params, dense, codes, route="xla")
    np.testing.assert_allclose(score.numpy(), ref_xla, **TOL)

    # routing: landing nodes identical to the JAX walk over its own bins
    bins = jgbdt.bin_dataset(params["tables"], dense, codes, N_BINS)
    ref_leaves = jgbdt.leaf_indices(
        jax.tree.map(jnp.asarray, params["trees"]),
        jnp.asarray(np.ascontiguousarray(bins.T)), 4, N_BINS)
    np.testing.assert_array_equal(leaves.numpy(), np.asarray(ref_leaves))


def test_plain_walk_and_bins_match_jax():
    """`bin_dataset` is bit-equal and `predict_trees` (the per-level walk
    the service checks the kernel against) lands on the same leaves."""
    meta, params, dense, codes = _model("gbt", seed=1)
    bins = tgbdt.bin_dataset(params["tables"], dense, codes, N_BINS)
    np.testing.assert_array_equal(
        bins, jgbdt.bin_dataset(params["tables"], dense, codes, N_BINS))
    trees = {k: torch.tensor(v) for k, v in params["trees"].items()}
    got = tgbdt.predict_trees(trees, torch.as_tensor(bins.T.copy()), 4,
                              N_BINS)
    ref = jgbdt.predict_trees(jax.tree.map(jnp.asarray, params["trees"]),
                              jnp.asarray(bins.T.copy()), 4, N_BINS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _hand_tree(n_nodes, feature, bin_, default_left, leaves):
    t = {"feature": np.full((1, n_nodes), -1, np.int32),
         "bin": np.zeros((1, n_nodes), np.int32),
         "default_left": np.zeros((1, n_nodes), np.int32),
         "is_leaf": np.ones((1, n_nodes), bool),
         "gain": np.zeros((1, n_nodes), np.float32),
         "leaf_value": np.zeros((1, n_nodes), np.float32)}
    t["feature"][0, 0] = feature
    t["bin"][0, 0] = bin_
    t["default_left"][0, 0] = default_left
    t["is_leaf"][0, 0] = False
    t["leaf_value"][0, 1:3] = leaves
    return t


def _hand_case(loss, leaves, default_left=0):
    n_bins = 8
    cfg = TreeConfig(max_depth=1, n_bins=n_bins, learning_rate=1.0,
                     loss=loss)
    trees = _hand_tree(cfg.n_nodes, 0, 2, default_left, leaves)
    num_cuts = np.arange(1, n_bins - 1, dtype=np.float32)[:, None]
    tables = jgbdt.make_bin_tables(num_cuts, [], n_bins)
    meta = {"kind": "gbt",
            "treeConfig": {"max_depth": 1, "n_bins": n_bins,
                           "learning_rate": 1.0, "loss": loss}}
    return meta, {"trees": trees, "tables": tables}


@pytest.mark.parametrize("default_left", [0, 1])
def test_missing_routes_by_default_left(default_left):
    meta, params = _hand_case("squared", (-1.0, 2.0), default_left)
    dense = np.array([[0.5], [2.5], [np.nan], [np.inf]], np.float32)
    ens = weights.to_torch("gbt", meta, params, "cpu")
    got = tgbdt.predict(meta, ens, dense, None).numpy()
    ref = jgbdt.predict(meta, params, dense, None, route="xla")
    np.testing.assert_array_equal(got, ref)
    assert got[2] == (-1.0 if default_left else 2.0)


def test_logloss_clip_boundary():
    """Raw scores past ±30 clip before the sigmoid."""
    meta, params = _hand_case("log", (-100.0, 100.0))
    dense = np.array([[0.5], [5.5]], np.float32)
    ens = weights.to_torch("gbt", meta, params, "cpu")
    got = tgbdt.predict(meta, ens, dense, None).numpy()
    np.testing.assert_allclose(got, jgbdt.predict(meta, params, dense, None,
                                                  route="xla"), **TOL)
    np.testing.assert_allclose(got, [1.0 / (1.0 + np.exp(30.0)),
                                     1.0 / (1.0 + np.exp(-30.0))],
                               rtol=1e-6)


def test_row_count_invariance():
    """Each row only sees its own lane: scoring a prefix, or the batch
    padded by repeating its last row, gives the same per-row scores."""
    meta, params, dense, codes = _model("gbt", seed=2, n_trees=3, depth=3)
    base, _ = _port_kernel_route(meta, params, dense, codes)
    head, _ = _port_kernel_route(meta, params, dense[:37], codes[:37])
    np.testing.assert_array_equal(head.numpy(), base.numpy()[:37])
    pad = np.concatenate([dense, np.repeat(dense[-1:], 40, 0)])
    padc = np.concatenate([codes, np.repeat(codes[-1:], 40, 0)])
    padded, _ = _port_kernel_route(meta, params, pad, padc)
    np.testing.assert_array_equal(padded.numpy()[:len(dense)], base.numpy())


def test_make_fused_inputs_defaults_to_the_card(monkeypatch):
    """Without a device argument the packing targets the card, like
    every entry point: with none present it raises instead of quietly
    building CPU tensors."""
    dense, codes, tables, _ = _dataset(3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tgbdt.make_fused_inputs(tables, dense, codes, N_BINS)


# ---------------------------------------------------------------------------
# The redesigned kernel's pieces, rehearsed on the CPU: binary-search
# binning, the node records, and `_k2_plan`
# ---------------------------------------------------------------------------

def _adversarial_cuts(rng, k):
    """Ascending cuts of width K with duplicated values and, past the
    real cuts, +inf pads (K need not be a power of two)."""
    real = max(1, k - 3)
    base = np.sort(rng.choice(np.arange(-6, 7, dtype=np.float32) / 2,
                              real))                 # duplicates likely
    return np.concatenate([base, np.full(k - real, np.inf, np.float32)])


def _adversarial_values(rng, cuts, n=400):
    """Values on every cut (ties), between cuts, ±inf and NaN."""
    fin = cuts[np.isfinite(cuts)]
    v = np.concatenate([fin, fin + 0.25, fin - 0.25,
                        rng.normal(0, 2, n).astype(np.float32),
                        [np.inf, -np.inf, np.nan, np.nan, 1e30, -1e30]])
    return v.astype(np.float32)


def _sigma_bins(v, cuts, n_bins):
    """The plain rule: Σ(v ≥ cut) clamped to n_bins-2, NaN → n_bins-1."""
    b = np.minimum((v[:, None] >= cuts[None, :]).sum(1), n_bins - 2)
    return np.where(np.isnan(v), n_bins - 1, b)


def _bin_of_sorted(v, cuts, n_bins):
    """`bin_of_sorted` of csrc/binning.cuh, step for step, over the cuts
    as the kernel stages them: the K cuts, then NaN up to
    `search_span(K)` slots; binary lifting from the largest power of two
    <= K with no bound check (a NaN slot is <= no value)."""
    if np.isnan(v):
        return n_bins - 1
    k = len(cuts)
    span = fused_trees.search_span(k)
    staged = np.concatenate([cuts, np.full(span - k, np.nan, np.float32)])
    pos, step = 0, (span + 1) // 2
    while step:
        if staged[pos + step - 1] <= v:
            pos += step
        step >>= 1
    return min(pos, n_bins - 2)


@pytest.mark.parametrize("k", [7, 40, 64])
@pytest.mark.parametrize("n_bins", [8, 64, 256])
def test_binary_search_bins_equal_the_sum_rule(k, n_bins):
    """searchsorted(cuts[:K], v, right=True) clamped to n_bins-2 (NaN →
    n_bins-1), and the kernel's bounded search, both equal Σ(v ≥ cut):
    on ties, duplicated cuts, +inf pads with K not a power of two, ±inf
    and NaN values."""
    rng = np.random.default_rng(100 + k + n_bins)
    cuts = _adversarial_cuts(rng, k)
    v = _adversarial_values(rng, cuts)
    want = _sigma_bins(v, cuts, n_bins)
    tc, tv = torch.as_tensor(cuts), torch.as_tensor(v)
    got = torch.searchsorted(tc, tv, right=True).clamp(max=n_bins - 2)
    got = torch.where(torch.isnan(tv), n_bins - 1, got)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        [_bin_of_sorted(x, cuts, n_bins) for x in v], want)
    # and the plain kernel route bins the same way
    vT = torch.as_tensor(np.tile(v, (2, 1)))
    plain_bins = torch.zeros(vT.shape, dtype=torch.long)
    for j in range(k):
        plain_bins += vT >= torch.as_tensor(np.tile(cuts, (2, 1)))[:, j:j + 1]
    plain_bins = torch.where(torch.isnan(vT), n_bins - 1,
                             plain_bins.clamp(max=n_bins - 2))
    np.testing.assert_array_equal(plain_bins[0].numpy(), want)


def test_inf_counts_only_the_pads_inside_k():
    """K = 7 with two +inf pads and 64 bins: v = +inf lands in bin 7
    (every cut counts), not in the bin a search over cuts padded to a
    power of two with further +inf would give (8)."""
    cuts = np.array([-1, 0, 0, 1, 2, np.inf, np.inf], np.float32)
    assert _sigma_bins(np.array([np.inf], np.float32), cuts, 64)[0] == 7
    assert _bin_of_sorted(np.float32(np.inf), cuts, 64) == 7
    padded = np.concatenate([cuts, [np.inf]]).astype(np.float32)
    assert _bin_of_sorted(np.float32(np.inf), padded, 64) == 8


def test_pack_nodes_records():
    """Each node's split word decodes to the packed block's split bin
    (bits 0-7, at most 254), default_left (bit 8), stop (bit 9) and, on
    split nodes, feature (bits 16-30; 0 on stop nodes); the leaf plane
    holds the leaf values' exact bits."""
    meta, params, _, _ = _model("gbt", seed=3, n_trees=3, depth=3)
    ens = weights.to_torch("gbt", meta, params, "cpu")
    rec = ens.node_pack
    assert rec.dtype == torch.int32 and tuple(rec.shape) == \
        (2, ens.nodes.shape[1])
    assert torch.equal(rec, fused_trees.pack_nodes(ens.nodes, ens.n_trees))
    w0 = rec[0]
    stop = ens.nodes[3] > 0
    assert stop.any() and (~stop).any()
    np.testing.assert_array_equal(w0 & 0xFF, ens.nodes[1].int().clamp(0, 254))
    np.testing.assert_array_equal((w0 >> 8) & 1, (ens.nodes[2] > 0).int())
    np.testing.assert_array_equal((w0 >> 9) & 1, stop.int())
    np.testing.assert_array_equal(
        w0 >> 16, torch.where(stop, 0, ens.nodes[0].int()))
    assert torch.equal(rec[1].view(torch.float32), ens.nodes[4])


def test_k2_plan_layouts_and_chunks(monkeypatch):
    """One warp per row up to SMALL_R_MAX rows, one thread per row
    above; every ensemble that fits the budget is one chunk, a larger
    one is walked in chunks, and the bytes are the kernel's formula."""
    small = fused_trees.SMALL_R_MAX
    c, k, t, n_pad = 28, 63, 20, 128
    for r in (1, 512, small):
        assert fused_trees._k2_plan(r, c, k, t, n_pad).layout == \
            fused_trees.LAYOUT_WARPS
    for r in (small + 1, 1 << 20):
        assert fused_trees._k2_plan(r, c, k, t, n_pad).layout == \
            fused_trees.LAYOUT_ROWS
    for r in (small, small + 1):
        plan = fused_trees._k2_plan(r, c, k, t, n_pad)
        assert plan.chunk == t
        assert plan.smem == fused_trees.smem_bytes(plan.layout, c, k, n_pad,
                                                   t)
        assert plan.smem <= fused_trees.SMEM_BUDGET
    monkeypatch.setattr(fused_trees, "SMEM_BUDGET", 24 * 1024)
    for r in (small, small + 1):
        plan = fused_trees._k2_plan(r, c, k, t, n_pad)
        assert 1 <= plan.chunk < t and plan.smem <= 24 * 1024
        assert fused_trees.smem_bytes(plan.layout, c, k, n_pad,
                                      plan.chunk + 1) > 24 * 1024
    monkeypatch.setattr(fused_trees, "SMEM_BUDGET", 4 * 1024)
    with pytest.raises(ValueError, match="budget"):
        fused_trees._k2_plan(1, c, k, t, n_pad)
