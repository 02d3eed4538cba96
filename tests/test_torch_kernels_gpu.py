"""Each CUDA kernel of the port against its plain PyTorch version on the
card, at the shapes `chip_smoke.py` drives. Needs an NVIDIA card and
`nvcc`; elsewhere every test skips with a reason. The file imports no
JAX, so on a machine without it run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from shifu_tpu_torch.models import gbdt  # noqa: E402
from shifu_tpu_torch.ops import (best_splits, fused_score,  # noqa: E402
                                 fused_trees, level_hist)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch sees no CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("prepacked", [False, True])
@pytest.mark.parametrize("c,h", [(600, 512), (37, 16), (20, 1)])
@pytest.mark.parametrize("n", [1, 8, 37, 64, 512, 65536])
def test_fused_score_matches_plain(cuda, n, c, h, prepacked):
    """Every plan the serving buckets and eval reach (cluster K-splits at
    small N, two warpgroups above 64 rows), odd widths (C = 37 takes the
    4-byte copies) and H = 1, with and without a precomputed pack."""
    x, mean, std, w, b = cs.k1_inputs(n + c, n, cuda, c, h)
    kw = dict(packed=fused_score.pack_norm(mean, std, cs.CUTOFF),
              packed_w=fused_score.pack_weights(w)) if prepacked else {}
    before = fused_score.launches
    got = fused_score.fused_first_layer(x, mean, std, cs.CUTOFF, w, b, **kw)
    want = fused_score.fused_first_layer_plain(x, mean, std, cs.CUTOFF, w,
                                               b)
    torch.cuda.synchronize()
    assert fused_score.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [8, 512, 65536])
def test_fused_score_launches_bit_identical(cuda, n):
    """The K-split reduces in a fixed order, without atomics: two
    launches on the same input agree bit for bit."""
    x, mean, std, w, b = cs.k1_inputs(3, n, cuda)
    one = fused_score.fused_first_layer(x, mean, std, cs.CUTOFF, w, b)
    two = fused_score.fused_first_layer(x, mean, std, cs.CUTOFF, w, b)
    torch.cuda.synchronize()
    assert torch.equal(one, two)


@pytest.mark.parametrize("r,kind,loss", [(1, "gbt", "log"),
                                         (512, "gbt", "log"),
                                         (700, "rf", "squared"),
                                         (512, "gbt", "squared")])
def test_fused_trees_matches_plain(cuda, r, kind, loss):
    nodes, vT, cuts, kw = cs.k2_inputs(r, r, cuda, kind, loss)
    got, leaves = fused_trees.predict_ensemble(nodes, vT, cuts, **kw,
                                               return_leaves=True)
    want, want_leaves = fused_trees.predict_ensemble_plain(
        nodes, vT, cuts, **kw, return_leaves=True)
    torch.cuda.synchronize()
    assert torch.equal(leaves, want_leaves)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t", [1, 20, 200])
@pytest.mark.parametrize("r", [2048, 2049, 100_000])
def test_fused_trees_layouts_and_tree_counts(cuda, r, t):
    """Both layouts (one warp per row up to SMALL_R_MAX = 2048 rows, one
    thread per row above) at 1, 20 and 200 trees: leaves exact."""
    assert fused_trees.SMALL_R_MAX == 2048
    nodes, vT, cuts, kw = cs.k2_inputs(t, r, cuda, t=t)
    got, leaves = fused_trees.predict_ensemble(nodes, vT, cuts, **kw,
                                               return_leaves=True)
    want, want_leaves = fused_trees.predict_ensemble_plain(
        nodes, vT, cuts, **kw, return_leaves=True)
    torch.cuda.synchronize()
    assert torch.equal(leaves, want_leaves)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("r", [300, 5000])
@pytest.mark.parametrize("k,n_bins", [(7, 64), (40, 8), (64, 256)])
def test_fused_trees_adversarial_binning(cuda, r, k, n_bins):
    """Cuts with duplicates and +inf pads (K not a power of two), values
    on every cut, ±inf and NaN: the binary search lands every row on the
    plain Σ(v ≥ cut) walk's leaves, in both layouts."""
    nodes, vT, _, kw = cs.k2_inputs(k, r, cuda)
    kw["n_bins"] = n_bins
    gen = np.random.default_rng(k)
    c = vT.shape[0]
    real = max(1, k - 3)
    cuts = np.sort(gen.choice(np.arange(-6, 7) / 2.0, (c, real)), axis=1)
    cuts = np.concatenate([cuts, np.full((c, k - real), np.inf)], axis=1)
    cuts_t = torch.as_tensor(cuts, dtype=torch.float32, device=cuda)
    on_cut = cuts_t[torch.arange(c, device=cuda)[:, None],
                    torch.randint(0, real, (c, r), device=cuda)]
    pick = torch.rand((c, r), device=cuda)
    vals = torch.where(pick < 0.5, on_cut, vT)
    vals[(pick > 0.90) & (pick <= 0.93)] = np.inf
    vals[(pick > 0.93) & (pick <= 0.96)] = -np.inf
    vals[pick > 0.96] = np.nan
    vals = vals.contiguous()
    got, leaves = fused_trees.predict_ensemble(nodes, vals, cuts_t, **kw,
                                               return_leaves=True)
    want, want_leaves = fused_trees.predict_ensemble_plain(
        nodes, vals, cuts_t, **kw, return_leaves=True)
    torch.cuda.synchronize()
    assert torch.equal(leaves, want_leaves)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("r", [300, 5000])
def test_fused_trees_chunks_large_ensembles(cuda, monkeypatch, r):
    """An ensemble larger than the shared-memory budget is walked in
    chunks of trees and scores the same, in both layouts."""
    nodes, vT, cuts, kw = cs.k2_inputs(9, r, cuda)
    whole = fused_trees.predict_ensemble(nodes, vT, cuts, **kw)
    monkeypatch.setattr(fused_trees, "SMEM_BUDGET", 24 * 1024)
    assert fused_trees._k2_plan(r, vT.shape[0], cuts.shape[1],
                                kw["n_trees"], nodes.shape[1]
                                // kw["n_trees"]).chunk < kw["n_trees"]
    chunked = fused_trees.predict_ensemble(nodes, vT, cuts, **kw)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


def test_cuda_route_never_falls_back(cuda):
    """On a CUDA tensor the wrapper launches or raises: a shape the
    kernel does not take is refused, not sent to the plain route."""
    nodes, vT, cuts, kw = cs.k2_inputs(10, 64, cuda)
    kw["n_bins"] = 300
    with pytest.raises(ValueError, match="n_bins"):
        fused_trees.predict_ensemble(nodes, vT, cuts, **kw)
    x = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError):
        fused_score.fused_first_layer(
            x, torch.zeros(3, device=cuda), torch.ones(3, device=cuda),
            cs.CUTOFF, torch.zeros((3, 2), device=cuda),
            torch.zeros(2, device=cuda),
            packed=torch.zeros((4, 5), device=cuda))


# ---------------------------------------------------------------------------
# The training kernels: K3, K4 (level_hist) and K5 (best_splits)
# ---------------------------------------------------------------------------


def test_profile_trace_names_k1_and_k3(cuda, tmp_path, monkeypatch):
    """`profiling.maybe_profile` (the `--profile` flag) around one K1
    and one K3 launch: the Chrome trace it exports under the trace run's
    id names both kernels, once each."""
    import json

    from shifu_tpu_torch import profiling
    from shifu_tpu_torch.obs import trace as obs_trace
    monkeypatch.setenv("SHIFU_TPU_TRACE", "1")
    monkeypatch.delenv("SHIFU_TPU_TRACE_DIR", raising=False)
    x, mean, std, w, b = cs.k1_inputs(5, 512, cuda)
    _, _, binsT, slot, grad, hess = cs.hist_inputs(3, 100_003, 8, cuda,
                                                   True)
    binsT = binsT.to(torch.uint8)
    # built and warm before the profiled window
    fused_score.fused_first_layer(x, mean, std, cs.CUTOFF, w, b)
    level_hist.level_histograms(binsT, slot, grad, hess, 8, cs.GBT_BINS)
    torch.cuda.synchronize()
    root = str(tmp_path)
    before = fused_score.launches, level_hist.launches
    with obs_trace.trace_run(root, "train") as run, \
            profiling.maybe_profile(root, "train", True) as out:
        fused_score.fused_first_layer(x, mean, std, cs.CUTOFF, w, b)
        level_hist.level_histograms(binsT, slot, grad, hess, 8,
                                    cs.GBT_BINS)
        torch.cuda.synchronize()
    assert os.path.basename(out) == run.run_id
    with open(os.path.join(out, profiling.PROFILE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert (fused_score.launches, level_hist.launches) == \
        (before[0] + 1, before[1] + 1)
    assert sum("fused_score_kernel" in n for n in kernels) == 1, kernels
    assert sum("level_hist_kernel" in n for n in kernels) == 1, kernels
    assert [r["run_id"] for r in obs_trace.trace_ls(root)] == [run.run_id]


@pytest.mark.parametrize("n_slots", [1, 7, 32])
@pytest.mark.parametrize("integer", [True, False])
def test_level_hist_k3_k4_match_plain(cuda, n_slots, integer):
    """K3 on the builders' uint8 bins and on int32 bins, and K4 on the
    raw values, against the plain version; K4 equals K3 over the same
    bins on integer grads."""
    vals, cuts, binsT, slot, grad, hess = cs.hist_inputs(
        n_slots, 100_003, n_slots, cuda, integer)
    want = level_hist.level_histograms_plain(binsT, slot, grad, hess,
                                             n_slots, cs.GBT_BINS)
    before = level_hist.launches, level_hist.fused_launches
    k3 = [level_hist.level_histograms(b, slot, grad, hess, n_slots,
                                      cs.GBT_BINS)
          for b in (binsT, binsT.to(torch.uint8))]
    k4 = level_hist.level_histograms_fused(vals, cuts, slot, grad, hess,
                                           n_slots, cs.GBT_BINS)
    torch.cuda.synchronize()
    assert (level_hist.launches, level_hist.fused_launches) == \
        (before[0] + 2, before[1] + 1)
    for got in k3 + [k4]:
        for g, w, wt in zip(got, want, (grad, hess)):
            cs._hist_err("hist", g, w, slot, wt, n_slots, integer)
    if integer:
        assert torch.equal(k4[0], k3[1][0]) and torch.equal(k4[1], k3[1][1])


def _exact(got, binsT, slot, grad, hess, n_slots, n_bins):
    want = level_hist.level_histograms_plain(binsT, slot, grad, hess,
                                             n_slots, n_bins)
    assert got[0].shape == want[0].shape
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _int_rows(seed, shape, n_slots, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    slot = torch.randint(-1, n_slots + 1, shape, generator=gen,
                         device=device, dtype=torch.int32)
    grad = torch.randint(-3, 4, shape, generator=gen, device=device).float()
    hess = torch.randint(0, 3, shape, generator=gen, device=device).float()
    return slot, grad, hess


def test_level_hist_forest_axis_and_slot_tiles(cuda):
    """(T, R) per-tree rows in one launch; a level too wide for one
    block's shared memory splits its slots across blocks (S = 512 at
    B = 64, S = 64 at B = 256); T = 20 trees."""
    _, _, binsT, _, _, _ = cs.hist_inputs(3, 50_000, 1, cuda, True)
    for n_slots, n_bins, t in ((4, 64, 3), (512, 64, 3), (64, 256, 3),
                               (32, 64, 20)):
        bins = binsT if n_bins == 64 else binsT * 4 + 3
        slot, grad, hess = _int_rows(n_slots, (t, 50_000), n_slots, cuda)
        plan = level_hist.plan_for(bins, None, slot, n_slots, n_bins)
        assert (n_slots, n_bins) not in ((512, 64), (64, 256)) or \
            plan.slot_tile < n_slots
        for b in (bins, bins.to(torch.uint8)):
            got = level_hist.level_histograms(b, slot, grad, hess, n_slots,
                                              n_bins)
            assert got[0].shape == (t, n_slots, cs.GBT_COLS, n_bins)
            _exact(got, bins, slot, grad, hess, n_slots, n_bins)


@pytest.mark.parametrize("r", [1, 15, 17, 511, 1000, 100_003])
@pytest.mark.parametrize("trees", [0, 3])
def test_level_hist_ragged_rows(cuda, r, trees):
    """R below one chunk, R % 16 != 0 and a ragged last chunk, for one
    tree and for a forest whose trees start off the 16-byte grid."""
    vals, cuts, binsT, _, _, _ = cs.hist_inputs(r, r, 1, cuda, True)
    slot, grad, hess = _int_rows(r, ((trees,) if trees else ()) + (r,), 8,
                                 cuda)
    for b in (binsT, binsT.to(torch.uint8)):
        _exact(level_hist.level_histograms(b, slot, grad, hess, 8,
                                           cs.GBT_BINS),
               binsT, slot, grad, hess, 8, cs.GBT_BINS)
    _exact(level_hist.level_histograms_fused(vals, cuts, slot, grad, hess, 8,
                                             cs.GBT_BINS),
           binsT, slot, grad, hess, 8, cs.GBT_BINS)


@pytest.mark.parametrize("c,n_slots", [(29, 32), (7, 8), (1, 4), (300, 2)])
def test_level_hist_columns_not_a_tile_multiple(cuda, c, n_slots):
    """Column counts that leave the last block of a cluster (or of a
    column group) part empty."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    r = 20_011
    binsT = torch.randint(0, cs.GBT_BINS, (c, r), generator=gen,
                          device=cuda, dtype=torch.int32)
    slot, grad, hess = _int_rows(c, (r,), n_slots, cuda)
    got = level_hist.level_histograms(binsT.to(torch.uint8), slot, grad,
                                      hess, n_slots, cs.GBT_BINS)
    _exact(got, binsT, slot, grad, hess, n_slots, cs.GBT_BINS)


@pytest.mark.parametrize("k", [1, 2, 3, 7, 62, 254])
def test_level_hist_k4_adversarial_cuts(cuda, k):
    """K4's binary search over staged cuts with duplicates, ±inf pads,
    NaN values and values equal to a cut gives K3 over the plain bins
    exactly."""
    n_bins, c, r = k + 2, 5, 30_001
    gen = torch.Generator(device=cuda).manual_seed(k)
    cuts = torch.sort(torch.randn((c, k), generator=gen, device=cuda),
                      dim=1).values
    if k >= 3:
        cuts[0, 1] = cuts[0, 0]
        cuts[1, -1] = float("inf")
        cuts[3, -(k // 2):] = float("inf")
    if k >= 2:
        cuts[2, 0] = -float("inf")
    vals = torch.randn((c, r), generator=gen, device=cuda)
    u = torch.rand((c, r), generator=gen, device=cuda)
    vals[u < 0.05] = float("nan")
    vals[u > 0.99] = float("inf")
    vals[(u > 0.98) & (u <= 0.99)] = -float("inf")
    pick = torch.randint(0, k, (c, r), generator=gen, device=cuda)
    on_cut = (u > 0.5) & (u < 0.7)
    vals[on_cut] = torch.gather(cuts, 1, pick)[on_cut]
    cuts = cuts.contiguous()
    binsT = level_hist.bins_from_values_plain(vals, cuts, n_bins)
    slot, grad, hess = _int_rows(k, (r,), 4, cuda)
    _exact(level_hist.level_histograms_fused(vals, cuts, slot, grad, hess,
                                             4, n_bins),
           binsT, slot, grad, hess, 4, n_bins)


def test_level_hist_plan_variants_and_smem(cuda):
    """Every variant the timing sweeps force (histogram replicas, other
    clusters, the slot tiles they bring) gives the plain result; the
    launch refuses a plan whose shared memory disagrees with the
    kernel's layout, so every launch holds the Python mirror to it."""
    vals, cuts, binsT, slot, grad, hess = cs.hist_inputs(9, 70_001, 32,
                                                         cuda, True)
    b8 = binsT.to(torch.uint8)
    variants = [level_hist.plan_for(b8, None, slot, 32, cs.GBT_BINS,
                                    cluster=cl, copies=cp)
                for cl, cp in ((None, None), (1, 1), (2, 4), (4, 8),
                               (7, 16), (1, None))]
    assert any(v.slot_tile < 32 for v in variants)
    for v in variants:
        _exact(level_hist._launch(b8, None, slot, grad, hess, 32,
                                  cs.GBT_BINS, plan=v),
               binsT, slot, grad, hess, 32, cs.GBT_BINS)
    k4 = level_hist.plan_for(vals, cuts, slot, 32, cs.GBT_BINS)
    _exact(level_hist._launch(vals, cuts, slot, grad, hess, 32, cs.GBT_BINS,
                              plan=k4),
           binsT, slot, grad, hess, 32, cs.GBT_BINS)
    for plan, b, c in ((variants[0], b8, None), (k4, vals, cuts)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            level_hist._launch(b, c, slot, grad, hess, 32, cs.GBT_BINS,
                               plan=plan._replace(smem=plan.smem - 16))


@pytest.mark.parametrize("n_slots", [1, 32])
def test_level_hist_two_launches_are_bit_identical(cuda, n_slots):
    """K3 (uint8 and int32 bins) and K4 add in fixed point, so two
    launches on real-valued gradients give the same bits (and a forest
    of 3 trees too)."""
    vals, cuts, binsT, slot, grad, hess = cs.hist_inputs(
        31 + n_slots, 500_003, n_slots, cuda, False)
    for lead in (None, 3):
        sl, g, h = (slot, grad, hess) if lead is None else (
            x.expand(lead, -1).contiguous() for x in (slot, grad, hess))
        for b in (binsT, binsT.to(torch.uint8)):
            one = level_hist.level_histograms(b, sl, g, h, n_slots,
                                              cs.GBT_BINS)
            two = level_hist.level_histograms(b, sl, g, h, n_slots,
                                              cs.GBT_BINS)
            assert torch.equal(one[0], two[0]) and torch.equal(one[1],
                                                               two[1])
        one = level_hist.level_histograms_fused(vals, cuts, sl, g, h,
                                                n_slots, cs.GBT_BINS)
        two = level_hist.level_histograms_fused(vals, cuts, sl, g, h,
                                                n_slots, cs.GBT_BINS)
        assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


def test_level_hist_second_card(cuda):
    """K3 and K4 launch on every card present, each with the kernel's
    shared-memory limit and its occupancy set on that card (needs two
    cards; skips on one)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("one card: nothing to launch on a second one")
    for i in range(torch.cuda.device_count() - 1, -1, -1):
        dev = torch.device("cuda", i)
        vals, cuts, binsT, slot, grad, hess = cs.hist_inputs(
            11 + i, 50_003, 32, dev, True)
        with torch.cuda.device(0):
            got = level_hist.level_histograms(binsT.to(torch.uint8), slot,
                                              grad, hess, 32, cs.GBT_BINS)
            fused = level_hist.level_histograms_fused(
                vals, cuts, slot, grad, hess, 32, cs.GBT_BINS)
        assert got[0].device == dev
        _exact(got, binsT, slot, grad, hess, 32, cs.GBT_BINS)
        _exact(fused, binsT, slot, grad, hess, 32, cs.GBT_BINS)


def _k5_cases():
    """(N, C, B) over N ∈ {1, 32, 320, 640}, C ∈ {1, 28, 33, 300} and
    B ∈ {2, 3, 64, 65, 256, 1024}, without the products above 2^24
    cells (their histograms and references run to gigabytes)."""
    return [(n, c, b) for n in (1, 32, 320, 640) for c in (1, 28, 33, 300)
            for b in (2, 3, 64, 65, 256, 1024) if n * c * b <= 2 ** 24]


def _k5_mask_rows(n):
    """The mask forms at N nodes: (C,) at N = 1, a forest's (T, C) masks
    at N = 320 and 640 (10 and 20 trees), and at N = 32 the GBT
    builder's one (1, C) row for every node and a mask a node."""
    return {1: [None], 32: [1, 32], 320: [10], 640: [20]}[n]


@pytest.mark.parametrize("n", [1, 32, 640])
def test_best_splits_matches_plain(cuda, n):
    """Integer-valued histograms (every order of adds exact): every
    output equals the plain version bit for bit, and one call is one
    launch."""
    g, h, mask = cs.split_inputs(n, n, cuda)
    before = best_splits.launches
    got = best_splits.best_splits(g, h, mask, 1.0, 2.0)
    want = best_splits.best_splits_plain(g, h, mask, 1.0, 2.0)
    torch.cuda.synchronize()
    assert best_splits.launches == before + 1
    assert cs.same_bits(got, want) == []


@pytest.mark.parametrize("n,c,b", _k5_cases())
def test_best_splits_shapes_bit_exact(cuda, n, c, b):
    """Real-valued histograms against the sequential-f32 reference and
    integer-valued ones against the plain version, bit for bit, over
    tiles of one column up to all of a node's, and columns of 1 to
    1,023 main bins, each in one shared-memory segment."""
    for m in _k5_mask_rows(n):
        for integer in (False, True):
            g, h, mask = cs.split_inputs(n + c + b, n, cuda, c, b, integer,
                                         m)
            got = best_splits.best_splits(g, h, mask, 1.0, 2.0)
            want = (best_splits.best_splits_plain if integer
                    else cs.k5_sequential)(g, h, mask, 1.0, 2.0)
            assert cs.same_bits(got, want) == [], (integer,
                                                   tuple(mask.shape))


@pytest.mark.parametrize("c", [1, 33])
def test_best_splits_segments_when_no_column_fits(cuda, c):
    """6,143 main bins: not one column's sums fit shared memory, so each
    column goes in segments, summed twice (totals, then scores), bit
    for bit all the same."""
    for integer in (False, True):
        g, h, mask = cs.split_inputs(c, 4, cuda, c, 6144, integer)
        got = best_splits.best_splits(g, h, mask, 1.0, 2.0)
        want = (best_splits.best_splits_plain if integer
                else cs.k5_sequential)(g, h, mask, 1.0, 2.0)
        assert cs.same_bits(got, want) == [], integer


@pytest.mark.parametrize("c", [40, 300])
def test_best_splits_tie_across_warps_goes_to_the_earlier_column(cuda, c):
    """Two identical columns, the only ones switched on, whose equal
    cells threads of other warps score: their gains tie exactly and the
    earlier column wins."""
    for first, second in ((3, 20), (3, 35)):
        g, h, _ = cs.split_inputs(c, 8, cuda, c, 64, False)
        g[:, second] = g[:, first]
        h[:, second] = h[:, first]
        mask = torch.zeros((8, c), device=cuda)
        mask[:, first] = mask[:, second] = 1.0
        got = best_splits.best_splits(g, h, mask, 1.0, 2.0)
        assert bool((got["feature"] == first).all()), (first, second)
        assert cs.same_bits(got, cs.k5_sequential(g, h, mask, 1.0,
                                                  2.0)) == []


def test_best_splits_all_masked_node(cuda):
    """A node with every feature off resolves to index 0 with gain -inf
    and column 0, bin 0's default_left; column 0's totals all the
    same."""
    g, h, mask = cs.split_inputs(3, 32, cuda, 28, 64, False)
    mask[5] = 0.0
    got = best_splits.best_splits(g, h, mask, 1.0, 2.0)
    want = cs.k5_sequential(g, h, mask, 1.0, 2.0)
    assert cs.same_bits(got, want) == []
    for node in (0, 5):
        assert got["gain"][node] == -math.inf
        assert got["feature"][node] == 0 and got["bin"][node] == 0


def test_best_splits_nan_gains(cuda):
    """λ = 0 and empty bins with min_inst = 0: 0/0 gains are NaN, rank
    above every number and keep torch.maximum's NaN."""
    g, h, mask = cs.split_inputs(4, 32, cuda, 28, 64)
    gen = torch.Generator(device=cuda).manual_seed(4)
    empty = torch.rand(g.shape, generator=gen, device=cuda) < 0.3
    g[empty] = 0.0
    h[empty] = 0.0
    got = best_splits.best_splits(g, h, mask, 0.0, 0.0)
    want = best_splits.best_splits_plain(g, h, mask, 0.0, 0.0)
    assert bool(torch.isnan(want["gain"]).any())
    assert cs.same_bits(got, want) == []
    assert cs.same_bits(got, cs.k5_sequential(g, h, mask, 0.0, 0.0)) == []


@pytest.mark.parametrize("min_inst", [2.0, 200.0, 1e9])
def test_best_splits_min_inst(cuda, min_inst):
    """Sides lighter than min_inst score -inf: some cells, most of them,
    or every one (the node then resolves to index 0)."""
    g, h, mask = cs.split_inputs(5, 32, cuda, 28, 64)
    got = best_splits.best_splits(g, h, mask, 1.0, min_inst)
    want = best_splits.best_splits_plain(g, h, mask, 1.0, min_inst)
    assert cs.same_bits(got, want) == []
    if min_inst == 1e9:
        assert bool((got["gain"] == -math.inf).all())
        assert bool((got["feature"] == 0).all())


def test_best_splits_forest_masks_equal_per_node_masks(cuda):
    """(T, C) masks give what the same masks repeated to one row a node
    give: node i reads row i // P."""
    g, h, masks = cs.split_inputs(6, 640, cuda, 28, 64, False, 20)
    per_node = torch.repeat_interleave(masks, 32, dim=0)
    got = best_splits.best_splits(g, h, masks, 1.0, 2.0)
    assert cs.same_bits(got, best_splits.best_splits(
        g, h, per_node, 1.0, 2.0)) == []


def test_best_splits_warps_and_launch_count(cuda, monkeypatch):
    """Every warps-a-block setting gives the same bits; each call is one
    launch."""
    g, h, mask = cs.split_inputs(7, 320, cuda, 300, 256, False, 10)
    want = cs.k5_sequential(g, h, mask, 1.0, 2.0)
    for warps in (1, 8, 16, 32):
        monkeypatch.setattr(best_splits, "_warps",
                            lambda n, dev, w=warps: w)
        before = best_splits.launches
        got = best_splits.best_splits(g, h, mask, 1.0, 2.0)
        assert best_splits.launches == before + 1
        assert cs.same_bits(got, want) == [], warps


def test_split_step_is_one_kernel(cuda):
    """A level's split search (`gbdt._apply_level` with the fold set
    aside) launches exactly one CUDA kernel, K5."""
    cfg = gbdt.TreeConfig(max_depth=6, n_bins=cs.GBT_BINS)
    counts = cs.split_step_launches(cfg)
    assert counts["search"]["launches"] == 1, counts
    assert "best_splits_kernel" in counts["search"]["kernels"][0], counts
    assert counts["fold"]["launches"] > 0


def test_serving_and_split_kernels_on_every_card(cuda):
    """K1, K2 and K5 launch on every card present with card 0 current:
    each sets its kernel attributes on the tensors' card and launches
    there (needs two cards; skips on one)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("one card: nothing to launch on a second one")
    for i in range(torch.cuda.device_count() - 1, -1, -1):
        dev = torch.device("cuda", i)
        x, mean, std, w, b = cs.k1_inputs(20 + i, 512, dev)
        nodes, vT, cuts, kw = cs.k2_inputs(20 + i, 512, dev)
        g, h, mask = cs.split_inputs(20 + i, 640, dev, mask_rows=20)
        with torch.cuda.device(0):
            k1 = fused_score.fused_first_layer(
                x, mean, std, cs.CUTOFF, w, b,
                packed=fused_score.pack_norm(mean, std, cs.CUTOFF),
                packed_w=fused_score.pack_weights(w))
            k2, leaves = fused_trees.predict_ensemble(
                nodes, vT, cuts, **kw, return_leaves=True)
            k5 = best_splits.best_splits(g, h, mask, 1.0, 2.0)
            assert torch.cuda.current_device() == 0
        torch.cuda.synchronize(dev)
        assert k1.device == k2.device == k5["gain"].device == dev
        torch.testing.assert_close(k1, fused_score.fused_first_layer_plain(
            x, mean, std, cs.CUTOFF, w, b), rtol=1e-5, atol=1e-5)
        want, want_leaves = fused_trees.predict_ensemble_plain(
            nodes, vT, cuts, **kw, return_leaves=True)
        assert torch.equal(leaves, want_leaves)
        torch.testing.assert_close(k2, want, rtol=1e-6, atol=1e-6)
        assert cs.same_bits(k5, best_splits.best_splits_plain(
            g, h, mask, 1.0, 2.0)) == []


def test_rf_and_first_gbt_round_on_card_bit_exact_with_cpu(cuda):
    """Integer gradients: atomics reorder nothing that rounds, so the
    card grows the CPU's trees bit for bit."""
    rng = np.random.default_rng(5)
    bins = rng.integers(0, 64, (20_000, cs.GBT_COLS)).astype(np.int32)
    y = ((bins[:, 0] + bins[:, 1] + rng.normal(0, 8, len(bins)))
         > 64).astype(np.float32)
    w = np.ones_like(y)
    cfg = gbdt.TreeConfig(max_depth=6, n_bins=64, learning_rate=0.2)
    for fn in (lambda d: gbdt.build_rf(cfg, bins, y, w, 4, "SQRT", 1.0, 7,
                                       device=d),
               lambda d: gbdt.build_gbt(cfg, bins, y, w, 1, device=d)[0]):
        card, cpu = fn(cuda), fn("cpu")
        for k in cpu:
            np.testing.assert_array_equal(card[k], cpu[k], err_msg=k)


def test_training_kernels_refuse_what_they_do_not_take(cuda):
    _, _, binsT, slot, grad, hess = cs.hist_inputs(4, 1000, 2, cuda, True)
    with pytest.raises(TypeError):
        level_hist.level_histograms(binsT.long(), slot, grad, hess, 2,
                                    cs.GBT_BINS)
    g = torch.zeros((2, 3, 4), device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        best_splits.best_splits(g, g, torch.ones(3, device=cuda), 1.0, 1.0)
    g = g.float()
    for mask in (torch.ones(3, device=cuda, dtype=torch.float64),
                 torch.ones((3, 2), device=cuda).T):
        with pytest.raises(TypeError, match="feature_mask"):
            best_splits.best_splits(g, g, mask, 1.0, 1.0)
    with pytest.raises(ValueError, match="feature_mask"):
        best_splits.best_splits(g, g, torch.ones((3, 3), device=cuda), 1.0,
                                1.0)


def test_level_loop_never_waits_for_the_card(cuda):
    """Growing a forest (K3, K5, fold and route on every level) makes no
    host synchronization: with CUDA sync debugging set to error, any
    `.item()`, `.cpu()` or data-dependent shape in the loop raises."""
    _, _, binsT, _, _, _ = cs.hist_inputs(6, 30_000, 1, cuda, True)
    gen = torch.Generator(device=cuda).manual_seed(6)
    grad = torch.randn((3, 30_000), generator=gen, device=cuda)
    hess = torch.rand((3, 30_000), generator=gen, device=cuda)
    masks = torch.ones((3, cs.GBT_COLS), device=cuda)
    cfg = gbdt.TreeConfig(max_depth=6, n_bins=cs.GBT_BINS)
    gbdt.build_forest(cfg, binsT, grad, hess, masks)    # loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trees, node = gbdt.build_forest(cfg, binsT, grad, hess, masks,
                                        return_nodes=True)
        with pytest.raises(RuntimeError):   # the mode does catch a sync
            trees["gain"].sum().item()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert node.shape == (3, 30_000)
    assert bool(trees["is_leaf"][:, cfg.n_internal:].all())


def test_eval_and_posttrain_on_card_match_cpu(cuda, tmp_path):
    """`posttrain` and `eval` of a GBT set trained by the port on the card,
    as processes on the card and on a `--device cpu` copy: the outputs
    held as `chip_smoke.py` phase 8 holds them (1e-6, or one row's share
    at a tie edge), `fused_trees` launched on the card."""
    import shutil
    root = str(tmp_path / "card")
    cs.write_model_set(root, "GBT", {"TreeNum": 3, "MaxDepth": 4,
                                     "LearningRate": 0.2, "Loss": "log"},
                       61, 4000, 0.1)
    cs.run_pipeline(root, "cuda")
    cs.run_step(root, "train", "cuda")
    names, cols, _, _ = cs.raw_table(np.random.default_rng(62), 3000, False)
    cs.write_raw(str(tmp_path / "holdout"), names, cols)
    cs.add_eval_set(root, "holdout", str(tmp_path / "holdout"))
    cpu = str(tmp_path / "cpu")
    shutil.copytree(root, cpu)
    for verb in ("posttrain", "eval"):
        card, _ = cs.run_twins(root, cpu, verb)
        assert card["device"] == "cuda"
        assert card["launches"]["fused_trees"] > 0
    cs.compare_posttrain(root, cpu, 0.0, 1e-6)
    out = cs.compare_eval_dir(root, cpu, "holdout", 1e-6)
    assert out["auc_err"] <= 1e-6


# ---------------------------------------------------------------------------
# serving through CUDA graphs (serve/aot.ServingGraphs)
# ---------------------------------------------------------------------------

def _graph_services(workdir, seed=42):
    """Phase 4's two model sets, each served with graphs and eagerly."""
    from shifu_tpu_torch.serve.service import ScorerService
    rng = np.random.default_rng(seed)
    nn_dir, tree_dir, norm, nn_rows, tree_req = cs.serving_sets(workdir, rng)
    out = {}
    for name, kw, make in (("nn", {"models_dir": nn_dir, "norm": norm},
                            nn_rows),
                           ("trees", {"models_dir": tree_dir}, tree_req)):
        proto = make(rng, 1)
        out[name] = (
            ScorerService(max_delay=0.0005, device="cuda", **kw)
            .start(proto=proto),
            ScorerService(max_delay=0.0005, device="cuda", graphs=False,
                          **kw).start(proto=proto), make)
    return out, rng


def test_graph_replay_bit_equal_to_eager_at_every_bucket(cuda, tmp_path):
    """Each bucket's graphs score a request bit for bit as the eager card
    path at the same bucket, the captures stay at one per (model,
    bucket) under traffic, and a replay counts its kernels."""
    svcs, rng = _graph_services(str(tmp_path))
    try:
        for name, (graph, eager, make) in svcs.items():
            st = graph.stats()
            n_models = len(st["models"])
            assert st["graphs"] == st["graph_captures"] == \
                n_models * len(graph.ladder)
            before = (fused_score.launches, fused_trees.launches)
            for n in sorted(set(graph.ladder) | {3, 40, 300}):
                blocks = make(rng, n)
                got, want = graph.submit(**blocks), eager.submit(**blocks)
                for k in want:
                    assert np.array_equal(got[k], want[k], equal_nan=True), \
                        (name, n, k)
            assert graph.stats()["graph_captures"] == st["graph_captures"]
            after = (fused_score.launches, fused_trees.launches)
            assert after != before
    finally:
        for graph, eager, _ in svcs.values():
            graph.close()
            eager.close()


def test_graph_replay_launches_match_the_profiler(cuda, tmp_path):
    """One replay launches what the capture counted: the K1/K2 kernels
    between two marker kernels equal `BucketGraph.kernels`."""
    svcs, _ = _graph_services(str(tmp_path))
    try:
        for graph, _, _ in svcs.values():
            for g in graph._graphs.graphs.values():
                names = cs.kernels_between_markers(g.replay)
                for kname, k in (("fused_score", "fused_score_kernel"),
                                 ("fused_trees", "fused_trees_")):
                    seen = sum(1 for n in names if k in n)
                    assert seen == g.kernels.get(kname, 0), (names, g.kernels)
    finally:
        for graph, eager, _ in svcs.values():
            graph.close()
            eager.close()


def test_swap_during_replays_serves_wholly_old_or_new(cuda, tmp_path):
    """One thread submits without pause while `swap_params` flips
    between two same-shaped NN sets: every answer equals one set's
    eager scores as a whole, none fails, no graph is captured again;
    a wrong-shaped set returns False and changes nothing."""
    import threading

    from shifu_tpu_torch.models.spec import save_model
    from shifu_tpu_torch.serve.service import ScorerService
    rng = np.random.default_rng(3)
    dirs = []
    for seed in (1, 2):
        d = str(tmp_path / f"nn{seed}")
        save_model(os.path.join(d, "model0.nn"), "nn",
                   {"spec": {"input_dim": cs.NN_IN,
                             "hidden_dims": list(cs.NN_HIDDEN),
                             "activations": ["relu", "relu"]}},
                   cs.nn_params(np.random.default_rng(seed)))
        dirs.append(d)
    mean, std = cs.norm_params(rng)
    norm = {"mean": mean, "std": std, "cutoff": cs.CUTOFF}
    reqs = [{"raw_dense": cs.raw_rows(rng, n, mean, std)}
            for n in (1, 5, 64, 200)]
    want = []
    for d in dirs:
        ref = ScorerService(models_dir=d, norm=norm, device="cuda",
                            graphs=False).start(proto=reqs[0])
        want.append([ref.submit(**r)["mean"] for r in reqs])
        ref.close()
    svc = ScorerService(models_dir=dirs[0], norm=norm, max_delay=0.0002,
                        device="cuda").start(proto=reqs[0])
    captures = svc.graph_captures
    seen, errors, stop = [0, 0], [], threading.Event()

    def client():
        i = 0
        while not stop.is_set():
            j = i % len(reqs)
            try:
                got = svc.submit(**reqs[j])["mean"]
            except Exception as e:  # noqa: BLE001 — counted, then raised
                errors.append(e)
                return
            hit = [np.array_equal(got, w[j]) for w in want]
            if not any(hit):
                errors.append(AssertionError(f"request {j} mixed"))
                return
            seen[hit.index(True)] += 1
            i += 1
    t = threading.Thread(target=client)
    t.start()
    try:
        for k in range(10):
            assert svc.swap_params(dirs[(k + 1) % 2])
        bad = str(tmp_path / "bad")
        save_model(os.path.join(bad, "model0.nn"), "nn",
                   {"spec": {"input_dim": cs.NN_IN, "hidden_dims": [8],
                             "activations": ["relu"]}},
                   [{"w": np.zeros((cs.NN_IN, 8), np.float32),
                     "b": np.zeros(8, np.float32)},
                    {"w": np.zeros((8, 1), np.float32),
                     "b": np.zeros(1, np.float32)}])
        assert not svc.swap_params(bad)
    finally:
        stop.set()
        t.join()
    try:
        assert not errors, errors
        assert seen[0] and seen[1], seen
        assert svc.swaps == 10 and svc.graph_captures == captures
        assert np.array_equal(svc.submit(**reqs[2])["mean"], want[0][2])
    finally:
        svc.close()


def test_capture_while_another_service_scores(cuda, tmp_path):
    """Two services score without pause while a third captures its
    graphs (thread-local capture on a side stream): nobody fails, and
    the new service's graphs match its eager twin bit for bit."""
    import threading

    from shifu_tpu_torch.serve.service import ScorerService
    svcs, rng = _graph_services(str(tmp_path))
    errors, stop = [], threading.Event()
    loads = [(svcs[name][0], svcs[name][2](np.random.default_rng(i), 64))
             for i, name in enumerate(("nn", "trees"))]

    def client(svc, blocks):
        while not stop.is_set():
            try:
                svc.submit(**blocks)
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return
    threads = [threading.Thread(target=client, args=a) for a in loads]
    for t in threads:
        t.start()
    try:
        nn_dir = os.path.join(str(tmp_path), "nn", "models")
        proto = {"dense": np.nan_to_num(cs.tree_rows(rng, 1, cs.NN_IN),
                                        posinf=0.0, neginf=0.0)}
        third = ScorerService(models_dir=nn_dir, device="cuda",
                              max_delay=0.0005).start(proto=proto)
        twin = ScorerService(models_dir=nn_dir, device="cuda",
                             graphs=False).start(proto=proto)
    finally:
        stop.set()
        for t in threads:
            t.join()
    try:
        assert not errors, errors
        x = np.nan_to_num(cs.tree_rows(rng, 37, cs.NN_IN), posinf=0.0,
                          neginf=0.0)
        assert np.array_equal(third.submit(dense=x)["mean"],
                              twin.submit(dense=x)["mean"])
    finally:
        third.close()
        twin.close()
        for graph, eager, _ in svcs.values():
            graph.close()
            eager.close()


def test_checkpointed_card_run_resumed_after_preempt_equals_straight(
        cuda, tmp_path, monkeypatch):
    """The small NN on the card with dropout (a CUDA generator in the
    carry) and mini-batches: a preemption after the first save raises
    `Preempted`, the rerun resumes at epoch 4 and ends on the straight
    card run's parameters and curves, to the bit (cuBLAS with TF32 off
    runs the same kernels on the same shapes)."""
    from shifu_tpu_torch import resilience
    from shifu_tpu_torch.config.model_config import ModelTrainConf
    from shifu_tpu_torch.train import checkpoint as ckpt
    from shifu_tpu_torch.train.trainer import train_nn
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (600, 8)).astype(np.float32)
    y = (x[:, 0] - x[:, 1] > 0).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 600).astype(np.float32)
    conf = ModelTrainConf()
    conf.params = {"NumHiddenLayers": 2, "NumHiddenNodes": [16, 8],
                   "ActivationFunc": ["tanh", "relu"], "LearningRate": 0.05,
                   "Propagation": "ADAM", "DropoutRate": 0.1,
                   "MiniBatchRows": 128}
    conf.numTrainEpochs, conf.baggingNum, conf.validSetRate = 12, 2, 0.2
    straight = train_nn(conf, x, y, w, seed=7, device=cuda)
    d = str(tmp_path / "ck")
    monkeypatch.setenv("SHIFU_TPU_FAULT", "ckpt.saved:preempt:1")
    monkeypatch.setenv("SHIFU_TPU_CKPT_ASYNC", "0")
    resilience.reset_faults()
    with pytest.raises(resilience.Preempted, match="after epoch 4/12"):
        train_nn(conf, x, y, w, seed=7, device=cuda, checkpoint_dir=d,
                 checkpoint_interval=4)
    monkeypatch.delenv("SHIFU_TPU_FAULT")
    assert ckpt.latest_step(d) == 4
    res = train_nn(conf, x, y, w, seed=7, device=cuda, checkpoint_dir=d,
                   checkpoint_interval=4)
    np.testing.assert_array_equal(res.val_errors, straight.val_errors[:, 4:])
    np.testing.assert_array_equal(res.best_val, straight.best_val)
    for pg, pw in zip(res.params_per_bag, straight.params_per_bag):
        for lg, lw in zip(pg, pw):
            for k in lw:
                np.testing.assert_array_equal(lg[k], lw[k])
