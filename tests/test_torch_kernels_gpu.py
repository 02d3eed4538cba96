"""Each CUDA kernel of the port against its plain PyTorch version on the
card, at the shapes `chip_smoke.py` drives. Needs an NVIDIA card and
`nvcc`; elsewhere every test skips with a reason. The file imports no
JAX, so on a machine without it run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

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


@pytest.mark.parametrize("n", [1, 37, 512])
def test_fused_score_matches_plain(cuda, n):
    x, mean, std, w, b = cs.k1_inputs(n, n, cuda)
    before = fused_score.launches
    got = fused_score.fused_first_layer(x, mean, std, cs.CUTOFF, w, b)
    want = fused_score.fused_first_layer_plain(x, mean, std, cs.CUTOFF, w,
                                               b)
    torch.cuda.synchronize()
    assert fused_score.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


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


def test_fused_trees_chunks_large_ensembles(cuda, monkeypatch):
    """An ensemble larger than the shared-memory budget is walked in
    chunks of trees and scores the same."""
    nodes, vT, cuts, kw = cs.k2_inputs(9, 300, cuda)
    whole = fused_trees.predict_ensemble(nodes, vT, cuts, **kw)
    monkeypatch.setattr(fused_trees, "SMEM_BUDGET", 24 * 1024)
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


@pytest.mark.parametrize("n_slots", [1, 7, 32])
@pytest.mark.parametrize("integer", [True, False])
def test_level_hist_k3_k4_match_plain(cuda, n_slots, integer):
    vals, cuts, binsT, slot, grad, hess = cs.hist_inputs(
        n_slots, 100_003, n_slots, cuda, integer)
    want = level_hist.level_histograms_plain(binsT, slot, grad, hess,
                                             n_slots, cs.GBT_BINS)
    before = level_hist.launches, level_hist.fused_launches
    k3 = level_hist.level_histograms(binsT, slot, grad, hess, n_slots,
                                     cs.GBT_BINS)
    k4 = level_hist.level_histograms_fused(vals, cuts, slot, grad, hess,
                                           n_slots, cs.GBT_BINS)
    torch.cuda.synchronize()
    assert (level_hist.launches, level_hist.fused_launches) == \
        (before[0] + 1, before[1] + 1)
    for got in (k3, k4):
        for g, w, wt in zip(got, want, (grad, hess)):
            cs._hist_err("hist", g, w, slot, wt, n_slots, integer)


def test_level_hist_forest_axis_and_slot_tiles(cuda):
    """(T, R) per-tree rows in one launch; a level too wide for one
    block's shared memory splits its slots across blocks."""
    _, _, binsT, _, _, _ = cs.hist_inputs(3, 50_000, 1, cuda, True)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for n_slots in (4, 512):
        slot = torch.randint(-1, n_slots + 1, (3, 50_000), generator=gen,
                             device=cuda, dtype=torch.int32)
        grad = torch.randint(-3, 4, (3, 50_000), generator=gen,
                             device=cuda).float()
        hess = torch.ones_like(grad)
        got = level_hist.level_histograms(binsT, slot, grad, hess, n_slots,
                                          cs.GBT_BINS)
        want = level_hist.level_histograms_plain(binsT, slot, grad, hess,
                                                 n_slots, cs.GBT_BINS)
        assert got[0].shape == (3, n_slots, cs.GBT_COLS, cs.GBT_BINS)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [1, 32, 640])
def test_best_splits_matches_plain(cuda, n):
    g, h, mask = cs.split_inputs(n, n, cuda)
    before = best_splits.launches
    got = best_splits.best_splits(g, h, mask, 1.0, 2.0)
    want = best_splits.best_splits_plain(g, h, mask, 1.0, 2.0)
    torch.cuda.synchronize()
    assert best_splits.launches == before + 1
    for k in ("feature", "bin", "default_left"):
        assert torch.equal(got[k], want[k]), k
    for k in ("gain", "g_tot", "h_tot"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=0.0)


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
