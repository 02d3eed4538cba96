"""Port parity for kernel K5 (split search).

`shifu_tpu_torch.ops.best_splits.best_splits` on CPU tensors runs its
plain PyTorch route (the XLA chain of `gbdt._best_splits`, line for
line); it is held against the JAX package's `_best_splits` (XLA chain)
and `best_splits_pallas` in interpret mode. feature, bin and
default_left must match exactly — they are written into the saved model
file; gain within rtol 1e-5, g_tot / h_tot within rtol 1e-6 (the
cumsums add in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shifu_tpu.models import gbdt as jgbdt
from shifu_tpu.models.gbdt import TreeConfig
from shifu_tpu.ops import pallas_split
from shifu_tpu_torch.ops import best_splits as bs

LAM, MIN_INST = 1.0, 2.0


def _hists(seed, n=6, c=5, b=16, integer=False):
    """Level histograms of a random dataset: per node, rows binned into
    (C, B) cells with grad and hess sums (missing bin last)."""
    rng = np.random.default_rng(seed)
    r = 40 * n
    node = rng.integers(0, n, r)
    bins = rng.integers(0, b, (r, c))
    if integer:
        grad = rng.integers(-2, 3, r).astype(np.float32)
        hess = np.ones(r, np.float32)
    else:
        grad = rng.normal(0, 1, r).astype(np.float32)
        hess = rng.uniform(0.05, 0.25, r).astype(np.float32)
    g = np.zeros((n, c, b), np.float32)
    h = np.zeros((n, c, b), np.float32)
    for j in range(c):
        np.add.at(g, (node, j, bins[:, j]), grad)
        np.add.at(h, (node, j, bins[:, j]), hess)
    return g, h


def _port(g, h, mask, min_inst=MIN_INST):
    out = bs.best_splits(torch.as_tensor(g), torch.as_tensor(h),
                         torch.as_tensor(mask), LAM, min_inst)
    return {k: v.numpy() for k, v in out.items()}


def _check(got, want):
    for k in ("feature", "bin", "default_left"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["gain"], np.asarray(want["gain"]),
                               rtol=1e-5, atol=0)
    for k in ("g_tot", "h_tot"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w if w.ndim == 1 else w[:, 0],
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def _xla(g, h, mask, min_inst=MIN_INST):
    cfg = TreeConfig(n_bins=g.shape[2], reg_lambda=LAM,
                     min_instances_per_node=min_inst)
    return jgbdt._best_splits((jnp.asarray(g), jnp.asarray(h)), cfg,
                              jnp.asarray(mask))


def _pallas(g, h, mask, min_inst=MIN_INST):
    mask2 = np.broadcast_to(mask, g.shape[:2]) if mask.ndim == 1 else mask
    return pallas_split.best_splits_pallas(
        jnp.asarray(g), jnp.asarray(h), jnp.asarray(mask2), LAM,
        float(min_inst), interpret=True)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_k5_matches_xla_chain_and_pallas(seed, integer):
    g, h = _hists(seed, integer=integer)
    mask = np.ones(g.shape[1], np.float32)
    got = _port(g, h, mask)
    _check(got, _xla(g, h, mask))
    _check(got, _pallas(g, h, mask))


def test_per_node_masks_and_all_masked_node():
    g, h = _hists(3, n=5)
    rng = np.random.default_rng(3)
    mask = (rng.random(g.shape[:2]) < 0.6).astype(np.float32)
    mask[2] = 0.0                        # node 2: every feature off
    got = _port(g, h, mask)
    _check(got, _xla(g, h, mask))
    _check(got, _pallas(g, h, mask))
    assert got["gain"][2] == -np.inf
    assert got["feature"][2] == 0 and got["bin"][2] == 0
    # its default_left is column 0, bin 0's, taken before the masks
    # (held equal to both JAX routes above); the fold writes it into
    # the saved file even though the node becomes a leaf


def test_tie_goes_to_the_earliest_flat_index():
    g, h = _hists(4, n=3, c=4)
    g[:, 3] = g[:, 1]                    # columns 1 and 3 identical
    h[:, 3] = h[:, 1]
    mask = np.array([0, 1, 0, 1], np.float32)
    got = _port(g, h, mask)
    _check(got, _xla(g, h, mask))
    _check(got, _pallas(g, h, mask))
    assert (got["feature"] == 1).all()


def test_min_inst_masking_everything():
    g, h = _hists(5, n=4, integer=True)
    mask = np.ones(g.shape[1], np.float32)
    got = _port(g, h, mask, min_inst=1e6)
    _check(got, _xla(g, h, mask, min_inst=1e6))
    _check(got, _pallas(g, h, mask, min_inst=1e6))
    assert (got["gain"] == -np.inf).all()
    assert (got["feature"] == 0).all() and (got["bin"] == 0).all()


def test_last_main_bin_is_never_chosen():
    g, h = _hists(6, n=8, b=4)
    got = _port(g, h, np.ones(g.shape[1], np.float32))
    assert (got["bin"] < 2).all()


def test_refuses_a_device_without_a_kernel():
    g, h = (torch.zeros((2, 3, 4), device="meta") for _ in range(2))
    with pytest.raises(ValueError, match="no kernel"):
        bs.best_splits(g, h, torch.ones(3, device="meta"), LAM, MIN_INST)
    with pytest.raises(ValueError, match="feature_mask"):
        bs.best_splits(torch.zeros((2, 3, 4)), torch.zeros((2, 3, 4)),
                       torch.ones(4), LAM, MIN_INST)
