"""Each CUDA kernel of the port against its plain PyTorch version on the
card, at the shapes `chip_smoke.py` drives. Needs an NVIDIA card and
`nvcc`; elsewhere every test skips with a reason. The file imports no
JAX, so on a machine without it run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from shifu_tpu_torch.ops import fused_score, fused_trees  # noqa: E402

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
