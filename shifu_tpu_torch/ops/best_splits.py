"""Split search of the tree builders (kernel K5).

Counterpart of `shifu_tpu/ops/pallas_split.py` and the XLA chain of
`shifu_tpu/models/gbdt._best_splits` (gbdt.py:381-448):
`best_splits(g, h, feature_mask, lam, min_inst)` takes a level's (N, C,
B) G/H histograms (missing bin last) and a (C,) or per-node (N, C)
feature mask, and returns the `_best_splits` dict — per node `feature`,
`bin`, `gain`, `default_left`, and column 0's totals `g_tot` / `h_tot`
as (N,).

Kernel: `csrc/best_splits.cu`, CUDA C++ for sm_90a. It replaces
`_split_kernel` / `best_splits_pallas` (shifu_tpu/ops/pallas_split.py:
64,144): one block per node, one thread per column walking its bins in
order, a block reduction for the winner. Ties keep the EARLIEST flat
index c·(B-1)+b; an all-masked node resolves to index 0 with
`default_left` from column 0, bin 0 — both are written into the saved
model file. The cumsum runs sequentially in the kernel; the plain
version's `torch.cumsum` may add in another order, so the two agree
exactly on integer-valued histograms and within f32 rounding otherwise.

Routing has no knob: CUDA tensors launch the kernel (a failed build or
launch raises), CPU tensors take `best_splits_plain`. `launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from shifu_tpu_torch import _build

__all__ = ["best_splits", "best_splits_plain", "launches"]

launches = 0  # kernel launches of this process (plain calls not counted)


def _mask2(feature_mask: torch.Tensor, n: int, c: int) -> torch.Tensor:
    if feature_mask.dim() == 1:
        return feature_mask[None, :].expand(n, c)
    return feature_mask


def best_splits_plain(g: torch.Tensor, h: torch.Tensor,
                      feature_mask: torch.Tensor, lam: float,
                      min_inst: float) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version: the XLA chain of `gbdt._best_splits`, line
    for line (x ** 2 written x * x, as the kernel rounds it)."""
    g_miss = g[:, :, -1]
    h_miss = h[:, :, -1]
    g_main = g[:, :, :-1]
    h_main = h[:, :, :-1]
    gl = torch.cumsum(g_main, dim=2)     # left sums for split after bin b
    hl = torch.cumsum(h_main, dim=2)
    g_tot = gl[:, :, -1] + g_miss        # (N, C)
    h_tot = hl[:, :, -1] + h_miss
    neg_inf = torch.tensor(-torch.inf, dtype=g.dtype, device=g.device)

    def gain_of(gl_, hl_):
        gr_ = g_tot[:, :, None] - gl_
        hr_ = h_tot[:, :, None] - hl_
        score = (gl_ * gl_ / (hl_ + lam) + gr_ * gr_ / (hr_ + lam)
                 - (g_tot * g_tot / (h_tot + lam))[:, :, None])
        # minimum instances per side (hess≈count when hess=1)
        ok = (hl_ >= min_inst) & (hr_ >= min_inst)
        return torch.where(ok, score, neg_inf)

    gain_left = gain_of(gl + g_miss[:, :, None], hl + h_miss[:, :, None])
    gain_right = gain_of(gl, hl)
    default_left = gain_left >= gain_right          # (N, C, B-1)
    gain = torch.maximum(gain_left, gain_right)
    n, c, bm = gain.shape
    mask3 = _mask2(feature_mask, n, c)[:, :, None]
    gain = torch.where(mask3 > 0, gain, neg_inf)
    # the last main bin as split point sends everything left — exclude
    gain[:, :, -1] = -torch.inf

    flat = gain.reshape(n, c * bm)
    best = torch.argmax(flat, dim=1)
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    best_dl = torch.gather(default_left.reshape(n, c * bm), 1,
                           best[:, None])[:, 0]
    return {"feature": (best // bm).to(torch.int32),
            "bin": (best % bm).to(torch.int32), "gain": best_gain,
            "default_left": best_dl, "g_tot": g_tot[:, 0],
            "h_tot": h_tot[:, 0]}


def best_splits(g: torch.Tensor, h: torch.Tensor,
                feature_mask: torch.Tensor, lam: float,
                min_inst: float) -> Dict[str, torch.Tensor]:
    """Best (feature, bin, missing direction) per node of a level's
    (N, C, B) G/H histograms; `feature_mask` is (C,) or (N, C)."""
    if g.dim() != 3 or tuple(h.shape) != tuple(g.shape):
        raise ValueError(f"g {tuple(g.shape)} and h {tuple(h.shape)} must "
                         "both be (N, C, B)")
    n, c, b = g.shape
    if c < 1 or b < 2:
        raise ValueError(f"need C >= 1 and B >= 2, got C = {c}, B = {b}")
    if tuple(feature_mask.shape) not in ((c,), (n, c)):
        raise ValueError(f"feature_mask {tuple(feature_mask.shape)} is "
                         f"neither ({c},) nor ({n}, {c})")
    devices = {t.device for t in (g, h, feature_mask)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    if g.device.type == "cpu":
        return best_splits_plain(g, h, feature_mask, lam, min_inst)
    if g.device.type != "cuda":
        raise ValueError(f"no kernel for device {g.device}")
    for name, t in (("g", g), ("h", h)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32")
    if c * (b - 1) >= 2 ** 24:
        raise ValueError(f"{c} columns × {b - 1} bins: flat split indices "
                         "would not be exact in the kernel's f32 output")
    global launches
    mask = _mask2(feature_mask.to(torch.float32), n, c).contiguous()
    out = torch.empty((5, n), dtype=torch.float32, device=g.device)
    lib = _lib()
    rc = lib.best_splits_launch(
        g.data_ptr(), h.data_ptr(), mask.data_ptr(), out.data_ptr(), n, c,
        b, float(lam), float(min_inst),
        torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(rc, "best_splits", lib.best_splits_error_string)
    launches += 1
    best = out[1].to(torch.int32)
    return {"feature": best // (b - 1), "bin": best % (b - 1),
            "gain": out[0], "default_left": out[2] > 0.5,
            "g_tot": out[3], "h_tot": out[4]}


def _lib() -> ctypes.CDLL:
    lib = _build.load("best_splits")
    if lib.best_splits_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.best_splits_launch.argtypes = [p, p, p, p, i, i, i, f, f, p]
        lib.best_splits_launch.restype = i
        lib.best_splits_error_string.argtypes = [i]
        lib.best_splits_error_string.restype = ctypes.c_char_p
    return lib
