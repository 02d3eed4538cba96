"""Split search of the tree builders (kernel K5).

Counterpart of `shifu_tpu/ops/pallas_split.py` and the XLA chain of
`shifu_tpu/models/gbdt._best_splits` (gbdt.py:380-448):
`best_splits(g, h, feature_mask, lam, min_inst)` takes a level's (N, C,
B) G/H histograms (missing bin last) and a (C,) or (M, C) feature mask
(M dividing N: node i reads row i // (N/M), so a lockstep forest's
(T, C) masks serve its T·P nodes as they are), and returns the
`_best_splits` dict — per node `feature` and `bin` (int32), `gain`
(f32), `default_left` (bool), and column 0's totals `g_tot` / `h_tot`
(f32), each (N,).

Kernel: `csrc/best_splits.cu`, CUDA C++ for sm_90a. It replaces
`_split_kernel` / `best_splits_pallas` (shifu_tpu/ops/pallas_split.py:
64,144): one block per node stages the columns it reads (column 0 and
those switched on) in shared memory, one thread a column adds the left
sums, every thread scores (column, bin) cells, and a shuffle argmax
picks the split; one launch writes every output tensor. Ties keep the
EARLIEST flat index c·(B-1)+b; an all-masked node resolves to index 0
with `default_left` from column 0, bin 0 — both are written into the
saved model file. The kernel adds
each column's left sums in sequential f32 order; the plain version's
`torch.cumsum` may add in another order (on the CPU it accumulates in
double), so the two agree exactly on integer-valued histograms and
within f32 rounding otherwise.

Routing has no knob: CUDA tensors launch the kernel (a failed build or
launch raises), CPU tensors take `best_splits_plain`. `launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from shifu_tpu_torch import _build

__all__ = ["best_splits", "best_splits_plain", "launches"]

launches = 0  # kernel launches of this process (plain calls not counted)


def _mask_rows(feature_mask: torch.Tensor, n: int, c: int) -> int:
    """M, the rows of a (C,) or (M, C) feature mask, M dividing N."""
    shape = tuple(feature_mask.shape)
    if shape == (c,):
        return 1
    if len(shape) == 2 and shape[1] == c and shape[0] >= 1 \
            and n % shape[0] == 0:
        return shape[0]
    raise ValueError(f"feature_mask {shape} is neither ({c},) nor (M, "
                     f"{c}) with M dividing the {n} nodes")


def best_splits_plain(g: torch.Tensor, h: torch.Tensor,
                      feature_mask: torch.Tensor, lam: float,
                      min_inst: float) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version: the XLA chain of `gbdt._best_splits`, line
    for line (x ** 2 written x * x, as the kernel rounds it), the mask's
    M rows repeated N/M times each."""
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
    m = _mask_rows(feature_mask, n, c)
    mask2 = torch.repeat_interleave(feature_mask.reshape(m, c), n // m,
                                    dim=0)
    gain = torch.where(mask2[:, :, None] > 0, gain, neg_inf)
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
    (N, C, B) G/H histograms; `feature_mask` is (C,) or (M, C) with M
    dividing N."""
    if g.dim() != 3 or tuple(h.shape) != tuple(g.shape):
        raise ValueError(f"g {tuple(g.shape)} and h {tuple(h.shape)} must "
                         "both be (N, C, B)")
    n, c, b = g.shape
    if c < 1 or b < 2:
        raise ValueError(f"need C >= 1 and B >= 2, got C = {c}, B = {b}")
    m = _mask_rows(feature_mask, n, c)
    if not (g.device == h.device == feature_mask.device):
        devices = {t.device for t in (g, h, feature_mask)}
        raise ValueError(f"inputs lie on several devices: {devices}")
    if g.device.type == "cpu":
        return best_splits_plain(g, h, feature_mask, lam, min_inst)
    if g.device.type != "cuda":
        raise ValueError(f"no kernel for device {g.device}")
    return _launch(g, h, feature_mask, m, lam, min_inst)


@functools.lru_cache(maxsize=16)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _warps(n: int, device: torch.device) -> int:
    """Warps a node's block: 32 while every node has an SM to itself
    (the block's latency is the level's), 8 once nodes share SMs (small
    blocks pack them); `chip_smoke.k5_timing` measures both against 16
    by putting another `_warps` in its place."""
    return 32 if n <= _sms(device) else 8


def _launch(g, h, feature_mask, m: int, lam: float,
            min_inst: float) -> Dict[str, torch.Tensor]:
    """One K5 launch writing the dict's tensors."""
    for name, t in (("g", g), ("h", h), ("feature_mask", feature_mask)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous float32 "
                            f"tensor, got {t.dtype}, contiguous "
                            f"{t.is_contiguous()}")
    n, c, b = g.shape
    if c * (b - 1) >= 2 ** 31:
        raise ValueError(f"{c} columns × {b - 1} bins: flat split indices "
                         "overflow the kernel's int32")
    global launches
    dev = g.device
    out = {k: torch.empty(n, dtype=dt, device=dev) for k, dt in (
        ("feature", torch.int32), ("bin", torch.int32),
        ("gain", torch.float32), ("default_left", torch.bool),
        ("g_tot", torch.float32), ("h_tot", torch.float32))}
    if n == 0:
        return out
    lib = _lib()
    rc = _build.call_on(
        dev.index, lib.best_splits_launch, g.data_ptr(), h.data_ptr(),
        feature_mask.data_ptr(), n // m, out["feature"].data_ptr(),
        out["bin"].data_ptr(), out["gain"].data_ptr(),
        out["default_left"].data_ptr(), out["g_tot"].data_ptr(),
        out["h_tot"].data_ptr(), n, c, b, float(lam), float(min_inst),
        _warps(n, dev), _build.raw_stream(dev))
    _build.check(rc, "best_splits", lib.best_splits_error_string)
    launches += 1
    return out


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = _build.load("best_splits")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.best_splits_launch.argtypes = [p, p, p, i] + [p] * 6 + [i, i, i, f,
                                                                 f, i, p]
    lib.best_splits_launch.restype = i
    lib.best_splits_error_string.argtypes = [i]
    lib.best_splits_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib
