"""Fused z-score normalize + first-layer matmul (kernel K1).

Counterpart of `shifu_tpu/ops/pallas_score.py`. `fused_first_layer`
turns raw (N, C) rows (NaN = missing) into the (N, H) first-layer
pre-activation ``zscore(values) @ w + b`` without writing the z-scored
matrix to device memory; `score_nn` runs the rest of the MLP.

Kernel: `csrc/fused_score.cu`, CUDA C++ for sm_90a. It replaces the TPU
kernel `_score_kernel` via `_fused_first_layer_pallas`
(shifu_tpu/ops/pallas_score.py:64,110). At the repo's wide NN shape
(C = 600, H = 512) the product is bound by arithmetic, so the kernel
runs it on the tensor cores in 3xTF32 (`wgmma` with the z tile as a
register operand, normalized on its way out of shared memory), which
keeps the f32 contract at three TF32 products per f32 one. B is
`pack_weights(w)`: w's TF32 hi and lo parts, K-major, in the kernel's
tile order, built once per model (`weights.to_torch` keeps it on the
`MLP`). `_k1_plan` picks the tile and a K-split over a thread-block
cluster so that every serving bucket fills the card.

Routing has no knob: CUDA tensors launch the kernel (a failed build or
launch raises), CPU tensors take `fused_first_layer_plain`, the plain
PyTorch version of the same function. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from shifu_tpu_torch import _build
from shifu_tpu_torch.models import nn as nn_mod
from shifu_tpu_torch.ops.normalize import STD_EPS, zscore

__all__ = ["fused_first_layer", "fused_first_layer_plain", "score_nn",
           "pack_weights", "launches"]

launches = 0  # kernel launches of this process (plain calls not counted)

# Layout constants shared with csrc/fused_score.cu.
BK = 16                 # columns of x per k-tile (`BK`)
SPLIT_ALIGN = 8         # packed k-tiles are a multiple of every split
MAX_SPLIT = 8           # portable thread-block cluster size
MAX_BN = 128            # widest tile the kernel instantiates
TARGET_BLOCKS = 64      # blocks a plan fills at least: half the SMs


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def k_tiles(c: int) -> int:
    """Packed k-tiles for C columns: ⌈C/BK⌉ rounded up to a multiple of
    SPLIT_ALIGN, so that every K-split of the plan divides them."""
    return _ceil(_ceil(c, BK), SPLIT_ALIGN) * SPLIT_ALIGN


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest TF32 value (ties away from zero, the 13 low
    mantissa bits cleared), as `cvt.rna.tf32.f32` rounds: an integer
    add of half a TF32 ulp to the magnitude bits, then a mask."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(C, H) f32 weights → the kernel's B operand: w's TF32 hi part and
    the TF32-rounded residual lo = tf32(w - hi), transposed to (H, C)
    with K contiguous, C zero-padded to `k_tiles(C)`·BK and H to a
    multiple of 8, laid out (k-tile, hi/lo, k8 step, K chunk of 4,
    H8, 4): each k-tile's B is eight contiguous runs of H8 rows × 16
    bytes, the order in which a stage copies and `wgmma` reads them."""
    c, h = w.shape
    kt, h8 = k_tiles(c), _ceil(h, 8) * 8
    wt = torch.zeros((h8, kt * BK), dtype=torch.float32, device=w.device)
    wt[:h, :c] = w.to(torch.float32).T
    hi = tf32_round(wt)
    lo = tf32_round(wt - hi)
    planes = torch.stack([hi, lo])                      # (2, H8, Cpad)
    return (planes.reshape(2, h8, kt, BK // 8, 2, 4)
            .permute(2, 0, 3, 4, 1, 5).contiguous())


class K1Plan(NamedTuple):
    """Output tile bm × bn, and a K-split over a cluster of `split`
    blocks (the cluster size)."""
    bm: int
    bn: int
    split: int

    def blocks(self, n: int, h: int) -> int:
        return _ceil(n, self.bm) * _ceil(_ceil(h, 8) * 8, self.bn) \
            * self.split


@functools.lru_cache(maxsize=256)
def _k1_plan(n: int, c: int, h: int) -> K1Plan:
    """Tile and K-split for an (n, c) → h product: two consumer
    warpgroups (128 rows) above 64 rows, one below; the widest `wgmma`
    N (≤ 128: the kernel keeps two BN/2-float accumulators a thread)
    that covers H; then, while the grid has fewer than TARGET_BLOCKS
    blocks, first split K (powers of two up to a cluster of 8, no more
    than the real k-tiles), then narrow the tile down to 32 columns.
    Half the SMs, not all: each split adds a partial tile to the
    cluster's reduction and takes k-tiles from each block's pipeline, and
    at 512 rows the 64-block plan beats the 128-block one
    (`chip_smoke.py` times both, `PERF.md` records them)."""
    bm = 128 if n > 64 else 64
    bn = min(MAX_BN, max(8, 1 << (_ceil(h, 8) * 8 - 1).bit_length()))
    kt_real = _ceil(c, BK)
    plan = K1Plan(bm, bn, 1)
    while plan.blocks(n, h) < TARGET_BLOCKS:
        if plan.split < MAX_SPLIT and plan.split * 2 <= kt_real:
            plan = plan._replace(split=plan.split * 2)
        elif plan.bn > 32:
            plan = plan._replace(bn=plan.bn // 2)
        else:
            break
    return plan


def pack_norm(mean: torch.Tensor, std: torch.Tensor,
              cutoff: float) -> torch.Tensor:
    """(6, C) f32 block: rows [mean, safe std, lo, hi] — `_pack_norm` of
    the TPU kernel — then, as the bytes of rows 4–5, the C float64
    reciprocals 1/safe std. Columns with std < STD_EPS get lo = hi =
    mean and std 1, so z = (clip(v) - mean) / std lands on exactly 0.
    The kernel divides as f32(f64(v - mean) · f64(1/std)): both f64
    roundings together err by under 2^-51 relative, and a quotient of
    two f32 values lies at least 2^-49 from any midpoint between f32
    neighbours (it would need 25 significant bits), so the result is
    the correctly rounded IEEE f32 quotient, without the division
    routine's call (which would serialize the kernel's `wgmma`)."""
    mean = mean.to(torch.float32)
    std = std.to(torch.float32)
    ok = std >= STD_EPS
    safe = torch.where(ok, std, 1.0)
    four = torch.stack([
        mean,
        safe,
        torch.where(ok, mean - cutoff * std, mean),
        torch.where(ok, mean + cutoff * std, mean),
    ])
    rcp = 1.0 / safe.to(torch.float64)
    return torch.cat([four.reshape(-1), rcp.view(torch.float32)]) \
        .reshape(6, -1)


def fused_first_layer_plain(values: torch.Tensor, mean: torch.Tensor,
                            std: torch.Tensor, cutoff: float,
                            w: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: `zscore` then an f32 matmul plus bias."""
    z = zscore(values.to(torch.float32), mean.to(torch.float32),
               std.to(torch.float32), cutoff)
    return torch.matmul(z, w.to(torch.float32)) + b.to(torch.float32)


def _check(values, mean, std, w, b) -> None:
    if values.dim() != 2:
        raise ValueError(f"values must be (N, C), got {tuple(values.shape)}")
    c = values.shape[1]
    if w.dim() != 2 or w.shape[0] != c:
        raise ValueError(f"w must be ({c}, H), got {tuple(w.shape)}")
    h = w.shape[1]
    if tuple(mean.shape) != (c,) or tuple(std.shape) != (c,):
        raise ValueError(f"mean/std must be ({c},), got "
                         f"{tuple(mean.shape)} / {tuple(std.shape)}")
    if tuple(b.shape) != (h,):
        raise ValueError(f"b must be ({h},), got {tuple(b.shape)}")
    dev = values.device
    if not (mean.device == dev and std.device == dev and w.device == dev
            and b.device == dev):
        devices = {t.device for t in (values, mean, std, w, b)}
        raise ValueError(f"inputs lie on several devices: {devices}")
    for name, t in (("values", values), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_first_layer(values: torch.Tensor, mean: torch.Tensor,
                      std: torch.Tensor, cutoff: float, w: torch.Tensor,
                      b: torch.Tensor,
                      packed: Optional[torch.Tensor] = None,
                      packed_w: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """(N, C) raw values → (N, H) ``zscore(values) @ w + b``. On a CUDA
    tensor this launches the kernel; on a CPU tensor it runs the plain
    version. `packed` is `pack_norm(mean, std, cutoff)` and `packed_w`
    `pack_weights(w)`, computed once by a caller that scores many
    batches (the service, the model); without them the wrapper packs
    per call. The CPU route ignores both."""
    if not values.is_cuda:
        _check(values, mean, std, w, b)
        if values.device.type != "cpu":
            raise ValueError(f"no kernel for device {values.device}")
        return fused_first_layer_plain(values, mean, std, cutoff, w, b)
    n = values.shape[0]
    key = (id(mean), id(std), id(w), id(b), id(packed), id(packed_w),
           cutoff, n)
    hit = _launches.get(key)
    if hit is None or not (hit[0] is mean and hit[1] is std and hit[2] is w
                           and hit[3] is b and hit[4] is packed
                           and hit[5] is packed_w):
        hit = _launcher(key, values, mean, std, cutoff, w, b, packed,
                        packed_w)
    launch, dev, c, h = hit[6:10]
    if (values.dim() != 2 or values.shape[1] != c
            or values.dtype != torch.float32
            or not values.is_contiguous()
            or values.get_device() != dev.index):
        _check(values, mean, std, w, b)
        raise ValueError(f"values must be a contiguous float32 (N, {c}) "
                         f"block on {dev}")
    global launches
    out = torch.empty((n, h), dtype=torch.float32, device=dev)
    rc = _build.call_on(dev.index, _LIB.fused_score_run, launch,
                        values.data_ptr(), out.data_ptr(),
                        _build.raw_stream(dev))
    if rc:
        _build.check(rc, "fused_score", _LIB.fused_score_error_string)
    launches += 1
    return out


class _Launch(ctypes.Structure):
    """`Launch` of csrc/fused_score.cu, field for field."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("norm", "wpack", "bias")]
                + [(f, ctypes.c_int) for f in (
                    "n", "c", "h", "kt_pack", "bm", "bn", "split")])


# (mean, std, w, b, packed, packed_w, cutoff, N) of the layers scored
# lately → (those tensors, launch address, device, C, H, the launch and
# the packs it points into); an entry holds its tensors, so an id is
# never another tensor's
_launches: Dict[Tuple[Any, ...], Tuple[Any, ...]] = {}


def _launcher(key, values, mean, std, cutoff, w, b, packed, packed_w
              ) -> Tuple[Any, ...]:
    """Check a first layer on the card and both packs, and fill its
    launch for N rows; cached when the caller passes both packs (bare
    tensors get packs, and a launch, per call)."""
    _check(values, mean, std, w, b)
    c, h = w.shape
    dev = values.device
    norm = pack_norm(mean, std, float(cutoff)) if packed is None else packed
    if (tuple(norm.shape) != (6, c) or norm.device != dev
            or norm.dtype != torch.float32 or not norm.is_contiguous()
            or norm.data_ptr() % 16):
        raise ValueError(f"packed norm must be pack_norm(...): a "
                         f"contiguous float32 (6, {c}) block on {dev}")
    wp = pack_weights(w) if packed_w is None else packed_w
    want = (k_tiles(c), 2, BK // 8, 2, _ceil(h, 8) * 8, 4)
    if (tuple(wp.shape) != want or wp.device != dev
            or wp.dtype != torch.float32 or not wp.is_contiguous()
            or wp.data_ptr() % 16):
        raise ValueError(f"packed weights must be pack_weights(w): a "
                         f"contiguous, 16-byte aligned float32 {want} "
                         f"block on {dev}")
    n = values.shape[0]
    plan = _k1_plan(n, c, h)
    _prepare(dev, plan.bm, plan.bn)
    launch = _Launch(norm.data_ptr(), wp.data_ptr(), b.data_ptr(), n, c, h,
                     want[0], plan.bm, plan.bn, plan.split)
    entry = (mean, std, w, b, packed, packed_w, ctypes.addressof(launch),
             dev, c, h, launch, norm, wp)
    if packed is not None and packed_w is not None:
        if len(_launches) >= 64:
            _launches.clear()
        _launches[key] = entry
    return entry


@functools.lru_cache(maxsize=64)
def _prepare(device: torch.device, bm: int, bn: int) -> None:
    """The (bm, bn) variant's shared-memory limit, set on `device` once:
    the attribute is per device and the variant's size is fixed."""
    lib = _lib()
    rc = _build.call_on(device.index, lib.fused_score_prepare, bm, bn)
    _build.check(rc, "fused_score_prepare", lib.fused_score_error_string)


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = _build.load("fused_score")
    if lib.fused_score_run.argtypes is None:
        p = ctypes.c_void_p
        lib.fused_score_run.argtypes = [p] * 4
        lib.fused_score_run.restype = ctypes.c_int
        lib.fused_score_prepare.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.fused_score_prepare.restype = ctypes.c_int
        lib.fused_score_error_string.argtypes = [ctypes.c_int]
        lib.fused_score_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def score_nn(mlp, values: torch.Tensor, mean: torch.Tensor,
             std: torch.Tensor, cutoff: float,
             packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full MLP forward over RAW inputs with the normalize and layer-0
    matmul fused (scoring only, f32 throughout) — mirrors
    `pallas_score.score_nn`; layers ≥ 1 are plain f32 `torch.matmul`.
    The first layer's `pack_weights` comes from the model (`w0_pack`,
    set by `weights.to_torch`) when it has one."""
    spec = mlp.spec
    ws, bs = list(mlp.w), list(mlp.b)
    h = fused_first_layer(values, mean, std, cutoff, ws[0], bs[0], packed,
                          getattr(mlp, "w0_pack", None))
    if len(ws) == 1:
        out = h
    else:
        h = nn_mod.activation(spec.activations[0])(h)
        for i in range(1, len(ws) - 1):
            h = torch.matmul(h, ws[i]) + bs[i]
            h = nn_mod.activation(spec.activations[i])(h)
        out = torch.matmul(h, ws[-1]) + bs[-1]
    if spec.output_activation == "softmax":
        return torch.softmax(out, dim=-1)
    out = nn_mod.activation(spec.output_activation)(out)
    return out[..., 0] if spec.output_dim == 1 else out
