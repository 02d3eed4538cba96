"""Per-level gradient/hessian histograms of the tree builders (kernels K3
and K4).

Counterpart of `shifu_tpu/ops/pallas_hist.py`:

- `level_histograms(binsT, slot, grad, hess, n_slots, n_bins)` (K3):
  (C, R) int32 bins → G, H of shape (S, C, B);
- `level_histograms_fused(valuesT, cuts, slot, grad, hess, n_slots,
  n_bins)` (K4): the same from (C, R) raw f32 values (NaN = missing)
  and (C, K) ascending, +inf padded cuts, binned in-register with K2's
  rule (`bins_from_values_plain`).

G[s, c, b] = Σ_r [slot_r = s]·[bin_{c,r} = b]·grad_r, H likewise with
hess; slots outside [0, S) (the dump slot, -1) and bins outside [0, B)
are dropped. slot/grad/hess may carry a leading tree axis (T, R) — the
lockstep forest — and the outputs then do too, (T, S, C, B), from one
launch.

Kernel: `csrc/level_hist.cu`, CUDA C++ for sm_90a, one source for both
(the binning is a compile-time prologue). It replaces `_hist_kernel` /
`_level_histograms_pallas` (shifu_tpu/ops/pallas_hist.py:100,250) and
`_fused_hist_kernel` / `_level_histograms_fused` (:112,338). The TPU
kernels contract one-hot matrices on the MXU; here each block keeps a
privatized (slots × columns × B) histogram in shared memory, adds with
shared-memory atomics and flushes with global atomics. Bound by bytes
(each bin or value read once, slot/grad/hess per row, the outputs
written once). Sums are f32, as the JAX package's XLA scatter route —
not the TPU kernel's default bf16 products. Atomics reorder the sums:
exact for integer grad/hess, within f32 rounding of the sum otherwise.

Routing has no knob: CUDA tensors launch the kernel (a failed build or
launch raises), CPU tensors take `level_histograms_plain`. `launches`
counts K3 launches and `fused_launches` K4 launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from shifu_tpu_torch import _build

__all__ = ["level_histograms", "level_histograms_fused",
           "level_histograms_plain", "bins_from_values_plain",
           "launches", "fused_launches"]

launches = 0        # K3 kernel launches of this process
fused_launches = 0  # K4 kernel launches of this process

# Shared-memory budget of one block (of the 227 KB an H100 block may
# use): two blocks fit on an SM.
SMEM_BUDGET = 96 * 1024
SMEM_MAX = 227 * 1024
THREADS = 256
BLOCKS_PER_SM_WAVE = 2  # row chunks are sized for this many waves


def bins_from_values_plain(valuesT: torch.Tensor, cuts: torch.Tensor,
                           n_bins: int) -> torch.Tensor:
    """(C, R) raw values + (C, K) ascending cuts → (C, R) int32 bins:
    Σ(v ≥ cut) (searchsorted side="right") clamped to n_bins-2, NaN →
    n_bins-1 — `pallas_hist.bins_from_values` and K4's prologue."""
    b = torch.searchsorted(cuts.contiguous(), valuesT.contiguous(),
                           right=True)
    b = torch.clamp(b, max=n_bins - 2)
    return torch.where(torch.isnan(valuesT), n_bins - 1, b).to(torch.int32)


def level_histograms_plain(binsT: torch.Tensor, slot: torch.Tensor,
                           grad: torch.Tensor, hess: torch.Tensor,
                           n_slots: int, n_bins: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: per tree, one `index_add_` over the
    flattened (s, c, b) index, with dropped cells sent to one extra
    cell that is cut off."""
    c, r = binsT.shape
    forest = slot.dim() == 2
    slots = slot if forest else slot[None]
    grads = grad if forest else grad[None]
    hesss = hess if forest else hess[None]
    bins = binsT.long()
    bin_ok = (bins >= 0) & (bins < n_bins)
    col = torch.arange(c, device=binsT.device)[:, None]
    size = n_slots * c * n_bins
    out_g, out_h = [], []
    for s, g, h in zip(slots, grads, hesss):
        s = s.long()
        ok = ((s >= 0) & (s < n_slots))[None, :] & bin_ok       # (C, R)
        flat = torch.where(ok, (s[None, :] * c + col) * n_bins + bins,
                           size).reshape(-1)
        acc = []
        for v in (g, h):
            z = torch.zeros(size + 1, dtype=torch.float32,
                            device=binsT.device)
            z.index_add_(0, flat, v.to(torch.float32)
                         .expand(c, r).reshape(-1))
            acc.append(z[:size].reshape(n_slots, c, n_bins))
        out_g.append(acc[0])
        out_h.append(acc[1])
    g_out, h_out = torch.stack(out_g), torch.stack(out_h)
    return (g_out, h_out) if forest else (g_out[0], h_out[0])


def _check(name, t, dtype):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rows(columns: torch.Tensor, slot, grad, hess, n_slots: int,
                n_bins: int) -> None:
    if columns.dim() != 2:
        raise ValueError("binsT / valuesT must be (C, R)")
    r = columns.shape[1]
    if slot.dim() not in (1, 2) or slot.shape[-1] != r:
        raise ValueError(f"slot {tuple(slot.shape)} is neither (R,) nor "
                         f"(T, R) for R = {r}")
    for name, t in (("grad", grad), ("hess", hess)):
        if tuple(t.shape) != tuple(slot.shape):
            raise ValueError(f"{name} {tuple(t.shape)} does not match slot "
                             f"{tuple(slot.shape)}")
    if n_slots < 1 or n_bins < 2:
        raise ValueError(f"n_slots {n_slots} < 1 or n_bins {n_bins} < 2")
    devices = {t.device for t in (columns, slot, grad, hess)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def level_histograms(binsT: torch.Tensor, slot: torch.Tensor,
                     grad: torch.Tensor, hess: torch.Tensor, n_slots: int,
                     n_bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (C, R) int32 bins + slot/grad/hess (R,) or (T, R) → G, H of
    shape (S, C, B) or (T, S, C, B)."""
    _check_rows(binsT, slot, grad, hess, n_slots, n_bins)
    if binsT.device.type == "cpu":
        return level_histograms_plain(binsT, slot, grad, hess, n_slots,
                                      n_bins)
    global launches
    out = _launch(binsT, None, None, slot, grad, hess, n_slots, n_bins)
    launches += 1
    return out


def level_histograms_fused(valuesT: torch.Tensor, cuts: torch.Tensor,
                           slot: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor, n_slots: int, n_bins: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: K3 over bins computed in-register from (C, R) raw values and
    (C, K) cuts — the (C, R) bin matrix never exists."""
    _check_rows(valuesT, slot, grad, hess, n_slots, n_bins)
    if cuts.dim() != 2 or cuts.shape[0] != valuesT.shape[0]:
        raise ValueError(f"cuts {tuple(cuts.shape)} is not (C, K) for "
                         f"C = {valuesT.shape[0]}")
    if cuts.device != valuesT.device:
        raise ValueError("cuts and valuesT lie on different devices")
    if valuesT.device.type == "cpu":
        return level_histograms_plain(
            bins_from_values_plain(valuesT, cuts, n_bins), slot, grad,
            hess, n_slots, n_bins)
    global fused_launches
    out = _launch(None, valuesT, cuts, slot, grad, hess, n_slots, n_bins)
    fused_launches += 1
    return out


def tiles(c: int, n_slots: int, n_bins: int, k: int = 0
          ) -> Tuple[int, int]:
    """(col_tile, slot_tile) of one block under SMEM_BUDGET: every slot
    and as many columns as fit, else one column and as many slots as
    fit."""
    per_col = 8 * n_slots * n_bins + 4 * k
    if per_col <= SMEM_BUDGET:
        return max(1, min(c, SMEM_BUDGET // per_col)), n_slots
    slot_tile = max(1, (SMEM_BUDGET - 4 * k) // (8 * n_bins))
    if 8 * slot_tile * n_bins + 4 * k > SMEM_MAX:
        raise ValueError(f"one slot of {n_bins} bins and {k} cuts exceeds "
                         "the histogram kernel's shared memory")
    return 1, min(slot_tile, n_slots)


def _launch(binsT: Optional[torch.Tensor], valuesT: Optional[torch.Tensor],
            cuts: Optional[torch.Tensor], slot, grad, hess, n_slots: int,
            n_bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    cols = binsT if binsT is not None else valuesT
    if cols.device.type != "cuda":
        raise ValueError(f"no kernel for device {cols.device}")
    if binsT is not None:
        _check("binsT", binsT, torch.int32)
    else:
        _check("valuesT", valuesT, torch.float32)
        _check("cuts", cuts, torch.float32)
    _check("slot", slot, torch.int32)
    _check("grad", grad, torch.float32)
    _check("hess", hess, torch.float32)
    c, r = cols.shape
    t = slot.shape[0] if slot.dim() == 2 else 1
    k = cuts.shape[1] if cuts is not None else 0
    if r >= 2 ** 31:
        raise ValueError(f"{r} rows exceed the kernel's int32 row index")
    col_tile, slot_tile = tiles(c, n_slots, n_bins, k)
    n_tiles = -(-c // col_tile) * -(-n_slots // slot_tile)
    if n_tiles > 65535 or t > 65535:
        raise ValueError(f"{n_tiles} tiles or {t} trees exceed the grid")
    lib = _lib()
    smem = lib.level_hist_smem_bytes(col_tile, slot_tile, n_bins, k)
    per_sm = max(1, min(2048 // THREADS, SMEM_MAX // max(smem, 1)))
    sms = torch.cuda.get_device_properties(cols.device).multi_processor_count
    target = BLOCKS_PER_SM_WAVE * sms * per_sm
    row_blocks = max(1, min(-(-r // THREADS), -(-target // (n_tiles * t))))
    lead = (t,) if slot.dim() == 2 else ()
    out_g = torch.zeros(lead + (n_slots, c, n_bins), dtype=torch.float32,
                        device=cols.device)
    out_h = torch.zeros_like(out_g)
    stream = torch.cuda.current_stream(cols.device).cuda_stream
    rc = lib.level_hist_launch(
        binsT.data_ptr() if binsT is not None else None,
        valuesT.data_ptr() if valuesT is not None else None,
        cuts.data_ptr() if cuts is not None else None,
        slot.data_ptr(), grad.data_ptr(), hess.data_ptr(),
        out_g.data_ptr(), out_h.data_ptr(), r, c, k, t, n_slots, n_bins,
        col_tile, slot_tile, row_blocks, stream)
    _build.check(rc, "level_hist", lib.level_hist_error_string)
    return out_g, out_h


def _lib() -> ctypes.CDLL:
    lib = _build.load("level_hist")
    if lib.level_hist_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.level_hist_launch.argtypes = [p] * 8 + [i] * 9 + [p]
        lib.level_hist_launch.restype = i
        lib.level_hist_smem_bytes.argtypes = [i, i, i, i]
        lib.level_hist_smem_bytes.restype = i
        lib.level_hist_error_string.argtypes = [i]
        lib.level_hist_error_string.restype = ctypes.c_char_p
    return lib
