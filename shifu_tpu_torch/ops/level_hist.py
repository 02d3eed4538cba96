"""Per-level gradient/hessian histograms of the tree builders (kernels K3
and K4).

Counterpart of `shifu_tpu/ops/pallas_hist.py`:

- `level_histograms(binsT, slot, grad, hess, n_slots, n_bins)` (K3):
  (C, R) uint8 or int32 bins → G, H of shape (S, C, B). The builders
  hand uint8 bins (`gbdt._device_bins`, every model set with B <= 256);
  int32 is the JAX package's contract, which the parity tests feed;
- `level_histograms_fused(valuesT, cuts, slot, grad, hess, n_slots,
  n_bins)` (K4): the same from (C, R) raw f32 values (NaN = missing)
  and (C, K) ascending, +inf padded cuts, binned in-register with K2's
  rule (`bins_from_values_plain`).

G[s, c, b] = Σ_r [slot_r = s]·[bin_{c,r} = b]·grad_r, H likewise with
hess; slots outside [0, S) (the dump slot, -1) and bins outside [0, B)
are dropped. slot/grad/hess may carry a leading tree axis (T, R) — the
lockstep forest — and the outputs then do too, (T, S, C, B), from one
launch.

Kernel: `csrc/level_hist.cu`, CUDA C++ for sm_90a, one source for both,
instantiated per bin type (uint8, int32, f32 values). It replaces
`_hist_kernel` / `_level_histograms_pallas`
(shifu_tpu/ops/pallas_hist.py:100,250) and `_fused_hist_kernel` /
`_level_histograms_fused` (:112,338). The TPU kernels contract one-hot
matrices on the MXU; here persistent thread-block clusters keep a
privatized (slots × columns × B) histogram in each block's shared
memory, fed by a ring of bulk copies (the row chunk's slot/grad/hess
multicast to the cluster), add with shared-memory atomics and flush
once per block with global atomics. `_k3_plan` sizes the cluster, the
tiles and the ring. Sums are f32, as the JAX package's XLA scatter
route — not the TPU kernel's default bf16 products. Atomics reorder the
sums: exact for integer grad/hess, within f32 rounding of the sum
otherwise.

Routing has no knob: CUDA tensors launch the kernel (a failed build,
attribute call or launch raises), CPU tensors take
`level_histograms_plain`; the bins' dtype picks the kernel's
instantiation. `launches` counts K3 launches and `fused_launches` K4
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from shifu_tpu_torch import _build
from shifu_tpu_torch.ops.fused_trees import search_span

__all__ = ["level_histograms", "level_histograms_fused",
           "level_histograms_plain", "bins_from_values_plain", "launches",
           "fused_launches"]

launches = 0        # K3 kernel launches of this process
fused_launches = 0  # K4 kernel launches of this process

# The constants of csrc/level_hist.cu and of the H100 that size a plan.
SMEM_MAX = 232448       # shared memory one block may use (227 KB)
HEAD = 64               # the ring's mbarriers
WARP_SCRATCH = 32 * 4   # a consumer warp's list of live rows
MAX_CLUSTER = 8         # the portable cluster size
MAX_STAGES = 3
CONSUMER_WARPS = 16     # plus one producer warp
MIN_CHUNK, PLAN_CHUNK, MAX_CHUNK = 512, 1024, 8192   # ring rows:
# multiples of MIN_CHUNK, one row for each consumer thread
SMS = 132
KINDS = {torch.uint8: 0, torch.int32: 1, torch.float32: 2}


class K3Plan(NamedTuple):
    cluster: int        # blocks of a cluster: they split a column group
    col_tile: int       # columns of one block
    slot_tile: int      # slots of one block's histogram
    chunk: int          # rows of one ring stage
    stages: int         # ring depth
    copies: int         # replicas of the histogram, each for a share of
                        # the consumer warps (fewer collisions)
    smem: int           # dynamic shared-memory bytes of one block


def _r16(v: int) -> int:
    return -(-v // 16) * 16


def smem_bytes(col_tile: int, slot_tile: int, n_bins: int, k: int,
               chunk: int, stages: int, es: int, copies: int = 1) -> int:
    """`layout` of csrc/level_hist.cu, whose launch refuses a plan that
    disagrees with it: the barriers, the
    consumer warps' scratch, `copies` replicas of the (slot_tile,
    col_tile, B + 1) cells of (G, H) f32 pairs, K4's cuts at
    search_span(K) slots a column, and `stages` ring stages, each with
    slot/grad/hess buffers and a buffer a column of `es`-byte bins (each
    buffer a chunk plus the 16-byte windows around it; a column's 16
    bytes past a multiple of 128, so 8 columns start on 8 banks)."""
    cells = slot_tile * col_tile * (n_bins + 1)
    ring = _r16(_r16(HEAD + CONSUMER_WARPS * WARP_SCRATCH
                     + 8 * copies * cells)
                + 4 * col_tile * search_span(k))
    col_buf = (es * chunk + 32 + 111) // 128 * 128 + 16
    stage = 3 * _r16(4 * chunk + 32) + col_tile * col_buf
    return ring + stages * stage


@functools.lru_cache(maxsize=256)
def _k3_plan(c: int, n_slots: int, n_bins: int, k: int = 0, es: int = 1,
             rows: int = 0, trees: int = 1, sms: int = SMS,
             cluster: Optional[int] = None,
             copies: Optional[int] = None) -> K3Plan:
    """Cluster, tiles and ring of K3/K4 for C columns of `es`-byte bins
    (or f32 values and K cuts), S slots and B bins:

    1. the smallest cluster (1..8 blocks) whose blocks each hold every
       slot of their share of the columns beside a ring of three
       PLAN_CHUNK-row stages;
    2. if none, slot tiles: the widest column tile of which one slot
       fits beside a two-stage MIN_CHUNK ring, a cluster of up to 8 such
       blocks (more columns go to further column groups), and as many
       slots a block as fit;
    3. replicas of the histogram: as many (a power of two, up to one
       a consumer warp) as fit beside a three-stage MIN_CHUNK ring (at
       S = 1, 8 replicas in 512-row chunks tie 4 in 1,024-row ones on
       uniform bins and win on skewed ones);
    4. the chunk: about four units (row chunk × tree × slot tile ×
       column group) for each cluster the card holds (one block an SM),
       within [MIN_CHUNK, MAX_CHUNK] and what fits, in three stages if
       a MIN_CHUNK stage fits thrice, else two.

    `cluster` forces steps 1–2 (the column tile is C / cluster, the slot
    tile as many slots as fit) and `copies` step 3 (the slot tile then
    fits that many replicas); the timing sweeps of chip_smoke.py compare
    such variants. ValueError when nothing fits."""
    def size(ct, st, ch, stages, cp=1):
        return smem_bytes(ct, st, n_bins, k, ch, stages, es, cp)

    def slot_tile(ct, cp):
        st = 0
        while st < n_slots and \
                size(ct, st + 1, MIN_CHUNK, 2, cp) <= SMEM_MAX:
            st += 1
        return st

    if cluster:
        cl, ct = cluster, -(-c // cluster)
    else:
        for cl in range(1, MAX_CLUSTER + 1):
            ct = -(-c // cl)
            if -(-c // ct) == cl and \
                    size(ct, n_slots, PLAN_CHUNK, MAX_STAGES) <= SMEM_MAX:
                break
        else:
            ct = -(-c // min(c, MAX_CLUSTER))
            while ct > 1 and size(ct, 1, MIN_CHUNK, 2) > SMEM_MAX:
                ct -= 1
            cl = min(MAX_CLUSTER, -(-c // ct))
    cp = copies or 1
    st = slot_tile(ct, cp)
    while not copies and 2 * cp <= CONSUMER_WARPS and \
            size(ct, st, MIN_CHUNK, MAX_STAGES, 2 * cp) <= SMEM_MAX:
        cp *= 2
    stages = MAX_STAGES if size(ct, st, MIN_CHUNK, MAX_STAGES,
                                cp) <= SMEM_MAX else 2
    if st == 0 or size(ct, st, MIN_CHUNK, stages, cp) > SMEM_MAX:
        raise ValueError(f"{cp} replicas of one slot of {min(ct, c)} "
                         f"columns, {n_bins} bins and {k} cuts exceed the "
                         "histogram kernel's shared memory")
    groups = -(-c // (cl * ct))
    units = max(rows, 1) * trees * -(-n_slots // st) * groups
    clusters = max(1, sms // cl)
    want = -(-units // (4 * clusters * MIN_CHUNK)) * MIN_CHUNK
    want = min(max(want, MIN_CHUNK), MAX_CHUNK)
    ch = want
    while ch > MIN_CHUNK and size(ct, st, ch, stages, cp) > SMEM_MAX:
        ch -= MIN_CHUNK
    return K3Plan(cl, ct, st, ch, stages, cp, size(ct, st, ch, stages, cp))


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


def _check(name, t, dtypes):
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
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
    """K3: (C, R) uint8 or int32 bins + slot/grad/hess (R,) or (T, R) →
    G, H of shape (S, C, B) or (T, S, C, B)."""
    _check_rows(binsT, slot, grad, hess, n_slots, n_bins)
    if binsT.device.type == "cpu":
        return level_histograms_plain(binsT, slot, grad, hess, n_slots,
                                      n_bins)
    global launches
    out = _launch(binsT, None, slot, grad, hess, n_slots, n_bins)
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
    out = _launch(valuesT, cuts, slot, grad, hess, n_slots, n_bins)
    fused_launches += 1
    return out


class _Args(ctypes.Structure):
    """`HistArgs` of csrc/level_hist.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "cols", "cuts", "slot", "grad", "hess", "out_g", "out_h")]
        + [(n, ctypes.c_int) for n in (
            "r", "c", "k", "t", "n_slots", "n_bins", "kind", "cluster",
            "col_tile", "slot_tile", "chunk", "stages", "copies", "smem",
            "max_clusters")])


def plan_for(cols: torch.Tensor, cuts: Optional[torch.Tensor],
             slot: torch.Tensor, n_slots: int, n_bins: int,
             cluster: Optional[int] = None,
             copies: Optional[int] = None) -> K3Plan:
    """`_k3_plan` for these inputs on their card (`cluster`, `copies`:
    a forced variant)."""
    c, r = cols.shape
    sms = torch.cuda.get_device_properties(cols.device) \
        .multi_processor_count if cols.device.type == "cuda" else SMS
    return _k3_plan(c, n_slots, n_bins,
                    cuts.shape[1] if cuts is not None else 0,
                    cols.element_size(), r,
                    slot.shape[0] if slot.dim() == 2 else 1, sms, cluster,
                    copies)


@functools.lru_cache(maxsize=256)
def _max_clusters(device: int, kind: int, cluster: int, smem: int) -> int:
    """How many clusters of `cluster` blocks with `smem` bytes each card
    `device` holds at once. The library first sets the kernel's
    shared-memory limit on that card: both are per device."""
    lib = _lib()
    fit = ctypes.c_int(0)
    rc = _build.call_on(device, lib.level_hist_max_clusters, kind, cluster,
                        smem, ctypes.byref(fit))
    _build.check(rc, "level_hist", lib.level_hist_error_string)
    return fit.value


def _launch(cols: torch.Tensor, cuts: Optional[torch.Tensor], slot, grad,
            hess, n_slots: int, n_bins: int,
            plan: Optional[K3Plan] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K3 (cuts None) or K4 launch; `plan` overrides `_k3_plan`
    (the timing sweeps of chip_smoke.py compare variants)."""
    if cols.device.type != "cuda":
        raise ValueError(f"no kernel for device {cols.device}")
    if cuts is None:
        _check("binsT", cols, (torch.uint8, torch.int32))
    else:
        _check("valuesT", cols, (torch.float32,))
        _check("cuts", cuts, (torch.float32,))
        if cuts.shape[1] < 1:
            raise ValueError("K4 needs at least one cut a column")
    _check("slot", slot, (torch.int32,))
    _check("grad", grad, (torch.float32,))
    _check("hess", hess, (torch.float32,))
    c, r = cols.shape
    t = slot.shape[0] if slot.dim() == 2 else 1
    if r >= 2 ** 31:
        raise ValueError(f"{r} rows exceed the kernel's int32 row index")
    if plan is None:
        plan = plan_for(cols, cuts, slot, n_slots, n_bins)
    lead = (t,) if slot.dim() == 2 else ()
    out_g = torch.zeros(lead + (n_slots, c, n_bins), dtype=torch.float32,
                        device=cols.device)
    out_h = torch.zeros_like(out_g)
    kind, dev = KINDS[cols.dtype], cols.device.index
    args = _Args(cols.data_ptr(),
                 cuts.data_ptr() if cuts is not None else None,
                 slot.data_ptr(), grad.data_ptr(), hess.data_ptr(),
                 out_g.data_ptr(), out_h.data_ptr(), r, c,
                 cuts.shape[1] if cuts is not None else 0, t, n_slots,
                 n_bins, kind, plan.cluster, plan.col_tile, plan.slot_tile,
                 plan.chunk, plan.stages, plan.copies, plan.smem,
                 _max_clusters(dev, kind, plan.cluster, plan.smem))
    lib = _lib()
    rc = _build.call_on(dev, lib.level_hist_run, ctypes.byref(args),
                        _build.raw_stream(cols.device))
    _build.check(rc, "level_hist", lib.level_hist_error_string)
    return out_g, out_h


def _lib() -> ctypes.CDLL:
    lib = _build.load("level_hist")
    if lib.level_hist_run.argtypes is None:
        i = ctypes.c_int
        lib.level_hist_run.argtypes = [ctypes.POINTER(_Args),
                                       ctypes.c_void_p]
        lib.level_hist_run.restype = i
        lib.level_hist_max_clusters.argtypes = [i, i, i,
                                                ctypes.POINTER(i)]
        lib.level_hist_max_clusters.restype = i
        lib.level_hist_error_string.argtypes = [i]
        lib.level_hist_error_string.restype = ctypes.c_char_p
    return lib
