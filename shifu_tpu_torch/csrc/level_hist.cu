// Per-level gradient/hessian histograms of the tree builders (K3), and
// the same with in-register binning from raw values (K4).
//
// Replaces the TPU kernels `_hist_kernel` / `_level_histograms_pallas`
// (K3, shifu_tpu/ops/pallas_hist.py:100,250) and `_fused_hist_kernel` /
// `_level_histograms_fused` (K4, pallas_hist.py:112,338). Function:
//   G[t,s,c,b] = Σ_r [slot[t,r] = s]·[bin[c,r] = b]·grad[t,r], H likewise
// with hess; rows whose slot lies outside [0, S) (the builders' dump slot,
// -1) and bins outside [0, B) are dropped, as the JAX scatter drops them.
// Inputs: the (C, R) bins as uint8 (the builders' layout for B <= 256)
// or int32 (the JAX contract) for K3, or (C, R) f32 values with NaN =
// missing plus (C, K) ascending, +inf padded cuts for K4; slot (T, R)
// int32 and grad/hess (T, R) f32, T = 1 for one tree and the tree count
// for the lockstep forest (one launch for every tree).
//
// The TPU kernel expresses the scatter as one-hot MXU contractions,
// because a TPU scatters badly. On Hopper it is a privatized histogram
// in shared memory, fed by a ring of asynchronous copies:
//
// - Work: a unit is one row chunk of one tree, for one slot tile and
//   one group of columns. A thread-block cluster (at most 8 blocks)
//   splits a group's columns: block q of the cluster owns columns
//   [c0 + q·col_tile, ...) and keeps their (slots, columns, B) G/H cells
//   in shared memory. The grid is persistent: as many clusters as fit
//   on the card at once (one block an SM), each walking a contiguous run
//   of units.
// - Ring: warp 0 is the producer. Its lane 0 waits until a stage is free
//   in every block of the cluster (an `mbarrier` that each consumer warp
//   of the cluster arrives on); then its lanes copy the chunk's bins (or
//   values), a column a lane, with `cp.async.bulk` onto the stage's full
//   `mbarrier` (complete_tx). Block 0 of the cluster copies the chunk's
//   slot, grad and hess once for the whole cluster
//   (`.multicast::cluster`): those 12 bytes a row leave device memory
//   once per cluster, not once per block. The 16 consumer warps add the
//   previous chunk from shared memory meanwhile.
// - Alignment: a bulk copy moves 16-byte aligned runs. Every run here is
//   widened to the 16-byte window around it and the consumer skips the
//   lead; the bytes past the last full window of an array (its last 15
//   at most) are copied one by one by the producer. So any R, any row
//   offset of a tree, and a ragged last chunk need no padding.
// - Adds, in fixed point: a row's g and h become int64 at a power-of-two
//   scale 2^k (`fixed_shift`: k from max|g| (max|h|) over the launch,
//   which the wrapper computes on the card and hands in by pointer, and
//   from R, so that R·max|g|·2^k < 2^62 and no sum overflows). A cell
//   holds the G and H integers side by side; a value adds its low
//   32-bit word with a native shared-memory `atomicAdd` and its high
//   word (plus the carry) with a second only when that is not zero
//   (`add_fixed`: a 64-bit shared add would be a compare-and-swap
//   loop). Integer addition
//   is associative, so the sums no longer depend on the order in which
//   the warps race: two launches on the same inputs give the same bits.
//   Each consumer warp lists the live rows (slot in the tile) of 32 rows
//   and spreads the (live row, column) pairs over its lanes, consecutive
//   lanes on consecutive columns: a dead row (the dump slot, the right
//   children under sibling subtraction) costs no lane, and lanes of one
//   step rarely share a cell. Cells are B + 1 apart, so lanes spread
//   over the banks by slot and column. Where shared memory allows, the
//   consumer warps add into `copies` replicas of the histogram, which
//   the flush sums: fewer warps race for one cell (a zero-inflated
//   column puts most rows on one bin).
// - Flush: once per block and unit key (tree, slot tile, column group),
//   normally once per block per launch, the non-zero cells go to an
//   int64 (2, T, S, C, B) scratch with global 64-bit atomics. Each
//   (key, block rank) has a counter; the last cluster to flush a key
//   (`flushers` says how many do) converts that block's slice of the
//   key to the f32 (T, S, C, B) outputs, once: so one launch a level,
//   and every output cell is written (the wrapper zeroes only the
//   scratch).
// - K4 bins each value by K2's binary lifting (`bin_of_sorted2` of
//   binning.cuh: `bin_of_sorted` for two values at once) over its
//   columns' cuts, staged once per column group with NaN pads
//   (`stage_cuts`, K2's staging).
//
// What bounds it on an H100: it reads each live row's bins (1 B, or 4)
// once, each row's slot/grad/hess (12 B) once, and writes 8·S·C·B
// bytes: at R = 2M, C = 28, S = 32 with uint8 bins ≈ 77 MB, 0.023 ms at
// 3.35 TB/s. The shared-memory atomics, two per live row and column,
// take longer than that (PERF.md).
//
// Precision: the fixed-point sums round each row's value to 2^-k, at
// least 2^(62 - bits(R)) / max|g| steps of the largest one (2^41 at R =
// 2M and max|g| = 1), then the exact sum rounds once to f32. The TPU
// kernel multiplies in bf16 on the MXU by default
// (SHIFU_TPU_HIST_PRECISION); the port's reference is the f32 route (the
// XLA scatter, or the interpret-mode kernel under `highest`). The sums
// are bit-exact against it when grad/hess are integers (below 2^24), and
// within the f32 sum's own rounding otherwise; run to run they are
// equal to the bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "binning.cuh"

namespace {

constexpr int CONSUMER_WARPS = 16;
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;
constexpr int THREADS = CONSUMERS + 32;  // warp 0 produces
constexpr int MAX_STAGES = 3;
constexpr int MAX_CLUSTER = 8;
constexpr int HEAD = 64;  // the ring's full and empty mbarriers, a flag
constexpr int FLAG = 56;  // the consumers' shared word in the head
// a consumer warp's scratch: its list of live rows (32 ints)
constexpr int WARP_SCRATCH = 32 * 4;
constexpr int SCRATCH = CONSUMER_WARPS * WARP_SCRATCH;
constexpr int SMEM_MAX = 232448;
constexpr unsigned FULL = 0xffffffffu;

enum Kind { BINS_U8 = 0, BINS_I32 = 1, VALUES_F32 = 2 };

__host__ __device__ inline int r16(int v) { return (v + 15) & ~15; }

// Shared-memory layout of one block (`smem_bytes` of ops/level_hist.py):
// the barriers, the consumer warps' scratch, `copies` replicas of the
// (slot_tile, col_tile, B + 1) cells of (G, H) int64 pairs, K4's cuts at
// search_span(K) slots a column, then `stages` ring stages of slot, grad
// and hess buffers and one buffer a column. A buffer holds a chunk plus
// the 16-byte windows around it.
struct Layout {
  int cells, cuts, ring, row_buf, col_buf, stage, total;
};

__host__ __device__ inline Layout layout(int col_tile, int slot_tile,
                                         int n_bins, int span, int chunk,
                                         int stages, int es, int copies) {
  Layout l;
  l.cells = slot_tile * col_tile * (n_bins + 1);
  l.cuts = r16(HEAD + SCRATCH + 16 * copies * l.cells);
  l.ring = r16(l.cuts + 4 * col_tile * span);
  l.row_buf = r16(4 * chunk + 32);
  // 16 bytes past a multiple of 128: the columns a warp reads at once
  // start on 8 different banks, not 4
  l.col_buf = (es * chunk + 32 + 111) / 128 * 128 + 16;
  l.stage = 3 * l.row_buf + col_tile * l.col_buf;
  l.total = l.ring + stages * l.stage;
  return l;
}

}  // namespace

extern "C" {

// What a launch needs (`_Args` of ops/level_hist.py, field for field).
struct HistArgs {
  const void* cols;   // (c, r) bins (uint8 or int32) or f32 values
  const float* cuts;  // (c, k), K4 only
  const int* slot;    // (t, r)
  const float* grad;  // (t, r)
  const float* hess;  // (t, r)
  const float* gh_max;  // (2,): max |grad| and max |hess| of the launch
  float* out_g;       // (t, n_slots, c, n_bins), every cell written
  float* out_h;
  // zeroed int64 scratch: the (2, t, n_slots, c, n_bins) fixed-point
  // sums, then a flush counter per (unit key, block rank)
  unsigned long long* acc;
  int r, c, k, t, n_slots, n_bins, kind;
  // `_k3_plan` (smem: its `smem_bytes`, which the launch checks)
  int cluster, col_tile, slot_tile, chunk, stages, copies, smem;
  // clusters of this plan the card holds at once
  // (`level_hist_max_clusters`)
  int max_clusters;
};

}  // extern "C"

namespace {

__device__ __forceinline__ uint32_t su32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Arrives on the barrier at `bar` (a local address) in block `rank` of
// the cluster.
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, int rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, uint64_t src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The same bytes into the same offsets of every block in `mask`, each
// block's own barrier at `bar` counting them.
__device__ __forceinline__ void bulk_multicast(uint32_t dst, uint64_t src,
                                               uint32_t bytes, uint32_t bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The consumer warps' own barrier (the producer is busy elsewhere).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// Bytes [p0, p1) of an array ending (exclusive) at `lim`, as one bulk
// copy of the 16-byte windows around them that lie inside the array's
// last full window, plus the bytes past that copied one by one.
struct Run {
  uint64_t src;     // the copy's first byte: p0 rounded down to 16
  uint32_t bytes;   // the copy's size, a multiple of 16 (0: no copy)
  uint64_t tail0;   // [tail0, p1): bytes the producer stores itself
};

__device__ __forceinline__ Run run_of(uint64_t p0, uint64_t p1,
                                      uint64_t lim) {
  Run w;
  w.src = p0 & ~15ull;
  const uint64_t up = (p1 + 15) & ~15ull, last = lim & ~15ull;
  const uint64_t end = up < last ? up : last;
  w.bytes = end > w.src ? (uint32_t)(end - w.src) : 0u;
  w.tail0 = end > p0 ? end : p0;
  return w;
}

// The producer's own stores of a run's tail; they are ordered before
// the consumers' reads by its arrival on the stage's barrier.
__device__ __forceinline__ void store_tail(unsigned char* dst, const Run& w,
                                           uint64_t p1) {
  for (uint64_t a = w.tail0; a < p1; ++a)
    dst[a - w.src] = *reinterpret_cast<const unsigned char*>(a);
}

// The fixed-point shift k of a launch: 2^k·max|v| < 2^(62 - bits(rows)),
// so that a sum of `rows` rounded values stays below 2^62. `fixed_shift`
// of ops/level_hist.py mirrors it.
__device__ __forceinline__ int fixed_shift(float amax, int rows) {
  int e;
  frexpf(amax, &e);  // amax < 2^e (e = 0 for 0)
  const int bits = 32 - __clz(rows);  // rows < 2^bits
  return min(max(62 - e - bits, -126), 126);
}

// A cell is G then H, int64 each, little-endian: the low and high
// 32-bit words of each. Hopper has no native 64-bit shared-memory
// atomic add (`atomicAdd` on a shared 64-bit word compiles to a
// compare-and-swap loop, ATOMS.CAST.SPIN.64), but a native 32-bit one:
// a value adds its low word natively, and its high word plus the carry
// out of the low word (read from the returned old value) only when that
// is not zero, so a row whose |value| < 2^32 takes one add. The words
// then hold the exact int64 sum, whatever the order of the adds.
__device__ __forceinline__ void add_fixed(unsigned int* word, long long v) {
  const unsigned int lo = (unsigned int)v;
  const unsigned int old = atomicAdd(word, lo);
  const int up = (int)(v >> 32) + (old + lo < old ? 1 : 0);
  if (up) atomicAdd(word + 1, (unsigned int)up);
}

__device__ __forceinline__ void add_gh(unsigned long long* cell,
                                       long long g, long long h) {
  unsigned int* w = reinterpret_cast<unsigned int*>(cell);
  add_fixed(w, g);
  add_fixed(w + 2, h);
}

// How many clusters walk a unit of key `key` (the units of a key are
// contiguous, each cluster's run too): the flushes the key's counter
// waits for.
__device__ __forceinline__ int flushers(int key, int n_chunks,
                                        long long units,
                                        long long n_clusters) {
  const long long k0 = (long long)key * n_chunks, k1 = k0 + n_chunks;
  int n = 0;
  for (long long c = 0; c < n_clusters; ++c) {
    const long long a = c * units / n_clusters;
    const long long b = (c + 1) * units / n_clusters;
    n += a < k1 && b > k0;
  }
  return n;
}

// A unit's key (tree, slot tile, column group) and what follows from it.
struct Unit {
  int key, chunk, tree, s0, ns, c0, nc;
};

__device__ __forceinline__ Unit unit_of(const HistArgs& a, int u,
                                        int n_chunks, int n_stiles,
                                        int rank) {
  Unit x;
  x.chunk = u % n_chunks;
  x.key = u / n_chunks;
  x.tree = x.key % a.t;
  const int rest = x.key / a.t;
  const int stile = rest % n_stiles, group = rest / n_stiles;
  x.s0 = stile * a.slot_tile;
  x.ns = min(a.slot_tile, a.n_slots - x.s0);
  x.c0 = (group * a.cluster + rank) * a.col_tile;
  x.nc = max(0, min(a.col_tile, a.c - x.c0));
  return x;
}

template <typename T>
__device__ __forceinline__ T load_col(const unsigned char* p, int i) {
  return reinterpret_cast<const T*>(p)[i];
}

template <typename BinT>
__global__ void __launch_bounds__(THREADS, 1)
level_hist_kernel(const HistArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool FUSED = std::is_same<BinT, float>::value;
  constexpr int ES = sizeof(BinT);
  const int span = FUSED ? search_span(a.k) : 0;
  const Layout L = layout(a.col_tile, a.slot_tile, a.n_bins, span, a.chunk,
                          a.stages, ES, a.copies);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  // `copies` replicas of the (slot_tile, col_tile, B + 1) cells of
  // (G, H) int64 pairs; consumer warp w adds into replica w % copies
  unsigned long long* hist0 =
      reinterpret_cast<unsigned long long*>(smem + HEAD + SCRATCH);
  int* flag = reinterpret_cast<int*>(smem + FLAG);
  float* s_cuts = reinterpret_cast<float*>(smem + L.cuts);
  unsigned char* ring = smem + L.ring;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = cluster_rank();
  const int n_chunks = (a.r + a.chunk - 1) / a.chunk;
  const int n_stiles = (a.n_slots + a.slot_tile - 1) / a.slot_tile;
  const int n_groups =
      (a.c + a.cluster * a.col_tile - 1) / (a.cluster * a.col_tile);
  const long long units = (long long)n_groups * n_stiles * a.t * n_chunks;
  const long long n_clusters = gridDim.x / a.cluster;
  const long long cid = blockIdx.x / a.cluster;
  const int u0 = (int)(cid * units / n_clusters);
  const int u1 = (int)((cid + 1) * units / n_clusters);
  const int bp = a.n_bins + 1;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(su32(full + s), 1);
      mbar_init(su32(empty + s), CONSUMER_WARPS * a.cluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers exist before any copy lands

  const uint64_t cols = reinterpret_cast<uint64_t>(a.cols);
  const uint64_t cols_end = cols + (uint64_t)a.c * a.r * ES;
  const uint64_t rows_end = 4ull * a.t * a.r;

  if (warp == 0) {
    // Producer: its lanes split a chunk's copies (lanes 0-2 the slot,
    // grad and hess runs, lane j column j, j + 32, ...); lane 0 waits for
    // the free stage and posts the byte count.
    const uint64_t row_array = reinterpret_cast<uint64_t>(
        lane == 0 ? (const void*)a.slot
                  : lane == 1 ? (const void*)a.grad : (const void*)a.hess);
    for (int u = u0; u < u1; ++u) {
      const int i = u - u0, s = i % a.stages, n = i / a.stages;
      const Unit x = unit_of(a, u, n_chunks, n_stiles, rank);
      const int r0 = x.chunk * a.chunk, nr = min(a.chunk, a.r - r0);
      const uint32_t bar = su32(full + s);
      if (lane == 0) mbar_wait(su32(empty + s), (n & 1) ^ 1);
      __syncwarp();
      unsigned char* st = ring + s * L.stage;
      // tails first (ordered before the consumers' reads by lane 0's
      // arrival, after the warp barrier), then the count, then the copies
      uint32_t tx = 0;
      Run row_run;
      row_run.bytes = 0;
      if (lane < 3) {
        const uint64_t p0 =
            row_array + 4 * ((uint64_t)x.tree * a.r + r0);
        const uint64_t p1 = p0 + 4ull * nr;
        row_run = run_of(p0, p1, row_array + rows_end);
        store_tail(st + lane * L.row_buf, row_run, p1);
        tx += row_run.bytes;
      }
      for (int j = lane; j < x.nc; j += 32) {
        const uint64_t p0 = cols + ((uint64_t)(x.c0 + j) * a.r + r0) * ES;
        const uint64_t p1 = p0 + (uint64_t)nr * ES;
        const Run w = run_of(p0, p1, cols_end);
        store_tail(st + 3 * L.row_buf + j * L.col_buf, w, p1);
        tx += w.bytes;
      }
      __syncwarp();
      tx = __reduce_add_sync(FULL, tx);
      if (lane == 0) mbar_expect(bar, tx);
      __syncwarp();
      for (int j = lane; j < x.nc; j += 32) {
        const uint64_t p0 = cols + ((uint64_t)(x.c0 + j) * a.r + r0) * ES;
        const Run w = run_of(p0, p0 + (uint64_t)nr * ES, cols_end);
        if (w.bytes)
          bulk_copy(su32(st + 3 * L.row_buf + j * L.col_buf), w.src,
                    w.bytes, bar);
      }
      if (rank == 0 && lane < 3 && row_run.bytes) {
        const uint32_t dst = su32(st + lane * L.row_buf);
        if (a.cluster > 1)
          bulk_multicast(dst, row_run.src, row_run.bytes, bar,
                         (uint16_t)((1u << a.cluster) - 1));
        else
          bulk_copy(dst, row_run.src, row_run.bytes, bar);
      }
    }
  } else {
    // Consumers: 16 warps add chunk after chunk into the block's tile.
    const int ctid = tid - 32, cw = warp - 1;
    int* wlist = reinterpret_cast<int*>(smem + HEAD + cw * WARP_SCRATCH);
    unsigned long long* hist = hist0 + 2 * (cw % a.copies) * L.cells;
    // the launch's fixed-point scales (`fixed_shift`)
    const int kg = fixed_shift(a.gh_max[0], a.r);
    const int kh = fixed_shift(a.gh_max[1], a.r);
    const float sg = exp2f((float)kg), sh = exp2f((float)kh);
    const float ug = exp2f((float)-kg), uh = exp2f((float)-kh);
    const size_t cells_out = (size_t)a.t * a.n_slots * a.c * a.n_bins;
    unsigned long long* acc_g = a.acc;
    unsigned long long* acc_h = a.acc + cells_out;
    unsigned int* counts =
        reinterpret_cast<unsigned int*>(a.acc + 2 * cells_out);
    const int top = search_top(a.k);
    Unit cur;
    cur.key = -1;
    cur.c0 = -1;

    auto flush = [&](const Unit& x) {
      consumers_sync();  // every add of the key is in
      const size_t out0 =
          ((size_t)x.tree * a.n_slots + x.s0) * a.c * a.n_bins;
      const int per_slot = x.nc * a.n_bins;
      for (int i = ctid; i < x.ns * per_slot; i += CONSUMERS) {
        const int s = i / per_slot, rest = i - s * per_slot;
        const int j = rest / a.n_bins, b = rest - j * a.n_bins;
        const int sm = 2 * ((s * a.col_tile + j) * bp + b);
        const size_t o = out0 + ((size_t)s * a.c + x.c0 + j) * a.n_bins + b;
        // the replicas' sum (integers: any order gives the same value);
        // a zero cell adds nothing
        unsigned long long g = hist0[sm], h = hist0[sm + 1];
        for (int q = 1; q < a.copies; ++q) {
          g += hist0[2 * q * L.cells + sm];
          h += hist0[2 * q * L.cells + sm + 1];
        }
        if (g) atomicAdd(acc_g + o, g);
        if (h) atomicAdd(acc_h + o, h);
      }
      // the last cluster to flush this key converts the block's slice
      __threadfence();
      consumers_sync();
      if (ctid == 0) {
        const int want = flushers(x.key, n_chunks, units, n_clusters);
        *flag = atomicAdd(counts + (size_t)x.key * a.cluster + rank, 1u) ==
                (unsigned)(want - 1);
      }
      consumers_sync();
      if (!*flag) return;
      __threadfence();
      for (int i = ctid; i < x.ns * per_slot; i += CONSUMERS) {
        const int s = i / per_slot, rest = i - s * per_slot;
        const int j = rest / a.n_bins, b = rest - j * a.n_bins;
        const size_t o = out0 + ((size_t)s * a.c + x.c0 + j) * a.n_bins + b;
        const long long g =
            (long long)*reinterpret_cast<volatile unsigned long long*>(
                acc_g + o);
        const long long h =
            (long long)*reinterpret_cast<volatile unsigned long long*>(
                acc_h + o);
        a.out_g[o] = __ll2float_rn(g) * ug;
        a.out_h[o] = __ll2float_rn(h) * uh;
      }
    };

    for (int u = u0; u < u1; ++u) {
      const int i = u - u0, s = i % a.stages, n = i / a.stages;
      const Unit x = unit_of(a, u, n_chunks, n_stiles, rank);
      if (x.key != cur.key) {
        if (cur.key >= 0) flush(cur);
        consumers_sync();  // the flush has read every cell
        for (int q = ctid; q < 2 * a.copies * L.cells; q += CONSUMERS)
          hist0[q] = 0ull;
        if (FUSED && x.c0 != cur.c0) {
          stage_cuts(s_cuts, a.cuts, x.c0, x.nc, a.k, ctid, CONSUMERS);
          asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" :::
                           "memory");
        }
        consumers_sync();
        cur = x;
      }
      const int r0 = x.chunk * a.chunk, nr = min(a.chunk, a.r - r0);
      const unsigned char* st = ring + s * L.stage;
      // where row 0 of the chunk sits in each buffer: past the lead of
      // its 16-byte window
      const uint64_t first = (uint64_t)x.tree * a.r + r0;
      const int* sl = reinterpret_cast<const int*>(
          st + ((reinterpret_cast<uint64_t>(a.slot) + 4 * first) & 15));
      const float* gr = reinterpret_cast<const float*>(
          st + L.row_buf +
          ((reinterpret_cast<uint64_t>(a.grad) + 4 * first) & 15));
      const float* he = reinterpret_cast<const float*>(
          st + 2 * L.row_buf +
          ((reinterpret_cast<uint64_t>(a.hess) + 4 * first) & 15));
      const unsigned char* cb = st + 3 * L.row_buf;
      const uint32_t lead0 =
          (uint32_t)(cols + ((uint64_t)x.c0 * a.r + r0) * ES);
      const uint32_t lead_step = (uint32_t)((uint64_t)a.r * ES);
      mbar_wait(su32(full + s), n & 1);

      // Each warp takes 32 rows at a time, lists their live rows (slot in
      // the tile) and spreads the (live row, column) pairs over its
      // lanes, consecutive lanes on consecutive columns of one row: a
      // dead row costs no lane, and two lanes of one step share a cell
      // only if they share a column (a warp wider than the block's
      // columns), a slot and a bin. (Lanes on 4 rows × 8 columns, which
      // read fewer banks, collide more and were slower.) A lane takes
      // two pairs a step, 32 apart, whose loads (and K4's searches)
      // overlap.
      const int nc = x.nc;
      const int dk = nc ? 32 / nc : 0, dj = nc ? 32 % nc : 0;
      const int k_lane = nc ? lane / nc : 0, j_lane = nc ? lane % nc : 0;
      // Pair (k, j)'s cell, or -1 when it lies past the list (`ok`
      // false) or its bin is out of range. The loads are unconditional
      // (row 0 of the list stands in), so two pairs' loads overlap.
      // K4 hands in the bin its search found.
      auto pair = [&](bool ok, int k, int j, int fused_bin, float& g,
                      float& h) {
        const int r = wlist[ok ? k : 0];
        g = gr[r];
        h = he[r];
        const int b = FUSED ? fused_bin
                            : (int)load_col<BinT>(
                                  cb + j * L.col_buf +
                                      ((lead0 + j * lead_step) & 15),
                                  r);
        const int key = 2 * (((sl[r] - x.s0) * a.col_tile + j) * bp + b);
        return ok && (unsigned)b < (unsigned)a.n_bins ? key : -1;
      };
      for (int base = cw * 32; base < nr && nc; base += CONSUMERS) {
        const int row = base + lane;
        const int sv0 = row < nr ? sl[row] - x.s0 : -1;
        const bool live = (unsigned)sv0 < (unsigned)x.ns;
        const unsigned ballot = __ballot_sync(FULL, live);
        if (live) wlist[__popc(ballot & ((1u << lane) - 1))] = row;
        __syncwarp();
        const int items = __popc(ballot) * nc;
        int k = k_lane, j = j_lane;
        for (int p0 = 0; p0 < items; p0 += 64) {
          int k2 = k + dk, j2 = j + dj;
          if (j2 >= nc) {
            j2 -= nc;
            ++k2;
          }
          const int p1 = p0 + lane, p2 = p1 + 32;
          int b1 = 0, b2 = 0;
          if (FUSED) {
            const int r1 = wlist[p1 < items ? k : 0];
            const int r2 = wlist[p2 < items ? k2 : 0];
            const float v1 = load_col<float>(
                cb + j * L.col_buf + ((lead0 + j * lead_step) & 15), r1);
            const float v2 = load_col<float>(
                cb + j2 * L.col_buf + ((lead0 + j2 * lead_step) & 15), r2);
            bin_of_sorted2(v1, s_cuts + j * span, v2, s_cuts + j2 * span,
                           top, a.n_bins, b1, b2);
          }
          float g1, h1, g2, h2;
          const int key1 = pair(p1 < items, k, j, b1, g1, h1);
          const int key2 = pair(p2 < items, k2, j2, b2, g2, h2);
          if (key1 >= 0)
            add_gh(hist + key1, __float2ll_rn(g1 * sg),
                   __float2ll_rn(h1 * sh));
          if (key2 >= 0)
            add_gh(hist + key2, __float2ll_rn(g2 * sg),
                   __float2ll_rn(h2 * sh));
          __syncwarp();
          k = k2 + dk;
          j = j2 + dj;
          if (j >= nc) {
            j -= nc;
            ++k;
          }
        }
      }
      __syncwarp();
      if (lane == 0)
        for (int q = 0; q < a.cluster; ++q) mbar_arrive_at(su32(empty + s), q);
    }
    if (cur.key >= 0) flush(cur);
  }
  // no block leaves while another may still copy into it or arrive on
  // its barriers
  cluster_sync();
}

cudaLaunchAttribute cluster_dim(int cluster) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

template <typename BinT>
int max_clusters(int cluster, int smem, int* fit) {
  // per device: the caller caches the result per card
  cudaError_t err = cudaFuncSetAttribute(
      level_hist_kernel<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_dim(cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(fit, level_hist_kernel<BinT>, &cfg);
  if (err != cudaSuccess) return (int)err;
  return *fit < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

template <typename BinT>
int launch(const HistArgs& a, long long units, cudaStream_t stream) {
  // as many clusters as the card holds at once, fewer for a small launch
  const int clusters =
      (int)(units < a.max_clusters ? units : a.max_clusters);
  cudaLaunchAttribute attr = cluster_dim(a.cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * a.cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, level_hist_kernel<BinT>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Sets the largest shared-memory size on the current device for K3
// (kind BINS_U8 / BINS_I32) or K4 (VALUES_F32) and writes to `fit` how
// many clusters of `cluster` blocks with `smem` bytes each it holds at
// once. Returns a cudaError_t (0 = ok).
int level_hist_max_clusters(int kind, int cluster, int smem, int* fit) {
  if (cluster < 1 || cluster > MAX_CLUSTER || smem < 0 || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  switch (kind) {
    case BINS_U8:
      return max_clusters<uint8_t>(cluster, smem, fit);
    case BINS_I32:
      return max_clusters<int32_t>(cluster, smem, fit);
    case VALUES_F32:
      return max_clusters<float>(cluster, smem, fit);
  }
  return (int)cudaErrorInvalidValue;
}

// Launches K3 (kind BINS_U8 / BINS_I32) or K4 (VALUES_F32) on `stream`,
// a stream of the current device, after `level_hist_max_clusters` for
// the plan on that device; `acc` must be zeroed (the outputs need not
// be). Returns the
// cudaError_t of the launch (0 = ok); a plan whose `smem` is not the
// kernel's layout is refused.
int level_hist_run(const HistArgs* p, void* stream) {
  const HistArgs& a = *p;
  if (a.r <= 0 || a.c <= 0 || a.t <= 0 || a.n_slots <= 0) return 0;
  const int es = a.kind == BINS_U8 ? 1 : 4;
  const int span = a.kind == VALUES_F32 ? search_span(a.k) : 0;
  const long long units =
      (long long)((a.c + a.cluster * a.col_tile - 1) /
                  (a.cluster * a.col_tile)) *
      ((a.n_slots + a.slot_tile - 1) / a.slot_tile) * a.t *
      ((a.r + a.chunk - 1) / a.chunk);
  if (a.cluster < 1 || a.cluster > MAX_CLUSTER || a.col_tile < 1 ||
      a.slot_tile < 1 || a.chunk < 16 || a.chunk % 16 || a.stages < 2 ||
      a.copies < 1 || a.copies > CONSUMER_WARPS ||
      a.stages > MAX_STAGES || a.smem > SMEM_MAX || a.max_clusters < 1 ||
      units >= (1ll << 31) || (a.kind == VALUES_F32 && a.k < 1) ||
      a.smem != layout(a.col_tile, a.slot_tile, a.n_bins, span, a.chunk,
                       a.stages, es, a.copies)
                    .total)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  switch (a.kind) {
    case BINS_U8:
      return launch<uint8_t>(a, units, st);
    case BINS_I32:
      return launch<int32_t>(a, units, st);
    case VALUES_F32:
      return launch<float>(a, units, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* level_hist_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
