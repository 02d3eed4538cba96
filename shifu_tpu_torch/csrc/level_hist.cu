// Per-level gradient/hessian histograms of the tree builders (K3), and
// the same with in-register binning from raw values (K4).
//
// Replaces the TPU kernels `_hist_kernel` / `_level_histograms_pallas`
// (K3, shifu_tpu/ops/pallas_hist.py:100,250) and `_fused_hist_kernel` /
// `_level_histograms_fused` (K4, pallas_hist.py:112,338). Function:
//   G[t,s,c,b] = Σ_r [slot[t,r] = s]·[bin[c,r] = b]·grad[t,r], H likewise
// with hess; rows whose slot lies outside [0, S) (the builders' dump slot,
// -1) and bins outside [0, B) are dropped, as the JAX scatter drops them.
// Inputs keep the JAX layouts: binsT (C, R) int32 (K3), or valuesT (C, R)
// f32 with NaN = missing plus cuts (C, K) ascending and +inf padded (K4);
// slot (T, R) int32 and grad/hess (T, R) f32, T = 1 for one tree and the
// tree count for the lockstep forest (one launch for every tree).
//
// The TPU kernel expresses the scatter as one-hot MXU contractions,
// because a TPU scatters badly. On Hopper this is a privatized histogram:
// each block owns (a chunk of rows) × (a tile of columns) × (a tile of
// slots) of one tree, zero-fills its (slots, columns, B) G/H pair in
// shared memory, walks its rows with shared-memory atomicAdd, and flushes
// the non-zero cells into the (T, S, C, B) outputs with global atomicAdd
// (the wrapper zeroes them before the launch). The tile sizes come from
// the wrapper's shared-memory budget: at the HIGGS leaf level (S = 32,
// B = 64) a column costs 16 KB, so a block takes 6 of the 28 columns; at
// the root (S = 1) all 28 fit in 14 KB.
//
// What bounds it on an H100: it reads each bin (4 B) and each row's slot,
// grad and hess (12 B) once and writes 8·S·C·B bytes: ≈ 248 MB at
// R = 2M, C = 28, about 0.074 ms at 3.35 TB/s. The design reads binsT
// once (column tiles split the columns) but re-reads slot/grad/hess once
// per column tile, and its shared-memory atomics serialize where rows of
// a warp hit the same (slot, bin) cell.
//
// Precision: f32 sums throughout. The TPU kernel multiplies in bf16 on
// the MXU by default (SHIFU_TPU_HIST_PRECISION); the port's reference is
// the f32 route (the XLA scatter, or the interpret-mode kernel under
// `highest`). Atomics add in an order that changes from run to run: the
// sums are bit-exact when grad/hess are integers (below 2^24) and agree
// within the sum's own rounding otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "binning.cuh"

namespace {

constexpr int THREADS = 256;

template <bool FUSED>
__global__ void __launch_bounds__(THREADS)
level_hist_kernel(const int32_t* __restrict__ binsT,   // (c, r) K3
                  const float* __restrict__ valsT,     // (c, r) K4
                  const float* __restrict__ cuts,      // (c, k) K4
                  const int32_t* __restrict__ slot,    // (t, r)
                  const float* __restrict__ grad,      // (t, r)
                  const float* __restrict__ hess,      // (t, r)
                  float* __restrict__ out_g,           // (t, s, c, b)
                  float* __restrict__ out_h,
                  int r, int c, int k, int n_slots, int n_bins,
                  int col_tile, int slot_tile, int n_col_tiles,
                  int rows_per_block) {
  extern __shared__ float smem[];
  const int cells = slot_tile * col_tile * n_bins;
  float* s_g = smem;                 // (slot_tile, col_tile, n_bins)
  float* s_h = smem + cells;
  float* s_cuts = smem + 2 * cells;  // (col_tile, k), K4 only

  const int c0 = (blockIdx.y % n_col_tiles) * col_tile;
  const int s0 = (blockIdx.y / n_col_tiles) * slot_tile;
  const int tc = min(col_tile, c - c0);
  const int ts = min(slot_tile, n_slots - s0);
  const int tree = blockIdx.z;

  for (int i = threadIdx.x; i < 2 * cells; i += THREADS) smem[i] = 0.f;
  if (FUSED) {
    for (int i = threadIdx.x; i < tc * k; i += THREADS)
      s_cuts[i] = cuts[(size_t)c0 * k + i];
  }
  __syncthreads();

  const size_t row_base = (size_t)tree * r;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r, r0 + rows_per_block);
  for (int row = r0 + threadIdx.x; row < r1; row += THREADS) {
    const int s = slot[row_base + row] - s0;
    if (s < 0 || s >= ts) continue;  // other slot tile, or the dump slot
    const float gv = grad[row_base + row];
    const float hv = hess[row_base + row];
    float* g_row = s_g + s * col_tile * n_bins;
    float* h_row = s_h + s * col_tile * n_bins;
    for (int cl = 0; cl < tc; ++cl) {
      const size_t at = (size_t)(c0 + cl) * r + row;
      int b;
      if (FUSED) {
        b = bin_of(valsT[at], s_cuts + cl * k, k, n_bins);
      } else {
        b = binsT[at];
        if (b < 0 || b >= n_bins) continue;
      }
      atomicAdd(g_row + cl * n_bins + b, gv);
      atomicAdd(h_row + cl * n_bins + b, hv);
    }
  }
  __syncthreads();

  // flush: skipping zero cells is exact (x + 0 = x for the +0 start)
  const size_t tree_base = (size_t)tree * n_slots * c * n_bins;
  const int span = tc * n_bins;  // one slot's live cells in this tile
  for (int i = threadIdx.x; i < ts * span; i += THREADS) {
    const int s = i / span;
    const int rest = i - s * span;  // cl·n_bins + b
    const int sm = s * col_tile * n_bins + rest;
    const size_t o = tree_base + ((size_t)(s0 + s) * c + c0) * n_bins + rest;
    const float gv = s_g[sm];
    const float hv = s_h[sm];
    if (gv != 0.f) atomicAdd(out_g + o, gv);
    if (hv != 0.f) atomicAdd(out_h + o, hv);
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block: the G/H tile pair, plus the cut tile
// for K4 (k > 0).
int level_hist_smem_bytes(int col_tile, int slot_tile, int n_bins, int k) {
  return (int)(sizeof(float) * (2 * (size_t)slot_tile * col_tile * n_bins +
                                (size_t)col_tile * k));
}

// Launches K3 (valsT == null) or K4 (binsT == null) on `stream` over a
// grid of (row chunks, column tiles × slot tiles, trees); out_g/out_h
// must be zeroed. Returns the cudaError_t of the launch (0 = ok).
int level_hist_launch(const void* binsT, const void* valsT, const void* cuts,
                      const void* slot, const void* grad, const void* hess,
                      void* out_g, void* out_h, int r, int c, int k, int t,
                      int n_slots, int n_bins, int col_tile, int slot_tile,
                      int row_blocks, void* stream) {
  if (r <= 0 || c <= 0 || t <= 0 || n_slots <= 0) return 0;
  const bool fused = binsT == nullptr;
  const int smem = level_hist_smem_bytes(col_tile, slot_tile, n_bins,
                                         fused ? k : 0);
  const int n_col_tiles = (c + col_tile - 1) / col_tile;
  const int n_slot_tiles = (n_slots + slot_tile - 1) / slot_tile;
  const int rows_per_block = (r + row_blocks - 1) / row_blocks;
  const dim3 grid((r + rows_per_block - 1) / rows_per_block,
                  n_col_tiles * n_slot_tiles, t);
  cudaError_t err;
  if (fused) {
    err = cudaFuncSetAttribute(level_hist_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    level_hist_kernel<true><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        nullptr, (const float*)valsT, (const float*)cuts,
        (const int32_t*)slot, (const float*)grad, (const float*)hess,
        (float*)out_g, (float*)out_h, r, c, k, n_slots, n_bins, col_tile,
        slot_tile, n_col_tiles, rows_per_block);
  } else {
    err = cudaFuncSetAttribute(level_hist_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    level_hist_kernel<false><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const int32_t*)binsT, nullptr, nullptr, (const int32_t*)slot,
        (const float*)grad, (const float*)hess, (float*)out_g,
        (float*)out_h, r, c, 0, n_slots, n_bins, col_tile, slot_tile,
        n_col_tiles, rows_per_block);
  }
  return (int)cudaGetLastError();
}

const char* level_hist_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
