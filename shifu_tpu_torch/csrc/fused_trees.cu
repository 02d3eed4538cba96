// Fused GBT / RF ensemble inference: binning, tree walk and convert.
//
// Replaces the TPU kernel `_tree_kernel` / `_predict_ensemble_pallas`
// (shifu_tpu/ops/pallas_trees.py:118,203). Inputs keep the JAX layouts:
// valuesT (C, R) raw f32 (NaN = missing) and cuts (C, K) ascending and
// +inf padded. The nodes come as `pack_nodes` of the (8, T·N_pad) block
// of `pack_ensemble`, built once per model: a plane of 4-byte split
// words (split bin, default_left and stop flags, feature) and a plane
// of f32 leaves. A walk step reads one split word: a tree's first 63
// words span 252 bytes, so a warp's loads at any depth hit distinct
// banks.
// Output (R,) f32 scores, and optionally (T, R) int32 landing node ids.
//
// The TPU kernel routes through one-hot MXU products and a select over
// every node because a TPU gathers badly; a Hopper thread indexes the
// node table directly, so the walk is max_depth dependent loads per
// tree, from shared memory.
//
// What bounds it on an H100: per row it reads C floats and writes one.
// At the HIGGS serving shape (C = 28, K = 63, T = 20, depth 6) the
// bytes bound at 1M rows is 0.036 ms; next come the shared-memory
// reads of the binning and of the walk. The design:
// - Binning is `bin_of_sorted` (binning.cuh): an upper-bound search by
//   binary lifting over the ascending cuts, ⌈log2(K+1)⌉ steps, not K.
// - Cuts and nodes reach shared memory through cp.async, all copies in
//   flight at once. Ensembles too large for the shared budget are
//   walked in chunks of trees; the per-row sum still runs in tree order.
// - Two layouts, picked by `_k2_plan` (ops/fused_trees.py):
//   * rows (large R): one thread per row, a persistent grid of as many
//     blocks as fit on the card, each staging the tables once and
//     walking row tiles. valuesT column reads are coalesced, and the
//     next COLS columns load while this group's searches run; a row's
//     bins sit in shared memory, column-major by thread. A thread runs
//     COLS columns' searches and TREES trees' walks side by side, so
//     their shared-memory loads overlap instead of queueing. The walk
//     has no branch: a stop node is its own child.
//   * warps (small R, the serving buckets): one warp per row, so a
//     512-row batch spreads over 128 blocks. Lanes bin the columns, then
//     walk the trees (lane j takes trees j, j + 32, ...); leaf values go
//     to shared memory and lane 0 sums them in tree order. A warp reads
//     its row's C values with stride R, which is right for a few hundred
//     rows and wrong at 1M, hence the rows layout there.
//
// Semantics (bit-exact routing with the reference walk): bin = Σ(v ≥ cut)
// clamped to n_bins-2, NaN → n_bins-1; at a node the missing bin goes by
// default_left, else bin <= split bin goes left (child 2i+1) and right
// otherwise (2i+2); a stop node parks the row. RF averages the leaves,
// GBT scales the sum by lr and, for log loss, applies the ±30-clipped
// sigmoid with expf (not __expf).

#include <cuda_runtime.h>
#include <stdint.h>

#include "binning.cuh"

namespace {

constexpr int ROW_THREADS = 256;  // rows layout: one thread per row
constexpr int WARPS = 4;          // warps layout: one warp per row
constexpr int LAYOUT_ROWS = 0, LAYOUT_WARPS = 1;
// Rows layout: columns binned and trees walked side by side by a thread.
// Four of each keep the kernel at 32 registers, six blocks an SM.
constexpr int COLS = 4;
constexpr int TREES = 4;

// A split word (`pack_nodes`): bits 0-7 the split bin (bin <= it goes
// left), bit 8 default_left, bit 9 stop, bits 16-31 the feature (0 on
// stop nodes, whose bin read is discarded).
constexpr uint32_t WORD_LEFT_DEFAULT = 1u << 8, WORD_STOP = 1u << 9;
__device__ __forceinline__ int word_feat(uint32_t w) { return w >> 16; }
__device__ __forceinline__ int word_bin(uint32_t w) { return w & 0xff; }

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared-memory bytes of one block (`smem_bytes` of ops/fused_trees.py):
// a chunk of split words and leaves, the cuts, then per layout the bins
// (and the warps layout's per-tree leaf values).
__host__ __device__ int smem_bytes(int layout, int c, int k, int n_pad,
                                   int chunk) {
  int b = chunk * n_pad * 8 + round_up(c * search_span(k) * 4, 8);
  if (layout == LAYOUT_ROWS) return b + c * ROW_THREADS;
  return b + WARPS * chunk * 4 + WARPS * round_up(c, 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `count` nodes from `first` on (both multiples of 8: N_pad is)
// of the (2, s) planes into the chunk's words and leaves and, when
// `cuts` is given, the (C, K) cuts at search_span(K) slots a column,
// NaN past K (`bin_of_sorted`); the caller commits and waits.
__device__ __forceinline__ void stage(uint32_t* s_words, const int* nodes,
                                      int s, int first, int count,
                                      int chunk_nodes, float* s_cuts,
                                      const float* cuts, int c, int k,
                                      int tid, int nthreads) {
  for (int i = tid; i < count / 2; i += nthreads) {
    const int plane = i / (count / 4), j = 4 * (i % (count / 4));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(s_words + plane * chunk_nodes + j)),
                 "l"(nodes + (size_t)plane * s + first + j)
                 : "memory");
  }
  if (s_cuts != nullptr) stage_cuts(s_cuts, cuts, 0, c, k, tid, nthreads);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// A row's bins in shared memory hold MISSING for NaN: above every
// split bin (`pack_nodes` clamps those to <= 254), so a split compares
// once and the missing row goes by default_left.
constexpr int MISSING = 255;

// The child of split word `w` at `node` for a row whose bin of the
// split feature is `rb`, or `node` itself at a stop node (a parked row
// stays for every later step). Branch-free: a stop node has feature 0,
// whose bin is read and discarded.
__device__ __forceinline__ int child(uint32_t w, int rb, int node) {
  const bool left =
      rb <= word_bin(w) || (rb == MISSING && (w & WORD_LEFT_DEFAULT));
  return (w & WORD_STOP) ? node : 2 * node + 2 - left;
}

// The landing node of one tree; `bins` holds the row's bins at `stride`.
__device__ __forceinline__ int walk(const uint32_t* tree, const uint8_t* bins,
                                    int stride, int max_depth) {
  int node = 0;
  for (int d = 0; d < max_depth; ++d) {
    const uint32_t w = tree[node];
    node = child(w, bins[word_feat(w) * stride], node);
  }
  return node;
}

// Shared-memory loads at 32-bit shared addresses: the rows layout's hot
// loops keep one such address a column or tree, not a 64-bit pointer.
__device__ __forceinline__ float lds_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ uint32_t lds_u32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ int lds_u8(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(a));
  return (int)v;
}

__device__ __forceinline__ float finish(float total, int t, int is_rf,
                                        int log_loss, float lr) {
  if (is_rf) return total / (float)t;
  float raw = lr * total;
  if (!log_loss) return raw;
  raw = fminf(fmaxf(raw, -30.f), 30.f);
  return 1.f / (1.f + expf(-raw));
}

struct Args {
  const float* valsT;  // (c, r)
  const float* cuts;   // (c, k)
  const int* nodes;    // (2, t·n_pad): split words, leaf bits
  float* out;          // (r,)
  int32_t* leaves;     // (t, r) or null
  int r, c, k, t, n_pad, max_depth, n_bins, chunk, is_rf, log_loss;
  float lr;
};

__global__ void __launch_bounds__(ROW_THREADS)
fused_trees_rows_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk_nodes = a.chunk * a.n_pad;
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  float* s_cuts = reinterpret_cast<float*>(smem + chunk_nodes * 8);
  const int span = search_span(a.k), top = search_top(a.k);
  uint8_t* s_bins =
      reinterpret_cast<uint8_t*>(s_cuts) + round_up(a.c * span * 4, 8);
  const int tid = threadIdx.x;
  const int s_total = a.t * a.n_pad;
  const bool one_chunk = a.chunk >= a.t;

  stage(s_words, a.nodes, s_total, 0, one_chunk ? s_total : 0, chunk_nodes,
        s_cuts, a.cuts, a.c, a.k, tid, ROW_THREADS);
  stage_wait();

  const int n_tiles = (a.r + ROW_THREADS - 1) / ROW_THREADS;
  const uint32_t cuts_at = smem_u32(s_cuts), words_at = smem_u32(s_words),
                 bins_at = smem_u32(s_bins + tid);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row = tile * ROW_THREADS + tid;
    const bool active = row < a.r;
    // bins of this thread's row, column-major by thread, COLS columns
    // at a time: their searches interleave, and the next COLS values
    // load while this group's run
    if (active) {
      float next[COLS];
#pragma unroll
      for (int u = 0; u < COLS; ++u)
        next[u] = u < a.c ? a.valsT[(size_t)u * a.r + row] : 0.f;
      for (int c0 = 0; c0 < a.c; c0 += COLS) {
        float v[COLS];
        uint32_t cu[COLS], q[COLS];  // column u's cuts; past those counted
#pragma unroll
        for (int u = 0; u < COLS; ++u) {
          v[u] = next[u];
          q[u] = cu[u] = cuts_at + 4 * min(c0 + u, a.c - 1) * span;
          const int cn = c0 + COLS + u;
          if (cn < a.c) next[u] = a.valsT[(size_t)cn * a.r + row];
        }
        for (int step = top; step > 0; step >>= 1)
#pragma unroll
          for (int u = 0; u < COLS; ++u) {
            const uint32_t p = q[u] + 4 * (step - 1);
            if (lds_f32(p) <= v[u]) q[u] = p + 4;  // bin_of_sorted's step
          }
#pragma unroll
        for (int u = 0; u < COLS; ++u)
          if (c0 + u < a.c)
            s_bins[(c0 + u) * ROW_THREADS + tid] = (uint8_t)(
                isnan(v[u]) ? MISSING
                            : min((int)(q[u] - cu[u]) / 4, a.n_bins - 2));
      }
    }
    float total = 0.f;
    for (int t0 = 0; t0 < a.t; t0 += a.chunk) {
      const int nt = min(a.chunk, a.t - t0);
      if (!one_chunk) {
        __syncthreads();  // the previous chunk's readers are done
        stage(s_words, a.nodes, s_total, t0 * a.n_pad, nt * a.n_pad,
              chunk_nodes, nullptr, nullptr, 0, 0, tid, ROW_THREADS);
        stage_wait();
      }
      if (!active) continue;
      // TREES trees walked side by side, level by level; their leaves
      // are summed in tree order
      for (int tt0 = 0; tt0 < nt; tt0 += TREES) {
        int node[TREES];
        uint32_t tree[TREES];  // past the chunk: its last tree again
#pragma unroll
        for (int u = 0; u < TREES; ++u) {
          node[u] = 0;
          tree[u] = words_at + 4 * min(tt0 + u, nt - 1) * a.n_pad;
        }
        for (int d = 0; d < a.max_depth; ++d)
#pragma unroll
          for (int u = 0; u < TREES; ++u) {
            const uint32_t w = lds_u32(tree[u] + 4 * node[u]);
            node[u] = child(
                w, lds_u8(bins_at + word_feat(w) * ROW_THREADS), node[u]);
          }
#pragma unroll
        for (int u = 0; u < TREES; ++u)
          if (tt0 + u < nt) {
            // the leaf plane follows the words' at chunk_nodes words
            total += lds_f32(tree[u] + 4 * (chunk_nodes + node[u]));
            if (a.leaves != nullptr)
              a.leaves[(size_t)(t0 + tt0 + u) * a.r + row] = node[u];
          }
      }
    }
    if (active) a.out[row] = finish(total, a.t, a.is_rf, a.log_loss, a.lr);
  }
}

__global__ void __launch_bounds__(WARPS * 32)
fused_trees_warps_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk_nodes = a.chunk * a.n_pad;
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  const float* s_leaves = reinterpret_cast<const float*>(s_words + chunk_nodes);
  float* s_cuts = reinterpret_cast<float*>(smem + chunk_nodes * 8);
  const int span = search_span(a.k), top = search_top(a.k);
  float* s_leaf = s_cuts + round_up(a.c * span * 4, 8) / 4;
  uint8_t* s_bins = reinterpret_cast<uint8_t*>(s_leaf + WARPS * a.chunk);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row = blockIdx.x * WARPS + warp;
  const bool active = row < a.r;  // uniform over the warp
  const int s_total = a.t * a.n_pad;
  const bool one_chunk = a.chunk >= a.t;
  uint8_t* bins = s_bins + warp * round_up(a.c, 4);
  float* leaf = s_leaf + warp * a.chunk;

  stage(s_words, a.nodes, s_total, 0, one_chunk ? s_total : 0, chunk_nodes,
        s_cuts, a.cuts, a.c, a.k, tid, WARPS * 32);
  // the first 32 columns' values load while the tables are in flight
  const float v0 = (active && lane < a.c)
                       ? a.valsT[(size_t)lane * a.r + row] : 0.f;
  stage_wait();
  if (active)
    for (int col = lane; col < a.c; col += 32) {
      const float v = col == lane ? v0 : a.valsT[(size_t)col * a.r + row];
      bins[col] = (uint8_t)(isnan(v) ? MISSING
                                     : bin_of_sorted(v, s_cuts + col * span,
                                                     top, a.n_bins));
    }
  __syncwarp();

  float total = 0.f;  // lane 0's, in tree order
  for (int t0 = 0; t0 < a.t; t0 += a.chunk) {
    const int nt = min(a.chunk, a.t - t0);
    if (!one_chunk) {
      __syncthreads();  // the previous chunk's readers are done
      stage(s_words, a.nodes, s_total, t0 * a.n_pad, nt * a.n_pad,
            chunk_nodes, nullptr, nullptr, 0, 0, tid, WARPS * 32);
      stage_wait();
    }
    if (!active) continue;
    for (int tt = lane; tt < nt; tt += 32) {
      const int node =
          walk(s_words + tt * a.n_pad, bins, 1, a.max_depth);
      leaf[tt] = s_leaves[tt * a.n_pad + node];
      if (a.leaves != nullptr)
        a.leaves[(size_t)(t0 + tt) * a.r + row] = node;
    }
    __syncwarp();
    if (lane == 0)
      for (int tt = 0; tt < nt; ++tt) total += leaf[tt];
    __syncwarp();
  }
  if (active && lane == 0)
    a.out[row] = finish(total, a.t, a.is_rf, a.log_loss, a.lr);
}

void* kernel_of(int layout) {
  return layout == LAYOUT_ROWS ? (void*)fused_trees_rows_kernel
                               : (void*)fused_trees_warps_kernel;
}

}  // namespace

extern "C" {

// On the current device, once per (device, layout, shared-memory bytes)
// (the wrapper keeps the record): sets the layout's dynamic
// shared-memory limit to `limit` (the most any plan there has asked
// for, so a smaller plan after a larger one never lowers it) and writes
// to `grid_cap` the blocks of `smem` bytes the card holds at once
// (blocks per SM × SMs), the rows layout's grid.
int fused_trees_prepare(int layout, int limit, int smem, int* grid_cap) {
  if ((layout != LAYOUT_ROWS && layout != LAYOUT_WARPS) || smem > limit)
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_of(layout);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, layout == LAYOUT_ROWS ? ROW_THREADS : WARPS * 32, smem);
  if (err != cudaSuccess) return (int)err;
  *grid_cap = per_sm * sms;
  return 0;
}

// What a launch needs besides its input and outputs, filled once per
// (model, batch size) by the wrapper (`_Launch` of ops/fused_trees.py,
// field for field).
struct Launch {
  const float* cuts;  // (c, k)
  const int* nodes;   // pack_nodes: (2, t·n_pad)
  int layout, grid, smem;  // `_k2_plan`; smem prepared for the layout
  int r, c, k, t, n_pad, max_depth, n_bins, chunk, is_rf, log_loss;
  float lr;
};

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
int fused_trees_run(const Launch* p, const void* valsT, void* out,
                    void* leaves, void* stream) {
  if (p->r <= 0) return 0;
  if (p->grid < 1 || p->chunk < 1 || p->n_pad % 8 ||
      p->smem < smem_bytes(p->layout, p->c, p->k, p->n_pad, p->chunk))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)valsT, p->cuts, p->nodes, (float*)out,
               (int32_t*)leaves, p->r, p->c, p->k, p->t, p->n_pad,
               p->max_depth, p->n_bins, p->chunk, p->is_rf, p->log_loss,
               p->lr};
  auto st = (cudaStream_t)stream;
  if (p->layout == LAYOUT_ROWS)
    fused_trees_rows_kernel<<<p->grid, ROW_THREADS, p->smem, st>>>(a);
  else if (p->layout == LAYOUT_WARPS)
    fused_trees_warps_kernel<<<p->grid, WARPS * 32, p->smem, st>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* fused_trees_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
