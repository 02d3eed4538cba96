// Split search of the tree builders (K5): per node, the best (feature,
// bin, missing direction) over the level's G/H histograms.
//
// Replaces the TPU kernel `_split_kernel` / `best_splits_pallas`
// (shifu_tpu/ops/pallas_split.py:64,144), which fuses the XLA chain of
// `models/gbdt._best_splits` (gbdt.py:380-448). Inputs: g, h (N, C, B)
// f32 with the missing bin last, and a feature mask of M rows (M
// dividing N: node i reads row i / (N/M); 0 = feature off). Outputs,
// each (N,): feature and bin int32, gain f32, default_left one byte
// (0/1, a torch.bool), and column 0's totals g_tot, h_tot f32. One
// launch writes them all.
//
// Semantics, each of which lands in the saved model file:
// - per column, a sequential cumsum over the B-1 main bins; the split
//   after bin b scores G²/(H+λ) on both sides minus the parent's, with
//   the missing bin sent left (gain_left) or right (gain_right);
//   default_left = gain_left >= gain_right, taken BEFORE the masks;
// - a side with hess sum < min_inst scores -inf, as do masked-off
//   features and the last main bin (a split there sends every row left);
// - the best gain wins; ties go to the EARLIEST flat index c·(B-1)+b,
//   across columns too (jnp.argmax's first-occurrence rule); NaN ranks
//   above every number, as in torch.argmax / jnp.argmax;
// - an all-masked node (every gain -inf) resolves to flat index 0, whose
//   default_left is still computed from column 0, bin 0;
// - g_tot / h_tot are column 0's cumsum total plus its missing bin.
// The gain is computed with the round-to-nearest intrinsics so the
// compiler contracts nothing into an FMA: each operation rounds as the
// plain PyTorch chain's does. Bin j's left sum is ((b0 + b1) + …) + bj
// in f32, added in that order, so the trees do not depend on the card.
//
// Design: one block per node; columns go in tiles of whole columns
// that fit shared memory (all 28 of the HIGGS shape at B = 64). The
// block copies a tile's G and H main bins into rows of odd stride, a
// few cells a thread in flight at once; one THREAD a column then turns
// its row into left sums in place (the sequential order admits no
// parallel scan, so the B-1 dependent adds run in parallel across
// columns, each thread reading a bank of its own) and the column's
// totals and parent score; then the block's threads score the tile's
// (column, bin) cells, each keeping its best by the `beats` order (a
// total order, so the order of arrival does not matter), and a shuffle
// argmax and one pass over the warp winners in shared memory pick the
// node's split. Only where not one column fits does a tile hold at most
// a warp's columns in segments, summed twice: once for the totals, once
// for the scores (`plan`). Masked-off columns other than column 0 can
// never win (their gains are -inf and column 0, bin 0 always holds a
// -inf candidate of a lower index), so they are neither read, summed
// nor scored; a masked-off column 0 is read and summed for its totals
// and scores only its bin 0 (an all-masked node's default_left). What
// bounds it on an H100: it reads 8·B bytes of G and H for column 0 and
// each column switched on, once (at most 458,752 B at N = 32, C = 28,
// B = 64: 0.14 µs at 3.35 TB/s) and does ~24 operations per such
// cell, four of them IEEE divisions; at the builders' sizes the launch,
// the loads' latency, the B-1 dependent adds and the divisions set its
// time, not bytes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 32;
constexpr int SMEM_BUDGET = 40960;  // dynamic bytes: below the 48 KB that
                                    // needs no opt-in attribute
constexpr unsigned FULL = 0xffffffffu;
constexpr int COPY = 4;  // cells a thread's stage loop keeps in flight

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

struct Best {
  float gain;
  int idx;
  int dl;
};

// a beats b: NaN above numbers, then the greater gain, then the lower index
__device__ __forceinline__ bool beats(const Best& a, const Best& b) {
  const bool an = isnan(a.gain), bn = isnan(b.gain);
  if (an != bn) return an;
  if (!an && a.gain != b.gain) return a.gain > b.gain;
  return a.idx < b.idx;
}

// the warp's best in lane 0 (ties to the lower index, as `beats` orders)
__device__ __forceinline__ Best warp_best(Best best) {
  for (int off = 16; off > 0; off >>= 1) {
    const Best o{__shfl_down_sync(FULL, best.gain, off),
                 __shfl_down_sync(FULL, best.idx, off),
                 __shfl_down_sync(FULL, best.dl, off)};
    if (beats(o, best)) best = o;
  }
  return best;
}

__device__ __forceinline__ float gain_of(float gl, float hl, float g_tot,
                                         float h_tot, float parent,
                                         float lam, float min_inst) {
  const float gr = __fsub_rn(g_tot, gl);
  const float hr = __fsub_rn(h_tot, hl);
  if (!(hl >= min_inst && hr >= min_inst)) return neg_inf();
  const float left = __fdiv_rn(__fmul_rn(gl, gl), __fadd_rn(hl, lam));
  const float right = __fdiv_rn(__fmul_rn(gr, gr), __fadd_rn(hr, lam));
  return __fsub_rn(__fadd_rn(left, right), parent);
}

struct Out {
  int32_t* feature;
  int32_t* bin;
  float* gain;
  uint8_t* default_left;
  float* g_tot;
  float* h_tot;
};

// How a launch walks a node, chosen on the host (`plan`): `ct` columns
// at a time (a tile), their main bins in segments of `seg`, each
// column's left sums `stride` floats apart in shared memory (odd, so the
// threads of the sums read a bank each).
struct Tile {
  int ct, seg, stride;
};

// Left sums of one column's segment, in place: ((s0 + b0) + b1) + …, the
// bins read eight at a time ahead of their adds.
__device__ __forceinline__ void left_sums(float* rg, float* rh, int len,
                                          float& sg, float& sh) {
  int j = 0;
  for (; j + 8 <= len; j += 8) {
    float vg[8], vh[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      vg[q] = rg[j + q];
      vh[q] = rh[j + q];
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      rg[j + q] = sg = __fadd_rn(sg, vg[q]);
      rh[j + q] = sh = __fadd_rn(sh, vh[q]);
    }
  }
  for (; j < len; ++j) {
    rg[j] = sg = __fadd_rn(sg, rg[j]);
    rh[j] = sh = __fadd_rn(sh, rh[j]);
  }
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
best_splits_kernel(const float* __restrict__ g,     // (n, c, b)
                   const float* __restrict__ h,
                   const float* __restrict__ mask,  // (n / per_row, c)
                   int per_row, Out out, int c, int b, Tile tl, float lam,
                   float min_inst) {
  // [ct][stride] left sums of G, the same of H, then per tile column its
  // g_tot, h_tot, g_miss, h_miss, parent score and state (1: on, 0:
  // column 0 switched off, -1: neither, never summed nor scored)
  extern __shared__ float smem[];
  __shared__ Best s_best[MAX_WARPS];
  const int node = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int threads = blockDim.x, n_warps = threads >> 5;
  const int bm = b - 1, ct = tl.ct, stride = tl.stride;
  const int n_seg = (bm + tl.seg - 1) / tl.seg;
  float* sums_g = smem;
  float* sums_h = sums_g + ct * stride;
  float* tot = sums_h + ct * stride;
  float* state = tot + 5 * ct;
  const float* mrow = mask + (size_t)(node / per_row) * c;
  const float* gn = g + (size_t)node * c * b;
  const float* hn = h + (size_t)node * c * b;

  Best best{neg_inf(), INT_MAX, 0};
  for (int c0 = 0; c0 < c; c0 += ct) {
    const int cols = min(ct, c - c0);
    // (the previous tile's last barrier lies after its every read of
    // `state`)
    float st_own = -1.f;  // the state of thread tid's column
    if (tid < cols) {
      const int col = c0 + tid;
      st_own = mrow[col] > 0.f ? 1.f : col == 0 ? 0.f : -1.f;
      state[tid] = st_own;
    }
    __syncthreads();
    // with several segments, pass 0 sums each column for its totals
    // first; pass 1 sums again and scores
    for (int pass = n_seg > 1 ? 0 : 1; pass < 2; ++pass) {
      const bool totals = pass == 0 || n_seg == 1;
      float sg = 0.f, sh = 0.f;  // thread tid's sums of column c0 + tid
      for (int s = 0; s < n_seg; ++s) {
        const int base = s * tl.seg, len = min(tl.seg, bm - base);
        const int n_cells = cols * len;
        const float* gt = gn + (size_t)c0 * b + base;
        const float* ht = hn + (size_t)c0 * b + base;
        // stage: the block copies the (column, bin) cells of the tile's
        // columns that it reads, COPY a thread in flight at once
        for (int e0 = tid; e0 < n_cells; e0 += COPY * threads) {
          float vg[COPY], vh[COPY];
          int at[COPY];
#pragma unroll
          for (int q = 0; q < COPY; ++q) {
            const int e = e0 + q * threads;
            at[q] = -1;
            if (e < n_cells) {
              const int k = e / len, j = e - k * len;
              if (state[k] >= 0.f) {
                vg[q] = gt[(size_t)k * b + j];
                vh[q] = ht[(size_t)k * b + j];
                at[q] = k * stride + j;
              }
            }
          }
#pragma unroll
          for (int q = 0; q < COPY; ++q)
            if (at[q] >= 0) {
              sums_g[at[q]] = vg[q];
              sums_h[at[q]] = vh[q];
            }
        }
        __syncthreads();
        // a thread a column adds its bins in order
        if (st_own >= 0.f) {
          const bool last = totals && s == n_seg - 1;
          float g_miss = 0.f, h_miss = 0.f;  // loaded ahead of the adds
          if (last) {
            g_miss = gn[(size_t)(c0 + tid) * b + bm];
            h_miss = hn[(size_t)(c0 + tid) * b + bm];
          }
          left_sums(sums_g + tid * stride, sums_h + tid * stride, len, sg,
                    sh);
          if (last) {
            tot[2 * ct + tid] = g_miss;
            tot[3 * ct + tid] = h_miss;
            const float g_tot = __fadd_rn(sg, g_miss);
            const float h_tot = __fadd_rn(sh, h_miss);
            tot[tid] = g_tot;
            tot[ct + tid] = h_tot;
            tot[4 * ct + tid] = __fdiv_rn(__fmul_rn(g_tot, g_tot),
                                          __fadd_rn(h_tot, lam));
            if (c0 + tid == 0) {
              out.g_tot[node] = g_tot;
              out.h_tot[node] = h_tot;
            }
          }
        }
        __syncthreads();
        if (pass == 0) continue;
        // scores: the block's threads over the tile's (column, bin) cells
        const int dk = threads / len, dj = threads - dk * len;
        int k = tid / len, j = tid - k * len;
        for (int e = tid; e < n_cells; e += threads) {
          const float st = state[k];
          // a masked-off column 0 scores only bin 0
          if (st > 0.f || (st == 0.f && base + j == 0)) {
            const float gl = sums_g[k * stride + j];
            const float hl = sums_h[k * stride + j];
            const float g_tot = tot[k], h_tot = tot[ct + k];
            const float g_miss = tot[2 * ct + k], h_miss = tot[3 * ct + k];
            const float parent = tot[4 * ct + k];
            const float g_left = gain_of(__fadd_rn(gl, g_miss),
                                         __fadd_rn(hl, h_miss), g_tot,
                                         h_tot, parent, lam, min_inst);
            const float g_right = gain_of(gl, hl, g_tot, h_tot, parent,
                                          lam, min_inst);
            // torch.maximum's rule: the first NaN operand, bits and all
            float gain = isnan(g_left)    ? g_left
                         : isnan(g_right) ? g_right
                                          : fmaxf(g_left, g_right);
            if (st == 0.f || base + j == bm - 1) gain = neg_inf();
            const Best cand{gain, (c0 + k) * bm + base + j,
                            g_left >= g_right};
            if (beats(cand, best)) best = cand;
          }
          j += dj;
          k += dk;
          if (j >= len) {
            j -= len;
            ++k;
          }
        }
        __syncthreads();  // the next stage overwrites the sums
      }
    }
  }

  best = warp_best(best);
  if (lane == 0) s_best[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = lane < n_warps ? s_best[lane] : Best{neg_inf(), INT_MAX, 0};
    best = warp_best(best);
    // column 0, bin 0 is always a candidate, so an all -inf node ends at
    // index 0 (the lower index wins the tie), never at INT_MAX
    if (lane == 0) {
      out.feature[node] = best.idx / bm;
      out.bin[node] = best.idx % bm;
      out.gain[node] = best.gain;
      out.default_left[node] = (uint8_t)best.dl;
    }
  }
}

// The tile for C columns of B bins on `threads` threads: whole columns,
// as many as fit the budget (at most a thread each); where not one
// fits, a warp's worth of columns (at most) in segments that fit,
// summed twice (totals, then scores).
Tile plan(int c, int b, int threads) {
  const int bm = b - 1;
  const int per_col = 8 * (bm | 1) + 24;  // two odd runs, six per column
  const int fit = SMEM_BUDGET / per_col;
  const int ct_one = c < threads ? c : threads;
  if (fit >= 1) return Tile{fit < ct_one ? fit : ct_one, bm, bm | 1};
  const int ct_seg = ct_one < 32 ? ct_one : 32;
  int stride = (SMEM_BUDGET / ct_seg - 24) / 8;
  if (!(stride & 1)) --stride;
  return Tile{ct_seg, stride, stride};
}

}  // namespace

extern "C" {

// Launches on `stream`, for the current device: one block per node of
// `warps` warps (fewer when the node has fewer than 32 cells a warp),
// the tile from `plan` in at most
// SMEM_BUDGET bytes of shared memory. `mask` has n / per_row rows.
// Returns the cudaError_t of the launch (0 = ok).
int best_splits_launch(const void* g, const void* h, const void* mask,
                       int per_row, void* feature, void* bin, void* gain,
                       void* default_left, void* g_tot, void* h_tot, int n,
                       int c, int b, float lam, float min_inst, int warps,
                       void* stream) {
  if (n <= 0) return 0;
  if (c < 1 || b < 2 || per_row < 1 || n % per_row || warps < 1 ||
      warps > MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  const int cell_warps = (int)(((long long)c * (b - 1) + 31) / 32);
  const int w = cell_warps < warps ? cell_warps : warps;
  const Tile tl = plan(c, b, 32 * w);
  const Out out{(int32_t*)feature, (int32_t*)bin,   (float*)gain,
                (uint8_t*)default_left, (float*)g_tot, (float*)h_tot};
  const size_t smem = sizeof(float) * (2 * (size_t)tl.ct * tl.stride +
                                       6 * (size_t)tl.ct);
  best_splits_kernel<<<n, 32 * w, smem, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)h, (const float*)mask, per_row, out, c,
      b, tl, lam, min_inst);
  return (int)cudaGetLastError();
}

const char* best_splits_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
