// Split search of the tree builders (K5): per node, the best (feature,
// bin, missing direction) over the level's G/H histograms.
//
// Replaces the TPU kernel `_split_kernel` / `best_splits_pallas`
// (shifu_tpu/ops/pallas_split.py:64,124), which fuses the XLA chain of
// `models/gbdt._best_splits` (gbdt.py:409-448). Inputs: g, h (N, C, B)
// f32 with the missing bin last, mask (N, C) f32 (0 = feature off for
// that node). Output (5, N) f32 rows: best gain, flat index c·(B-1)+b
// (exact in f32: the wrapper checks C·(B-1) < 2^24), default_left,
// and column 0's totals g_tot, h_tot.
//
// Semantics, each of which lands in the saved model file:
// - per column, a sequential cumsum over the B-1 main bins; the split
//   after bin b scores G²/(H+λ) on both sides minus the parent's, with
//   the missing bin sent left (gain_left) or right (gain_right);
//   default_left = gain_left >= gain_right, taken BEFORE the masks;
// - a side with hess sum < min_inst scores -inf, as do masked-off
//   features and the last main bin (a split there sends every row left);
// - the best gain wins; ties go to the EARLIEST flat index, across
//   columns too (jnp.argmax's first-occurrence rule); NaN ranks above
//   every number, as in torch.argmax / jnp.argmax;
// - an all-masked node (every gain -inf) resolves to flat index 0, whose
//   default_left is still computed from column 0, bin 0;
// - g_tot / h_tot are column 0's cumsum total plus its missing bin.
// The gain is computed with the round-to-nearest intrinsics so the
// compiler contracts nothing into an FMA: each operation rounds as the
// plain PyTorch chain's does.
//
// The TPU kernel tiles columns and carries the running best across a
// sequential grid; here one block owns one node (N = 2^depth per tree,
// T·2^depth for the lockstep forest), one thread owns one column and
// walks its bins in order, and a warp-shuffle plus shared-memory
// reduction picks the block's winner. What bounds it on an H100: it
// reads 8·N·C·B bytes once (458,752 B at N = 32, C = 28, B = 64:
// 0.14 µs at 3.35 TB/s) and does ~20 flops per cell; at these sizes the
// launch and the serial per-column walk set its time, not bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

struct Best {
  float gain;
  int idx;
  float dl;
};

// a beats b: NaN above numbers, then the greater gain, then the lower index
__device__ __forceinline__ bool beats(const Best& a, const Best& b) {
  const bool an = isnan(a.gain), bn = isnan(b.gain);
  if (an != bn) return an;
  if (!an && a.gain != b.gain) return a.gain > b.gain;
  return a.idx < b.idx;
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

__global__ void __launch_bounds__(MAX_THREADS)
best_splits_kernel(const float* __restrict__ g,     // (n, c, b)
                   const float* __restrict__ h,
                   const float* __restrict__ mask,  // (n, c)
                   float* __restrict__ out,         // (5, n)
                   int n, int c, int b, float lam, float min_inst) {
  __shared__ Best s_best[MAX_THREADS / 32];
  __shared__ float s_tot[2];
  const int node = blockIdx.x;
  const int bm = b - 1;
  const float* gn = g + (size_t)node * c * b;
  const float* hn = h + (size_t)node * c * b;

  Best best{neg_inf(), 0x7fffffff, 0.f};
  for (int col = threadIdx.x; col < c; col += blockDim.x) {
    const float* gc = gn + (size_t)col * b;
    const float* hc = hn + (size_t)col * b;
    const float g_miss = gc[bm], h_miss = hc[bm];
    float gl = 0.f, hl = 0.f;
    for (int j = 0; j < bm; ++j) {
      gl = __fadd_rn(gl, gc[j]);
      hl = __fadd_rn(hl, hc[j]);
    }
    const float g_tot = __fadd_rn(gl, g_miss);
    const float h_tot = __fadd_rn(hl, h_miss);
    if (col == 0) {
      s_tot[0] = g_tot;
      s_tot[1] = h_tot;
    }
    const float parent = __fdiv_rn(__fmul_rn(g_tot, g_tot),
                                   __fadd_rn(h_tot, lam));
    const bool on = mask[(size_t)node * c + col] > 0.f;
    gl = 0.f;
    hl = 0.f;
    for (int j = 0; j < bm; ++j) {
      gl = __fadd_rn(gl, gc[j]);
      hl = __fadd_rn(hl, hc[j]);
      const float g_left = gain_of(__fadd_rn(gl, g_miss),
                                   __fadd_rn(hl, h_miss), g_tot, h_tot,
                                   parent, lam, min_inst);
      const float g_right = gain_of(gl, hl, g_tot, h_tot, parent, lam,
                                    min_inst);
      const float dl = (g_left >= g_right) ? 1.f : 0.f;
      float gain = (isnan(g_left) || isnan(g_right))
                       ? __uint_as_float(0x7fc00000u)
                       : fmaxf(g_left, g_right);
      if (!on || j == bm - 1) gain = neg_inf();
      const Best cand{gain, col * bm + j, dl};
      if (beats(cand, best)) best = cand;
    }
  }

  // block reduction: warps by shuffle, then the warp winners
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.gain = __shfl_down_sync(0xffffffffu, best.gain, off);
    o.idx = __shfl_down_sync(0xffffffffu, best.idx, off);
    o.dl = __shfl_down_sync(0xffffffffu, best.dl, off);
    if (beats(o, best)) best = o;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) s_best[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    const int n_warps = (blockDim.x + 31) / 32;
    for (int w = 1; w < n_warps; ++w)
      if (beats(s_best[w], best)) best = s_best[w];
    // column 0, bin 0 is thread 0's first candidate, so an all -inf node
    // ends at index 0 (the lower index wins the tie), never at the
    // initial 0x7fffffff
    out[node] = best.gain;
    out[n + node] = (float)best.idx;
    out[2 * n + node] = best.dl;
    out[3 * n + node] = s_tot[0];
    out[4 * n + node] = s_tot[1];
  }
}

}  // namespace

extern "C" {

// Launches on `stream`: one block of 32·⌈min(C, 1024)/32⌉ threads per
// node. Returns the cudaError_t of the launch (0 = ok).
int best_splits_launch(const void* g, const void* h, const void* mask,
                       void* out, int n, int c, int b, float lam,
                       float min_inst, void* stream) {
  if (n <= 0) return 0;
  const int cols = c < MAX_THREADS ? c : MAX_THREADS;
  const int threads = ((cols + 31) / 32) * 32;
  best_splits_kernel<<<n, threads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)h, (const float*)mask, (float*)out, n,
      c, b, lam, min_inst);
  return (int)cudaGetLastError();
}

const char* best_splits_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
