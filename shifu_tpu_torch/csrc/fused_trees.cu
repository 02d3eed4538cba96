// Fused GBT / RF ensemble inference: binning, tree walk and convert.
//
// Replaces the TPU kernel `_tree_kernel` / `_predict_ensemble_pallas`
// (shifu_tpu/ops/pallas_trees.py:118,203). Inputs keep the JAX layouts:
// valuesT (C, R) raw f32 (NaN = missing), cuts (C, K) ascending and
// +inf padded, nodes (8, T·N_pad) f32 from `pack_ensemble` (rows:
// feature, bin, default_left, stop, leaf_value). Output (R,) f32 scores,
// and optionally (T, R) int32 landing node ids.
//
// One thread per row. The TPU kernel routes through one-hot MXU products
// and a select over every node because a TPU gathers badly; a Hopper
// thread indexes the node table directly, so the walk here is max_depth
// dependent loads per tree, from shared memory.
//
// What bounds it on an H100: per row it reads C floats and writes one,
// and does C·K compares for the bins plus at most T·max_depth node
// steps. At the HIGGS serving shape (C = 28, K = 63, T = 20, depth 6)
// that is about 2,300 simple operations per 116 bytes, near the balance
// point of the card, so both the compares and the reads matter. The
// design keeps everything a row reads more than once on chip: the cuts
// (C·K f32) and the nodes, packed to 8 bytes each (int16 feature, uint8
// bin, uint8 flags, f32 leaf), sit in shared memory; each row's bins are
// computed once into shared memory (uint8, C per thread). Ensembles too
// large for the shared budget are walked in chunks of trees, reloading
// the node table per chunk; the per-row sum still runs in tree order.
//
// Semantics (bit-exact routing with the reference walk): bin = Σ(v ≥ cut)
// clamped to n_bins-2, NaN → n_bins-1 (`bin_of`, binning.cuh, shared
// with the histogram kernel K4); at a node the missing bin goes by
// default_left, else bin <= split bin goes left (child 2i+1) and right
// otherwise (2i+2); a stop node parks the row. RF averages the leaves,
// GBT scales the sum by lr and, for log loss, applies the ±30-clipped
// sigmoid with expf (not __expf).

#include <cuda_runtime.h>
#include <stdint.h>

#include "binning.cuh"

namespace {

constexpr int THREADS = 256;

struct __align__(8) Node {
  int16_t feat;   // split feature, -1 on leaves/pad
  uint8_t bin;    // split bin: bin <= it goes left
  uint8_t flags;  // bit 0 default_left, bit 1 stop
  float leaf;
};

__global__ void __launch_bounds__(THREADS)
fused_trees_kernel(const float* __restrict__ valsT,   // (c, r)
                   const float* __restrict__ cuts,    // (c, k)
                   const float* __restrict__ nodes,   // (8, t·n_pad)
                   float* __restrict__ out,           // (r,)
                   int32_t* __restrict__ leaves,      // (t, r) or null
                   int r, int c, int k, int t, int n_pad, int max_depth,
                   int n_bins, int chunk_trees, int is_rf, int log_loss,
                   float lr) {
  extern __shared__ __align__(8) unsigned char smem[];
  Node* s_nodes = reinterpret_cast<Node*>(smem);
  float* s_cuts = reinterpret_cast<float*>(s_nodes + chunk_trees * n_pad);
  uint8_t* s_bins = reinterpret_cast<uint8_t*>(s_cuts + c * k);

  const int tid = threadIdx.x;
  const int row = blockIdx.x * THREADS + tid;
  const bool active = row < r;
  const int s_total = t * n_pad;

  for (int i = tid; i < c * k; i += THREADS) s_cuts[i] = cuts[i];
  __syncthreads();

  // bins of this thread's row, column-major by thread: conflict-free
  if (active) {
    for (int col = 0; col < c; ++col) {
      const int b = bin_of(valsT[(size_t)col * r + row], s_cuts + col * k,
                           k, n_bins);
      s_bins[col * THREADS + tid] = (uint8_t)b;
    }
  }

  float total = 0.f;
  for (int t0 = 0; t0 < t; t0 += chunk_trees) {
    const int nt = min(chunk_trees, t - t0);
    __syncthreads();  // previous chunk's readers are done
    for (int i = tid; i < nt * n_pad; i += THREADS) {
      const int s = t0 * n_pad + i;
      Node nd;
      nd.feat = (int16_t)nodes[s];
      nd.bin = (uint8_t)nodes[s_total + s];
      nd.flags = (uint8_t)((nodes[2 * s_total + s] > 0.f ? 1 : 0) |
                           (nodes[3 * s_total + s] > 0.f ? 2 : 0));
      nd.leaf = nodes[4 * s_total + s];
      s_nodes[i] = nd;
    }
    __syncthreads();
    if (!active) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const Node* tree = s_nodes + tt * n_pad;
      int node = 0;
      for (int d = 0; d < max_depth; ++d) {
        const Node nd = tree[node];
        if (nd.flags & 2) break;  // parked: stays for every later step
        const int rb = s_bins[nd.feat * THREADS + tid];
        const bool left = (rb == n_bins - 1) ? (nd.flags & 1)
                                             : (rb <= (int)nd.bin);
        node = 2 * node + (left ? 1 : 2);
      }
      total += tree[node].leaf;
      if (leaves != nullptr) leaves[(size_t)(t0 + tt) * r + row] = node;
    }
  }
  if (!active) return;

  float score;
  if (is_rf) {
    score = total / (float)t;
  } else {
    float raw = lr * total;
    if (log_loss) {
      raw = fminf(fmaxf(raw, -30.f), 30.f);
      score = 1.f / (1.f + expf(-raw));
    } else {
      score = raw;
    }
  }
  out[row] = score;
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs for a chunk of `chunk_trees`.
int fused_trees_smem_bytes(int c, int k, int n_pad, int chunk_trees) {
  return (int)(chunk_trees * n_pad * sizeof(Node) + c * k * sizeof(float) +
               c * THREADS * sizeof(uint8_t));
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
int fused_trees_launch(const void* valsT, const void* cuts,
                       const void* nodes, void* out, void* leaves, int r,
                       int c, int k, int t, int n_pad, int max_depth,
                       int n_bins, int chunk_trees, int is_rf, int log_loss,
                       float lr, void* stream) {
  if (r <= 0) return 0;
  const int smem = fused_trees_smem_bytes(c, k, n_pad, chunk_trees);
  cudaError_t err = cudaFuncSetAttribute(
      fused_trees_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (r + THREADS - 1) / THREADS;
  fused_trees_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)valsT, (const float*)cuts, (const float*)nodes,
      (float*)out, (int32_t*)leaves, r, c, k, t, n_pad, max_depth, n_bins,
      chunk_trees, is_rf, log_loss, lr);
  return (int)cudaGetLastError();
}

const char* fused_trees_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
