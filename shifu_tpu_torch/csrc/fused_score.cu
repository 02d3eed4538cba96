// Fused z-score normalize + first-layer matmul for NN scoring.
//
// Replaces the TPU kernel `_score_kernel` / `_fused_first_layer_pallas`
// (shifu_tpu/ops/pallas_score.py:64,110): out = zscore(x) @ w + b for raw
// (N, C) rows, without writing the z-scored matrix to device memory.
//
// What bounds it on an H100: at the serving and eval shapes (C = 600,
// H = 512) the product does 2·N·C·H flops against 4·(N·C + N·H) bytes,
// about 140 flops per byte, so it is bound by f32 arithmetic, not by
// memory. The design is a plain tiled SIMT GEMM (64×64 output tile per
// block, 16-deep K slices, 4×4 outputs per thread, FMA in f32). The
// normalize is the prologue of the A-tile load: each raw value is read
// once from device memory, NaN-filled, clamped and divided on its way
// into shared memory. Edges are masked (zero-filled loads, skipped
// stores), which is the padding of the TPU kernel without the copy.
//
// Order of operations mirrors `_pack_norm` + `_score_kernel`: NaN is
// replaced by the mean BEFORE the clamp (fminf/fmaxf would otherwise
// turn a NaN into lo or hi), the clamp bounds come packed (tiny-std
// columns carry lo = hi = mean and std 1, so z is exactly 0), and z is
// (clip(v) - mean) / std as a true IEEE division (no fast math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows of the output tile
constexpr int BN = 64;   // columns (hidden units) of the output tile
constexpr int BK = 16;   // reduction slice
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
fused_score_kernel(const float* __restrict__ x,      // (n, c) raw
                   const float* __restrict__ norm,   // (4, c) mean,std,lo,hi
                   const float* __restrict__ w,      // (c, h)
                   const float* __restrict__ b,      // (h,)
                   float* __restrict__ out,          // (n, h)
                   int n, int c, int h) {
  __shared__ float As[BK][BM + 4];  // z tile, k-major
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tr = tid / 16;          // this thread's rows: tr + 16·i
  const int tc = tid % 16;          // this thread's cols: tc + 16·j
  const int row0 = blockIdx.x * BM;  // rows on x: up to 2^31-1 blocks
  const int col0 = blockIdx.y * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < c; k0 += BK) {
    // A tile: BM×BK raw values, normalized on the way in. Neighbouring
    // threads read neighbouring columns of one row.
#pragma unroll
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK, k = i % BK;
      const int gr = row0 + m, gk = k0 + k;
      float z = 0.f;
      if (gr < n && gk < c) {
        const float mean = norm[gk];
        const float sd = norm[c + gk];
        const float lo = norm[2 * c + gk];
        const float hi = norm[3 * c + gk];
        float v = x[(size_t)gr * c + gk];
        if (isnan(v)) v = mean;          // before the clamp
        v = fminf(fmaxf(v, lo), hi);
        z = (v - mean) / sd;
      }
      As[k][m] = z;
    }
    // B tile: BK×BN weights.
#pragma unroll
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = i / BN, nn = i % BN;
      const int gk = k0 + k, gc = col0 + nn;
      Bs[k][nn] = (gk < c && gc < h) ? w[(size_t)gk * h + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][tr + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Bs[k][tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + tr + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tc + 16 * j;
      if (col < h) out[(size_t)r * h + col] = acc[i][j] + b[col];
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
int fused_score_launch(const void* x, const void* norm, const void* w,
                       const void* b, void* out, int n, int c, int h,
                       void* stream) {
  if (n <= 0 || h <= 0) return 0;
  dim3 grid((n + BM - 1) / BM, (h + BN - 1) / BN);
  fused_score_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)norm, (const float*)w,
      (const float*)b, (float*)out, n, c, h);
  return (int)cudaGetLastError();
}

const char* fused_score_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
