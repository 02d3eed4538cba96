// Fused z-score normalize + first-layer matmul for NN scoring, on the
// tensor cores in 3xTF32.
//
// Replaces the TPU kernel `_score_kernel` / `_fused_first_layer_pallas`
// (shifu_tpu/ops/pallas_score.py:64,110): out = zscore(x) @ w + b for raw
// (N, C) rows, without writing the z-scored matrix to device memory.
//
// What bounds it on an H100: at the serving and eval shapes (C = 600,
// H = 512) the product does 2·N·C·H multiply-adds against 4·(N·C + N·H)
// bytes, so at eval size it is bound by arithmetic. The contract is f32
// (rtol = atol = 1e-5 against the plain version), which the f32 FMA
// pipes deliver at 67 TFLOP/s. The tensor cores run TF32 at 495 TFLOP/s;
// splitting each operand into a TF32 high part and a TF32 low part (the
// residual, rounded the same way) and summing hi·hi + hi·lo + lo·hi in
// f32 accumulators (CUTLASS's OpMultiplyAddFastF32) keeps the error near
// f32, about 2^-21 relative per product, at three tensor-core products
// per f32 one. Its least time is 3·2·N·C·H at 495 TFLOP/s.
//
// Design:
// - A (the z tile) goes to `wgmma` from registers. Raw x tiles reach
//   shared memory through cp.async (16-byte copies when C·4 % 16 == 0,
//   4-byte ones otherwise, zero-filled past the edges). Each thread of a
//   consumer warpgroup reads its m64k8 fragment, NaN-fills, clamps,
//   divides (a true IEEE division) and splits the values in registers;
//   z never touches device memory.
// - B is `pack_weights(w)` (ops/fused_score.py): w's TF32 hi and lo
//   parts, transposed to K-major and laid out k-tile by k-tile in the
//   order the stage reads, so one stage's B is eight contiguous runs of
//   BN rows × 16 bytes, read by `wgmma` through no-swizzle descriptors
//   (core matrices of 8 rows × 16 bytes; LBO = the K-chunk stride,
//   SBO = 128 bytes).
// - Each k-tile's three products land in a fresh tensor-core
//   accumulator, which plain f32 adds (round to nearest) fold into the
//   running sum: summing all of K in the tensor cores' accumulator drifts
//   past the tolerance at C = 600, since its additions do not round to
//   nearest.
// - A ring of STAGES shared-memory stages keeps the next k-tiles' copies
//   in flight while `wgmma` runs on this one.
// - The card is filled at every bucket by `_k1_plan` (Python): tile
//   BM×BN (BM = 64 or 128 rows, one or two consumer warpgroups;
//   BN ≤ 128 columns), and at
//   small N a K-split over the blocks of one thread-block cluster. Each
//   block stages its partial tile in shared memory; block r of the
//   cluster then sums rows [r·BM/S, (r+1)·BM/S) of all S partials
//   through distributed shared memory in the fixed order 0..S-1, adds
//   the bias once and writes coalesced rows. No atomics: two launches on
//   the same input are bit-identical.
//
// Order of operations mirrors `_pack_norm` + `_score_kernel`: NaN is
// replaced by the mean BEFORE the clamp, the clamp bounds come packed
// (tiny-std columns carry lo = hi = mean and std 1, so z is exactly 0),
// and z is (clip(v) - mean) / std. Columns past C are z = 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 16;          // columns of x per k-tile (stage)
constexpr int KSTEPS = BK / 8;  // wgmma k8 steps per k-tile
constexpr int XS = BK + 4;      // row stride of the raw x tile, floats:
                                // conflict-free fragment reads
constexpr int MAX_SPLIT = 8;    // portable cluster size
constexpr int STAGES = 5;       // shared-memory ring
constexpr int AHEAD = STAGES - 2;  // k-tiles in flight past this one

// Shared memory of one block, in floats: STAGES × (B hi/lo, x, norm),
// reused after the main loop for the (BM, BN + 4) partial tile.
template <int BM, int BN>
struct Smem {
  static constexpr int RUN = BN * 4;  // a run: BN rows × 4 k
  static constexpr int W = 2 * KSTEPS * 2 * RUN;
  static constexpr int X = BM * XS;
  static constexpr int NORM = 5 * BK;  // f64 1/std, mean, lo, hi
  static constexpr int STAGE = W + X + NORM;
  static constexpr int OUT = BM * (BN + 4);
  static constexpr int FLOATS = STAGE * STAGES > OUT ? STAGE * STAGES : OUT;
  static constexpr int BYTES = 4 * FLOATS;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// TF32 round-to-nearest (ties away), low 13 bits cleared: what
// `cvt.rna.tf32.f32` gives, in two integer instructions: half a TF32
// ulp added to the magnitude bits, then a mask (a carry rounds into the
// next binade, as it should).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// No-swizzle K-major shared-memory matrix descriptor.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) |
         ((uint64_t)((lbo & 0x3ffff) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3ffff) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins the accumulators around the asynchronous products, so the
// compiler moves none of them while a `wgmma` is in flight.
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64×N, f32) = A(64×8, tf32, registers) · B(8×N, tf32, shared)
// + (scale_d ? D : 0).
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float* d, const uint32_t* a,
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float* d, const uint32_t* a,
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float* d, const uint32_t* a,
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, const uint32_t* a,
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, const uint32_t* a,
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int WG, int BN>
__global__ void __launch_bounds__(WG * 128, 1)
fused_score_kernel(const float* __restrict__ x,      // (n, c) raw
                   const float* __restrict__ norm,   // pack_norm: (6, c)
                   const float* __restrict__ wpack,  // pack_weights(w)
                   const float* __restrict__ bias,   // (h,)
                   float* __restrict__ out,          // (n, h)
                   int n, int c, int h, int h8, int kt_per_split, int vec) {
  constexpr int BM = 64 * WG;
  constexpr int THREADS = 128 * WG;
  using S = Smem<BM, BN>;
  extern __shared__ __align__(128) float smem[];

  const int tid = threadIdx.x;
  const int n_ct = (h8 + BN - 1) / BN;
  // the column tiles of one row tile are neighbours: x is read from L2
  const int rt = blockIdx.x / n_ct, ct = blockIdx.x % n_ct;
  const int m0 = rt * BM;
  const int n0 = ct * BN;
  const int kt_real = (c + BK - 1) / BK;
  const int kt0 = blockIdx.z * kt_per_split;
  const int kt1 = min(kt0 + kt_per_split, kt_real);
  const int n_kt = max(kt1 - kt0, 0);
  const double* rcp = reinterpret_cast<const double*>(norm + 4 * c);

  // k-tile kt's B, x and norm into ring stage `stage`. Each thread's
  // copies are a fixed count of fixed slots (the counts divide evenly
  // but for B at BN < 16), so the loops unroll with no remainder paths.
  auto load_stage = [&](int kt, int stage) {
    float* st = smem + stage * S::STAGE;
    const int k0 = kt * BK;
    // B: 8 runs (hi/lo × k8 step × K chunk) of BN rows × 4 floats
    const float* wk = wpack + (size_t)kt * 8 * h8 * 4;
    constexpr int B_COPIES = (8 * BN + THREADS - 1) / THREADS;
#pragma unroll
    for (int j = 0; j < B_COPIES; ++j) {
      const int i = tid + j * THREADS;
      if ((8 * BN) % THREADS == 0 || i < 8 * BN) {
        const int run = i / BN, row = i % BN, gn = n0 + row;
        const bool ok = gn < h8;
        cp_async16(smem_u32(st + run * S::RUN + row * 4),
                   wk + ((size_t)run * h8 + (ok ? gn : 0)) * 4,
                   ok ? 16 : 0);
      }
    }
    float* xs = st + S::W;
    if (vec) {
      // BM rows × BK/4 chunks of 16 bytes: two a thread
#pragma unroll
      for (int j = 0; j < BM * (BK / 4) / THREADS; ++j) {
        const int i = tid + j * THREADS;
        const int row = i / (BK / 4), q = 4 * (i % (BK / 4));
        const int gr = m0 + row, gk = k0 + q;
        const bool ok = gr < n && gk < c;
        cp_async16(smem_u32(xs + row * XS + q),
                   ok ? x + (size_t)gr * c + gk : x, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int row = i / BK, j = i % BK;
        const int gr = m0 + row, gk = k0 + j;
        const bool ok = gr < n && gk < c;
        cp_async4(smem_u32(xs + row * XS + j),
                  ok ? x + (size_t)gr * c + gk : x, ok ? 4 : 0);
      }
    }
    // norm: BK f64 reciprocals, then mean, lo, hi (one copy a thread)
    float* ns = xs + S::X;
    if (tid < 4 * BK) {
      const int q = tid / BK, j = tid % BK, gk = k0 + j;
      const bool ok = gk < c;
      if (q == 0)
        cp_async8(smem_u32(ns + 2 * j), ok ? rcp + gk : rcp, ok ? 8 : 0);
      else
        cp_async4(smem_u32(ns + BK + tid),
                  ok ? norm + (size_t)(q == 1 ? 0 : q) * c + gk : norm,
                  ok ? 4 : 0);
    }
  };

  // `part` is one k-tile's product on the tensor cores; `acc` sums the
  // k-tiles with f32 adds that round to nearest.
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int frag_row = wg * 64 + warp * 16 + g;

  // This thread's A fragments of k-tile i: z of its (row, column)
  // pairs, split into TF32 hi and lo.
  auto normalize = [&](int i, uint32_t (&ahi)[KSTEPS][4],
                       uint32_t (&alo)[KSTEPS][4]) {
    const float* st = smem + i % STAGES * S::STAGE;
    const float* xs = st + S::W;
    const float* ns = xs + S::X;
    const double* nr = reinterpret_cast<const double*>(ns);
    const int k0 = (kt0 + i) * BK;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int row = frag_row + 8 * (v & 1);
        const int col = 8 * s + t + 4 * (v >> 1);
        const float mean = ns[2 * BK + col];
        const float lo = ns[3 * BK + col], hi = ns[4 * BK + col];
        float val = xs[row * XS + col];
        if (isnan(val)) val = mean;  // before the clamp
        val = fminf(fmaxf(val, lo), hi);
        // the correctly rounded (val - mean) / std (see pack_norm)
        float z = (float)((double)(val - mean) * nr[col]);
        z = (k0 + col < c) ? z : 0.f;
        ahi[s][v] = to_tf32(z);
        alo[s][v] = to_tf32(z - __uint_as_float(ahi[s][v]));
      }
    }
    // the fragments are final here, so this arithmetic runs while the
    // previous k-tile's products do: the compiler may not sink it past
    // the wait in `fold`, nor between the products `multiply` issues
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        asm volatile("" : "+r"(ahi[s][v]), "+r"(alo[s][v])::"memory");
  };

  // k-tile i's products: the small terms (lo·hi, hi·lo) of both k8
  // steps first, then hi·hi, into a fresh `part`.
  auto multiply = [&](int i, const uint32_t (&ahi)[KSTEPS][4],
                      const uint32_t (&alo)[KSTEPS][4]) {
    const uint32_t wbase = smem_u32(smem + i % STAGES * S::STAGE);
    // run (p, s, chunk 0) starts (p·KSTEPS + s)·2 runs in; the next K
    // chunk is one run (BN·16 bytes) further, the next 8 rows 128 bytes
    uint64_t d_hi[KSTEPS], d_lo[KSTEPS];
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      d_hi[s] = make_desc(wbase + (s * 2) * S::RUN * 4, S::RUN * 4,
                          128);
      d_lo[s] = make_desc(wbase + ((KSTEPS + s) * 2) * S::RUN * 4,
                          S::RUN * 4, 128);
    }
    fence_acc<BN / 2>(part);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      wgmma_tf32<BN>(part, alo[s], d_hi[s], s > 0);
      wgmma_tf32<BN>(part, ahi[s], d_lo[s], 1);
    }
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) wgmma_tf32<BN>(part, ahi[s], d_hi[s], 1);
    wgmma_commit();
  };

  // Waits for the products in flight, which read (ahi, alo): pinning
  // those registers here keeps the compiler from reusing them before.
  auto fold = [&](uint32_t (&ahi)[KSTEPS][4], uint32_t (&alo)[KSTEPS][4]) {
    wgmma_wait_all();
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        asm volatile("" : "+r"(ahi[s][v]), "+r"(alo[s][v])::"memory");
    fence_acc<BN / 2>(part);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] += part[j];
  };

  // k-tile i's data has landed in its stage, for every thread.
  auto arrive = [&](int i) {
    cp_async_wait<AHEAD - 1>();
    // cp.async writes are generic-proxy writes; wgmma reads B through
    // the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // the stage refilled now last held k-tile i - 2, whose products
    // every thread has folded before this barrier
    if (i + AHEAD < n_kt) load_stage(kt0 + i + AHEAD, (i + AHEAD) % STAGES);
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < n_kt) load_stage(kt0 + s, s);
    cp_async_commit();
  }

  uint32_t ahi0[KSTEPS][4], alo0[KSTEPS][4], ahi1[KSTEPS][4],
      alo1[KSTEPS][4];
  // k-tile i is normalized while k-tile i - 1's products run; the
  // fragments alternate between two register sets, since a `wgmma` in
  // flight still reads its A registers
  for (int i = 0; i < n_kt; i += 2) {
    arrive(i);
    normalize(i, ahi0, alo0);
    if (i > 0) fold(ahi1, alo1);
    multiply(i, ahi0, alo0);
    if (i + 1 < n_kt) {
      arrive(i + 1);
      normalize(i + 1, ahi1, alo1);
      fold(ahi0, alo0);
      multiply(i + 1, ahi1, alo1);
    }
  }
  if (n_kt > 0) fold(ahi0, alo0);
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: the partial tile through shared memory, then the cluster's
  // fixed-order reduction, the bias, and coalesced rows of float4.
  constexpr int OS = BN + 4;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int row = frag_row + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * t;
    *reinterpret_cast<float2*>(smem + row * OS + col) =
        make_float2(acc[i], acc[i + 1]);
  }
  // the cluster is the whole K-split: (1, 1, gridDim.z) blocks
  const int split = gridDim.z;
  const int rank = blockIdx.z;
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1)
    cluster.sync();
  else
    __syncthreads();
  const float* tile[MAX_SPLIT];  // each cluster block's partial tile
#pragma unroll
  for (int q = 0; q < MAX_SPLIT; ++q)
    tile[q] = q >= split ? nullptr
              : q == rank ? smem : cluster.map_shared_rank(smem, q);
  constexpr int C4 = BN / 4;  // float4 columns of the tile
  const int c4 = tid % C4, gc = n0 + 4 * c4;
  float bs[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) bs[e] = gc + e < h ? bias[gc + e] : 0.f;
  const bool row_vec = (h % 4 == 0) && gc + 3 < h;
  const int rows = BM / split;
#pragma unroll 4
  for (int r = tid / C4; r < rows; r += THREADS / C4) {
    const int row = rank * rows + r, gr = m0 + row;
    if (gr >= n) break;
    float4 sum = *reinterpret_cast<const float4*>(tile[0] + row * OS + 4 * c4);
#pragma unroll
    for (int q = 1; q < MAX_SPLIT; ++q)
      if (q < split) {
        const float4 p =
            *reinterpret_cast<const float4*>(tile[q] + row * OS + 4 * c4);
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
    sum.x += bs[0];
    sum.y += bs[1];
    sum.z += bs[2];
    sum.w += bs[3];
    float* o = out + (size_t)gr * h + gc;
    if (row_vec) {
      *reinterpret_cast<float4*>(o) = sum;
    } else {
      const float v4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (gc + e < h) o[e] = v4[e];
    }
  }
  if (split > 1) cluster.sync();  // no block leaves while another reads
}

template <int WG, int BN>
int launch(const float* x, const float* norm, const float* wpack,
           const float* b, float* out, int n, int c, int h, int h8,
           int kt_per_split, int split, cudaStream_t stream) {
  constexpr int BM = 64 * WG;
  constexpr int BYTES = Smem<BM, BN>::BYTES;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((n + BM - 1) / BM) * ((h8 + BN - 1) / BN), 1, split);
  cfg.blockDim = dim3(128 * WG);
  cfg.dynamicSmemBytes = BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int vec = (c % 4 == 0) &&
                  ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  cudaError_t err = cudaLaunchKernelEx(&cfg, fused_score_kernel<WG, BN>, x,
                                       norm, wpack, b, out, n, c, h, h8,
                                       kt_per_split, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The variant's shared-memory limit, on the current device: its size is
// fixed, so once per (device, variant) is enough.
template <int WG, int BN>
int prepare() {
  return (int)cudaFuncSetAttribute(
      fused_score_kernel<WG, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<64 * WG, BN>::BYTES);
}

}  // namespace

// Every (warpgroups, BN) variant the plan can pick (`_k1_plan`).
#define K1_VARIANTS                                                        \
  K1_CASE(1, 8) K1_CASE(1, 16) K1_CASE(1, 32) K1_CASE(1, 64)               \
  K1_CASE(1, 128)                                                          \
  K1_CASE(2, 8) K1_CASE(2, 16) K1_CASE(2, 32) K1_CASE(2, 64)               \
  K1_CASE(2, 128)

extern "C" {

// What a launch needs besides its input and output, filled once per
// (first layer, batch size) by the wrapper (`_Launch` of
// ops/fused_score.py, field for field).
struct Launch {
  const float* norm;   // pack_norm: (6, c)
  const float* wpack;  // pack_weights(w)
  const float* bias;   // (h,)
  int n, c, h;
  int kt_pack;         // the pack's k-tiles (a multiple of every split)
  int bm, bn, split;   // `_k1_plan(n, c, h)`
};

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
int fused_score_run(const Launch* p, const void* x, void* out,
                    void* stream) {
  const int n = p->n, c = p->c, h = p->h, bm = p->bm, bn = p->bn,
            split = p->split, kt_pack = p->kt_pack;
  if (n <= 0 || h <= 0) return 0;
  const int h8 = (h + 7) / 8 * 8;
  if (split < 1 || split > MAX_SPLIT || (split & (split - 1)) ||
      kt_pack % split || kt_pack * BK < c || (bm / 64) * 64 != bm ||
      bm % split)
    return (int)cudaErrorInvalidValue;
  const int kps = kt_pack / split;
  auto st = (cudaStream_t)stream;
  const float *xf = (const float*)x, *nf = p->norm, *wf = p->wpack,
              *bf = p->bias;
  float* of = (float*)out;
#define K1_CASE(WG, BN)                                                    \
  if (bm == 64 * WG && bn == BN)                                           \
    return launch<WG, BN>(xf, nf, wf, bf, of, n, c, h, h8, kps, split, st);
  K1_VARIANTS
#undef K1_CASE
  return (int)cudaErrorInvalidValue;
}

// Sets the shared-memory limit of the (bm, bn) variant on the current
// device; the wrapper calls it once per (device, variant) before that
// variant's first launch there. Returns the cudaError_t (0 = ok).
int fused_score_prepare(int bm, int bn) {
#define K1_CASE(WG, BN) \
  if (bm == 64 * WG && bn == BN) return prepare<WG, BN>();
  K1_VARIANTS
#undef K1_CASE
  return (int)cudaErrorInvalidValue;
}

const char* fused_score_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
