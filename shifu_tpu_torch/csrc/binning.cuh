// The binning rule of K2 (fused_trees.cu) and K4 (level_hist.cu): a raw
// f32 value's bin against one column's K cut boundaries, ascending and
// +inf padded. NaN is tested BEFORE any comparison and lands in the
// missing bin n_bins-1; otherwise bin = Σ(v >= cut), clamped to
// n_bins-2. +inf pads never count for a finite value; v = +inf counts
// them and is clamped like any value beyond the last cut. The same rule
// as `bin_index_numeric` / `bins_from_values` of the JAX package (a
// searchsorted(side="right") over ascending cuts), so the bins agree
// exactly with the plain PyTorch versions.
//
// Both kernels find the bin by an upper-bound binary search: over
// ascending cuts Σ(v >= cut) is the number of cuts <= v, the largest
// p <= K with cuts[p-1] <= v. It is found by binary lifting in
// ⌈log2(K+1)⌉ steps instead of K: steps of search_top(K), then half of
// it, ... 1, each taking its step when the cut it lands on is <= v. The
// cuts are staged (`stage_cuts`) with search_span(K) slots a column, the
// slots past K holding NaN: a NaN cut is <= no value, +inf included, so
// the search never counts a slot past the K cuts given (v = +inf counts
// exactly the +inf pads inside the K, as Σ does) and needs no bound
// check; duplicated cuts count once each.
#pragma once

#include <stdint.h>

// The largest power of two <= k (0 for k = 0), the first step.
__host__ __device__ inline int search_top(int k) {
  int t = k > 0 ? 1 : 0;
  while (t > 0 && 2 * t <= k) t *= 2;
  return t;
}

// Slots a column's staged cuts take: every index the search can reach.
__host__ __device__ inline int search_span(int k) {
  return k > 0 ? 2 * search_top(k) - 1 : 0;
}

// Columns [c0, c0 + nc) of the (C, K) cuts into `s_cuts`, search_span(K)
// slots a column: the K cuts by cp.async, NaN in the slots past them.
// Thread `tid` of `nthreads` takes every nthreads-th slot; the caller
// commits, waits and synchronizes.
__device__ __forceinline__ void stage_cuts(float* s_cuts, const float* cuts,
                                           int c0, int nc, int k, int tid,
                                           int nthreads) {
  const int span = search_span(k);
  for (int i = tid; i < nc * span; i += nthreads) {
    const int col = i / span, j = i - col * span;
    if (j < k)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       static_cast<uint32_t>(
                           __cvta_generic_to_shared(s_cuts + i))),
                   "l"(cuts + (size_t)(c0 + col) * k + j)
                   : "memory");
    else
      s_cuts[i] = __int_as_float(0x7fffffff);  // NaN: never <= v
  }
}

// One step: `q` points just past the cuts counted so far (all <= v).
__device__ __forceinline__ void search_step(float v, const float*& q,
                                            int step) {
  const float* p = q + (step - 1);
  if (*p <= v) q = p + 1;
}

// `cuts`: one column's K cuts, then NaN up to search_span(K) slots.
__device__ __forceinline__ int bin_of_sorted(float v, const float* cuts,
                                             int top, int n_bins) {
  if (isnan(v)) return n_bins - 1;
  const float* q = cuts;
  for (int step = top; step > 0; step >>= 1) search_step(v, q, step);
  return min((int)(q - cuts), n_bins - 2);
}

// Two values' bins, their searches side by side (K4 overlaps them).
__device__ __forceinline__ void bin_of_sorted2(float v1, const float* c1,
                                               float v2, const float* c2,
                                               int top, int n_bins, int& b1,
                                               int& b2) {
  const float* q1 = c1;
  const float* q2 = c2;
  for (int step = top; step > 0; step >>= 1) {
    search_step(v1, q1, step);
    search_step(v2, q2, step);
  }
  b1 = isnan(v1) ? n_bins - 1 : min((int)(q1 - c1), n_bins - 2);
  b2 = isnan(v2) ? n_bins - 1 : min((int)(q2 - c2), n_bins - 2);
}
