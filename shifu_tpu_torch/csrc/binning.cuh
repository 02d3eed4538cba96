// The binning rule of K2 (fused_trees.cu) and K4 (level_hist.cu):
// a raw f32 value's bin against one column's K cut boundaries, ascending
// and +inf padded. NaN is tested BEFORE any comparison and lands in the
// missing bin n_bins-1; otherwise bin = Σ(v >= cut), clamped to n_bins-2.
// +inf pads never count for a finite value; v = +inf counts them and is
// clamped like any value beyond the last cut. The same rule as
// `bin_index_numeric` / `bins_from_values` of the JAX package (a
// searchsorted(side="right") over ascending cuts), so the bins agree
// exactly with the plain PyTorch versions.
#pragma once

__device__ __forceinline__ int bin_of(float v, const float* cuts, int k,
                                      int n_bins) {
  if (isnan(v)) return n_bins - 1;
  int b = 0;
  for (int j = 0; j < k; ++j) b += (v >= cuts[j]) ? 1 : 0;
  return min(b, n_bins - 2);
}

// The same bin by an upper-bound binary search (K2 runs this one; K4
// still runs the scan above): over ascending cuts Σ(v >= cut) is the
// number of cuts <= v, the largest p <= K with cuts[p-1] <= v. It is
// found by binary lifting in ⌈log2(K+1)⌉ steps instead of K: steps of
// search_top(K), then half of it, ... 1, each taking its step when the
// cut it lands on is <= v. The cuts are staged with search_span(K)
// slots a column, the slots past K holding NaN: a NaN cut is <= no
// value, +inf included, so the search never counts a slot past the K
// cuts given (v = +inf counts exactly the +inf pads inside the K, as Σ
// does) and needs no bound check; duplicated cuts count once each.

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
