// The binning rule shared by K2 (fused_trees.cu) and K4 (level_hist.cu):
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
