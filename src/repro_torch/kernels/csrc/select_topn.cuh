// N:M survivor selection shared by the port's kernels.
//
// The rule of src/repro/kernels/nm_compact.py:_select_topn, which the TPU
// kernels fused_update, nm_compact and grad_compress share: n rounds of
// max over the |x| of one m-group, the first position winning a tie,
// survivors then taken in ascending offset.  It is also the port's plain
// selection (core/sparsity._topn_offsets: n rounds of torch.argmax, which
// returns the first maximum and counts a NaN as the largest).  The result
// is a bit mask of the survivors, so walking it from bit 0 up gives them
// in ascending offset with no sort network.

#pragma once

#include <cuda_runtime.h>

template <int M>
__device__ __forceinline__ unsigned select_topn(const float (&x)[M], int n) {
  static_assert(M <= 32, "one bit per group position");
  unsigned keep = 0u;
  for (int r = 0; r < n; ++r) {
    int best = -1;
    float top = 0.f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if ((keep >> j) & 1u) continue;
      const float s = fabsf(x[j]);
      if (best < 0 || s > top || (isnan(s) && !isnan(top))) {
        best = j;
        top = s;
      }
    }
    keep |= 1u << best;
  }
  return keep;
}

// The same selection on integer keys, for fp32 x: key = |bits|, every NaN
// clamped to one value above +inf's (0x7f800001), so the keys order as
// the magnitudes do under the rule above (+0 == -0, all NaNs equal and
// above everything).  Each round takes the first largest key and retires
// it as -1: n rounds of M compare-and-selects, no float compares.
template <int M>
__device__ __forceinline__ unsigned select_topn_keys(const float (&x)[M],
                                                     int n) {
  static_assert(M <= 32, "one bit per group position");
  int key[M];
#pragma unroll
  for (int j = 0; j < M; ++j)
    key[j] = min(__float_as_int(x[j]) & 0x7fffffff, 0x7f800001);
  unsigned keep = 0u;
  for (int r = 0; r < n; ++r) {
    int best = 0, top = key[0];
#pragma unroll
    for (int j = 1; j < M; ++j) {
      const bool gt = key[j] > top;
      top = gt ? key[j] : top;
      best = gt ? j : best;
    }
    keep |= 1u << best;
#pragma unroll
    for (int j = 0; j < M; ++j) key[j] = j == best ? -1 : key[j];
  }
  return keep;
}
