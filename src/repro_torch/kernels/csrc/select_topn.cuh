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
