// SORE N:M compaction for Hopper (sm_90a).
//
// For a logical (R, K) operand x, with the m-groups along K:
//
//   vals[r, g*n + s] = the s-th survivor of group g of row r, in x's dtype
//   idx [r, g*n + s] = its in-group offset, ascending in s
//
// the survivors being the n largest |x| of the group (first position wins
// a tie).  idx is either one uint8 per value (R, Kc) or the u4 plane
// (R, ceil(Kc/2)): entry e in nibble (e & 1) of byte e/2, low nibble
// first, the last byte's high nibble 0 when Kc is odd.  Every operand is
// addressed through its own two element strides, so one kernel serves a
// contiguous (R, K) matrix (score rows) and the transposed view of a
// (K, F) weight packed along K, whose vals and idx land straight in the
// (Kc, F) layout nm_spmm reads (no transposed copy anywhere).
//
// Replaces the TPU kernel src/repro/kernels/nm_compact.py:_compact_kernel
// (nm_compact_pallas), which selects over a (TR, TK) VMEM tile with n
// rounds of masked max and an index sort network.
//
// What bounds it: bytes.  Each element is read once (2 or 4 B) and n/m of
// it written back plus an index; a handful of compares per element.
// Design: one thread owns one m-group of one row (two groups when a u4
// byte would straddle them, see below) and keeps its m values in
// registers; select_topn.cuh gives the survivors as a bit mask, walked
// from bit 0 up, so they come out in ascending offset with no sort.
// Threads are laid out along whichever logical axis has the smaller
// input stride: for the transposed weight view (strides (1, F)) lanes
// take neighbouring columns, so each of the m loads and every store of a
// warp is one contiguous run; for contiguous rows lanes take neighbouring
// groups.
//
// u4 with odd n (1:8, 3:8): a byte then spans two groups.  A thread takes
// two groups in that case, so its entries start at an even position and
// no two threads ever write halves of one byte.
//
// Bitwise contract: values are copied, never converted (a -0 survivor
// stays -0), and the selection is the plain version's (kernels/ref.py:
// ref_nm_compact, i.e. core/sparsity.nm_pack + pack_idx_u4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "select_topn.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int M, int IDX_BITS>
__global__ void __launch_bounds__(kThreads)
nm_compact_kernel(const T* __restrict__ x, int64_t xs_r, int64_t xs_k,
                  T* __restrict__ vals, int64_t vs_r, int64_t vs_k,
                  uint8_t* __restrict__ idx, int64_t is_r, int64_t is_k,
                  int64_t R, int G, int n, int gpt, int spans,
                  bool rows_fast) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= R * spans) return;
  int64_t r;
  int span;
  if (rows_fast) {
    span = (int)(t / R);
    r = t - (int64_t)span * R;
  } else {
    r = t / spans;
    span = (int)(t - r * spans);
  }
  const int g0 = span * gpt;
  const int g1 = min(G, g0 + gpt);
  const T* xr = x + r * xs_r;
  T* vr = vals + r * vs_r;
  uint8_t* ir = idx + r * is_r;
  unsigned pending = 0u;          // u4: the even entry awaiting its partner
  for (int g = g0; g < g1; ++g) {
    T raw[M];
    float s[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      raw[j] = xr[(int64_t)(g * M + j) * xs_k];
      s[j] = to_f32(raw[j]);
    }
    const unsigned keep = select_topn<M>(s, n);
    int e = g * n;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (!((keep >> j) & 1u)) continue;
      vr[(int64_t)e * vs_k] = raw[j];
      if (IDX_BITS == 8) {
        ir[(int64_t)e * is_k] = static_cast<uint8_t>(j);
      } else if (e & 1) {
        ir[(int64_t)(e >> 1) * is_k] =
            static_cast<uint8_t>(pending | ((unsigned)j << 4));
      } else {
        pending = (unsigned)j;
      }
      ++e;
    }
  }
  // an odd Kc leaves the row's last entry alone in its byte
  if (IDX_BITS == 4 && ((g1 * n) & 1))
    ir[(int64_t)((g1 * n) >> 1) * is_k] = static_cast<uint8_t>(pending);
}

template <typename T, int M>
int launch_m(int idx_bits, const void* x, int64_t xs_r, int64_t xs_k,
             void* vals, int64_t vs_r, int64_t vs_k, void* idx, int64_t is_r,
             int64_t is_k, int64_t R, int G, int n, int gpt, int spans,
             bool rows_fast, cudaStream_t st) {
  const int64_t threads = R * spans;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  const auto* xi = static_cast<const T*>(x);
  auto* vo = static_cast<T*>(vals);
  auto* io = static_cast<uint8_t*>(idx);
  if (idx_bits == 4)
    nm_compact_kernel<T, M, 4><<<blocks, kThreads, 0, st>>>(
        xi, xs_r, xs_k, vo, vs_r, vs_k, io, is_r, is_k, R, G, n, gpt, spans,
        rows_fast);
  else
    nm_compact_kernel<T, M, 8><<<blocks, kThreads, 0, st>>>(
        xi, xs_r, xs_k, vo, vs_r, vs_k, io, is_r, is_k, R, G, n, gpt, spans,
        rows_fast);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(int m, int idx_bits, const void* x, int64_t xs_r, int64_t xs_k,
             void* vals, int64_t vs_r, int64_t vs_k, void* idx, int64_t is_r,
             int64_t is_k, int64_t R, int G, int n, int gpt, int spans,
             bool rows_fast, cudaStream_t st) {
  switch (m) {
    case 2: return launch_m<T, 2>(idx_bits, x, xs_r, xs_k, vals, vs_r, vs_k,
                                  idx, is_r, is_k, R, G, n, gpt, spans,
                                  rows_fast, st);
    case 4: return launch_m<T, 4>(idx_bits, x, xs_r, xs_k, vals, vs_r, vs_k,
                                  idx, is_r, is_k, R, G, n, gpt, spans,
                                  rows_fast, st);
    case 8: return launch_m<T, 8>(idx_bits, x, xs_r, xs_k, vals, vs_r, vs_k,
                                  idx, is_r, is_k, R, G, n, gpt, spans,
                                  rows_fast, st);
    case 16: return launch_m<T, 16>(idx_bits, x, xs_r, xs_k, vals, vs_r,
                                    vs_k, idx, is_r, is_k, R, G, n, gpt,
                                    spans, rows_fast, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (R, K) with element strides (xs_r, xs_k); vals (R, K*n/m) of x's type
// with strides (vs_r, vs_k); idx uint8 (R, Kc) or, with idx_bits 4,
// (R, ceil(Kc/2)), strides (is_r, is_k).  dtype: 0 fp32, 1 bf16.
// m in {2, 4, 8, 16}, 0 < n <= m, K % m == 0.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a dtype or m it is not
// built for).
extern "C" int nm_compact_launch(const void* x, int dtype, int64_t xs_r,
                                 int64_t xs_k, void* vals, int64_t vs_r,
                                 int64_t vs_k, void* idx, int64_t is_r,
                                 int64_t is_k, int64_t R, int K, int n, int m,
                                 int idx_bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = K / m;
  const int gpt = (idx_bits == 4 && (n & 1)) ? 2 : 1;
  const int spans = (G + gpt - 1) / gpt;
  const bool rows_fast = xs_r < xs_k;
  switch (dtype) {
    case 0: return launch_t<float>(m, idx_bits, x, xs_r, xs_k, vals, vs_r,
                                   vs_k, idx, is_r, is_k, R, G, n, gpt, spans,
                                   rows_fast, st);
    case 1: return launch_t<__nv_bfloat16>(m, idx_bits, x, xs_r, xs_k, vals,
                                           vs_r, vs_k, idx, is_r, is_k, R, G,
                                           n, gpt, spans, rows_fast, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
