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
//
// Two variants, with the same bits:
//
//   * vector (the element pack's path): for the transposed weight view,
//     whose R axis has unit stride in x, vals and idx alike, a thread
//     owns one 16-byte chunk of columns (8 bf16, 4 fp32) of one m-group
//     (two groups for u4 with odd n, so nibbles pair up inside the
//     thread).  It issues all m row loads (16 bytes each) before a store,
//     selects every column in registers, and writes the n vals rows as
//     16-byte stores and each idx row's bytes of its columns as one 8- or
//     4-byte store; a warp's access to one row is one contiguous 512-byte
//     run (256 for idx).  The selection compares integer keys (see
//     select_column): n levels of max/min keep the n largest, which are
//     then ordered by position; each key carries its element's bits, so
//     nothing is indexed by a data-dependent position (such an index
//     puts the group in local memory).  A persistent grid walks the
//     (group span, chunk) items, chunk fastest, with 64-bit offsets
//     formed once per item.  n is a template argument (the key lists are
//     registers), built for n <= kVecMaxN.  The wrapper takes it when n
//     <= kVecMaxN, the R strides are 1, R is a whole number of chunks
//     and every base pointer and K stride is a multiple of 16 bytes.
//   * scalar (anything else: score rows, ragged or misaligned views,
//     n > kVecMaxN): one thread owns one m-group of one row (two groups
//     when a u4 byte would straddle them) and keeps its m values in
//     registers; select_topn.cuh gives the survivors as a bit mask,
//     walked from bit 0 up.  Threads are laid out along whichever logical
//     axis has the smaller input stride: for a transposed weight view
//     (strides (1, F)) lanes take neighbouring columns; for contiguous
//     rows lanes take neighbouring groups.
//
// Bitwise contract: values are copied, never converted (a -0 survivor
// stays -0), and the selection is the plain version's (kernels/ref.py:
// ref_nm_compact, i.e. core/sparsity.nm_pack + pack_idx_u4: n rounds of
// first-maximum argmax over |x|, a NaN the largest).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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


// ---- vector variant ----------------------------------------------------

constexpr int kVecMaxN = 4;   // the n the vector variant is built for

// An element's bits in an unsigned integer wide enough for its selection
// key; `get`/`put` move element c of 16 bytes held as four 32-bit words.
template <typename T>
struct Key;
template <>
struct Key<__nv_bfloat16> {
  using U = uint32_t;
  static constexpr int kBits = 16, kMant = 7;
  static constexpr U kNaN = 0x7f81u;   // every NaN's magnitude; +inf 0x7f80
  static __device__ __forceinline__ U get(const uint32_t (&w)[4], int c) {
    return (w[c >> 1] >> ((c & 1) * 16)) & 0xffffu;
  }
  static __device__ __forceinline__ void put(uint32_t (&w)[4], int c, U v) {
    w[c >> 1] |= v << ((c & 1) * 16);
  }
};
template <>
struct Key<float> {
  using U = unsigned long long;
  static constexpr int kBits = 32, kMant = 23;
  static constexpr U kNaN = 0x7f800001ull;
  static __device__ __forceinline__ U get(const uint32_t (&w)[4], int c) {
    return w[c];
  }
  static __device__ __forceinline__ void put(uint32_t (&w)[4], int c, U v) {
    w[c] = static_cast<uint32_t>(v);
  }
};

// The N survivors of one m-group column, in ascending position: their
// bits and positions.  Same selection as select_topn.cuh (|x| descending,
// a NaN above everything, the first position winning a tie, +0 == -0),
// done on distinct integer keys:
//
//   key = |bits| (every NaN one value) << (4 + L) | (15 - position) << L
//         | sign << kMant | mantissa,          L = kMant + 1,
//
// so the n largest keys are the survivors, and each key still holds its
// element's bits (a NaN's payload from the low field).
template <typename T, int M, int N>
__device__ __forceinline__ void select_column(
    const typename Key<T>::U (&raw)[M], typename Key<T>::U (&bits)[N],
    int (&pos)[N]) {
  using K = Key<T>;
  using U = typename K::U;
  constexpr int L = K::kMant + 1;
  constexpr U kMag = (U(1) << (K::kBits - 1)) - 1;
  constexpr U kLow = (U(1) << K::kMant) - 1;
  U top[N];   // the N largest keys so far, descending
#pragma unroll
  for (int i = 0; i < N; ++i) top[i] = 0;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const U mag = raw[j] & kMag;
    U c = ((mag < K::kNaN ? mag : K::kNaN) << (4 + L)) | (U(15 - j) << L) |
          ((raw[j] >> (K::kBits - 1)) << K::kMant) | (raw[j] & kLow);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const U hi = top[i] > c ? top[i] : c;
      c = top[i] > c ? c : top[i];
      top[i] = hi;
    }
  }
  // back to bits, keyed by position: (15 - position) << kBits | bits
  U ord[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    ord[i] = (((top[i] >> L) & 15) << K::kBits) |
             (((top[i] >> K::kMant) & 1) << (K::kBits - 1)) |
             ((top[i] >> (4 + L)) & (kMag & ~kLow)) | (top[i] & kLow);
#pragma unroll
  for (int a = 0; a < N; ++a)
#pragma unroll
    for (int b = 0; b + 1 < N - a; ++b) {
      const U hi = ord[b] > ord[b + 1] ? ord[b] : ord[b + 1];
      ord[b + 1] = ord[b] > ord[b + 1] ? ord[b + 1] : ord[b];
      ord[b] = hi;
    }
#pragma unroll
  for (int s = 0; s < N; ++s) {
    pos[s] = 15 - static_cast<int>(ord[s] >> K::kBits);
    bits[s] = ord[s] & ((U(1) << K::kBits) - 1);
  }
}

// W-byte store of the index bytes of W columns (W = 8 or 4).
template <int W>
__device__ __forceinline__ void store_idx(uint8_t* p, const uint32_t* w) {
  if constexpr (W == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(p) = w[0];
}

// One thread per (span, chunk) item at a time: span = GPT groups along K,
// chunk = the W columns of 16 bytes of x (the unit-stride R axis).  ldx,
// ldv, ldi are the K strides in elements.
template <typename T, int M, int N, int IDX_BITS>
__global__ void __launch_bounds__(kThreads)
nm_compact_vec_kernel(const T* __restrict__ x, int64_t ldx,
                      T* __restrict__ vals, int64_t ldv,
                      uint8_t* __restrict__ idx, int64_t ldi, int64_t chunks,
                      int64_t spans, int G) {
  using K = Key<T>;
  using U = typename K::U;
  constexpr int GPT = (IDX_BITS == 4 && (N & 1)) ? 2 : 1;
  constexpr int W = 16 / static_cast<int>(sizeof(T));   // columns a chunk
  constexpr int E = GPT * N;                            // entries a span
  constexpr int IR = IDX_BITS == 8 ? E : E / 2;         // idx rows a span
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t dspan = stride / chunks, dchunk = stride - dspan * chunks;
  int64_t span = first / chunks, chunk = first - span * chunks;
  while (span < spans) {
    const int64_t col = chunk * W;
    // groups of this span: an odd G leaves the last u4 span one group
    const int here = GPT == 2 && G - span * 2 < 2 ? 1 : GPT;
    uint32_t iw[IR][W / 4];   // index bytes of the W columns, per idx row
#pragma unroll
    for (int q = 0; q < IR; ++q)
#pragma unroll
      for (int i = 0; i < W / 4; ++i) iw[q][i] = 0u;
#pragma unroll
    for (int a = 0; a < GPT; ++a) {
      if (a < here) {
        const int64_t g = span * GPT + a;
        const T* xg = x + g * M * ldx + col;
        uint32_t w[M][4];
#pragma unroll
        for (int j = 0; j < M; ++j) {   // every load before a store
          const uint4 v = *reinterpret_cast<const uint4*>(xg + j * ldx);
          w[j][0] = v.x;
          w[j][1] = v.y;
          w[j][2] = v.z;
          w[j][3] = v.w;
        }
        uint32_t o[N][4];
#pragma unroll
        for (int s = 0; s < N; ++s)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[s][i] = 0u;
#pragma unroll
        for (int c = 0; c < W; ++c) {
          U raw[M], bits[N];
          int pos[N];
#pragma unroll
          for (int j = 0; j < M; ++j) raw[j] = K::get(w[j], c);
          select_column<T, M, N>(raw, bits, pos);
#pragma unroll
          for (int s = 0; s < N; ++s) {
            K::put(o[s], c, bits[s]);
            const int e = a * N + s;
            const int q = IDX_BITS == 8 ? e : e >> 1;
            const int sh = 8 * (c & 3) + (IDX_BITS == 8 ? 0 : 4 * (e & 1));
            iw[q][c >> 2] |= static_cast<uint32_t>(pos[s]) << sh;
          }
        }
        T* vg = vals + g * N * ldv + col;
#pragma unroll
        for (int s = 0; s < N; ++s)
          *reinterpret_cast<uint4*>(vg + s * ldv) =
              make_uint4(o[s][0], o[s][1], o[s][2], o[s][3]);
      }
    }
    // a lone group's odd entry count leaves its last high nibble 0
    const int rows = IDX_BITS == 8 ? IR : (here * N + 1) / 2;
    uint8_t* ig = idx + span * IR * ldi + col;
#pragma unroll
    for (int q = 0; q < IR; ++q)
      if (q < rows) store_idx<W>(ig + q * ldi, iw[q]);
    chunk += dchunk;
    span += dspan;
    if (chunk >= chunks) {
      chunk -= chunks;
      ++span;
    }
  }
}

template <typename T, int M, int IDX_BITS, int N = 1>
int launch_vec(int n, const void* x, int64_t ldx, void* vals, int64_t ldv,
               void* idx, int64_t ldi, int64_t R, int G, cudaStream_t st) {
  if constexpr (N > M || N > kVecMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (n != N)
      return launch_vec<T, M, IDX_BITS, N + 1>(n, x, ldx, vals, ldv, idx,
                                               ldi, R, G, st);
    constexpr int GPT = (IDX_BITS == 4 && (N & 1)) ? 2 : 1;
    auto* kernel = nm_compact_vec_kernel<T, M, N, IDX_BITS>;
    static int resident = 0;   // blocks the card holds at once, read once
    if (resident == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0);
      resident = sms * (per_sm > 0 ? per_sm : 1);
    }
    const int64_t chunks = R * static_cast<int64_t>(sizeof(T)) / 16;
    const int64_t spans = (G + GPT - 1) / GPT;
    const int64_t blocks = std::min<int64_t>(
        resident, (chunks * spans + kThreads - 1) / kThreads);
    kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const T*>(x), ldx, static_cast<T*>(vals), ldv,
        static_cast<uint8_t*>(idx), ldi, chunks, spans, G);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int M>
int launch_vec_m(int n, int idx_bits, const void* x, int64_t ldx, void* vals,
                 int64_t ldv, void* idx, int64_t ldi, int64_t R, int G,
                 cudaStream_t st) {
  return idx_bits == 4
             ? launch_vec<T, M, 4>(n, x, ldx, vals, ldv, idx, ldi, R, G, st)
             : launch_vec<T, M, 8>(n, x, ldx, vals, ldv, idx, ldi, R, G, st);
}

template <typename T>
int launch_vec_t(int m, int n, int idx_bits, const void* x, int64_t ldx,
                 void* vals, int64_t ldv, void* idx, int64_t ldi, int64_t R,
                 int G, cudaStream_t st) {
  switch (m) {
    case 2: return launch_vec_m<T, 2>(n, idx_bits, x, ldx, vals, ldv, idx,
                                      ldi, R, G, st);
    case 4: return launch_vec_m<T, 4>(n, idx_bits, x, ldx, vals, ldv, idx,
                                      ldi, R, G, st);
    case 8: return launch_vec_m<T, 8>(n, idx_bits, x, ldx, vals, ldv, idx,
                                      ldi, R, G, st);
    case 16: return launch_vec_m<T, 16>(n, idx_bits, x, ldx, vals, ldv, idx,
                                        ldi, R, G, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The vector variant's rule (the wrapper's `vector_ok`): n <= kVecMaxN,
// unit R strides, R a whole number of 16-byte chunks of x, every base
// pointer and K stride a multiple of 16 bytes.
bool vector_layout(const void* x, int64_t xs_r, int64_t xs_k,
                   const void* vals, int64_t vs_r, int64_t vs_k,
                   const void* idx, int64_t is_r, int64_t is_k, int64_t R,
                   int itemsize, int n) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(vals) |
                         reinterpret_cast<uintptr_t>(idx);
  return n <= kVecMaxN && (R * itemsize) % 16 == 0 && xs_r == 1 &&
         vs_r == 1 && is_r == 1 && (ptrs & 15) == 0 &&
         (xs_k * itemsize) % 16 == 0 && (vs_k * itemsize) % 16 == 0 &&
         is_k % 16 == 0;
}

}  // namespace

// x (R, K) with element strides (xs_r, xs_k); vals (R, K*n/m) of x's type
// with strides (vs_r, vs_k); idx uint8 (R, Kc) or, with idx_bits 4,
// (R, ceil(Kc/2)), strides (is_r, is_k).  dtype: 0 fp32, 1 bf16.
// m in {2, 4, 8, 16}, 0 < n <= m, K % m == 0.  vec = 1 takes the vector
// variant, whose layout rule (vector_layout) must hold.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a dtype
// or m it is not built for, or a vector launch off its layout).
extern "C" int nm_compact_launch(const void* x, int dtype, int64_t xs_r,
                                 int64_t xs_k, void* vals, int64_t vs_r,
                                 int64_t vs_k, void* idx, int64_t is_r,
                                 int64_t is_k, int64_t R, int K, int n, int m,
                                 int idx_bits, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = K / m;
  if (vec) {
    if (dtype != 0 && dtype != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    if (!vector_layout(x, xs_r, xs_k, vals, vs_r, vs_k, idx, is_r, is_k, R,
                       dtype == 0 ? 4 : 2, n))
      return static_cast<int>(cudaErrorInvalidValue);
    return dtype == 0
               ? launch_vec_t<float>(m, n, idx_bits, x, xs_k, vals, vs_k, idx,
                                     is_k, R, G, st)
               : launch_vec_t<__nv_bfloat16>(m, n, idx_bits, x, xs_k, vals,
                                             vs_k, idx, is_k, R, G, st);
  }
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
