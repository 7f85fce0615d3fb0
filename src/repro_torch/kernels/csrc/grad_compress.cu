// Error-feedback N:M gradient compression and the pod mean of the
// packed payloads, for Hopper (sm_90a).
//
// grad_compress: for R gradient rows g (R, K) (bf16 or fp32) and their
// fp32 error-feedback residual err (R, K), per m-group along K:
//
//   t    = f32(g) + err
//   keep = the n survivors of |t| (select_topn.cuh: n rounds of first
//          maximum), taken in ascending offset
//   vals = bf16(t) at the survivors (R, K*n/m), idx their offsets (u8)
//   err' = t - f32(bf16(t)) at a survivor, t elsewhere
//
// grad_decompress_mean: for P payload rows vals/idx (P, K*n/m), per
// m-group: decode each row (dense slot s = the survivor at offset s, or
// +0), sum the rows in order p = 0..P-1 from +0, multiply by
// float32(1/P), and write the K means in the output's dtype.
//
// Replaces the TPU kernels src/repro/kernels/grad_compress.py:
// _compress_kernel (grad_compress_pallas) and _decompress_mean_kernel
// (grad_decompress_mean_pallas).  The Pallas kernels tile (8, 1024)
// blocks into VMEM; here one thread owns one m-group of one row at a
// time, reads its m inputs, selects in registers and writes its
// outputs, so no dense intermediate exists in either kernel.  Rows may
// be strided (a leaf's (P, numel) view, a column range of the (P, T)
// residual): each row has its own leading dimension, so the sync passes
// views, not copies.  The sync launches each kernel once per leaf, so a
// launch covers up to 2 x 622,854,144 elements (the embedding table);
// every offset is 64-bit.
//
// What bounds them: bytes.  grad_compress reads g (2 or 4 B) and err
// (4 B) and writes err' (4 B) and n/m of a bf16 value and an index
// byte: 10.75 B per element at 2:8 with a bf16 gradient.
// grad_decompress_mean reads P*(n/m)*3 B and writes 4 B (fp32) or 2 B
// (bf16) per output element.  Both do a few dozen operations per
// element.
//
// Two variants of each kernel, with the same arithmetic:
//   * vector (the sync's path): a persistent grid walks tiles of
//     kThreads x U groups of a row.  Each thread moves its group's
//     g, err and err' (grad_compress) or its m means (the mean) in
//     16-byte vector accesses (the widest that divides the group:
//     one uint4 of bf16 g and two float4 of err at m = 8), with all of
//     its U groups' loads issued before the first store.  The compact
//     payload, n bf16 values and n index bytes per group, is staged in
//     shared memory and moved between the tile's contiguous payload
//     range and shared memory in 16-byte stores (loads, for the mean:
//     every pod's range of the tile, then one barrier), byte by byte
//     where that range is not 16-byte aligned.  The wrapper takes it
//     when every row pointer and row stride of g, err and err' (the
//     mean's output) is aligned to the vector width.
//   * scalar: one thread per group, m scalar loads and stores; any
//     alignment (m = 2 or 4 at odd offsets, ragged rows).
//
// Bitwise contract (the plain versions in kernels/ref.py): every sum,
// difference and product is an _rn intrinsic, which nvcc never
// contracts, so t - f32(bf16(t)) is the exact bf16 rounding error and
// decode(vals, idx) + err' == f32(g) + err holds bit for bit; err may be
// err_out (in place): a thread reads its groups' residual before it
// writes them, and no other thread touches them (so neither pointer is
// __restrict__).  A -0 survivor stays -0 in vals and gives err' = +0, as
// the reference's jnp path (kernels/ops._jnp_grad_compress) computes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "select_topn.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename E>
__device__ __forceinline__ E narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// W elements of E moved as one vector access of sizeof(E) * W <= 16 bytes.
template <typename E, int W>
struct alignas(sizeof(E) * W) Pack {
  E v[W];
};

// Elements per vector access of an m-group of E: the whole group up to
// 16 bytes.  The group's address must be aligned to that many elements.
template <typename E, int M>
__host__ __device__ constexpr int pack_elems() {
  return M * static_cast<int>(sizeof(E)) <= 16
             ? M
             : 16 / static_cast<int>(sizeof(E));
}

template <int M, typename E>
__device__ __forceinline__ void load_group(const E* p, float (&x)[M]) {
  constexpr int W = pack_elems<E, M>();
  const auto* src = reinterpret_cast<const Pack<E, W>*>(p);
#pragma unroll
  for (int c = 0; c < M / W; ++c) {
    const Pack<E, W> v = src[c];
#pragma unroll
    for (int j = 0; j < W; ++j) x[c * W + j] = widen(v.v[j]);
  }
}

template <int M, typename E>
__device__ __forceinline__ void store_group(E* p, const float (&x)[M]) {
  constexpr int W = pack_elems<E, M>();
  auto* dst = reinterpret_cast<Pack<E, W>*>(p);
#pragma unroll
  for (int c = 0; c < M / W; ++c) {
    Pack<E, W> v;
#pragma unroll
    for (int j = 0; j < W; ++j) v.v[j] = narrow<E>(x[c * W + j]);
    dst[c] = v;
  }
}

// The block copies nbytes between device and shared memory: 16-byte
// moves where both ends are 16-byte aligned, bytes otherwise.
__device__ __forceinline__ void block_copy(void* dst, const void* src,
                                           int nbytes) {
  auto* d = static_cast<uint8_t*>(dst);
  const auto* s = static_cast<const uint8_t*>(src);
  int head = 0;
  if (((reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(s)) &
       15) == 0) {
    const int nv = nbytes >> 4;
    for (int i = threadIdx.x; i < nv; i += blockDim.x)
      reinterpret_cast<uint4*>(d)[i] = reinterpret_cast<const uint4*>(s)[i];
    head = nv << 4;
  }
  for (int i = head + threadIdx.x; i < nbytes; i += blockDim.x) d[i] = s[i];
}

// Groups per thread per tile of the vector variants.
constexpr int kCompressUnroll = 2;
// The mean's payload stage: up to 48 KB, the most a block may take
// without opting in to more.
constexpr size_t kStageBytes = 48 * 1024;
template <int M>
__host__ __device__ constexpr int decompress_unroll() {
  return M <= 8 ? 4 : 2;
}

template <int M, typename G>
__global__ void __launch_bounds__(kThreads)
grad_compress_kernel(const G* __restrict__ g, int64_t ldg, const float* err,
                     int64_t lde, float* err_out, int64_t ldo,
                     __nv_bfloat16* __restrict__ vals,
                     uint8_t* __restrict__ idx, int64_t groups, int n) {
  const int64_t grp = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (grp >= groups) return;
  const int64_t row = blockIdx.y;
  const G* gr = g + row * ldg + grp * M;
  const float* er = err + row * lde + grp * M;
  float t[M];
#pragma unroll
  for (int j = 0; j < M; ++j) t[j] = __fadd_rn(widen(gr[j]), er[j]);
  const unsigned keep = select_topn<M>(t, n);
  float* eo = err_out + row * ldo + grp * M;
  int64_t out = (row * groups + grp) * n;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    if ((keep >> j) & 1u) {
      const __nv_bfloat16 sent = __float2bfloat16_rn(t[j]);
      vals[out] = sent;
      idx[out] = static_cast<uint8_t>(j);
      ++out;
      eo[j] = __fsub_rn(t[j], __bfloat162float(sent));
    } else {
      eo[j] = t[j];
    }
  }
}

template <int M, typename O>
__global__ void __launch_bounds__(kThreads)
grad_decompress_mean_kernel(const __nv_bfloat16* __restrict__ vals,
                            int64_t ldv, const uint8_t* __restrict__ idx,
                            int64_t ldi, O* __restrict__ out, int64_t groups,
                            int n, int pods, float inv_pods) {
  const int64_t grp = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (grp >= groups) return;
  float acc[M];
#pragma unroll
  for (int s = 0; s < M; ++s) acc[s] = 0.f;
  for (int p = 0; p < pods; ++p) {
    const __nv_bfloat16* v = vals + p * ldv + grp * n;
    const uint8_t* i = idx + p * ldi + grp * n;
    float dec[M];
#pragma unroll
    for (int s = 0; s < M; ++s) dec[s] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float x = __bfloat162float(v[j]);
      const unsigned at = i[j];
#pragma unroll
      for (int s = 0; s < M; ++s)
        if (at == static_cast<unsigned>(s)) dec[s] = __fadd_rn(dec[s], x);
    }
#pragma unroll
    for (int s = 0; s < M; ++s) acc[s] = __fadd_rn(acc[s], dec[s]);
  }
  O* o = out + grp * M;
#pragma unroll
  for (int s = 0; s < M; ++s) o[s] = narrow<O>(__fmul_rn(acc[s], inv_pods));
}

template <int M, typename G>
__global__ void __launch_bounds__(kThreads)
grad_compress_vec_kernel(const G* __restrict__ g, int64_t ldg,
                         const float* err, int64_t lde, float* err_out,
                         int64_t ldo, __nv_bfloat16* __restrict__ vals,
                         uint8_t* __restrict__ idx, int64_t groups, int n) {
  constexpr int U = kCompressUnroll;
  constexpr int T = kThreads * U;
  __shared__ __align__(16) __nv_bfloat16 sv[T * M];
  __shared__ __align__(16) uint8_t si[T * M];
  const int64_t row = blockIdx.y;
  const G* gr = g + row * ldg;
  const float* er = err + row * lde;
  float* eo = err_out + row * ldo;
  const int64_t tiles = (groups + T - 1) / T;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t g0 = tile * T;
    const int cnt = groups - g0 < T ? static_cast<int>(groups - g0) : T;
    float t[U][M];
#pragma unroll
    for (int u = 0; u < U; ++u) {   // every load before the first store
      const int loc = u * kThreads + threadIdx.x;
      if (loc < cnt) {
        const int64_t at = (g0 + loc) * M;
        float x[M], e[M];
        load_group<M>(gr + at, x);
        load_group<M>(er + at, e);
#pragma unroll
        for (int j = 0; j < M; ++j) t[u][j] = __fadd_rn(x[j], e[j]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int loc = u * kThreads + threadIdx.x;
      if (loc < cnt) {
        const unsigned keep = select_topn<M>(t[u], n);
        float e[M];
        int k = loc * n;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          if ((keep >> j) & 1u) {
            const __nv_bfloat16 sent = __float2bfloat16_rn(t[u][j]);
            sv[k] = sent;
            si[k] = static_cast<uint8_t>(j);
            ++k;
            e[j] = __fsub_rn(t[u][j], __bfloat162float(sent));
          } else {
            e[j] = t[u][j];
          }
        }
        store_group<M>(eo + (g0 + loc) * M, e);
      }
    }
    __syncthreads();
    const int64_t out = (row * groups + g0) * n;
    block_copy(vals + out, sv, cnt * n * 2);
    block_copy(idx + out, si, cnt * n);
    __syncthreads();   // the next tile overwrites sv and si
  }
}

// N > 0 fixes n at compile time (the decode loop unrolls), N = 0 reads
// it from `n_arg`.
template <int M, int N, typename O>
__global__ void __launch_bounds__(kThreads)
grad_decompress_mean_vec_kernel(const __nv_bfloat16* __restrict__ vals,
                                int64_t ldv, const uint8_t* __restrict__ idx,
                                int64_t ldi, O* __restrict__ out,
                                int64_t groups, int n_arg, int pods, int pass,
                                float inv_pods) {
  const int n = N > 0 ? N : n_arg;
  // Dynamic shared memory: `pass` pods' payload of one tile, their
  // vals (T * n bf16 each) and then their idx (T * n bytes each).
  extern __shared__ __align__(16) uint8_t stage[];
  constexpr int U = decompress_unroll<M>();
  constexpr int T = kThreads * U;
  auto* sv = reinterpret_cast<__nv_bfloat16*>(stage);
  uint8_t* si = stage + static_cast<size_t>(pass) * T * n * 2;
  const int64_t tiles = (groups + T - 1) / T;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t g0 = tile * T;
    const int cnt = groups - g0 < T ? static_cast<int>(groups - g0) : T;
    float acc[U][M];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int s = 0; s < M; ++s) acc[u][s] = 0.f;
    for (int p0 = 0; p0 < pods; p0 += pass) {
      const int np = pods - p0 < pass ? pods - p0 : pass;
      for (int q = 0; q < np; ++q) {   // every pod's loads, then one wait
        block_copy(sv + q * T * n, vals + (p0 + q) * ldv + g0 * n,
                   cnt * n * 2);
        block_copy(si + q * T * n, idx + (p0 + q) * ldi + g0 * n, cnt * n);
      }
      __syncthreads();
      for (int q = 0; q < np; ++q) {   // pods in order p = 0..P-1
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int loc = u * kThreads + threadIdx.x;
          if (loc < cnt) {
            float dec[M];
#pragma unroll
            for (int s = 0; s < M; ++s) dec[s] = 0.f;
            const int at0 = (q * T + loc) * n;
#pragma unroll
            for (int j = 0; j < n; ++j) {
              const float x = __bfloat162float(sv[at0 + j]);
              const unsigned at = si[at0 + j];
#pragma unroll
              for (int s = 0; s < M; ++s)
                if (at == static_cast<unsigned>(s))
                  dec[s] = __fadd_rn(dec[s], x);
            }
#pragma unroll
            for (int s = 0; s < M; ++s)
              acc[u][s] = __fadd_rn(acc[u][s], dec[s]);
          }
        }
      }
      __syncthreads();   // the next pass or tile overwrites the stage
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int loc = u * kThreads + threadIdx.x;
      if (loc < cnt) {
        float o[M];
#pragma unroll
        for (int s = 0; s < M; ++s) o[s] = __fmul_rn(acc[u][s], inv_pods);
        store_group<M>(out + (g0 + loc) * M, o);
      }
    }
  }
}

// Blocks of a persistent grid over `tiles` tiles of each of `rows` rows:
// as many as fit on the card at once (with `smem` bytes of dynamic
// shared memory each), at most one per tile.
template <typename Kernel>
dim3 persistent_grid(Kernel kernel, size_t smem, int64_t tiles, int rows) {
  static int sms = 0;   // read once: the cards of one host are alike
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm
                                                                   : 1);
  const int64_t x = std::max<int64_t>(
      1, std::min<int64_t>(tiles, resident / rows));
  return dim3(static_cast<unsigned>(x), static_cast<unsigned>(rows));
}

template <int M, typename G>
void compress_vec(cudaStream_t st, const G* g, int64_t ldg, const float* err,
                  int64_t lde, float* err_out, int64_t ldo,
                  __nv_bfloat16* vals, uint8_t* idx, int rows,
                  int64_t groups, int n) {
  constexpr int T = kThreads * kCompressUnroll;
  auto* kernel = grad_compress_vec_kernel<M, G>;
  const dim3 grid = persistent_grid(kernel, 0, (groups + T - 1) / T, rows);
  kernel<<<grid, kThreads, 0, st>>>(g, ldg, err, lde, err_out, ldo, vals, idx,
                                    groups, n);
}

template <int M, typename O>
void decompress_mean_vec(cudaStream_t st, const __nv_bfloat16* vals,
                         int64_t ldv, const uint8_t* idx, int64_t ldi, O* out,
                         int64_t groups, int n, int pods, float inv_pods) {
  constexpr int T = kThreads * decompress_unroll<M>();
  // as many pods per pass as fit in kStageBytes (at least one)
  const size_t per_pod = static_cast<size_t>(T) * n * 3;
  const int pass = static_cast<int>(std::max<size_t>(
      1, std::min<size_t>(pods, kStageBytes / per_pod)));
  // n = 2 (2:4, 2:8, the paper's patterns) unrolls its decode
  auto* kernel = n == 2 ? grad_decompress_mean_vec_kernel<M, 2, O>
                        : grad_decompress_mean_vec_kernel<M, 0, O>;
  const dim3 grid = persistent_grid(kernel, pass * per_pod,
                                    (groups + T - 1) / T, 1);
  kernel<<<grid, kThreads, pass * per_pod, st>>>(
      vals, ldv, idx, ldi, out, groups, n, pods, pass, inv_pods);
}

dim3 grid_of(int64_t groups, int rows) {
  return dim3(static_cast<unsigned>((groups + kThreads - 1) / kThreads),
              static_cast<unsigned>(rows));
}

template <int M, typename G>
void compress_as(int vec, cudaStream_t st, const G* g, int64_t ldg,
                 const float* err, int64_t lde, float* err_out, int64_t ldo,
                 __nv_bfloat16* vals, uint8_t* idx, int rows, int64_t groups,
                 int n) {
  if (vec)
    compress_vec<M, G>(st, g, ldg, err, lde, err_out, ldo, vals, idx, rows,
                       groups, n);
  else
    grad_compress_kernel<M, G><<<grid_of(groups, rows), kThreads, 0, st>>>(
        g, ldg, err, lde, err_out, ldo, vals, idx, groups, n);
}

template <int M>
void compress(int vec, cudaStream_t st, const void* g, int64_t ldg,
              int g_bf16, const float* err, int64_t lde, float* err_out,
              int64_t ldo, __nv_bfloat16* vals, uint8_t* idx, int rows,
              int64_t groups, int n) {
  if (g_bf16)
    compress_as<M>(vec, st, static_cast<const __nv_bfloat16*>(g), ldg, err,
                   lde, err_out, ldo, vals, idx, rows, groups, n);
  else
    compress_as<M>(vec, st, static_cast<const float*>(g), ldg, err, lde,
                   err_out, ldo, vals, idx, rows, groups, n);
}

template <int M, typename O>
void decompress_mean_as(int vec, cudaStream_t st, const __nv_bfloat16* vals,
                        int64_t ldv, const uint8_t* idx, int64_t ldi, O* out,
                        int64_t groups, int n, int pods, float inv_pods) {
  if (vec)
    decompress_mean_vec<M, O>(st, vals, ldv, idx, ldi, out, groups, n, pods,
                              inv_pods);
  else
    grad_decompress_mean_kernel<M, O><<<grid_of(groups, 1), kThreads, 0,
                                         st>>>(vals, ldv, idx, ldi, out,
                                               groups, n, pods, inv_pods);
}

template <int M>
void decompress_mean(int vec, cudaStream_t st, const __nv_bfloat16* vals,
                     int64_t ldv, const uint8_t* idx, int64_t ldi, void* out,
                     int out_bf16, int64_t groups, int n, int pods,
                     float inv_pods) {
  if (out_bf16)
    decompress_mean_as<M>(vec, st, vals, ldv, idx, ldi,
                          static_cast<__nv_bfloat16*>(out), groups, n, pods,
                          inv_pods);
  else
    decompress_mean_as<M>(vec, st, vals, ldv, idx, ldi,
                          static_cast<float*>(out), groups, n, pods,
                          inv_pods);
}

}  // namespace

// g (R, K) bf16 (g_bf16 = 1) or fp32, row stride ldg elements; err and
// err_out (R, K) fp32, row strides lde and ldo (err_out may be err);
// vals (R, K*n/m) bf16 and idx (R, K*n/m) uint8, contiguous.
// m in {2, 4, 8, 16}, 0 < n <= m, K % m == 0, 0 < R <= 65535.
// vec = 1 takes the vector variant: every row of g, err and err_out must
// start on a multiple of min(16, m * element size) bytes.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an m the kernel is not built for).
extern "C" int grad_compress_launch(const void* g, int64_t ldg, int g_bf16,
                                    const void* err, int64_t lde,
                                    void* err_out, int64_t ldo, void* vals,
                                    void* idx, int R, int64_t K, int n, int m,
                                    int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t groups = K / m;
  const auto* e = static_cast<const float*>(err);
  auto* eo = static_cast<float*>(err_out);
  auto* v = static_cast<__nv_bfloat16*>(vals);
  auto* i = static_cast<uint8_t*>(idx);
  switch (m) {
    case 2: compress<2>(vec, st, g, ldg, g_bf16, e, lde, eo, ldo, v, i, R,
                        groups, n); break;
    case 4: compress<4>(vec, st, g, ldg, g_bf16, e, lde, eo, ldo, v, i, R,
                        groups, n); break;
    case 8: compress<8>(vec, st, g, ldg, g_bf16, e, lde, eo, ldo, v, i, R,
                        groups, n); break;
    case 16: compress<16>(vec, st, g, ldg, g_bf16, e, lde, eo, ldo, v, i, R,
                          groups, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// vals (P, Kc) bf16 and idx (P, Kc) uint8 with row strides ldv and ldi;
// out (Kc*m/n,) bf16 (out_bf16 = 1) or fp32, contiguous.  inv_pods is
// float32(1/P).  m in {2, 4, 8, 16}, 0 < n <= m, Kc % n == 0, P > 0.
// vec = 1 takes the vector variant: out must start on a multiple of
// min(16, m * element size) bytes.
extern "C" int grad_decompress_mean_launch(const void* vals, int64_t ldv,
                                           const void* idx, int64_t ldi,
                                           void* out, int out_bf16, int P,
                                           int64_t Kc, int n, int m,
                                           float inv_pods, int vec,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t groups = Kc / n;
  const auto* v = static_cast<const __nv_bfloat16*>(vals);
  const auto* i = static_cast<const uint8_t*>(idx);
  switch (m) {
    case 2: decompress_mean<2>(vec, st, v, ldv, i, ldi, out, out_bf16,
                               groups, n, P, inv_pods); break;
    case 4: decompress_mean<4>(vec, st, v, ldv, i, ldi, out, out_bf16,
                               groups, n, P, inv_pods); break;
    case 8: decompress_mean<8>(vec, st, v, ldv, i, ldi, out, out_bf16,
                               groups, n, P, inv_pods); break;
    case 16: decompress_mean<16>(vec, st, v, ldv, i, ldi, out, out_bf16,
                                 groups, n, P, inv_pods); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
