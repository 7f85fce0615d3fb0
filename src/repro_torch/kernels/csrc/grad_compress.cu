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
// blocks into VMEM; here one thread owns one m-group of one row, reads
// its m inputs, selects in registers and writes its outputs, so no
// dense intermediate exists in either kernel and no thread reads what
// another writes.  Rows may be strided (a leaf's (P, numel) view cut to
// a bucket's columns, a column range of the (P, T) residual): each row
// has its own leading dimension, so the sync passes views, not copies.
//
// What bounds them: bytes.  grad_compress reads g (2 or 4 B) and err
// (4 B) and writes err' (4 B) and n/m of a bf16 value and an index
// byte: 10.75 B per element at 2:8 with a bf16 gradient.
// grad_decompress_mean reads P*(n/m)*3 B and writes 4 B (fp32) or 2 B
// (bf16) per output element.  Both do a few dozen operations per
// element.
//
// Bitwise contract (the plain versions in kernels/ref.py): every sum,
// difference and product is an _rn intrinsic, which nvcc never
// contracts, so t - f32(bf16(t)) is the exact bf16 rounding error and
// decode(vals, idx) + err' == f32(g) + err holds bit for bit; err may be
// err_out (in place): a thread reads its group's residual before it
// writes it.  A -0 survivor stays -0 in vals and gives err' = +0, as the
// reference's jnp path (kernels/ops._jnp_grad_compress) computes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "select_topn.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
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
  for (int s = 0; s < M; ++s) store(o + s, __fmul_rn(acc[s], inv_pods));
}

template <int M>
void compress(dim3 grid, cudaStream_t st, const void* g, int64_t ldg,
              int g_bf16, const float* err, int64_t lde, float* err_out,
              int64_t ldo, __nv_bfloat16* vals, uint8_t* idx, int64_t groups,
              int n) {
  if (g_bf16)
    grad_compress_kernel<M, __nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), ldg, err, lde, err_out, ldo,
        vals, idx, groups, n);
  else
    grad_compress_kernel<M, float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(g), ldg, err, lde, err_out, ldo, vals, idx,
        groups, n);
}

template <int M>
void decompress_mean(dim3 grid, cudaStream_t st, const __nv_bfloat16* vals,
                     int64_t ldv, const uint8_t* idx, int64_t ldi, void* out,
                     int out_bf16, int64_t groups, int n, int pods,
                     float inv_pods) {
  if (out_bf16)
    grad_decompress_mean_kernel<M, __nv_bfloat16><<<grid, kThreads, 0, st>>>(
        vals, ldv, idx, ldi, static_cast<__nv_bfloat16*>(out), groups, n,
        pods, inv_pods);
  else
    grad_decompress_mean_kernel<M, float><<<grid, kThreads, 0, st>>>(
        vals, ldv, idx, ldi, static_cast<float*>(out), groups, n, pods,
        inv_pods);
}

dim3 grid_of(int64_t groups, int rows) {
  return dim3(static_cast<unsigned>((groups + kThreads - 1) / kThreads),
              static_cast<unsigned>(rows));
}

}  // namespace

// g (R, K) bf16 (g_bf16 = 1) or fp32, row stride ldg elements; err and
// err_out (R, K) fp32, row strides lde and ldo (err_out may be err);
// vals (R, K*n/m) bf16 and idx (R, K*n/m) uint8, contiguous.
// m in {2, 4, 8, 16}, 0 < n <= m, K % m == 0, 0 < R <= 65535.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an m the kernel is not built for).
extern "C" int grad_compress_launch(const void* g, int64_t ldg, int g_bf16,
                                    const void* err, int64_t lde,
                                    void* err_out, int64_t ldo, void* vals,
                                    void* idx, int R, int64_t K, int n, int m,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t groups = K / m;
  const dim3 grid = grid_of(groups, R);
  const auto* e = static_cast<const float*>(err);
  auto* eo = static_cast<float*>(err_out);
  auto* v = static_cast<__nv_bfloat16*>(vals);
  auto* i = static_cast<uint8_t*>(idx);
  switch (m) {
    case 2: compress<2>(grid, st, g, ldg, g_bf16, e, lde, eo, ldo, v, i,
                        groups, n); break;
    case 4: compress<4>(grid, st, g, ldg, g_bf16, e, lde, eo, ldo, v, i,
                        groups, n); break;
    case 8: compress<8>(grid, st, g, ldg, g_bf16, e, lde, eo, ldo, v, i,
                        groups, n); break;
    case 16: compress<16>(grid, st, g, ldg, g_bf16, e, lde, eo, ldo, v, i,
                          groups, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// vals (P, Kc) bf16 and idx (P, Kc) uint8 with row strides ldv and ldi;
// out (Kc*m/n,) bf16 (out_bf16 = 1) or fp32, contiguous.  inv_pods is
// float32(1/P).  m in {2, 4, 8, 16}, 0 < n <= m, Kc % n == 0, P > 0.
extern "C" int grad_decompress_mean_launch(const void* vals, int64_t ldv,
                                           const void* idx, int64_t ldi,
                                           void* out, int out_bf16, int P,
                                           int64_t Kc, int n, int m,
                                           float inv_pods, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t groups = Kc / n;
  const dim3 grid = grid_of(groups, 1);
  const auto* v = static_cast<const __nv_bfloat16*>(vals);
  const auto* i = static_cast<const uint8_t*>(idx);
  switch (m) {
    case 2: decompress_mean<2>(grid, st, v, ldv, i, ldi, out, out_bf16,
                               groups, n, P, inv_pods); break;
    case 4: decompress_mean<4>(grid, st, v, ldv, i, ldi, out, out_bf16,
                               groups, n, P, inv_pods); break;
    case 8: decompress_mean<8>(grid, st, v, ldv, i, ldi, out, out_bf16,
                               groups, n, P, inv_pods); break;
    case 16: decompress_mean<16>(grid, st, v, ldv, i, ldi, out, out_bf16,
                                 groups, n, P, inv_pods); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
