// Fused WUVE + SORE pre-generation for Hopper (sm_90a).
//
// For a fp32 master weight w (K, F), its gradient g and momentum v, with
// the N:M groups along K (the contraction axis, axis 0):
//
//   mask  = the n survivors of |w| in each m-group (pre-update w)
//   g_eff = (g + wd*w) + lam*where(mask, 0, w)     SR-STE decay
//   v'    = mu*v + g_eff
//   w'    = w - lr*v'
//   vals, idx = the n survivors of |w'| per m-group, ascending offset:
//               vals (K*n/m, F) bf16, idx (K*n/m, F) uint8
//
// Replaces the TPU kernel src/repro/kernels/fused_update.py:
// _fused_update_kernel (fused_update_pallas), which works on a (TR, TK)
// tile of the transposed master with the groups along its last axis.
// Here the master stays in its stored (K, F) layout and the packed pair
// is written straight into the (Kc, F) layout nm_spmm reads, so no
// transposed copy of any operand exists.
//
// What bounds it: bytes.  Per element it reads w, g, v (12 B) and writes
// w', v' (8 B), n/m of a bf16 value and n/m of an index byte: 20.75 B at
// 2:8, against a few dozen flops.  Design: one thread owns one
// (m-group, column); it reads the m rows of its column, so a warp's
// loads and stores are 128-byte rows along F and the m loads of each of
// the three inputs are in flight together.  Both selections run in
// registers (select_topn.cuh).
//
// Bitwise contract: every product and sum is written with the _rn
// intrinsics, which nvcc never contracts into a fused multiply-add, so
// w', v', vals and idx equal the plain version (kernels/ref.py:
// ref_fused_update, one rounding per op in the order above) bit for bit.
// A contracted w - lr*v' or mu*v + g_eff moves w' or v' by an ulp and
// can flip a near-tie survivor in the next step.  The decay term is +0
// where the mask keeps a weight, as where(mask, 0, w) is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "select_topn.cuh"

namespace {

constexpr int kThreads = 256;     // columns per block
constexpr int kMaxGridY = 65535;  // groups beyond this loop in-block

template <int M>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const float* __restrict__ w, const float* __restrict__ g,
                    const float* __restrict__ v, float* __restrict__ w_out,
                    float* __restrict__ v_out,
                    __nv_bfloat16* __restrict__ vals,
                    uint8_t* __restrict__ idx, int groups, int F, int n,
                    float lr, float mu, float wd, float lam) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= F) return;
  for (int grp = blockIdx.y; grp < groups; grp += gridDim.y) {
    const size_t base = (size_t)grp * M * F + f;
    float wr[M], gr[M], vr[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      wr[j] = w[base + (size_t)j * F];
      gr[j] = g[base + (size_t)j * F];
      vr[j] = v[base + (size_t)j * F];
    }
    const unsigned keep = select_topn<M>(wr, n);
    float wn[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float decay = ((keep >> j) & 1u) ? 0.f : wr[j];
      const float g_eff = __fadd_rn(__fadd_rn(gr[j], __fmul_rn(wd, wr[j])),
                                    __fmul_rn(lam, decay));
      const float vn = __fadd_rn(__fmul_rn(mu, vr[j]), g_eff);
      wn[j] = __fsub_rn(wr[j], __fmul_rn(lr, vn));
      v_out[base + (size_t)j * F] = vn;
      w_out[base + (size_t)j * F] = wn[j];
    }
    const unsigned pick = select_topn<M>(wn, n);
    size_t out = (size_t)grp * n * F + f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if ((pick >> j) & 1u) {
        vals[out] = __float2bfloat16_rn(wn[j]);
        idx[out] = static_cast<uint8_t>(j);
        out += F;
      }
    }
  }
}

template <int M>
void launch(dim3 grid, cudaStream_t st, const float* w, const float* g,
            const float* v, float* w_out, float* v_out, __nv_bfloat16* vals,
            uint8_t* idx, int groups, int F, int n, float lr, float mu,
            float wd, float lam) {
  fused_update_kernel<M><<<grid, kThreads, 0, st>>>(
      w, g, v, w_out, v_out, vals, idx, groups, F, n, lr, mu, wd, lam);
}

}  // namespace

// w, g, v, w_out, v_out: (K, F) fp32; vals (K*n/m, F) bf16; idx
// (K*n/m, F) uint8; m in {2, 4, 8, 16}, 0 < n <= m, K % m == 0.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an m the kernel is not built for).
extern "C" int fused_update_launch(const void* w, const void* g,
                                   const void* v, void* w_out, void* v_out,
                                   void* vals, void* idx, int K, int F,
                                   int n, int m, float lr, float mu,
                                   float wd, float lam, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = K / m;
  const dim3 grid((F + kThreads - 1) / kThreads,
                  groups < kMaxGridY ? groups : kMaxGridY);
  const auto* wi = static_cast<const float*>(w);
  const auto* gi = static_cast<const float*>(g);
  const auto* vi = static_cast<const float*>(v);
  auto* wo = static_cast<float*>(w_out);
  auto* vo = static_cast<float*>(v_out);
  auto* pv = static_cast<__nv_bfloat16*>(vals);
  auto* pi = static_cast<uint8_t*>(idx);
  switch (m) {
    case 2: launch<2>(grid, st, wi, gi, vi, wo, vo, pv, pi, groups, F, n,
                      lr, mu, wd, lam); break;
    case 4: launch<4>(grid, st, wi, gi, vi, wo, vo, pv, pi, groups, F, n,
                      lr, mu, wd, lam); break;
    case 8: launch<8>(grid, st, wi, gi, vi, wo, vo, pv, pi, groups, F, n,
                      lr, mu, wd, lam); break;
    case 16: launch<16>(grid, st, wi, gi, vi, wo, vo, pv, pi, groups, F, n,
                        lr, mu, wd, lam); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
