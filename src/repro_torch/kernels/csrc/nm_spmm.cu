// Element-mode N:M sparse x dense matmul for Hopper (sm_90a).
//
//   out[b, f] = sum_k act[b, k] * W[k, f]   (fp32),
//   W = decompress(vals, idx): vals (Kc, F) bf16 holds the n survivors of
//   every m-group along K (Kc = K*n/m), idx their in-group offsets, either
//   one uint8 per value (Kc, F) or the u4 plane (ceil(Kc/2), F) with entry
//   kc in nibble (kc & 1) of byte idx[kc/2, f], low nibble first.
//
// Replaces the TPU kernel src/repro/kernels/nm_spmm.py:_spmm_kernel
// (nm_spmm_pallas), which decompresses a (TK, TF) tile in VMEM and feeds
// the MXU a dense tile product.
//
// What bounds it: bytes.  Serving decodes with B <= 32 rows, so the work
// is ~2*B*Kc*F operations on Kc*F*(2 + idx_bits/8) weight bytes, far
// below the ~295 op/byte at which the H100 stops being memory-bound.
// Design: a survivor-gather FMA, chosen over decompress-to-shared plus
// mma.sync because it reads only the compact bytes, does N/M of the
// dense MACs and builds no dense tile anywhere.  What it does about the
// bytes bound is keep enough loads in flight:
//   * a thread owns 8 adjacent output columns, so each compact row is one
//     16-byte load of vals and one 8-byte load of idx (for u4, one 8-byte
//     load serves two rows); consecutive lanes read consecutive bytes;
//   * rows are taken in pairs (the two nibbles of a u4 byte), four pairs
//     unrolled so their loads are in flight together;
//   * the block (4 warps, 256 columns) stages a chunk of the activation
//     panel act[b0:b0+BT, chunk of K] in shared memory as fp32, laid out
//     k-major so one 16-byte read gives 4 rows' activations at one k;
//     the 4 warps take 4 consecutive quarters of each chunk (in-block
//     split of K) and are summed through shared memory at the end;
//   * F/256 is only 4..48 blocks at the qwen3-8b shapes, so K is also
//     split across blockIdx.y (a plan that is a function of K, F and m
//     only, computed by the Python wrapper); each split writes fp32
//     partials and a second kernel sums them in split order.
// Determinism: no atomics.  Every (b, f) sums its survivors in ascending
// kc order within a warp's quarters, the warps in order 0..3, and the
// splits in order; none of these orders depends on B or on the other
// rows, so a row's result is bitwise the same in any batch and in every
// run (the serve engine's batched == solo invariant).  A product of two
// bf16 values is exact in fp32, so fused multiply-add changes nothing.
// An offset >= m selects no slot, as in the reference decompress: that
// value contributes nothing.  When F % 8 != 0 (or a pointer is not
// 16-byte aligned) the same kernel loads column by column.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;        // threads per block
constexpr int kCols = 8;                     // output columns per thread
constexpr int kBlockF = 32 * kCols;          // output columns per block

// Eight weights of compact row `row`, columns f0..f0+7.
template <bool VEC>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* vals,
                                          size_t row, int f0, int F,
                                          float w[kCols]) {
  if (VEC) {
    const uint4 u = *reinterpret_cast<const uint4*>(vals + row * F + f0);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      w[2 * i] = p.x;
      w[2 * i + 1] = p.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      w[c] = f0 + c < F ? __bfloat162float(vals[row * F + f0 + c]) : 0.f;
  }
}

// Eight index bytes of plane row `row`, columns f0..f0+7.
template <bool VEC>
__device__ __forceinline__ void load_idx(const uint8_t* idx, size_t row,
                                         int f0, int F, uint8_t v[kCols]) {
  if (VEC) {
    const uint2 u = *reinterpret_cast<const uint2*>(idx + row * F + f0);
    const uint8_t* p = reinterpret_cast<const uint8_t*>(&u);
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[c] = p[c];
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      v[c] = f0 + c < F ? idx[row * F + f0 + c] : 0;
  }
}

// acc[b][c] += act_s[base + off[c]][b] * w[c] for the BT rows.
template <int BT>
__device__ __forceinline__ void fma_row(const float* act_s, int base,
                                        const int off[kCols],
                                        const float w[kCols],
                                        float acc[BT][kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const float4* a = reinterpret_cast<const float4*>(
        act_s + (base + off[c]) * BT);
#pragma unroll
    for (int q = 0; q < BT / 4; ++q) {
      const float4 v = a[q];
      acc[4 * q + 0][c] = fmaf(v.x, w[c], acc[4 * q + 0][c]);
      acc[4 * q + 1][c] = fmaf(v.y, w[c], acc[4 * q + 1][c]);
      acc[4 * q + 2][c] = fmaf(v.z, w[c], acc[4 * q + 2][c]);
      acc[4 * q + 3][c] = fmaf(v.w, w[c], acc[4 * q + 3][c]);
    }
  }
}

// Grid (ceil(F/256), splits, ceil(B/BT)).  `quarter` is the even number of
// m-groups a warp takes from each staged chunk of 4*quarter groups; a
// split covers `chunks_per_split` chunks.
template <int BT, int IDX_BITS, bool VEC>
__global__ void __launch_bounds__(kThreads)
nm_spmm_partial(const __nv_bfloat16* __restrict__ act,
                const __nv_bfloat16* __restrict__ vals,
                const uint8_t* __restrict__ idx,
                float* __restrict__ out,
                int B, int K, int F, int Kc, int n, int m,
                int quarter, int chunks_per_split) {
  extern __shared__ __align__(16) float smem[];   // act_s [chunk_k][BT]
  const int chunk_groups = kWarps * quarter;
  const int chunk_k = chunk_groups * m;
  const int G = Kc / n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b0 = blockIdx.z * BT;
  const int nb = min(BT, B - b0);
  const int split = blockIdx.y;
  const int f0 = blockIdx.x * kBlockF + lane * kCols;

  float acc[BT][kCols];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;

  const int g_lo = split * chunks_per_split * chunk_groups;
  const int g_hi = min(G, g_lo + chunks_per_split * chunk_groups);

  for (int g0 = g_lo; g0 < g_hi; g0 += chunk_groups) {
    const int g1 = min(g_hi, g0 + chunk_groups);
    const int kk = (g1 - g0) * m;            // dense K columns of this chunk
    __syncthreads();                         // last chunk's reads are done
    for (int e = threadIdx.x; e < BT * chunk_k; e += kThreads) {
      const int b = e / chunk_k;
      const int k = e - b * chunk_k;
      float a = 0.f;
      if (b < nb && k < kk)
        a = __bfloat162float(act[(size_t)(b0 + b) * K + (size_t)g0 * m + k]);
      smem[k * BT + b] = a;
    }
    __syncthreads();
    if (f0 >= F) continue;                   // idle lane past the last column

    const int sg0 = min(g1, g0 + warp * quarter);
    const int sg1 = min(g1, sg0 + quarter);
    const int kc_end = sg1 * n;
    int base = (sg0 - g0) * m;               // act_s row of group kc/n
    int slot = 0;                            // kc % n
#pragma unroll 4
    for (int kc = sg0 * n; kc < kc_end; kc += 2) {
      const bool has_b = kc + 1 < kc_end;
      int base_b = base, slot_b = slot + 1;
      if (slot_b == n) {
        slot_b = 0;
        base_b += m;
      }
      float wa[kCols], wb[kCols];
      int oa[kCols], ob[kCols];
      load_vals<VEC>(vals, kc, f0, F, wa);
      if (has_b) {
        load_vals<VEC>(vals, kc + 1, f0, F, wb);
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) wb[c] = 0.f;
      }
      uint8_t ia[kCols], ib[kCols];
      if (IDX_BITS == 4) {
        load_idx<VEC>(idx, kc >> 1, f0, F, ia);   // kc is even: low nibble
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          ib[c] = ia[c] >> 4;
          ia[c] &= 0xF;
        }
      } else {
        load_idx<VEC>(idx, kc, f0, F, ia);
        if (has_b) {
          load_idx<VEC>(idx, kc + 1, f0, F, ib);
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) ib[c] = 0;
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        oa[c] = ia[c];
        ob[c] = ib[c];
        if (oa[c] >= m) {
          oa[c] = 0;
          wa[c] = 0.f;
        }
        if (ob[c] >= m) {
          ob[c] = 0;
          wb[c] = 0.f;
        }
      }
      fma_row<BT>(smem, base, oa, wa, acc);
      if (has_b) fma_row<BT>(smem, base_b, ob, wb, acc);
      base = base_b;
      slot = slot_b + 1;
      if (slot == n) {
        slot = 0;
        base += m;
      }
    }
  }

  // Sum the 4 warps' partial sums in warp order through shared memory
  // (reusing the activation buffer), then warp 0 writes.
  __syncthreads();
  float* red = smem;                         // [kWarps-1][BT][kBlockF]
  if (warp > 0) {
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        red[((warp - 1) * BT + b) * kBlockF + lane * kCols + c] = acc[b][c];
  }
  __syncthreads();
  if (warp != 0 || f0 >= F) return;
  float* dst = out + (size_t)split * B * F;
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (b >= nb) break;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float s = acc[b][c];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        s += red[((w - 1) * BT + b) * kBlockF + lane * kCols + c];
      if (f0 + c < F) dst[(size_t)(b0 + b) * F + f0 + c] = s;
    }
  }
}

// out[i] = ((part[0][i] + part[1][i]) + ...) in split order.
__global__ void nm_spmm_reduce(const float* __restrict__ part,
                               float* __restrict__ out, int splits,
                               size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = part[i];
  for (int k = 1; k < splits; ++k) s += part[(size_t)k * count + i];
  out[i] = s;
}

template <int BT, int IDX_BITS>
void launch_partial(bool vec, dim3 grid, size_t smem, cudaStream_t stream,
                    const __nv_bfloat16* act, const __nv_bfloat16* vals,
                    const uint8_t* idx, float* dst, int B, int K, int F,
                    int Kc, int n, int m, int quarter,
                    int chunks_per_split) {
  if (vec)
    nm_spmm_partial<BT, IDX_BITS, true><<<grid, kThreads, smem, stream>>>(
        act, vals, idx, dst, B, K, F, Kc, n, m, quarter, chunks_per_split);
  else
    nm_spmm_partial<BT, IDX_BITS, false><<<grid, kThreads, smem, stream>>>(
        act, vals, idx, dst, B, K, F, Kc, n, m, quarter, chunks_per_split);
}

}  // namespace

// Launches the partial kernel (and, with splits > 1, the split reduce) on
// `stream`.  `part` is scratch of splits*B*F floats, unused when
// splits == 1.  Returns cudaGetLastError() after the launches.
extern "C" int nm_spmm_launch(const void* act, const void* vals,
                              const void* idx, void* out, void* part, int B,
                              int K, int F, int Kc, int n, int m,
                              int idx_bits, int quarter,
                              int chunks_per_split, int splits,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bt = B <= 4 ? 4 : 8;
  const dim3 grid((F + kBlockF - 1) / kBlockF, splits, (B + bt - 1) / bt);
  // the staged activation chunk, or the warp-reduction buffer if larger
  // (at most 32 KB for chunks of <= 1024 dense columns)
  const size_t panel = (size_t)bt * kWarps * quarter * m;
  const size_t red = (size_t)(kWarps - 1) * bt * kBlockF;
  const size_t smem = (panel > red ? panel : red) * sizeof(float);
  const bool vec = F % kCols == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(idx) % 8 == 0;
  float* dst = static_cast<float*>(splits == 1 ? out : part);
  const auto* a = static_cast<const __nv_bfloat16*>(act);
  const auto* v = static_cast<const __nv_bfloat16*>(vals);
  const auto* ix = static_cast<const uint8_t*>(idx);
  if (bt == 4 && idx_bits == 4)
    launch_partial<4, 4>(vec, grid, smem, st, a, v, ix, dst, B, K, F, Kc, n,
                         m, quarter, chunks_per_split);
  else if (bt == 4)
    launch_partial<4, 8>(vec, grid, smem, st, a, v, ix, dst, B, K, F, Kc, n,
                         m, quarter, chunks_per_split);
  else if (idx_bits == 4)
    launch_partial<8, 4>(vec, grid, smem, st, a, v, ix, dst, B, K, F, Kc, n,
                         m, quarter, chunks_per_split);
  else
    launch_partial<8, 8>(vec, grid, smem, st, a, v, ix, dst, B, K, F, Kc, n,
                         m, quarter, chunks_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t count = (size_t)B * F;
  const int threads = 256;
  nm_spmm_reduce<<<(unsigned)((count + threads - 1) / threads), threads, 0,
                   st>>>(static_cast<const float*>(part),
                         static_cast<float*>(out), splits, count);
  return static_cast<int>(cudaGetLastError());
}
