// Shared-pattern N:M reduced-K matmul for Hopper (sm_90a).
//
//   out[b, j*TF + f] = sum_c act[b, rows[j, c]] * W_j[c, f]   (fp32)
//
// act (B, K) bf16 or fp32; vals (nf, Kc, TF) bf16 or fp32, one (Kc, TF)
// slab W_j per output tile j, cast to act's dtype before the product (as
// the reference casts it); rows (nf, Kc) int32, the absolute K row of
// each packed slot.  Serving's SharedOp is one tile (nf = 1, TF = F);
// ops.pack_shared's layout has TF = 128.
//
// Replaces the TPU kernel src/repro/kernels/nm_spmm_shared.py:
// _spmm_shared_kernel (nm_spmm_shared_pallas), which holds a (TB, K)
// activation panel in VMEM, gathers its Kc survivor columns with one
// jnp.take and feeds the MXU a (TB, Kc) x (Kc, TF) product.
//
// What bounds it: bytes.  Decode runs B = 4 rows: 2*B*Kc*F operations on
// Kc*F*2 weight bytes, far below the ~295 op/byte where the H100 stops
// being memory-bound; prefill (B ~ 128) is still below it.  Design: the
// pattern is shared by every column of a tile, so the gather is of
// activations only, done once per block into shared memory, and the
// weights stream as dense rows:
//   * a block (4 warps) covers 256 output columns of one tile; a thread
//     owns 8 adjacent columns, so a compact row is one 16-byte load of
//     bf16 vals, consecutive lanes on consecutive bytes;
//   * the block stages the gathered activation panel act[b0:b0+BT,
//     rows[j, chunk]] as fp32, laid out c-major, so one 16-byte shared
//     read (a broadcast: every lane reads the same address) gives 4 rows'
//     activations of one compact row; the 4 warps take 4 consecutive
//     quarters of each chunk and are summed through shared memory at the
//     end;
//   * F/256 is only 4..48 blocks at the qwen3-8b shapes, so Kc is also
//     split across blockIdx.y by a plan that is a function of Kc, TF and
//     nf only (the Python wrapper's split_plan); each split writes fp32
//     partials and a second kernel sums them in split order.
// Determinism: no atomics.  Every (b, column) sums its rows in ascending
// c within a warp's quarters, the warps in order 0..3 and the splits in
// order; none of these orders depends on B or on the other rows, so a
// row's result is bitwise the same in any batch and in every run (the
// serve engine's batched == solo invariant).  With bf16 activations the
// products are exact in fp32, so fused multiply-add changes nothing.
// A row index outside [0, K) reads activation 0.  When TF % 8 != 0 (or
// vals is not 16-byte aligned) the same kernel loads column by column.
// No library product: no cuBLAS, no tensor-core call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;        // threads per block
constexpr int kCols = 8;                     // output columns per thread
constexpr int kBlockF = 32 * kCols;          // output columns per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A weight in act's precision, as float: a fp32 weight meets bf16
// activations rounded to bf16 (round to nearest even), else exact.
template <typename A>
__device__ __forceinline__ float as_act(float w) { return w; }
template <>
__device__ __forceinline__ float as_act<__nv_bfloat16>(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// Eight weights of one compact row, columns f0..f0+7.
template <typename A, typename V, bool VEC>
__device__ __forceinline__ void load_row(const V* row, int f0, int TF,
                                         float w[kCols]) {
  if (VEC) {
    if constexpr (sizeof(V) == 2) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + f0);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < kCols / 2; ++i) {
        const float2 p = __bfloat1622float2(h[i]);
        w[2 * i] = p.x;
        w[2 * i + 1] = p.y;
      }
    } else {
      const float4* p = reinterpret_cast<const float4*>(row + f0);
      const float4 a = p[0], b = p[1];
      w[0] = as_act<A>(a.x); w[1] = as_act<A>(a.y);
      w[2] = as_act<A>(a.z); w[3] = as_act<A>(a.w);
      w[4] = as_act<A>(b.x); w[5] = as_act<A>(b.y);
      w[6] = as_act<A>(b.z); w[7] = as_act<A>(b.w);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      w[c] = f0 + c < TF ? as_act<A>(to_f32(row[f0 + c])) : 0.f;
  }
}

// Grid (ceil(TF/256), splits, nf * ceil(B/BT)).  `quarter` is the number
// of compact rows a warp takes from each staged chunk of 4*quarter rows;
// a split covers `chunks_per_split` chunks.
template <int BT, typename A, typename V, bool VEC>
__global__ void __launch_bounds__(kThreads)
shared_partial(const A* __restrict__ act, const V* __restrict__ vals,
               const int* __restrict__ rows, float* __restrict__ out,
               int B, int K, int Kc, int TF, int nf, int quarter,
               int chunks_per_split) {
  extern __shared__ __align__(16) float smem[];   // act_s [chunk][BT]
  const int chunk = kWarps * quarter;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nbt = (B + BT - 1) / BT;
  const int tile = blockIdx.z / nbt;
  const int b0 = (blockIdx.z - tile * nbt) * BT;
  const int nb = min(BT, B - b0);
  const int split = blockIdx.y;
  const int f0 = blockIdx.x * kBlockF + lane * kCols;
  const int* rows_j = rows + (size_t)tile * Kc;
  const V* vals_j = vals + (size_t)tile * Kc * TF;

  float acc[BT][kCols];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;

  const int c_lo = split * chunks_per_split * chunk;
  const int c_hi = min(Kc, c_lo + chunks_per_split * chunk);
  for (int c0 = c_lo; c0 < c_hi; c0 += chunk) {
    const int cc = min(chunk, c_hi - c0);    // compact rows of this chunk
    __syncthreads();                         // last chunk's reads are done
    for (int e = threadIdx.x; e < BT * chunk; e += kThreads) {
      const int b = e / chunk;
      const int c = e - b * chunk;
      float a = 0.f;
      if (b < nb && c < cc) {
        const int k = rows_j[c0 + c];
        if (k >= 0 && k < K) a = to_f32(act[(size_t)(b0 + b) * K + k]);
      }
      smem[c * BT + b] = a;
    }
    __syncthreads();
    if (f0 >= TF) continue;                  // idle lane past the last column

    const int q0 = min(cc, warp * quarter);
    const int q1 = min(cc, q0 + quarter);
#pragma unroll 4
    for (int c = q0; c < q1; ++c) {
      float w[kCols];
      load_row<A, V, VEC>(vals_j + (size_t)(c0 + c) * TF, f0, TF, w);
      const float4* a = reinterpret_cast<const float4*>(smem + c * BT);
#pragma unroll
      for (int q = 0; q < BT / 4; ++q) {
        const float4 v = a[q];
#pragma unroll
        for (int col = 0; col < kCols; ++col) {
          acc[4 * q + 0][col] = fmaf(v.x, w[col], acc[4 * q + 0][col]);
          acc[4 * q + 1][col] = fmaf(v.y, w[col], acc[4 * q + 1][col]);
          acc[4 * q + 2][col] = fmaf(v.z, w[col], acc[4 * q + 2][col]);
          acc[4 * q + 3][col] = fmaf(v.w, w[col], acc[4 * q + 3][col]);
        }
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
  if (warp != 0 || f0 >= TF) return;
  const size_t width = (size_t)nf * TF;
  float* dst = out + (size_t)split * B * width + (size_t)tile * TF;
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (b >= nb) break;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float s = acc[b][c];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        s += red[((w - 1) * BT + b) * kBlockF + lane * kCols + c];
      if (f0 + c < TF) dst[(size_t)(b0 + b) * width + f0 + c] = s;
    }
  }
}

// out[i] = ((part[0][i] + part[1][i]) + ...) in split order.
__global__ void shared_reduce(const float* __restrict__ part,
                              float* __restrict__ out, int splits,
                              size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = part[i];
  for (int k = 1; k < splits; ++k) s += part[(size_t)k * count + i];
  out[i] = s;
}

template <int BT, typename A, typename V>
void launch_partial(bool vec, dim3 grid, size_t smem, cudaStream_t st,
                    const void* act, const void* vals, const int* rows,
                    float* dst, int B, int K, int Kc, int TF, int nf,
                    int quarter, int chunks_per_split) {
  const auto* a = static_cast<const A*>(act);
  const auto* v = static_cast<const V*>(vals);
  if (vec)
    shared_partial<BT, A, V, true><<<grid, kThreads, smem, st>>>(
        a, v, rows, dst, B, K, Kc, TF, nf, quarter, chunks_per_split);
  else
    shared_partial<BT, A, V, false><<<grid, kThreads, smem, st>>>(
        a, v, rows, dst, B, K, Kc, TF, nf, quarter, chunks_per_split);
}

template <int BT>
void launch_bt(int act_bf16, int vals_bf16, bool vec, dim3 grid, size_t smem,
               cudaStream_t st, const void* act, const void* vals,
               const int* rows, float* dst, int B, int K, int Kc, int TF,
               int nf, int quarter, int chunks_per_split) {
  if (act_bf16 && vals_bf16)
    launch_partial<BT, __nv_bfloat16, __nv_bfloat16>(
        vec, grid, smem, st, act, vals, rows, dst, B, K, Kc, TF, nf, quarter,
        chunks_per_split);
  else if (act_bf16)
    launch_partial<BT, __nv_bfloat16, float>(
        vec, grid, smem, st, act, vals, rows, dst, B, K, Kc, TF, nf, quarter,
        chunks_per_split);
  else if (vals_bf16)
    launch_partial<BT, float, __nv_bfloat16>(
        vec, grid, smem, st, act, vals, rows, dst, B, K, Kc, TF, nf, quarter,
        chunks_per_split);
  else
    launch_partial<BT, float, float>(
        vec, grid, smem, st, act, vals, rows, dst, B, K, Kc, TF, nf, quarter,
        chunks_per_split);
}

}  // namespace

// act (B, K) contiguous, bf16 (act_bf16 = 1) or fp32; vals (nf, Kc, TF)
// contiguous, bf16 (vals_bf16 = 1) or fp32; rows (nf, Kc) int32; out
// (B, nf*TF) fp32.  Launches the partial kernel (and, with splits > 1,
// the split reduce) on `stream`; `part` is scratch of splits*B*nf*TF
// floats, unused when splits == 1.  Returns cudaGetLastError() after the
// launches.
extern "C" int nm_spmm_shared_launch(const void* act, int act_bf16,
                                     const void* vals, int vals_bf16,
                                     const void* rows, void* out, void* part,
                                     int B, int K, int Kc, int TF, int nf,
                                     int quarter, int chunks_per_split,
                                     int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bt = B <= 4 ? 4 : 8;
  const dim3 grid((TF + kBlockF - 1) / kBlockF, splits,
                  nf * ((B + bt - 1) / bt));
  // the staged activation chunk, or the warp-reduction buffer if larger
  const size_t panel = (size_t)bt * kWarps * quarter;
  const size_t red = (size_t)(kWarps - 1) * bt * kBlockF;
  const size_t smem = (panel > red ? panel : red) * sizeof(float);
  const bool vec = TF % kCols == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  float* dst = static_cast<float*>(splits == 1 ? out : part);
  const auto* r = static_cast<const int*>(rows);
  if (bt == 4)
    launch_bt<4>(act_bf16, vals_bf16, vec, grid, smem, st, act, vals, r, dst,
                 B, K, Kc, TF, nf, quarter, chunks_per_split);
  else
    launch_bt<8>(act_bf16, vals_bf16, vec, grid, smem, st, act, vals, r, dst,
                 B, K, Kc, TF, nf, quarter, chunks_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t count = (size_t)B * nf * TF;
  const int threads = 256;
  shared_reduce<<<(unsigned)((count + threads - 1) / threads), threads, 0,
                  st>>>(static_cast<const float*>(part),
                        static_cast<float*>(out), splits, count);
  return static_cast<int>(cudaGetLastError());
}
