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
// bf16 act and vals (every serving path): tensor cores.  Once gathered
// this is a plain dense GEMM, computed as out^T = W_j^T . act_g^T
// (nm_mma.cuh: the weight is the wgmma A operand, the batch rows are N):
//   * nm_spmm_shared_gather, a pass of its own, writes act_g[j][b][c] =
//     act[b, rows[j, c]] (0 for a row outside [0, K)) into scratch with
//     a row pitch of Kc rounded up to 8, zeros past Kc; it moves
//     B*nf*Kc*2 bytes, small beside the weights;
//   * nm_spmm_shared_mma, warp-specialised as nm_spmm's kernel: a block
//     owns BM columns of one tile and N rows; producer warps keep a TMA
//     ring of stages (the vals rows [tk][BM], and the gathered panel
//     straight into the swizzled K-major layout of nm_mma.cuh, the wgmma
//     B operand) and transpose each landed vals stage into an A slot of
//     the same layout; consumer warpgroups run wgmma.mma_async on it
//     while the producers prepare the next.
// What bounds it: at decode (B = 4) bytes, Kc*TF*2 weight bytes for
// 2*B*Kc*TF operations; at prefill rows (B = 128) still the bytes of the
// weights (a quarter of the dense weight's at 2:8), 128 rows being below
// the ~295 operations per byte where the H100 turns compute-bound.
// Rows are bitwise independent of the batch (nm_mma.cuh): Kc is cut into
// chunks of compact rows, a function of Kc only; each chunk is one
// tensor-core accumulator chain from zero and the partials are folded in
// ascending order, in registers when a block owns all chunks or, when
// the grid is short (decode, some prefill projections), through
// per-chunk scratch [n_chunks][B][nf*TF] and nm_spmm_shared_fold.
//
// fp32 act or vals (ragged callers only, on no main path): another
// function (a TF32 tensor product would round the operands), so these
// keep the CUDA-core FMA path below (shared_partial): a block of 4 warps
// covers 256 columns of one tile, stages the gathered activation panel
// act[b0:b0+BT, rows[j, chunk]] in shared memory as fp32 and streams the
// weight rows with 16-byte loads; Kc is split across blockIdx.y by a plan
// of (Kc, TF, nf) only, each split writes fp32 partials and
// shared_reduce() sums them in split order.  Every (b, column) sums its
// rows in ascending c within a warp's quarter, the warps in order 0..3
// and the splits in order, so rows are batch-independent there too.
// A row index outside [0, K) reads activation 0 on both paths.
// No library product: no cuBLAS, no cuBLASLt, no CUTLASS GEMM.

#include <string.h>

#include "nm_mma.cuh"

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
  if (act_bf16)    // bf16 x bf16 takes the tensor-core path
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

// The CUDA-core path, for act or vals fp32 (not both bf16).
// act (B, K) contiguous, bf16 (act_bf16 = 1) or fp32; vals (nf, Kc, TF)
// contiguous, bf16 (vals_bf16 = 1) or fp32; rows (nf, Kc) int32; out
// (B, nf*TF) fp32.  Launches the partial kernel (and, with splits > 1,
// the split reduce) on `stream`; `part` is scratch of splits*B*nf*TF
// floats, unused when splits == 1.  Returns cudaGetLastError() after the
// launches.
extern "C" int nm_spmm_shared_fp32_launch(const void* act, int act_bf16,
                                          const void* vals, int vals_bf16,
                                          const void* rows, void* out,
                                          void* part, int B, int K, int Kc,
                                          int TF, int nf, int quarter,
                                          int chunks_per_split, int splits,
                                          void* stream) {
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

// ---------------------------------------------------------------------
// The tensor-core path (bf16 act and vals).

namespace {

using namespace nm_mma;
using bf16 = __nv_bfloat16;

// act_g[j][b][c] = act[b, rows[j, c]] (0 outside [0, K) and for c >= Kc);
// grid (ceil(kcp/256), B, nf), row pitch kcp.
__global__ void nm_spmm_shared_gather(const bf16* __restrict__ act,
                                      const int* __restrict__ rows,
                                      bf16* __restrict__ act_g, int B, int K,
                                      int Kc, int kcp) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y, j = blockIdx.z;
  if (c >= kcp) return;
  bf16 v = __float2bfloat16_rn(0.f);
  if (c < Kc) {
    const int k = rows[(size_t)j * Kc + c];
    if (k >= 0 && k < K) v = act[(size_t)b * K + k];
  }
  act_g[((size_t)j * B + b) * kcp + c] = v;
}

struct SharedParams {
  const bf16* vals;    // (nf, Kc, TF)
  float* out;          // (B, nf*TF), or scratch [n_chunks][B][nf*TF]
  int B, Kc, TF, nf, f_blocks;
  int tk, n_stages;    // compact rows a stage, stages
  int chunk_stages, chunks_per_split, split;
  int vals_tma;        // vals rows by TMA (else per-thread loads)
  uint32_t tx_bytes;   // TMA bytes per stage
};

constexpr int kSlots = 4;     // TMA ring
constexpr int kASlots = 3;    // transposed A tiles

__host__ __device__ constexpr int up1k(int x) {
  return (x + 1023) / 1024 * 1024;
}

// One stage: vals rows [tk][BM] as stored (columns contiguous), then the
// gathered panel in the swizzled K-major layout of nm_mma.cuh; after the
// stages, kASlots A tiles (the vals rows transposed, the same layout),
// then the mbarriers: full and empty per stage slot and per A slot.
// Offsets from a 1024-byte aligned base found within the first 1024.
struct SharedLayout {
  int v_bytes, b_bytes, stage_bytes, a_bytes, bar_off, total;
  __host__ __device__ SharedLayout(int BM, int N, int tk) {
    v_bytes = up1k(tk * BM * 2);
    b_bytes = up1k(N * tk * 2);
    stage_bytes = v_bytes + b_bytes;
    a_bytes = BM * tk * 2;
    bar_off = kSlots * stage_bytes + kASlots * a_bytes;
    total = bar_off + 2 * (kSlots + kASlots) * 8 + 1024;
  }
};

// A tile (swizzled K-major) from the stage's vals rows [tk][BM]: a
// transpose by the PT producer threads.
template <int BM, int PT>
__device__ __forceinline__ void shared_expand(const bf16* v_s, bf16* a_s,
                                              int tk, int pt) {
  const uint16_t* v = reinterpret_cast<const uint16_t*>(v_s);
#pragma unroll 4
  for (int e = pt; e < BM * (tk / 8); e += PT) {
    const int f = e % BM, kb = e / BM;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)v[(kb * 8 + 2 * i) * BM + f] |
             ((uint32_t)v[(kb * 8 + 2 * i + 1) * BM + f] << 16);
    *reinterpret_cast<uint4*>(reinterpret_cast<char*>(a_s) +
                              sw128(f, kb * 8, BM)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Grid (nf * f_blocks, ceil(B/N), splits).  Warp-specialised as nm_spmm's
// kernel: PWG producer warpgroups keep the TMA ring full and transpose
// each landed vals stage into an A slot; CWG consumer warpgroups run
// wgmma on their 64 columns of it against the gathered panel.
template <int PWG, int CWG, int N>
__global__ void __launch_bounds__(128 * (PWG + CWG), 1)
nm_spmm_shared_mma(const __grid_constant__ CUtensorMap map_act,
                   const __grid_constant__ CUtensorMap map_vals,
                   const SharedParams p) {
  constexpr int BM = 64 * CWG, PT = 128 * PWG, R = N / 2;
  extern __shared__ __align__(1024) char shm_raw[];
  char* shm = shm_raw + ((1024 - (smem_u32(shm_raw) & 1023)) & 1023);
  const SharedLayout L(BM, N, p.tk);
  char* a_base = shm + kSlots * L.stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(shm + L.bar_off);
  uint64_t* empty = full + kSlots;
  uint64_t* afull = empty + kSlots;
  uint64_t* aempty = afull + kASlots;
  const int tile = blockIdx.x / p.f_blocks;
  const int f0 = (blockIdx.x - tile * p.f_blocks) * BM, b0 = blockIdx.y * N;
  const bf16* vals_j = p.vals + (size_t)tile * p.Kc * p.TF;
  const size_t width = (size_t)p.nf * p.TF;
  const int c_lo = blockIdx.z * p.chunks_per_split;
  const int st_lo = c_lo * p.chunk_stages;
  const int nst = min(p.n_stages, (c_lo + p.chunks_per_split) *
                                      p.chunk_stages) - st_lo;
  auto slot = [&](int s) { return shm + (s % kSlots) * L.stage_bytes; };
  auto a_slot = [&](int s) { return a_base + (s % kASlots) * L.a_bytes; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CWG);
    }
    for (int i = 0; i < kASlots; ++i) {
      mbar_init(&afull[i], 1);
      mbar_init(&aempty[i], CWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < PT) {
    // ---- producer
    const int pt = threadIdx.x;
    auto tma = [&](int s) {                  // local stage s, by thread 0
      char* buf = slot(s);
      const int c0 = (st_lo + s) * p.tk;
      uint64_t* bar = &full[s % kSlots];
      mbar_expect(bar, p.tx_bytes);
      if (p.vals_tma) tma_3d(buf, &map_vals, bar, f0, c0, tile);
      for (int a = 0; a < p.tk / 64; ++a)
        tma_3d(buf + L.v_bytes + a * N * 128, &map_act, bar, c0 + 64 * a,
               b0, tile);
    };
    if (pt == 0)
      for (int s = 0; s < kSlots && s < nst; ++s) tma(s);
    for (int s = 0; s < nst; ++s) {
      char* buf = slot(s);
      if (!p.vals_tma) {                     // plain loads of the vals rows
        const int c0 = (st_lo + s) * p.tk;
        bf16* v_s = reinterpret_cast<bf16*>(buf);
        for (int e = pt; e < p.tk * BM; e += PT) {
          const int r = e / BM, c = e - r * BM;
          v_s[r * BM + c] = c0 + r < p.Kc && f0 + c < p.TF
                                ? vals_j[(size_t)(c0 + r) * p.TF + f0 + c]
                                : __float2bfloat16_rn(0.f);
        }
      }
      mbar_wait(&full[s % kSlots], (s / kSlots) & 1);
      if (!p.vals_tma) named_sync(1, PT);
      if (s >= kASlots)
        mbar_wait(&aempty[s % kASlots], ((s / kASlots) & 1) ^ 1);
      shared_expand<BM, PT>(reinterpret_cast<const bf16*>(buf),
                            reinterpret_cast<bf16*>(a_slot(s)), p.tk, pt);
      fence_async_smem();
      named_sync(1, PT);
      if (pt == 0) {
        mbar_arrive(&afull[s % kASlots]);
        const int t = s - 1 + kSlots;        // refill stage s-1's slot
        if (s >= 1 && t < nst) {
          mbar_wait(&empty[(s - 1) % kSlots], ((s - 1) / kSlots) & 1);
          tma(t);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c multiplies columns 64c.. of each A slot
    const int c = (threadIdx.x - PT) >> 7;
    const bool lead = ((threadIdx.x - PT) & 127) == 0;
    float acc[R], total[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = total[i] = 0.f;
    for (int s = 0; s < nst; ++s) {
      const int gst = st_lo + s;
      mbar_wait(&afull[s % kASlots], (s / kASlots) & 1);
      mbar_wait(&full[s % kSlots], (s / kSlots) & 1);
      const char* a_s = a_slot(s) + c * 64 * 128;
      const char* b_s = slot(s) + L.v_bytes;
      const bool chunk_start = gst % p.chunk_stages == 0;
      fence_regs(acc);
      wg_fence();
      for (int k64 = 0; k64 < p.tk / 64; ++k64) {
#pragma unroll
        for (int kk = 4 * k64; kk < 4 * k64 + 4; ++kk)
          Wgmma<N>::mma(acc,
                        desc(a_s + k64 * BM * 128 + (kk & 3) * 32),
                        desc(b_s + k64 * N * 128 + (kk & 3) * 32),
                        kk > 0 || !chunk_start);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      if (lead) {
        mbar_arrive(&aempty[s % kASlots]);
        mbar_arrive(&empty[s % kSlots]);
      }
      if ((gst + 1) % p.chunk_stages == 0 || gst + 1 == p.n_stages) {
        const int chunk = gst / p.chunk_stages;
        if (p.split)
          store(acc,
                p.out + (size_t)chunk * p.B * width + (size_t)tile * p.TF,
                width, f0 + c * 64, b0, p.TF, p.B);
        else
          fold(total, acc, chunk == 0);
      }
    }
    if (!p.split)
      store(total, p.out + (size_t)tile * p.TF, width, f0 + c * 64, b0,
            p.TF, p.B);
  }
}

__global__ void nm_spmm_shared_fold(const float* __restrict__ part,
                                    float* __restrict__ out, int n_chunks,
                                    size_t count) {
  fold_chunks(part, out, n_chunks, count);
}

template <int PWG, int CWG, int N>
cudaError_t shared_launch(const CUtensorMap* maps, const SharedParams& p,
                          int splits, cudaStream_t st) {
  constexpr int BM = 64 * CWG;
  const SharedLayout L(BM, N, p.tk);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = nm_spmm_shared_mma<PWG, CWG, N>;
  static int allowed = 0;
  if (L.total > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return err;
    allowed = L.total;
  }
  SharedParams q = p;
  q.f_blocks = (p.TF + BM - 1) / BM;
  const dim3 grid(q.f_blocks * p.nf, (p.B + N - 1) / N, splits);
  kern<<<grid, 128 * (PWG + CWG), L.total, st>>>(maps[0], maps[1], q);
  return cudaGetLastError();
}

// The tile configurations (producer and consumer warpgroups, N), as
// nm_spmm's.
constexpr int kConfigs[4][3] = {{2, 1, 8}, {2, 1, 32}, {1, 2, 64},
                                {1, 2, 128}};

}  // namespace

// The tensor-core path (act and vals bf16).  act (B, K), vals (nf, Kc,
// TF), rows (nf, Kc) int32, out (B, nf*TF) fp32; act_g is scratch of
// nf*B*kcp bf16 (kcp = Kc rounded up to 8); `part` scratch of
// n_chunks*B*nf*TF floats, used when splits > 1.  The plan (config 0..3
// as nm_spmm's, stages of tk compact rows, n_stages of them,
// chunk_stages to a chunk, splits blocks along Kc of chunks_per_split
// chunks) is the wrapper's.  Launches the gather, the product and, with
// splits > 1, the fold on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue if a TMA descriptor could not be made.
extern "C" int nm_spmm_shared_launch(const void* act, const void* vals,
                                     const void* rows, void* act_g,
                                     void* out, void* part, int B, int K,
                                     int Kc, int TF, int nf, int config,
                                     int tk, int n_stages, int chunk_stages,
                                     int chunks_per_split, int splits,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (config < 0 || config > 3) return cudaErrorInvalidValue;
  const int BM = 64 * kConfigs[config][1], BN = kConfigs[config][2];
  const int kcp = (Kc + 7) / 8 * 8;
  nm_spmm_shared_gather<<<dim3((kcp + 255) / 256, B, nf), 256, 0, st>>>(
      static_cast<const bf16*>(act), static_cast<const int*>(rows),
      static_cast<bf16*>(act_g), B, K, Kc, kcp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  SharedParams p;
  p.vals = static_cast<const bf16*>(vals);
  p.out = static_cast<float*>(splits > 1 ? part : out);
  p.B = B; p.Kc = Kc; p.TF = TF; p.nf = nf; p.f_blocks = 0;
  p.tk = tk; p.n_stages = n_stages; p.chunk_stages = chunk_stages;
  p.chunks_per_split = chunks_per_split; p.split = splits > 1;
  p.vals_tma = TF % 8 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  p.tx_bytes = (uint32_t)(BN * tk * 2 + (p.vals_tma ? tk * BM * 2 : 0));
  CUtensorMap maps[2];
  memset(maps, 0, sizeof(maps));
  if (!make_sw128_map(&maps[0], act_g, B, kcp, BN, nf))
    return cudaErrorInvalidValue;
  if (p.vals_tma &&
      !make_rows_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, vals, Kc,
                     TF, tk, BM, nf))
    return cudaErrorInvalidValue;
  switch (config) {
    case 0: err = shared_launch<2, 1, 8>(maps, p, splits, st); break;
    case 1: err = shared_launch<2, 1, 32>(maps, p, splits, st); break;
    case 2: err = shared_launch<1, 2, 64>(maps, p, splits, st); break;
    default: err = shared_launch<1, 2, 128>(maps, p, splits, st); break;
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int n_chunks = (n_stages + chunk_stages - 1) / chunk_stages;
  const size_t count = (size_t)B * nf * TF;
  nm_spmm_shared_fold<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n_chunks,
      count);
  return static_cast<int>(cudaGetLastError());
}
