// Fused WUVE + SORE pre-generation for Hopper (sm_90a): one grouped
// launch updates every pre-generated site of a step and writes all that
// the next step reads from it.
//
// For each site, a fp32 master view w (K, F) (a conv's (H*W*I, O) view),
// its gradient g (bf16 or fp32, widened in registers: bitwise
// g.to(float32)) and momentum v, with the FF groups along K (m rows of a
// column) and the BP groups along F (m columns of a row):
//
//   decay = the n survivors of |w| in each FF group (pre-update w)
//   g_eff = (g + wd*w) + lam*where(decay, 0, w)      SR-STE decay
//   v'    = mu*v + g_eff
//   w'    = w - lr*v'
//   vals, idx = the n survivors of |w'| per FF group, ascending offset:
//               vals (K*n/m, F) bf16, idx (K*n/m, F) uint8
//   mask  = those FF survivors as bytes 0/1 (K, F)     (the FF mask)
//   bp    = bf16(where(BP survivors of |w'|, w', +0))  (bdwp), or
//           bf16(w')                                   (srste), (K, F)
//
// Replaces the TPU kernel src/repro/kernels/fused_update.py:
// _fused_update_kernel (fused_update_pallas), which works on a (TR, TK)
// tile of the transposed master; the reference derives the BP operand
// and the FF mask after it in jnp (src/repro/optim/sgd.py, pallas_upd).
// Here the master keeps its (K, F) layout, the packed pair is written in
// the (Kc, F) layout nm_spmm reads, and the BP operand and the FF mask
// come out of the same pass, bitwise what the plain derivation gives.
//
// What bounds it: bytes.  Per element at 2:8 with a bf16 g it reads
// w 4, g 2, v 4 and writes w' 4, v' 4, vals 0.5, idx 0.25, bp 2, mask 1:
// 21.75 B, against a few dozen integer and float ops.  Design:
//   * one warp owns a tile of m rows (one FF group) by 32*C columns; a
//     lane owns m rows of C adjacent columns (on the vector path C = 2
//     for m >= 8, 8-byte fp32 accesses, and 4 below, 16-byte ones; the
//     narrower streams at C times their width; C = 1 for a ragged F or
//     an unaligned view).  Each row of a tile is one contiguous span of
//     the warp;
//   * all loads of a tile are issued before any store, so the 3 x m
//     loads of a lane are in flight together;
//   * the FF selections run on a lane's own registers (one column's m
//     rows), on integer keys (select_topn.cuh: select_topn_keys); a BP
//     group is m adjacent columns of one row, spread over lanes, so the
//     warp stages its tile of w' in shared memory (2 KB a warp at 2:8)
//     and each lane then selects C whole BP groups (32*C a tile, each
//     once) and writes each group's m bf16 with one 2m-byte store (16
//     bytes at 2:8);
//   * a persistent grid of warps walks all tiles of all sites.  The site
//     table (pointers, K, F, first tile) travels by value as one
//     __grid_constant__ parameter (up to 32 KB on Hopper with CUDA >=
//     12.1), so the launch holds no host-to-device copy and a CUDA graph
//     can capture it.  That holds kMaxSites (256) sites; a launch of
//     more (whisper's 512 a step) reads the same table from device
//     memory the caller filled (FuTableRef), with the same kernel body.
// In and out pointers may alias (w/w_out, v/v_out: the optimizer
// updates master and momentum in place): a lane reads each element it
// writes, before it writes it, and reads nothing another lane writes.
// So none of the pointers is __restrict__.
//
// Bitwise contract: every product and sum is written with the _rn
// intrinsics, which nvcc never contracts into a fused multiply-add, so
// every output equals the plain version (kernels/ref.py:
// ref_fused_update, one rounding per op in the order above) bit for bit.
// The decay term is +0 where the decay mask keeps a weight, as
// where(mask, 0, w) is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "select_topn.cuh"

// One site of a launch, as kernels/fused_update.py:_Site lays it out.
// bp and mask are null in the FF-only mode.
struct FuSite {
  const float* w;
  const void* g;
  const float* v;
  float* w_out;
  float* v_out;
  void* vals;
  void* idx;
  void* bp;
  void* mask;
  long long first;  // first tile of the site in its launch
  int K, F;
  int col_tiles;    // tiles across F: ceil(F / (32 * C))
  int vec;          // 1: C = kVecCols<M> columns a lane, 0: C = 1
};

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxSites = 256;   // sites a by-value table holds

// columns a lane owns on the vector path: 2 for m >= 8 (8-byte fp32
// accesses; 4 columns hold 3 x m x 4 inputs in 140 registers, which
// leaves 2 blocks an SM and measured 20% slower at 2:8,
// tools/fused_update_variants.py), 4 below
template <int M>
constexpr int kVecCols = M >= 8 ? 2 : 4;

struct FuTable {
  FuSite site[kMaxSites];
  long long tiles;
  int count, n;
  float lr, mu, wd, lam;
};

// the same table with its sites in device memory (more than kMaxSites)
struct FuTableRef {
  const FuSite* site;
  long long tiles;
  int count, n;
  float lr, mu, wd, lam;
};

// C-wide accesses: fp32, a gradient widened to fp32, bf16 bits, bytes
__device__ __forceinline__ void load_c(const float* p, float (&x)[1]) {
  x[0] = p[0];
}
__device__ __forceinline__ void load_c(const float* p, float (&x)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  x[0] = t.x; x[1] = t.y;
}
__device__ __forceinline__ void load_c(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ float widen(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);   // bf16 -> fp32, exact
}
__device__ __forceinline__ void load_c(const __nv_bfloat16* p,
                                       float (&x)[1]) {
  x[0] = widen(*reinterpret_cast<const uint16_t*>(p));
}
__device__ __forceinline__ void load_c(const __nv_bfloat16* p,
                                       float (&x)[2]) {
  const uint32_t t = *reinterpret_cast<const uint32_t*>(p);
  x[0] = widen(t & 0xffffu); x[1] = widen(t >> 16);
}
__device__ __forceinline__ void load_c(const __nv_bfloat16* p,
                                       float (&x)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  x[0] = widen(t.x & 0xffffu); x[1] = widen(t.x >> 16);
  x[2] = widen(t.y & 0xffffu); x[3] = widen(t.y >> 16);
}

__device__ __forceinline__ void store_c(float* p, const float (&x)[1]) {
  p[0] = x[0];
}
__device__ __forceinline__ void store_c(float* p, const float (&x)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ void store_c(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store_c(uint16_t* p, const uint32_t (&h)[1]) {
  p[0] = static_cast<uint16_t>(h[0]);
}
__device__ __forceinline__ void store_c(uint16_t* p, const uint32_t (&h)[2]) {
  *reinterpret_cast<uint32_t*>(p) = h[0] | (h[1] << 16);
}
__device__ __forceinline__ void store_c(uint16_t* p, const uint32_t (&h)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(h[0] | (h[1] << 16),
                                            h[2] | (h[3] << 16));
}
__device__ __forceinline__ void store_c(uint8_t* p, const uint32_t (&b)[1]) {
  p[0] = static_cast<uint8_t>(b[0]);
}
__device__ __forceinline__ void store_c(uint8_t* p, const uint32_t (&b)[2]) {
  *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(b[0] | (b[1] << 8));
}
__device__ __forceinline__ void store_c(uint8_t* p, const uint32_t (&b)[4]) {
  *reinterpret_cast<uint32_t*>(p) = b[0] | (b[1] << 8) | (b[2] << 16)
                                    | (b[3] << 24);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// M bf16 (bits in M/2 words) to M adjacent elements: 2M bytes, aligned
template <int M>
__device__ __forceinline__ void store_group(uint16_t* p,
                                            const uint32_t (&h)[M / 2]) {
  if constexpr (M >= 8) {
#pragma unroll
    for (int i = 0; i < M / 8; ++i)
      reinterpret_cast<uint4*>(p)[i] = make_uint4(h[4 * i], h[4 * i + 1],
                                                  h[4 * i + 2], h[4 * i + 3]);
  } else if constexpr (M == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(h[0], h[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = h[0];
  }
}

// The bdwp BP operand of a tile whose w' the warp has staged in shared
// memory (``stage``: M rows of 32*C floats).  A BP group is M adjacent
// columns of one row; the tile holds 32*C of them, C per lane, so each
// is selected once, and each lane writes its groups' M bf16 with one
// 2M-byte store (rows of a store instruction are contiguous spans).
template <int M, int C>
__device__ __forceinline__ void bp_groups(const float* stage, uint16_t* bp,
                                          size_t row0, size_t F, int col0,
                                          int limit, int n, int lane) {
  constexpr int kGroupsPerRow = kWarp * C / M;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int q = lane + kWarp * i;
    const int r = q / kGroupsPerRow, cg = (q % kGroupsPerRow) * M;
    if (col0 + cg >= limit) continue;   // F % M == 0: whole groups
    float x[M];
    const float* src = stage + r * kWarp * C + cg;
    if constexpr (M >= 4) {
#pragma unroll
      for (int k = 0; k < M; k += 4) {
        const float4 t = *reinterpret_cast<const float4*>(src + k);
        x[k] = t.x; x[k + 1] = t.y; x[k + 2] = t.z; x[k + 3] = t.w;
      }
    } else {
      const float2 t = *reinterpret_cast<const float2*>(src);
      x[0] = t.x; x[1] = t.y;
    }
    const unsigned keep = select_topn_keys<M>(x, n);
    uint32_t h[M / 2];
#pragma unroll
    for (int k = 0; k < M / 2; ++k)
      h[k] = (((keep >> (2 * k)) & 1u) ? bf16_bits(x[2 * k]) : 0u)
             | ((((keep >> (2 * k + 1)) & 1u) ? bf16_bits(x[2 * k + 1]) : 0u)
                << 16);
    store_group<M>(bp + (row0 + r) * F + col0 + cg, h);
  }
}

// One warp's tile: FF group ``grp`` (rows grp*M ..), this lane's C
// columns from ``col``.  Lanes past F load zeros and store nothing.
// ``stage`` is the warp's shared memory (M * 32 * C floats).
template <int M, int C, bool BP_SELECT, typename G>
__device__ __forceinline__ void update_tile(const FuSite& s, int grp,
                                            int col, int lane, int n,
                                            float lr, float mu, float wd,
                                            float lam, float* stage) {
  const size_t F = static_cast<size_t>(s.F);
  const bool valid = col < s.F;
  const size_t at0 = static_cast<size_t>(grp) * M * F + col;
  float w[C][M], g[C][M], v[C][M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float a[C], b[C], c[C];
#pragma unroll
    for (int k = 0; k < C; ++k) a[k] = b[k] = c[k] = 0.f;
    if (valid) {
      const size_t at = at0 + j * F;
      load_c(s.w + at, a);
      load_c(static_cast<const G*>(s.g) + at, b);
      load_c(s.v + at, c);
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      w[k][j] = a[k]; g[k][j] = b[k]; v[k][j] = c[k];
    }
  }
  unsigned pick[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const unsigned keep = select_topn_keys<M>(w[c], n);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float decay = ((keep >> j) & 1u) ? 0.f : w[c][j];
      const float g_eff = __fadd_rn(__fadd_rn(g[c][j], __fmul_rn(wd, w[c][j])),
                                    __fmul_rn(lam, decay));
      v[c][j] = __fadd_rn(__fmul_rn(mu, v[c][j]), g_eff);
      w[c][j] = __fsub_rn(w[c][j], __fmul_rn(lr, v[c][j]));
    }
    pick[c] = select_topn_keys<M>(w[c], n);
  }
  if (valid) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float a[C], b[C];
#pragma unroll
      for (int c = 0; c < C; ++c) { a[c] = w[c][j]; b[c] = v[c][j]; }
      store_c(s.v_out + at0 + j * F, b);
      store_c(s.w_out + at0 + j * F, a);
    }
    // the k-th survivor of each column, ascending offset
    unsigned rest[C];
#pragma unroll
    for (int c = 0; c < C; ++c) rest[c] = pick[c];
    auto* vals = static_cast<uint16_t*>(s.vals);
    auto* idx = static_cast<uint8_t*>(s.idx);
    for (int k = 0; k < n; ++k) {
      uint32_t hv[C], hi[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int at = __ffs(rest[c]) - 1;
        rest[c] &= rest[c] - 1u;
        float x = 0.f;
#pragma unroll
        for (int j = 0; j < M; ++j) x = (j == at) ? w[c][j] : x;
        hv[c] = bf16_bits(x);
        hi[c] = static_cast<uint32_t>(at);
      }
      const size_t out = (static_cast<size_t>(grp) * n + k) * F + col;
      store_c(vals + out, hv);
      store_c(idx + out, hi);
    }
    if (s.mask != nullptr) {
      auto* mask = static_cast<uint8_t*>(s.mask);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        uint32_t b[C];
#pragma unroll
        for (int c = 0; c < C; ++c) b[c] = (pick[c] >> j) & 1u;
        store_c(mask + at0 + j * F, b);
      }
    }
  }
  if (s.bp == nullptr) return;   // the same for the whole warp
  auto* bp = static_cast<uint16_t*>(s.bp);
  if constexpr (BP_SELECT) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float a[C];
#pragma unroll
      for (int c = 0; c < C; ++c) a[c] = w[c][j];
      store_c(stage + j * kWarp * C + lane * C, a);
    }
    __syncwarp();
    bp_groups<M, C>(stage, bp, static_cast<size_t>(grp) * M, F,
                    col - lane * C, s.F, n, lane);
    __syncwarp();   // the stage is free for the next tile
  } else if (valid) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      uint32_t h[C];
#pragma unroll
      for (int c = 0; c < C; ++c) h[c] = bf16_bits(w[c][j]);
      store_c(bp + at0 + j * F, h);
    }
  }
}

template <int M, bool BP_SELECT, typename G, typename Table>
__global__ void __launch_bounds__(kThreads)
fused_update_sites_kernel(const __grid_constant__ Table t) {
  // a warp's stage: its tile of w' for the BP groups (M x 32*C floats)
  __shared__ __align__(16) float stage[kWarps][BP_SELECT
                                               ? M * kWarp * kVecCols<M>
                                               : 4];
  const int lane = threadIdx.x % kWarp;
  float* my_stage = stage[threadIdx.x / kWarp];
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  int s = 0;
  for (long long tile = static_cast<long long>(blockIdx.x) * kWarps
                        + threadIdx.x / kWarp;
       tile < t.tiles; tile += stride) {
    while (s + 1 < t.count && tile >= t.site[s + 1].first) ++s;
    const FuSite& site = t.site[s];
    const int local = static_cast<int>(tile - site.first);
    const int grp = local / site.col_tiles;
    const int ct = local - grp * site.col_tiles;
    if (site.vec) {
      constexpr int C = kVecCols<M>;
      update_tile<M, C, BP_SELECT, G>(site, grp, (ct * kWarp + lane) * C,
                                      lane, t.n, t.lr, t.mu, t.wd, t.lam,
                                      my_stage);
    } else {
      update_tile<M, 1, BP_SELECT, G>(site, grp, ct * kWarp + lane, lane,
                                      t.n, t.lr, t.mu, t.wd, t.lam,
                                      my_stage);
    }
  }
}

template <int M, bool BP_SELECT, typename G, typename Table>
int launch(const Table& t, cudaStream_t st) {
  static int grid_cap = 0;   // resident blocks on the card, per kernel
  auto kernel = fused_update_sites_kernel<M, BP_SELECT, G, Table>;
  if (grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (t.tiles + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(need < grid_cap ? need : grid_cap);
  kernel<<<grid, kThreads, 0, st>>>(t);
  return static_cast<int>(cudaGetLastError());
}

template <int M, typename Table>
int dispatch(const Table& t, bool g_bf16, bool bp_select,
             cudaStream_t st) {
  if (g_bf16)
    return bp_select ? launch<M, true, __nv_bfloat16>(t, st)
                     : launch<M, false, __nv_bfloat16>(t, st);
  return bp_select ? launch<M, true, float>(t, st)
                   : launch<M, false, float>(t, st);
}

template <typename Table>
int dispatch_m(const Table& t, int m, bool g_bf16, bool bp_select,
               cudaStream_t st) {
  switch (m) {
    case 2: return dispatch<2>(t, g_bf16, bp_select, st);
    case 4: return dispatch<4>(t, g_bf16, bp_select, st);
    case 8: return dispatch<8>(t, g_bf16, bp_select, st);
    case 16: return dispatch<16>(t, g_bf16, bp_select, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int fused_update_max_sites() { return kMaxSites; }

extern "C" int fused_update_site_bytes() {
  return static_cast<int>(sizeof(FuSite));
}

extern "C" int fused_update_vec_cols(int m) {
  switch (m) {
    case 2: return kVecCols<2>;
    case 4: return kVecCols<4>;
    case 8: return kVecCols<8>;
    case 16: return kVecCols<16>;
    default: return 0;
  }
}

// sites[0 .. count): the launch's table from kernels/fused_update.py:
// plan_sites, ``tiles`` tiles in all; every g of the launch bf16
// (g_bf16 = 1) or fp32; bp_select = 1 selects the BP operand (bdwp),
// 0 casts it (srste) where a site has a bp pointer; m in {2, 4, 8, 16},
// 0 < n <= m.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a table or an m the kernel does not take).
extern "C" int fused_update_sites_launch(const FuSite* sites, int count,
                                         long long tiles, int n, int m,
                                         int g_bf16, int bp_select,
                                         float lr, float mu, float wd,
                                         float lam, void* stream) {
  if (count < 1 || count > kMaxSites || tiles < 1 || n < 1 || n > m)
    return static_cast<int>(cudaErrorInvalidValue);
  FuTable t;   // host staging of the by-value parameter
  memset(&t, 0, sizeof(t));
  memcpy(t.site, sites, sizeof(FuSite) * count);
  t.tiles = tiles;
  t.count = count;
  t.n = n;
  t.lr = lr;
  t.mu = mu;
  t.wd = wd;
  t.lam = lam;
  return dispatch_m(t, m, g_bf16, bp_select,
                    static_cast<cudaStream_t>(stream));
}

// The same launch over ``count`` sites of any number, whose table the
// caller has copied to device memory (``dev_sites``, valid until the
// kernel has run on ``stream``).
extern "C" int fused_update_sites_launch_ref(const FuSite* dev_sites,
                                             int count, long long tiles,
                                             int n, int m, int g_bf16,
                                             int bp_select, float lr,
                                             float mu, float wd, float lam,
                                             void* stream) {
  if (dev_sites == nullptr || count < 1 || tiles < 1 || n < 1 || n > m)
    return static_cast<int>(cudaErrorInvalidValue);
  FuTableRef t;
  t.site = dev_sites;
  t.tiles = tiles;
  t.count = count;
  t.n = n;
  t.lr = lr;
  t.mu = mu;
  t.wd = wd;
  t.lam = lam;
  return dispatch_m(t, m, g_bf16, bp_select,
                    static_cast<cudaStream_t>(stream));
}
