// Element-mode N:M sparse x dense matmul on Hopper's tensor cores (sm_90a).
//
//   out[b, f] = sum_k act[b, k] * W[k, f]   (fp32),
//   W = decompress(vals, idx): vals (Kc, F) bf16 holds the n survivors of
//   every m-group along K (Kc = K*n/m), idx their in-group offsets, either
//   one uint8 per value (Kc, F) or the u4 plane (ceil(Kc/2), F) with entry
//   kc in nibble (kc & 1) of byte idx[kc/2, f], low nibble first.
//
// Stacked operands (MoE expert stacks) run in the same launch: act
// (E, B, K), vals and idx (E, ·, F), out (E, B, F), expert e's rows by
// expert e's weight.  This replaces the reference's jax.vmap of the
// pallas_call over the expert axis (src/repro/core/operand.py:
// _spmm_stacked): the expert is folded into the grid's z (expert x
// split), every TMA map has the expert as its outer (plane) dimension,
// so no box crosses from one expert into the next, and each expert
// runs exactly the chains the 2-D launch would, so its slab is bitwise
// the 2-D kernel's result on that expert alone.
//
// Replaces the TPU kernel src/repro/kernels/nm_spmm.py:_spmm_kernel
// (nm_spmm_pallas), which decompresses a (TK, TF) tile in VMEM and feeds
// the MXU a dense tile product.  This kernel does the same on the SM:
//
//   out^T[F, B] = W^T[F, K] . act^T[K, B]   (nm_mma.cuh: "swap A and B")
//
// The decompressed weight tile is the wgmma A operand (64 output columns
// per consumer warpgroup), the batch rows are the instruction's N, and
// act (B, K), K-contiguous, is the K-major B operand.  A block owns BM
// output columns and N rows and runs over its K range in stages of gs
// m-groups (sk = gs*m dense columns: 128 at decode, 64 at training
// rows).  It is warp-specialised:
//   * producer warpgroups: one thread keeps a TMA ring of stages in
//     flight (4 slots at decode, 6 at training rows): the act panel
//     [N][sk] straight into the swizzled K-major layout of nm_mma.cuh,
//     the compact vals rows [gs*n][BM] and their index bytes (u8, or the
//     raw u4 plane); all producer threads expand each landed stage into
//     one of 3 or 4 A slots (dense bf16 W^T in the same layout, zeros at
//     pruned slots) on the CUDA cores;
//   * consumer warpgroups run wgmma.mma_async on each expanded A slot
//     (their 64 rows) against the stage's act tile, so the tensor cores
//     multiply one stage while the producers expand the next;
//   * mbarriers hand stages and A slots between the two (full / empty).
// Shapes TMA cannot take (K or F not a multiple of 8 / 16, m not dividing
// the stage, a misaligned pointer) load the same stages with plain
// per-thread loads by the producers instead; the arithmetic is the same.
// Decompress is ref.decompress_nm's arithmetic: a slot is the bf16 sum,
// from +0, of the survivors whose offset names it; an offset >= m names
// none; u4 is low nibble first; an odd Kc's last nibble is 0.  2:8 and
// 1:8 have a batched expand (every item's loads first) of one 16-byte A
// row segment per group.
//
// What bounds it: at decode (B = 4) bytes, Kc*F*(2 + idx_bits/8) weight
// bytes for 2*B*Kc*F operations, and in practice the producers' expand,
// which turns every compact value into a dense tile slot; the grid is
// short, so K is split across blocks.  At training rows (B = 1024-2048)
// operations: 2*B*Kc*F N:M operations, which this dense-tile design
// executes as 2*B*K*F, the dense product's work; the expand, repeated for
// every N tile, and shared-memory traffic hold it well below that (a 2:4
// sparse-tensor-core path for 2:8 would halve the work: not built).
//
// Rows are bitwise independent of the batch, at every B (nm_mma.cuh):
// K is cut into chunks of chunk_groups m-groups, a function of (K, n, m)
// only; each chunk is one tensor-core accumulator chain from zero, and
// the chunk partials are folded in ascending order, in registers when a
// block owns all chunks, else through per-chunk scratch [n_chunks][B][F]
// and nm_spmm_fold.  The tile, stage width and split picked by B cut
// the same chains.  No atomics, so every run gives the same bits.

#include <string.h>

#include "nm_mma.cuh"

namespace {

using namespace nm_mma;
using bf16 = __nv_bfloat16;

struct Params {
  const bf16* act;
  const bf16* vals;
  const uint8_t* idx;
  float* out;          // (E, B, F), or scratch [n_chunks][E][B][F] when split
  int E, B, K, F, Kc, n, m, idx_bits;
  int gs, sk, tk, cr;  // groups, dense columns, tile width, compact rows
  int n_stages, chunk_stages, chunks_per_split, split, splits;
  int tma;             // stages come by TMA (else per-thread loads)
  uint32_t tx_bytes;   // TMA bytes per stage
};


__host__ __device__ constexpr int up1k(int x) {
  return (x + 1023) / 1024 * 1024;
}

// Shared-memory layout of one block (bytes, from a 1024-byte aligned
// base, which the block finds within its first 1024 bytes): S stages of
// [act tile | vals rows | index bytes], SA A tiles, then the mbarriers:
// full and empty per stage slot, full and empty per A slot.  One consumer
// warpgroup (decode rows, two blocks an SM) keeps 4 stages and 3 A tiles,
// two (training rows) 6 and 4.
struct Layout {
  int S, SA;
  int act_bytes, vals_bytes, idx_bytes, stage_bytes, a_bytes, bar_off, total;
  __host__ __device__ Layout(int BM, int BN, int tk, int cr)
      : S(BM == 64 ? 4 : 6), SA(BM == 64 ? 3 : 4) {
    act_bytes = up1k(BN * tk * 2);
    vals_bytes = up1k(cr * BM * 2);
    idx_bytes = up1k(cr * BM);
    stage_bytes = act_bytes + vals_bytes + idx_bytes;
    a_bytes = BM * tk * 2;
    bar_off = S * stage_bytes + SA * a_bytes;
    total = bar_off + 2 * (S + SA) * 8 + 1024;
  }
};

// Offset of compact row r (of this stage) in smem at column f: u8 or
// expanded rows are [cr][BM]; the raw u4 plane is [cr/2][BM] nibbles.
__device__ __forceinline__ int idx_at(const uint8_t* s, int r, int f, int BM,
                                      bool raw4) {
  if (raw4) return (s[(r >> 1) * BM + f] >> ((r & 1) * 4)) & 0xF;
  return s[r * BM + f];
}

__device__ __forceinline__ float add_rn(float acc, float v) {
  return __bfloat162float(__float2bfloat16_rn(acc + v));
}

// Stage st of expert e into `buf` with per-thread loads by the PT
// producer threads (shapes TMA cannot take): the act panel in the
// swizzled K-major layout (nm_mma.cuh), zero past sk and K; the compact
// rows [cr][BM]; the offsets expanded to one byte per row.
template <int BM, int BN, int PT>
__device__ __forceinline__ void load_plain(const Params& p, char* buf, int st,
                                           int f0, int b0, int e, int pt) {
  const Layout L(BM, BN, p.tk, p.cr);
  const bf16* act = p.act + (size_t)e * p.B * p.K;
  const bf16* vals = p.vals + (size_t)e * p.Kc * p.F;
  const uint8_t* idx =
      p.idx + (size_t)e * (p.idx_bits == 4 ? (p.Kc + 1) / 2 : p.Kc) * p.F;
  char* act_s = buf;
  bf16* vals_s = reinterpret_cast<bf16*>(buf + L.act_bytes);
  uint8_t* idx_s = reinterpret_cast<uint8_t*>(buf + L.act_bytes +
                                              L.vals_bytes);
  const int k0 = st * p.sk, kc0 = st * p.cr;
  for (int i = pt; i < BN * p.tk; i += PT) {
    const int r = i / p.tk, c = i - r * p.tk;
    const int b = b0 + r, k = k0 + c;
    *reinterpret_cast<bf16*>(act_s + sw128(r, c, BN)) =
        b < p.B && c < p.sk && k < p.K ? act[(size_t)b * p.K + k]
                                       : __float2bfloat16_rn(0.f);
  }
  for (int i = pt; i < p.cr * BM; i += PT) {
    const int r = i / BM, c = i - r * BM;
    const int kc = kc0 + r, f = f0 + c;
    const bool ok = kc < p.Kc && f < p.F;
    vals_s[r * BM + c] =
        ok ? vals[(size_t)kc * p.F + f] : __float2bfloat16_rn(0.f);
    uint8_t v = 0;
    if (ok)
      v = p.idx_bits == 4
              ? (idx[(size_t)(kc >> 1) * p.F + f] >> ((kc & 1) * 4)) & 0xF
              : idx[(size_t)kc * p.F + f];
    idx_s[r * BM + c] = v;
  }
}

// bf16 bits of a survivor as ref.decompress_nm writes it alone in its
// slot: +0 + v (a -0 becomes +0).
__device__ __forceinline__ uint32_t alone(uint16_t v) {
  return v == 0x8000u ? 0u : v;
}

// 2:8 and 1:8 expand, IPT items (f, group) per producer thread: every
// item's offsets and values are loaded first (independent shared-memory
// reads in flight together), then each survivor's bits are shifted into
// its slot of the group's 128-bit A row segment.
template <int BM, int PT, int IPT>
__device__ __forceinline__ void expand_m8(const Params& p, const bf16* vals_s,
                                          const uint8_t* idx_s, bool raw4,
                                          bf16* a_s, int pt) {
  const uint16_t* v16 = reinterpret_cast<const uint16_t*>(vals_s);
  int o0[IPT], o1[IPT];
  uint32_t v0[IPT], v1[IPT];
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    const int e = pt + i * PT, f = e % BM, g = e / BM;
    const int r = g * p.n;
    if (p.n == 2) {
      if (raw4) {                            // both nibbles of one byte
        const int byte = idx_s[g * BM + f];
        o0[i] = byte & 0xF;
        o1[i] = byte >> 4;
      } else {
        o0[i] = idx_s[r * BM + f];
        o1[i] = idx_s[(r + 1) * BM + f];
      }
      v1[i] = v16[(r + 1) * BM + f];
    } else {
      o0[i] = idx_at(idx_s, r, f, BM, raw4);
      o1[i] = 8;
      v1[i] = 0;
    }
    v0[i] = v16[r * BM + f];
  }
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    const int e = pt + i * PT, f = e % BM, g = e / BM;
    uint32_t a = alone((uint16_t)v0[i]), b = alone((uint16_t)v1[i]);
    int q0 = o0[i], q1 = o1[i];
    if (q1 == q0) {                          // one slot: (0 + v0) + v1
      const float s = add_rn(__bfloat162float(__ushort_as_bfloat16((uint16_t)a)),
                             __bfloat162float(__ushort_as_bfloat16((uint16_t)b)));
      a = __bfloat16_as_ushort(__float2bfloat16_rn(s));
      q1 = 8;
    }
    const uint64_t s0 = q0 < 8 ? (uint64_t)a << ((q0 & 3) * 16) : 0;
    const uint64_t s1 = q1 < 8 ? (uint64_t)b << ((q1 & 3) * 16) : 0;
    const uint64_t lo = (q0 < 4 ? s0 : 0) | (q1 < 4 ? s1 : 0);
    const uint64_t hi = (q0 >= 4 ? s0 : 0) | (q1 >= 4 ? s1 : 0);
    *reinterpret_cast<uint4*>(reinterpret_cast<char*>(a_s) +
                              sw128(f, g * 8, BM)) =
        make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi,
                   (uint32_t)(hi >> 32));
  }
}

// Expand the stage's compact rows into the A tile (the swizzled K-major
// layout of nm_mma.cuh) with the PT producer threads:
// A(f, g*m + s) = bf16 sum of the survivors of group g whose offset is s.
// Columns past sk stay 0.  IPT is the items per thread of the
// configuration's 2:8 stage.
template <int BM, int PT, int IPT>
__device__ __forceinline__ void expand(const Params& p, const bf16* vals_s,
                                       const uint8_t* idx_s, bool raw4,
                                       bf16* a_s, int pt) {
  if (p.m == 8 && p.n <= 2 && BM * p.gs == IPT * PT) {
    expand_m8<BM, PT, IPT>(p, vals_s, idx_s, raw4, a_s, pt);
    return;
  }
  const int blocks8 = (p.m + 7) / 8;
  for (int e = pt; e < BM * p.gs * blocks8; e += PT) {
    const int f = e % BM;
    const int rest = e / BM;
    const int g = rest / blocks8, sb = rest - g * blocks8;
    float acc[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) acc[s] = 0.f;
    for (int j = 0; j < p.n; ++j) {
      const int r = g * p.n + j;
      const int d = idx_at(idx_s, r, f, BM, raw4) - sb * 8;
      const float v = __bfloat162float(vals_s[r * BM + f]);
#pragma unroll
      for (int s = 0; s < 8; ++s)
        if (d == s) acc[s] = add_rn(acc[s], v);
    }
    const int k = g * p.m + sb * 8;            // dense column of slot 0
    if (p.m % 8 == 0) {                        // one aligned run of 8
      uint4 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
      *reinterpret_cast<uint4*>(reinterpret_cast<char*>(a_s) +
                                sw128(f, k, BM)) = u;
    } else {
      const int width = min(8, p.m - sb * 8);
#pragma unroll
      for (int s = 0; s < 8; ++s)
        if (s < width)
          *reinterpret_cast<bf16*>(reinterpret_cast<char*>(a_s) +
                                   sw128(f, k + s, BM)) =
              __float2bfloat16_rn(acc[s]);
    }
  }
}

// Grid (ceil(F/BM), ceil(B/N), E * splits).  Warp-specialised: the first PWG
// warpgroups produce (TMA issue, then the expand of each stage into an A
// slot), the next CWG warpgroups consume (wgmma of their 64 rows of the A
// slot against the stage's act tile, N rows); BM = 64*CWG.  mbarriers
// hand each stage and each A slot back and forth.
template <int PWG, int CWG, int N, int W>
__global__ void __launch_bounds__(128 * (PWG + CWG), CWG == 1 ? 2 : 1)
nm_spmm_wgmma(const __grid_constant__ CUtensorMap map_act,
              const __grid_constant__ CUtensorMap map_vals,
              const __grid_constant__ CUtensorMap map_idx, const Params p) {
  constexpr int BM = 64 * CWG, BN = N, PT = 128 * PWG, R = N / 2;
  constexpr int IPT = BM * (W / 8) / PT;     // 2:8 items per producer
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout L(BM, BN, p.tk, p.cr);
  char* a_base = smem + L.S * L.stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* empty = full + L.S;
  uint64_t* afull = empty + L.S;
  uint64_t* aempty = afull + L.SA;
  const int f0 = blockIdx.x * BM, b0 = blockIdx.y * BN;
  const int e = blockIdx.z / p.splits;     // the expert (0 unstacked)
  const bool raw4 = p.tma && p.idx_bits == 4;
  const int c_lo = (blockIdx.z - e * p.splits) * p.chunks_per_split;
  const int st_lo = c_lo * p.chunk_stages;
  const int nst = min(p.n_stages, (c_lo + p.chunks_per_split) *
                                      p.chunk_stages) - st_lo;
  auto slot = [&](int s) { return smem + (s % L.S) * L.stage_bytes; };
  auto a_slot = [&](int s) { return a_base + (s % L.SA) * L.a_bytes; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < L.S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CWG);
    }
    for (int i = 0; i < L.SA; ++i) {
      mbar_init(&afull[i], 1);
      mbar_init(&aempty[i], CWG);
    }
    mbar_init_fence();
  }
  {  // A columns no expand writes (past sk) must read 0
    uint4* z = reinterpret_cast<uint4*>(a_base);
    for (int i = threadIdx.x; i < L.SA * L.a_bytes / 16;
         i += blockDim.x)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  fence_async_smem();
  __syncthreads();

  // four warpgroups share 128 registers a thread: producers keep 64,
  // consumers (accumulators and the chunk fold) take 192
  constexpr bool kRebalance = PWG + CWG == 4;
  if (threadIdx.x < PT) {
    // ---- producer
    if constexpr (kRebalance) regs_dec<64>();
    const int pt = threadIdx.x;
    auto tma = [&](int s) {                  // local stage s, by thread 0
      char* buf = slot(s);
      const int gst = st_lo + s;
      uint64_t* bar = &full[s % L.S];
      mbar_expect(bar, p.tx_bytes);
      for (int a = 0; a < p.tk / 64; ++a)
        tma_3d(buf + a * BN * 128, &map_act, bar, gst * p.sk + 64 * a, b0,
               e);
      tma_3d(buf + L.act_bytes, &map_vals, bar, f0, gst * p.cr, e);
      tma_3d(buf + L.act_bytes + L.vals_bytes, &map_idx, bar, f0,
             p.idx_bits == 4 ? gst * p.cr / 2 : gst * p.cr, e);
    };
    if (p.tma && pt == 0)
      for (int s = 0; s < L.S && s < nst; ++s) tma(s);
    for (int s = 0; s < nst; ++s) {
      char* buf = slot(s);
      if (p.tma) {
        mbar_wait(&full[s % L.S], (s / L.S) & 1);
      } else {
        if (s >= L.S)
          mbar_wait(&empty[s % L.S], ((s / L.S) & 1) ^ 1);
        load_plain<BM, BN, PT>(p, buf, st_lo + s, f0, b0, e, pt);
        named_sync(1, PT);
      }
      if (s >= L.SA)
        mbar_wait(&aempty[s % L.SA], ((s / L.SA) & 1) ^ 1);
      expand<BM, PT, IPT>(p,
                          reinterpret_cast<const bf16*>(buf + L.act_bytes),
                     reinterpret_cast<const uint8_t*>(buf + L.act_bytes +
                                                      L.vals_bytes),
                     raw4, reinterpret_cast<bf16*>(a_slot(s)), pt);
      fence_async_smem();
      named_sync(1, PT);
      if (pt == 0) {
        mbar_arrive(&afull[s % L.SA]);
        // keep the ring three stages ahead: refill the slot of stage
        // s+3-S, which the consumers have left unless they lag
        const int t = s + 3;
        if (p.tma && t >= L.S && t < nst) {
          mbar_wait(&empty[(t - L.S) % L.S], ((t - L.S) / L.S) & 1);
          tma(t);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c multiplies rows 64c.. of each A slot
    if constexpr (kRebalance) regs_inc<192>();
    const int c = (threadIdx.x - PT) >> 7;
    const bool lead = ((threadIdx.x - PT) & 127) == 0;
    float acc[R], total[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = total[i] = 0.f;
    for (int s = 0; s < nst; ++s) {
      const int gst = st_lo + s;
      mbar_wait(&afull[s % L.SA], (s / L.SA) & 1);
      if (p.tma) mbar_wait(&full[s % L.S], (s / L.S) & 1);
      const char* a_s = a_slot(s) + c * 64 * 128;
      const char* b_s = slot(s);
      const bool chunk_start = gst % p.chunk_stages == 0;
      fence_regs(acc);
      wg_fence();
      for (int k64 = 0; k64 < p.tk / 64; ++k64) {
#pragma unroll
        for (int kk = 4 * k64; kk < 4 * k64 + 4; ++kk)
          Wgmma<N>::mma(acc,
                        desc(a_s + k64 * BM * 128 + (kk & 3) * 32),
                        desc(b_s + k64 * BN * 128 + (kk & 3) * 32),
                        kk > 0 || !chunk_start);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      if (lead) {
        mbar_arrive(&aempty[s % L.SA]);
        mbar_arrive(&empty[s % L.S]);
      }
      if ((gst + 1) % p.chunk_stages == 0 || gst + 1 == p.n_stages) {
        const int chunk = gst / p.chunk_stages;
        if (p.split)
          store(acc, p.out + ((size_t)chunk * p.E + e) * p.B * p.F, p.F,
                f0 + c * 64, b0, p.F, p.B);
        else
          fold(total, acc, chunk == 0);
      }
    }
    if (!p.split)
      store(total, p.out + (size_t)e * p.B * p.F, p.F, f0 + c * 64, b0, p.F,
            p.B);
  }
}

__global__ void nm_spmm_fold(const float* __restrict__ part,
                             float* __restrict__ out, int n_chunks,
                             size_t count) {
  fold_chunks(part, out, n_chunks, count);
}

template <int PWG, int CWG, int N, int W>
cudaError_t launch(const CUtensorMap* maps, const Params& p, int splits,
                   cudaStream_t st) {
  constexpr int BM = 64 * CWG;
  const Layout L(BM, N, p.tk, p.cr);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = nm_spmm_wgmma<PWG, CWG, N, W>;
  static int allowed = 0;                  // bytes already allowed
  if (L.total > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return err;
    allowed = L.total;
  }
  const dim3 grid((p.F + BM - 1) / BM, (p.B + N - 1) / N, p.E * splits);
  kern<<<grid, 128 * (PWG + CWG), L.total, st>>>(maps[0], maps[1], maps[2],
                                                 p);
  return cudaGetLastError();
}

// The tile configurations (producer warpgroups, consumer warpgroups, N,
// stage width) the wrapper's CONFIGS name; BM = 64 per consumer
// warpgroup.
constexpr int kConfigs[4][4] = {{2, 1, 8, 128}, {2, 1, 32, 128},
                                {2, 2, 64, 64}, {2, 2, 128, 64}};

}  // namespace

// Shared-memory bytes of one block (the wrapper checks its own formula
// against this).
extern "C" int nm_spmm_smem_bytes(int bm, int bn, int tk, int cr) {
  return Layout(bm, bn, tk, cr).total;
}

// Launches the kernel on `stream` with the wrapper's plan (config 0..3;
// stages of gs groups of m, tk the stage's tile width, n_stages of them,
// chunk_stages to a chunk; splits blocks along K of chunks_per_split
// chunks each) over E stacked experts (E = 1: one 2-D product).  With
// splits > 1 every chunk's partial goes to `part` ([n_chunks][E][B][F]
// floats) and a second kernel folds them into `out`.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// if a TMA descriptor could not be made.
extern "C" int nm_spmm_launch(const void* act, const void* vals,
                              const void* idx, void* out, void* part, int E,
                              int B, int K, int F, int Kc, int n, int m,
                              int idx_bits, int config, int gs, int tk,
                              int n_stages, int chunk_stages,
                              int chunks_per_split, int splits,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (config < 0 || config > 3) return cudaErrorInvalidValue;
  const int BM = 64 * kConfigs[config][1], BN = kConfigs[config][2];
  Params p;
  p.act = static_cast<const bf16*>(act);
  p.vals = static_cast<const bf16*>(vals);
  p.idx = static_cast<const uint8_t*>(idx);
  p.out = static_cast<float*>(splits > 1 ? part : out);
  p.E = E; p.B = B; p.K = K; p.F = F; p.Kc = Kc; p.n = n; p.m = m;
  p.idx_bits = idx_bits;
  p.gs = gs; p.sk = gs * m; p.tk = tk; p.cr = gs * n;
  p.n_stages = n_stages; p.chunk_stages = chunk_stages;
  p.chunks_per_split = chunks_per_split; p.split = splits > 1;
  p.splits = splits;
  const int idx_rows = idx_bits == 4 ? p.cr / 2 : p.cr;
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  p.tma = K % 8 == 0 && p.sk == tk && F % 16 == 0 && aligned(act) &&
          aligned(vals) && aligned(idx) && (idx_bits == 8 || p.cr % 2 == 0);
  p.tx_bytes = (uint32_t)(BN * tk * 2 + p.cr * BM * 2 + idx_rows * BM);
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  if (p.tma &&
      !(make_sw128_map(&maps[0], act, B, K, BN, E) &&
        make_rows_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, vals,
                      Kc, F, p.cr, BM, E) &&
        make_rows_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, idx,
                      idx_bits == 4 ? (Kc + 1) / 2 : Kc, F, idx_rows, BM,
                      E)))
    return cudaErrorInvalidValue;
  cudaError_t err;
  switch (config) {
    case 0: err = launch<2, 1, 8, 128>(maps, p, splits, st); break;
    case 1: err = launch<2, 1, 32, 128>(maps, p, splits, st); break;
    case 2: err = launch<2, 2, 64, 64>(maps, p, splits, st); break;
    default: err = launch<2, 2, 128, 64>(maps, p, splits, st); break;
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int n_chunks = (n_stages + chunk_stages - 1) / chunk_stages;
  const size_t count = (size_t)E * B * F;
  nm_spmm_fold<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n_chunks,
      count);
  return static_cast<int>(cudaGetLastError());
}
