// Tensor-core building blocks shared by nm_spmm.cu and nm_spmm_shared.cu.
//
// Both kernels compute out^T[F, B] = W^T[F, K] . act^T[K, B] ("swap A and
// B") with Hopper's warpgroup MMA: the weight tile is the A operand (64
// output columns per warpgroup), the batch rows are N, and both operands
// are read from shared memory by wgmma.mma_async (m64nNk16, bf16 in, fp32
// accumulators in registers).  The kernels are warp-specialised: producer
// warps bring each stage in by TMA (cp.async.bulk.tensor, one thread
// issuing whole tiles that complete on an mbarrier) and prepare its
// weight tile on the CUDA cores, consumer warpgroups multiply; mbarriers
// hand stages and tiles between them.
//
// Operand layout in shared memory: K-major with the 128-byte swizzle, in
// atoms of 64 bf16 columns: an atom of R rows is R x 128 bytes, 1024-byte
// aligned, and element (row r, column k) sits at byte r*128 +
// ((k/8) ^ (r%8))*16 + (k%8)*2, so 8 rows form a 1024-byte group
// (stride-byte offset 1024) and any 8 rows' same 16-byte chunk fall in
// different banks.  TMA with CU_TENSOR_MAP_SWIZZLE_128B and a box of 64
// columns writes a K-contiguous global panel in exactly this layout; the
// producers write expanded weight tiles the same way.  A k16 step inside
// an atom starts 32 bytes further.
//
// Rows are bitwise independent of the batch: K is cut into chunks whose
// size is a function of the weight's shape only; a chunk's partial is one
// accumulator chain on the tensor core, its k16 products in ascending K
// from zero, and the partials are folded in ascending order, acc = P0;
// acc += P1; ...  A block that owns all chunks folds in registers; when
// the grid is short (decode), the chunks are split across blocks, each
// writes its chunks' partials to scratch and a second kernel
// (fold_chunks) folds them in the same order, so both give the same
// bits.  A tensor-core element depends only on its A row, its B column
// and the K order, never on which rows share its N tile (the card shows
// it: row 0 is bitwise the same at N = 8 .. 128), so the tile, stage
// width and split that B picks never change a bit.
//
// Tile configurations: PWG producer warpgroups, CWG consumer warpgroups
// owning BM = 64 * CWG output columns (an m64 slab each) and N batch rows,
// stages of a fixed width in K.  The Python wrappers pick the
// configuration by B.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nm_mma {

constexpr int kMaxSmem = 232448;    // dynamic shared memory a block may use

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory writes of this thread (st.shared) become visible to the
// async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also announces `bytes` of TMA traffic.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// One plain arrival.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Hand registers between warpgroups (every warp of a warpgroup executes
// the same one): producers give theirs up, consumers take them.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Barrier `id` among the first `threads` threads (the producer warps).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// Wait until the barrier's phase `parity` has completed (the thread is
// suspended in between, up to the hinted time, instead of spinning).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1, %2;\n"
      "@P1 bra.uni DONE;\nbra.uni WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity), "r"(0x989680)
      : "memory");
}

// TMA tile loads global -> shared, completing on `bar`; out-of-bounds
// elements are zero.
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1,
                                       int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Matrix descriptor of a K-major, 128-byte-swizzled tile at `p` (8-row
// groups 1024 bytes apart).
__device__ __forceinline__ uint64_t desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Byte offset of element (r, k) in a swizzled tile of `rows` rows and
// 64-column atoms (the layout above).
__device__ __forceinline__ int sw128(int r, int k, int rows) {
  return (k >> 6) * rows * 128 + r * 128 +
         ((((k >> 3) & 7) ^ (r & 7)) << 4) + (k & 7) * 2;
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous product.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N fp32, N/2 per thread) = A (64 x 16) . B (16 x N) + (scale_d ?
// d : 0), both operands read from shared memory through descriptors.
// Accumulators are defined by wgmma alone (the first product has
// scale_d = 0, no register is zeroed), so the products stay asynchronous.
// Fragment of thread t of the warpgroup: warp w = t/32 holds rows 16w + g
// and 16w + g + 8 (g = lane/4); d[4j + r] is row 16w + g + 8*(r/2),
// column 8j + 2*(lane%4) + r%2.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// total = acc (a block's first chunk) or total += acc: the chunk fold.
template <int R>
__device__ __forceinline__ void fold(float (&total)[R], const float (&acc)[R],
                                     bool first) {
#pragma unroll
  for (int i = 0; i < R; ++i) total[i] = first ? acc[i] : total[i] + acc[i];
}

// out[i] = ((part[0][i] + part[1][i]) + ...) over n_chunks partials of
// `count` floats each: the register fold's order.  Each source wraps it
// in a kernel of its own name (the profiler attributes kernels by name).
__device__ __forceinline__ void fold_chunks(const float* __restrict__ part,
                                            float* __restrict__ out,
                                            int n_chunks, size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = part[i];
  for (int c = 1; c < n_chunks; ++c) s += part[(size_t)c * count + i];
  out[i] = s;
}

// Store a warpgroup's 64 x N accumulators: element (f, b) goes to
// dst[b * ld + f]; f0 is the warpgroup's first column, b0 its first row,
// F and B the bounds.
template <int R>
__device__ __forceinline__ void store(const float (&d)[R], float* dst,
                                      size_t ld, int f0, int b0, int F,
                                      int B) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int f = f0 + 16 * w + (lane >> 2);
  const int b = b0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int ff = f + ((i >> 1) & 1) * 8;
    const int bb = b + (i >> 2) * 8 + (i & 1);
    if (ff < F && bb < B) dst[(size_t)bb * ld + ff] = d[i];
  }
}

// Host side: cuTensorMapEncodeTiled, reached through the runtime's driver
// entry point (no link against libcuda).  make_map: a map of `rank` dims
// (dims[0] contiguous) over `base`; strides[i] is the byte stride of dim
// i + 1; box the tile; out-of-bounds reads fill zeros.  False if the
// driver refuses it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<EncodeTiled>(fn);
  }
  return encode;
}

inline bool make_map(
    CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return encoder() != nullptr &&
         encoder()(map, type, rank, const_cast<void*>(base), dims, strides,
                   box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K-contiguous (rows, cols) bf16 panels, `planes` of them back to back,
// as the wgmma B operand: box {64, box_rows, 1} lands as one swizzled
// atom (the layout above).  cols % 8 == 0.
inline bool make_sw128_map(CUtensorMap* map, const void* base, int rows,
                           int cols, int box_rows, int planes = 1) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims,
                  strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Row-major (rows, cols) matrices of `type` (esize-byte elements),
// `planes` of them back to back, box {box_cols, box_rows, 1}: lands as
// [row][col]; rows past `rows` read zero, never the next plane.
inline bool make_rows_map(CUtensorMap* map, CUtensorMapDataType type,
                          int esize, const void* base, int rows, int cols,
                          int box_rows, int box_cols, int planes = 1) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * esize,
                                 (cuuint64_t)rows * cols * esize};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  return make_map(map, type, 3, base, dims, strides, box);
}

}  // namespace nm_mma
