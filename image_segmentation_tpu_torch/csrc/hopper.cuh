// Shared device helpers for the Hopper (sm_90a) kernels: mbarriers, TMA
// tensor loads, wgmma descriptors and the wgmma instructions themselves.
//
// Layout convention: every tile that wgmma reads from shared memory is
// written by TMA with CU_TENSOR_MAP_SWIZZLE_128B (or by hand in the same
// pattern), as rows of 128 bytes (64 bf16) in groups of 8 rows (1024 B,
// 1024-byte aligned), the 16-byte chunk index within a row XOR-ed with
// the row index within its group:
//   byte(r, c) = (r / 8) * 1024 + (r % 8) * 128 + (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2.
// A tile wider than 64 columns is kept as consecutive 64-column slabs.
// - K-major operand (the reduction dimension along the 128-byte rows):
//   descriptor SBO = 1024 B (next 8-row group), LBO unused; the k-th
//   16-wide slice of a slab starts 32 k bytes further.
// - MN-major operand (rows run along the reduction dimension, transpose
//   flag set): a 64-wide N is one slab, SBO = 1024 B between groups of 8
//   reduction rows; the k-th 16-deep slice starts 2048 k bytes further.
//   A wider N is consecutive 64-wide slabs, and LBO is the byte stride
//   from one slab to the next (CUTLASS's canonical MN-major SW128 layout,
//   ((8, 8, n), (8, k)) : ((1, 8, LBO), (64, SBO)) in elements; checked on
//   the card with 128-channel K1 tiles, since dropped, see PERF.md); with
//   one slab LBO is never read.
//
// Accumulator layout of wgmma.m64nNk16 (f32), for a thread of warp w of
// the warpgroup, with g = lane / 4 and t = lane % 4: d[4 j + e] holds row
// 16 w + g + 8 (e / 2), column 8 j + 2 t + (e % 2). The A operand in
// registers (k16) takes the same (row, column) pairs as two neighbouring
// 8-column blocks, so an accumulator converts to the next product's A
// fragment without moving data between threads.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace istpu {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (swizzled tiles need it).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t s = smem_u32(p);
  return p + (((s + 1023u) & ~1023u) - s);
}

// Byte offset of element (r, c) of a 64-column swizzled slab.
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2);
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async (TMA) proxy.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also tells the barrier to expect `bytes` of TMA data.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One plain arrival.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spins until the barrier's phase with parity `phase` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
  }
}

// Register rebalancing between warpgroups: each warp of a warpgroup runs
// it together, `R` a multiple of 8 in [24, 256].
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma, TMA) of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- TMA -----------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// Shared -> global tensor store (out-of-bounds elements are not written),
// tracked by the issuing thread's bulk async-groups.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until this thread's bulk stores have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Waits until this thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A bf16 tensor map with 128-byte swizzle. dims and box run innermost
// first; strides (bytes) are those of dims 1..rank-1. Out-of-bounds
// elements of a box read as zeros. cuTensorMapEncodeTiled is a driver
// entry point: it is looked up through the runtime
// (cudaGetDriverEntryPoint), so the library needs no -lcuda.
inline cudaError_t make_tensor_map(CUtensorMap* map, const void* base, uint32_t rank,
                                   const cuuint64_t* dims, const cuuint64_t* strides,
                                   const cuuint32_t* box) {
  using EncodeFn = decltype(&cuTensorMapEncodeTiled);
  static const EncodeFn encode = []() -> EncodeFn {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeFn>(fn);
  }();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 4-D map over a (B, S, H, d) bf16 tensor with element strides
// (sb, ss, sh, 1); boxes of 64 tokens x one head x 64 (the attention
// kernels' q, k and v tiles, read out of a strided qkv projection). A head
// dim d under 64 (a multiple of 8) reads columns d .. 63 as zeros.
inline cudaError_t head_tile_map(CUtensorMap* map, const void* base, int B, int S, int H,
                                 long long sb, long long ss, long long sh, int d = 64) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return make_tensor_map(map, base, 4, dims, strides, box);
}

// A 5-D map over an h x w map of (B, h w, H, d) bf16 tokens with element
// strides (sb, ss, sh, 1), a map row being w tokens; boxes of `cols`
// tokens of one map row x one head x 64 (K5's window rows). Rows and
// columns past the map, and columns d .. 63 of a head, read as zeros.
inline cudaError_t map_row_map(CUtensorMap* map, const void* base, int B, int h, int w, int H,
                               long long sb, long long ss, long long sh, int cols, int d = 64) {
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(ss) * w * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[5] = {64, 1, static_cast<cuuint32_t>(cols), 1, 1};
  return make_tensor_map(map, base, 5, dims, strides, box);
}

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) { return sw128_desc(p, 16, 1024); }
__device__ __forceinline__ uint64_t mnmajor_desc(const void* p) {
  return sw128_desc(p, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products that write them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 64, f32) += A (64 x 16, shared, K-major) . B (16 x 64, shared),
// B K-major, or MN-major with kTransB = 1.
template <int kTransB = 0>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransB));
}

// D (64 x 128, f32) += A (64 x 16, shared) . B (16 x 128, shared), both K-major.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, shared), B MN-major.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

}  // namespace istpu
