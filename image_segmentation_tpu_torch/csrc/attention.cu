// K3: fused multi-head attention, softmax(Q K^T / sqrt(D)) V, for Hopper.
//
// Replaces image_segmentation_tpu/ops/pallas/attention.py:_attention_kernel
// (fused_attention -> _fused_attention_impl), the kernel every CLIP ViT
// block runs. The arithmetic is the Pallas kernel's (attention.py:41-60):
//   logits = (q . k) accumulated in f32, THEN times 1/sqrt(D);
//   keys >= S masked to -inf; row max, exp and sum in f32;
//   P = e / sum rounded to bf16 BEFORE P . V (no division after P . V);
//   P . V accumulated in f32; output in bf16.
//
// What bounds it on an H100: at ViT-B/16 shapes (S = 197, D = 64) one
// (batch, head) is 4 x 197^2 x 64 = 10 MFLOP against 100 KB of q/k/v/out,
// so the call is bound by memory (0.36 us for B = 1 at 3.35 TB/s) and,
// in practice, by latency: 48 blocks at B = 1, each a short chain of
// load -> product -> softmax -> product.
// Design: one warpgroup (128 threads) per (64-query tile, head, batch).
// One thread issues TMA loads of the tile's Q (64 x 64) and of all keys'
// K and V (S rounded up to 64, at most 256) through 4-D tensor maps over
// the caller's (B, S, H, D) strides, so the head split is never copied;
// rows past S arrive as zeros. Q and K complete one mbarrier, V another,
// so QK^T starts while V is in flight. QK^T is wgmma m64n64k16 per 64-key
// chunk (both operands K-major in shared memory); the logits of a row stay
// in the registers of the four threads that own it (up to 128 f32 each),
// so the exact softmax needs two quad shuffles per reduction and no
// shared memory. P is rounded to bf16 in registers, where it already has
// the layout of wgmma's A operand, and P . V is wgmma with A from
// registers and V as an MN-major B (transpose flag): nothing is transposed
// by hand. Shared memory is 8 + 2 x 32 KB at S = 197 and the registers
// are held to 168 a thread (__launch_bounds__(128, 3)), so three blocks
// fit on an SM and B = 8 (384 blocks) runs in one wave. With one warp a
// scheduler the softmax is latency-bound scalar code, so exp and the
// division run on the SFU.
#include "common.cuh"
#include "hopper.cuh"

namespace istpu {
namespace {

constexpr int kQTile = 64;   // query rows per block
constexpr int kKChunk = 64;  // keys per QK^T product (N of wgmma)
constexpr int kHeadDim = 64;
constexpr int kMaxChunks = 4;  // S <= 256
constexpr uint32_t kTileBytes = kQTile * kHeadDim * 2;  // one 64 x 64 bf16 box

size_t attention_smem_bytes(int chunks) {
  return 1024 + kTileBytes * (1 + 2 * chunks) + 2 * sizeof(uint64_t);
}

template <int kChunks>
__global__ void __launch_bounds__(128, 3)
attention_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int S, int H,
                 float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align_1024(smem_raw);
  unsigned char* Ks = Qs + kTileBytes;
  unsigned char* Vs = Ks + kChunks * kTileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kChunks * kTileBytes);  // [0] Q+K, [1] V

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    // Coordinates run innermost first: (d, head, token, batch).
    mbar_arrive_expect_tx(&bars[0], kTileBytes * (1 + kChunks));
    tma_load_4d(Qs, &tq, &bars[0], 0, h, q0, b);
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      tma_load_4d(Ks + c * kTileBytes, &tk, &bars[0], 0, h, c * kKChunk, b);
    mbar_arrive_expect_tx(&bars[1], kTileBytes * kChunks);
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      tma_load_4d(Vs + c * kTileBytes, &tv, &bars[1], 0, h, c * kKChunk, b);
  }

  // Logits: s[c][4 j + e] is row 16 warp + g + 8 (e / 2), key 64 c + 8 j + 2 t + e % 2.
  float s[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) s[c][i] = 0.f;
  mbar_wait(&bars[0], 0);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk)
      wgmma_m64n64k16_ss(s[c], kmajor_desc(Qs + 32 * kk),
                            kmajor_desc(Ks + c * kTileBytes + 32 * kk));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kChunks; ++c) fence_regs(s[c]);

  // Scale, mask keys >= S to -inf, and the row max over the quad.
  const float neg_inf = __int_as_float(0xff800000);
  float mx[2] = {neg_inf, neg_inf};
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c * kKChunk + 8 * j + 2 * t + (e & 1);
        const float l = key < S ? s[c][4 * j + e] * scale : neg_inf;
        s[c][4 * j + e] = l;
        mx[e >> 1] = fmaxf(mx[e >> 1], l);
      }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float e = __expf(s[c][i] - mx[(i >> 1) & 1]);
      s[c][i] = e;
      sum[(i >> 1) & 1] += e;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }

  // P = e / sum in bf16, as the A fragments of P . V: k-step 4 c + kk
  // covers keys 64 c + 16 kk .. +15, i.e. 8-key blocks 2 kk and 2 kk + 1.
  // exp and the division run on the SFU (__expf, __fdividef). __expf's
  // error grows with |x|: 2 + floor(1.173 |x|) f32 ulps by the CUDA
  // Programming Guide, tens of ulps for logits far below the row max;
  // __fdividef adds 2. A bf16 step is 2^16 f32 ulps, so P can differ from
  // the IEEE expf / division version only where the f32 value sits next to
  // a bf16 rounding boundary (chip_smoke.py phase 3 measures the gap).
  uint32_t p[kChunks * 4][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int lo = 8 * kk, hi = 8 * kk + 4;  // blocks 2 kk and 2 kk + 1
      p[4 * c + kk][0] = pack_bf16(__fdividef(s[c][lo], sum[0]), __fdividef(s[c][lo + 1], sum[0]));
      p[4 * c + kk][1] =
          pack_bf16(__fdividef(s[c][lo + 2], sum[1]), __fdividef(s[c][lo + 3], sum[1]));
      p[4 * c + kk][2] = pack_bf16(__fdividef(s[c][hi], sum[0]), __fdividef(s[c][hi + 1], sum[0]));
      p[4 * c + kk][3] =
          pack_bf16(__fdividef(s[c][hi + 2], sum[1]), __fdividef(s[c][hi + 3], sum[1]));
    }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  mbar_wait(&bars[1], 0);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kChunks * 4; ++ks)
    wgmma_m64n64k16_rs(acc, p[ks], mnmajor_desc(Vs + ks * 16 * 128));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

  // Output: a fresh contiguous (B, S, H, D) tensor.
  const long long row_stride = static_cast<long long>(H) * kHeadDim;
  bf16* ob = o + (static_cast<long long>(b) * S * H + h) * kHeadDim;
  const int row0 = q0 + warp * 16 + g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= S) continue;
    bf16* orow = ob + row * row_stride;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
          pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

template <int kChunks>
cudaError_t launch_attention(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                             bf16* o, int B, int S, int H, int q_tiles, int smem,
                             cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<kChunks>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(q_tiles, H, B);
  attention_kernel<kChunks><<<grid, 128, smem, stream>>>(
      tq, tk, tv, o, S, H, 1.0f / sqrtf(static_cast<float>(kHeadDim)));
  return cudaGetLastError();
}

}  // namespace
}  // namespace istpu

extern "C" {

// q, k, v: bf16 (B, S, H, D) with the given element strides (D contiguous,
// the others multiples of 8); o: contiguous bf16 (B, S, H, D); S <= 256,
// D = 64. The cut is the caller's plan (ops/kernels/attention.py
// attention_plan): q_tiles blocks of 64 queries, chunks of 64 keys and
// smem bytes of shared memory a block; a plan that does not cover S is
// refused. Returns a cudaError_t.
int istpu_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                         int S, int H, int D, long long qsb, long long qss,
                         long long qsh, long long ksb, long long kss, long long ksh,
                         long long vsb, long long vss, long long vsh, int q_tiles,
                         int chunks, int smem, int device, void* stream) {
  using namespace istpu;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (D != kHeadDim || B <= 0 || H <= 0 || S <= 0 || chunks < 1 || chunks > kMaxChunks ||
      chunks * kKChunk < S || q_tiles * kQTile < S ||
      static_cast<size_t>(smem) < attention_smem_bytes(chunks))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if ((err = head_tile_map(&tq, q, B, S, H, qsb, qss, qsh)) != cudaSuccess) return err;
  if ((err = head_tile_map(&tk, k, B, S, H, ksb, kss, ksh)) != cudaSuccess) return err;
  if ((err = head_tile_map(&tv, v, B, S, H, vsb, vss, vsh)) != cudaSuccess) return err;
  auto* op = static_cast<bf16*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  switch (chunks) {
    case 1: return launch_attention<1>(tq, tk, tv, op, B, S, H, q_tiles, smem, s);
    case 2: return launch_attention<2>(tq, tk, tv, op, B, S, H, q_tiles, smem, s);
    case 3: return launch_attention<3>(tq, tk, tv, op, B, S, H, q_tiles, smem, s);
    default: return launch_attention<4>(tq, tk, tv, op, B, S, H, q_tiles, smem, s);
  }
}

const char* istpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
