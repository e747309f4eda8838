// K4: fused ViT MLP, x + fc2(GELU(fc1(LayerNorm(x)))), for Hopper; the
// GELU is CLIP's quick GELU (the default, every ClipUNet call) or the exact
// erf GELU (`act` 1: Segment Anything's image encoder, models/sam.py).
//
// Replaces image_segmentation_tpu/ops/pallas/mlp.py:_mlp_kernel
// (fused_mlp -> _fused_mlp_impl), the second half of every CLIP ViT
// block. Cast points are the Pallas kernel's (mlp.py:75-88):
//   LayerNorm statistics and affine in f32, result rounded to bf16;
//   fc1 accumulated in f32, + f32 bias; quick-GELU h * sigmoid(1.702 h)
//   (or the exact 0.5 h (1 + erf(h / sqrt 2))) in f32, rounded to bf16;
//   fc2 accumulated in f32, + f32 bias, rounded to bf16; residual add in
//   bf16.
// Weights use the nn.Linear layout: w1 is (F, H), w2 is (H, F).
//
// What bounds it on an H100: at ViT-B/16 shapes one call is
// 4 x tokens x 768 x 3072 FLOP against 9.4 MB of bf16 weights. At the
// 197 tokens of one request it is bound by reading the weights (3.0 us);
// at the 1576 tokens of a batch of 8 by the tensor cores (15 us).
// The TPU kernel keeps both weight matrices in VMEM; 227 KB of shared
// memory cannot, and the fc2 accumulator of 64 tokens x 768 in f32 would
// fill an SM's register file. So the (tokens x F) intermediate G is
// written once in bf16 (9.7 MB at 1576 tokens, which stays in the 50 MB
// L2); the Pallas kernel rounds it to bf16 before fc2 anyway.
// Design: two wgmma GEMMs (bf16 in, f32 accumulate) whose operands arrive
// by TMA (128-byte swizzle) through a ring of stages that thread 0 keeps
// full ahead of the products; no float atomics, so the same inputs give
// the same bits.
// - fc1 (two warpgroups, one block an SM): a block owns 64 tokens and a
//   run of 128-wide F tiles. TMA brings the raw x tile straight into the
//   swizzled A slabs and the first eight W1 stages; the eight warps
//   normalise the tile in place (statistics and affine in f32, LN
//   parameters in registers), so A stays resident for the whole run while
//   W1 (F, H) streams K-major. Each warpgroup multiplies one 64-column
//   half of the tile (m64n64k16) and runs its epilogue: + b1 (loaded
//   before the products), quick-GELU in f32, bf16, store G. Two warps a
//   scheduler keep the LayerNorm and the epilogue, which are latency-bound
//   scalar code, from serialising.
// - fc2 (one warpgroup, two blocks an SM): a block owns 64 tokens x 128
//   outputs and a run of 64-wide chunks of F; G and W2 (H, F) both stream
//   (m64n128k16), G's ragged token edge reading as zeros. With one split
//   the epilogue adds b2 in f32, rounds, adds the bf16 residual and
//   rounds. Few tokens leave too few output tiles for the SMs, so F is
//   split; each split writes an f32 partial and a third kernel adds them
//   in split order, then b2 and the residual.
// The plan (token tiles, F runs, splits) comes from mlp_plan in
// ops/kernels/mlp.py.
// v3, the many-token design (mlp_plan takes it from MANY_TOKENS tokens on,
// SAM's encoder at 32,768 tokens among them). There a call is 309 GFLOP,
// 0.313 ms at the tensor cores' peak, and v2 ran at a quarter of that: fc1
// loaded and normalised each 64-token tile once for every two F tiles
// (twelve times a row), with the tensor cores idle meanwhile, and fc2's
// column tiles of one token tile ran a whole wave apart, so G came from
// HBM once for each. v3 normalises each row once, in a pass of its own
// (mlp_fc1_kernel_ln, v2's arithmetic, so its bf16 rows are v2's A
// operand), and runs fc1 and fc2 as one persistent GEMM design
// (many_gemm): a block an SM walks 128 x 128 output tiles in band order, a
// producer warpgroup keeps a ring of TMA loads in flight behind full and
// empty mbarriers, and two consumer warpgroups (232 registers each by
// setmaxnreg) take the tiles in turn, so one's epilogue (b1 and the GELU,
// or b2 and the residual, staged in shared memory and stored by TMA)
// overlaps the other's products. On an H100 at 32,768 tokens with the
// exact GELU a call takes 0.59 ms (v2 1.21): the products alone run at
// about 90% of the tensor cores' rate, the loads alone at about 10 TB/s
// from L2, and while one warpgroup's epilogue runs beside the other's
// products both slow, so fc1 with the erf epilogue (30 instructions an
// element) is bound by the two sharing an SM, and fc2 by the products
// and the loads together (PERF.md §6). Its outputs equal v2's bit for bit.
// v3 also takes SAM 2 Hiera-B+'s four widths, H 112, 224, 448 and 896 with
// F = 4H, which v2 does not build (mlp.py sends them to v3 at every token
// count). Their edges are ragged against v3's tiles: fc1's K = H is not a
// multiple of the 64-wide chunk at 112 and 224, so TMA fills the last
// chunk's columns past H with zeros in both xn and W1; fc2's N = H is not a
// multiple of the 128-wide tile at 112, 224 and 448 (nor fc1's N = F at
// 448), so the epilogue reads no bias past N and the TMA store clips there.
// At 112 a row is 14 sixteen-byte vectors, so the LayerNorm pass puts two
// rows on a warp and loads a few row groups before it normalises any,
// keeping as many bytes in flight as at 768. In stage 1 (65,536 tokens an
// image at 112) the MLP is bound by its bytes, 14.7 MB of x an image against
// 0.2 MB of weights, and fc1 by its erf epilogue (PERF.md §6).
// The tensor-parallel entry (istpu_mlp_partial_bf16) runs the same two
// stages on one model rank's F/T columns of fc1 and rows of fc2 and stops
// at the f32 sum: fc2 writes its f32 partials (into the output itself when
// F is not split) and a reduce adds the splits in order, with neither b2
// nor the residual. The model group all-reduces these f32 sums and adds
// b2 and the residual once (models/clip_vit.py). At ViT-B/16 with T = 2
// (F 1536) a call is half of K4's operations over half its weights.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace istpu {
namespace {

constexpr int kTM = 64;      // tokens per tile (M of wgmma)
constexpr int kTN = 128;     // output columns per tile (N of wgmma)
constexpr int kTK = 64;      // reduction columns per stage (one 128-byte swizzle row)
constexpr int kStages = 4;       // fc2: two blocks an SM
constexpr int kFc1Stages = 8;    // fc1: one block an SM beside its resident A tile
constexpr int kFc1Threads = 256;  // fc1: two warpgroups
constexpr uint32_t kSlabBytes = kTM * kTK * 2;   // 64 x 64 bf16, 8 KB
constexpr uint32_t kBTileBytes = kTN * kTK * 2;  // 128 x 64 bf16, 16 KB

template <int H>
constexpr size_t fc1_smem_bytes() {
  return 1024 + (H / kTK) * kSlabBytes + kFc1Stages * kBTileBytes +
         (kFc1Stages + 1) * sizeof(uint64_t);
}
constexpr size_t fc2_smem_bytes() {
  return 1024 + kStages * (kSlabBytes + kBTileBytes) + kStages * sizeof(uint64_t);
}

// h * sigmoid(1.702 h) in f32 with the SFU's exp and reciprocal. __expf's
// error grows with |x| (2 + floor(1.173 |x|) f32 ulps by the CUDA
// Programming Guide) and __fdividef adds 2; a bf16 step is 2^16 f32 ulps,
// so G can differ from the IEEE version only next to a bf16 rounding
// boundary (chip_smoke.py phase 3 measures the gap).
__device__ __forceinline__ float quick_gelu(float h) {
  return h * __fdividef(1.f, 1.f + __expf(-1.702f * h));
}

// The exact GELU, 0.5 h (1 + erf(h / sqrt 2)) in f32; CUDA's erff is within
// 2 f32 ulps (CUDA Programming Guide), far inside a bf16 step.
__device__ __forceinline__ float erf_gelu(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

enum Act { kQuickGelu = 0, kErfGelu = 1 };

template <int A>
__device__ __forceinline__ float gelu(float h) {
  return A == kErfGelu ? erf_gelu(h) : quick_gelu(h);
}

// LayerNorm of a row of H spread over L lanes of a warp (the whole warp,
// or 16 lanes where v3's LayerNorm pass puts two narrow rows side by side):
// lane l of the row's group owns the 16-byte vectors l + L u of the row
// (columns 8 (l + L u) .. +7).
template <int H, int L = 32>
__host__ __device__ constexpr int ln_per_lane() {
  return (H / 8 + L - 1) / L;
}

// This lane's LayerNorm weights and biases (columns past the row clamped).
template <int H>
__device__ __forceinline__ void ln_params(const float* __restrict__ ln_w,
                                          const float* __restrict__ ln_b, int lane,
                                          float (&lw)[ln_per_lane<H>()][8],
                                          float (&lb)[ln_per_lane<H>()][8]) {
#pragma unroll
  for (int u = 0; u < ln_per_lane<H>(); ++u)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = min(8 * (lane + 32 * u) + q, H - 1);
      lw[u][q] = ln_w[c];
      lb[u][q] = ln_b[c];
    }
}

// One row over a group of L lanes, `lane` this lane's place in it: v holds
// this lane's raw values (zeros past the row). Two-pass f32 statistics
// over the row, then (x - mu) * rstd * ln_w + ln_b rounded to bf16,
// vector u into out[u] (meaningless past the row). Every lane of the warp
// calls it together (the sums shuffle across the whole warp).
template <int H, int L = 32>
__device__ __forceinline__ void ln_row(const float (&v)[ln_per_lane<H, L>()][8],
                                       const float (&lw)[ln_per_lane<H, L>()][8],
                                       const float (&lb)[ln_per_lane<H, L>()][8], float eps,
                                       int lane, uint4 (&out)[ln_per_lane<H, L>()]) {
  constexpr int kVecs = H / 8, kPerLane = ln_per_lane<H, L>();
  float part[kPerLane];
#pragma unroll
  for (int u = 0; u < kPerLane; ++u)
    part[u] = ((v[u][0] + v[u][1]) + (v[u][2] + v[u][3])) +
              ((v[u][4] + v[u][5]) + (v[u][6] + v[u][7]));
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) sum += part[u];
  const float mu = warp_sum<L>(sum) / H;
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    float d[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) d[q] = lane + L * u < kVecs ? v[u][q] - mu : 0.f;
    part[u] = ((d[0] * d[0] + d[1] * d[1]) + (d[2] * d[2] + d[3] * d[3])) +
              ((d[4] * d[4] + d[5] * d[5]) + (d[6] * d[6] + d[7] * d[7]));
  }
  float ss = 0.f;
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) ss += part[u];
  const float rstd = rsqrtf(warp_sum<L>(ss) / H + eps);
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    uint32_t* pw = reinterpret_cast<uint32_t*>(&out[u]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      pw[q] = pack_bf16((v[u][2 * q] - mu) * rstd * lw[u][2 * q] + lb[u][2 * q],
                        (v[u][2 * q + 1] - mu) * rstd * lw[u][2 * q + 1] + lb[u][2 * q + 1]);
  }
}

// fc1: G[m, f] = bf16(GELU_A(LN(x)[m, :] . W1[f, :] + b1[f])).
// Grid (token tiles, F runs); run y covers F tiles [y * tiles, +tiles).
// Two warpgroups: both normalise rows, warpgroup w multiplies columns
// [64 w, 64 w + 64) of each 128-wide F tile and runs their epilogue.
template <int H, int A>
__global__ void __launch_bounds__(kFc1Threads)
mlp_fc1_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw1,
               const float* __restrict__ ln_w, const float* __restrict__ ln_b,
               const float* __restrict__ b1, bf16* __restrict__ g, int M, int F,
               int tiles_per_run, float eps) {
  static_assert(H % 128 == 0 && H <= 768, "unsupported hidden size");
  constexpr int kStages = kFc1Stages;
  constexpr int kChunks = H / kTK;
  constexpr int kVecs = H / 8;  // 16-byte vectors per row
  constexpr int kPerLane = ln_per_lane<H>();
  constexpr int kWarps = kFc1Threads / 32;
  constexpr int kHalf = kTN / 2;  // columns per warpgroup
  extern __shared__ unsigned char smem_raw[];
  unsigned char* As = align_1024(smem_raw);       // kChunks slabs of 64 x 64
  unsigned char* Bs = As + kChunks * kSlabBytes;  // kStages x (128 x 64)
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kStages * kBTileBytes);
  uint64_t* x_full = full + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7;
  const int m0 = blockIdx.x * kTM;
  const int f_tiles = (F + kTN - 1) / kTN;
  const int tile0 = blockIdx.y * tiles_per_run;
  const int tiles = min(tiles_per_run, f_tiles - tile0);
  const int loads = tiles * kChunks;  // load i: F tile tile0 + i / kChunks, chunk i % kChunks

  auto issue = [&](int i) {
    const int st = i % kStages;
    mbar_arrive_expect_tx(&full[st], kBTileBytes);
    tma_load_2d(Bs + st * kBTileBytes, &tw1, &full[st], (i % kChunks) * kTK,
                (tile0 + i / kChunks) * kTN);
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    mbar_init(x_full, 1);
    fence_barrier_init();
  }
  __syncthreads();  // every thread waits on x_full below
  if (tid == 0) {
    // The raw x tile lands in the A slabs, already in the swizzled layout
    // (rows past M read as zeros); W1's first stages follow.
    mbar_arrive_expect_tx(x_full, kChunks * kSlabBytes);
    for (int c = 0; c < kChunks; ++c) tma_load_2d(As + c * kSlabBytes, &tx, x_full, c * kTK, m0);
    for (int i = 0; i < min(kStages, loads); ++i) issue(i);
  }

  // LayerNorm in place (ln_row): warp w normalises rows 8 w .. 8 w + 7,
  // each written back where its raw vectors were; rows past M stay zero.
  float lw[kPerLane][8], lb[kPerLane][8];
  ln_params<H>(ln_w, ln_b, lane, lw, lb);
  mbar_wait(x_full, 0);
  constexpr int kRows = kTM / kWarps;
  const int rows = min(kRows, M - m0 - warp * kRows);
#pragma unroll 2
  for (int r = warp * kRows; r < warp * kRows + rows; ++r) {
    uint4* slot[kPerLane];
    float v[kPerLane][8];
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int vec = lane + 32 * u;
      slot[u] = reinterpret_cast<uint4*>(As + (vec / 8) * kSlabBytes +
                                         sw128_offset(r, 8 * (vec % 8)));
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (vec < kVecs) raw = *slot[u];
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int q = 0; q < 8; ++q) v[u][q] = __bfloat162float(e[q]);
    }
    uint4 packed[kPerLane];
    ln_row<H>(v, lw, lb, eps, lane, packed);
#pragma unroll
    for (int u = 0; u < kPerLane; ++u)
      if (lane + 32 * u < kVecs) *slot[u] = packed[u];
  }
  fence_proxy_async();  // the A tile's generic writes before wgmma reads them
  __syncthreads();

  // This thread's accumulator holds rows 16 (warp % 4) + gq (+ 8) and, of
  // each tile, columns 64 wg + 8 j + 2 gt (+ 1).
  const int gq = lane >> 2, gt = lane & 3;
  const int row0 = m0 + (warp & 3) * 16 + gq;
  float acc[32];
  for (int tile = 0; tile < tiles; ++tile) {
    const int f0 = (tile0 + tile) * kTN + wg * kHalf;
    // The tile's biases, loaded now so their latency hides behind the products.
    float bias[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = min(f0 + 8 * j + 2 * gt, F - 2);
      bias[j][0] = b1[f];
      bias[j][1] = b1[f + 1];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    for (int kc = 0; kc < kChunks; ++kc) {
      const int i = tile * kChunks + kc, st = i % kStages;
      mbar_wait(&full[st], (i / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk)
        wgmma_m64n64k16_ss(acc, kmajor_desc(As + kc * kSlabBytes + 32 * kk),
                              kmajor_desc(Bs + st * kBTileBytes + wg * (kBTileBytes / 2) +
                                          32 * kk));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      // Both warpgroups' products of load i - 1 are done: its stage takes
      // load i - 1 + kStages.
      if (kc >= 1 && i - 1 + kStages < loads) {
        named_barrier_sync(1, kFc1Threads);
        if (tid == 0) issue(i - 1 + kStages);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // The tile's last stage is free too.
    const int last = (tile + 1) * kChunks - 1;
    if (last + kStages < loads) {
      named_barrier_sync(1, kFc1Threads);
      if (tid == 0) issue(last + kStages);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = f0 + 8 * j + 2 * gt;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (f < F && row < M)
          *reinterpret_cast<uint32_t*>(g + static_cast<long long>(row) * F + f) =
              pack_bf16(gelu<A>(acc[4 * j + 2 * half] + bias[j][0]),
                        gelu<A>(acc[4 * j + 2 * half + 1] + bias[j][1]));
      }
    }
  }
}

// fc2: y[m, o] = G[m, :] . W2[o, :] over the split's chunks of F. One
// split and not `raw`: out = bf16(x + bf16(y + b2)); otherwise y to
// partial[split] (for `raw` with one split, partial is the f32 output).
// Grid (token tiles, H / 128, splits).
__global__ void __launch_bounds__(128)
mlp_fc2_kernel(const __grid_constant__ CUtensorMap tg, const __grid_constant__ CUtensorMap tw2,
               const bf16* __restrict__ x, const float* __restrict__ b2, bf16* __restrict__ out,
               float* __restrict__ partial, int M, int H, int F, int chunks_per_split,
               bool raw) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* As = align_1024(smem_raw);         // kStages x (64 x 64) of G
  unsigned char* Bs = As + kStages * kSlabBytes;    // kStages x (128 x 64) of W2
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kStages * kBTileBytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const int k_chunks = F / kTK;
  const int c0 = blockIdx.z * chunks_per_split;
  const int loads = min(chunks_per_split, k_chunks - c0);

  auto issue = [&](int i) {
    const int st = i % kStages;
    mbar_arrive_expect_tx(&full[st], kSlabBytes + kBTileBytes);
    tma_load_2d(As + st * kSlabBytes, &tg, &full[st], (c0 + i) * kTK, m0);
    tma_load_2d(Bs + st * kBTileBytes, &tw2, &full[st], (c0 + i) * kTK, n0);
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    fence_barrier_init();
    for (int i = 0; i < min(kStages, loads); ++i) issue(i);
  }
  __syncthreads();

  const int gq = lane >> 2, gt = lane & 3;
  const int row0 = m0 + warp * 16 + gq;
  // This thread's columns n0 + 8 j + 2 gt (+ 1): their biases, loaded now
  // so their latency hides behind the products.
  const bool epilogue = gridDim.z == 1 && !raw;
  float bias[16][2];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    bias[j][0] = epilogue ? b2[n0 + 8 * j + 2 * gt] : 0.f;
    bias[j][1] = epilogue ? b2[n0 + 8 * j + 2 * gt + 1] : 0.f;
  }
  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  for (int i = 0; i < loads; ++i) {
    const int st = i % kStages;
    mbar_wait(&full[st], (i / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk)
      wgmma_m64n128k16_ss(acc, kmajor_desc(As + st * kSlabBytes + 32 * kk),
                             kmajor_desc(Bs + st * kBTileBytes + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (tid == 0 && i >= 1 && i - 1 + kStages < loads) issue(i - 1 + kStages);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  if (epilogue) {
    // The residual, all loads issued before any is used.
    __nv_bfloat162 xv[16][2];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = min(row0 + 8 * half, M - 1);
        xv[j][half] = *reinterpret_cast<const __nv_bfloat162*>(
            x + static_cast<long long>(row) * H + n0 + 8 * j + 2 * gt);
      }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row >= M) continue;
        const float r0 = __bfloat162float(__float2bfloat16(acc[4 * j + 2 * half] + bias[j][0]));
        const float r1 =
            __bfloat162float(__float2bfloat16(acc[4 * j + 2 * half + 1] + bias[j][1]));
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * H + n0 + 8 * j +
                                           2 * gt) =
            __floats2bfloat162_rn(__low2float(xv[j][half]) + r0,
                                  __high2float(xv[j][half]) + r1);
      }
  } else {
    float* part = partial + static_cast<long long>(blockIdx.z) * M * H;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row < M)
          *reinterpret_cast<float2*>(part + static_cast<long long>(row) * H + n0 + 8 * j +
                                     2 * gt) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
  }
}

// out = bf16(x + bf16(sum of partials + b2)), the sum in split order, two
// columns per thread.
__global__ void mlp_reduce_kernel(const float* __restrict__ partial, int splits,
                                  const bf16* __restrict__ x, const float* __restrict__ b2,
                                  bf16* __restrict__ out, int M, int H) {
  const long long pairs = static_cast<long long>(M) * H / 2;
  const long long stride = static_cast<long long>(M) * H;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < pairs; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long idx = 2 * i;
    const int col = static_cast<int>(idx % H);
    float y0 = 0.f, y1 = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float2 p = *reinterpret_cast<const float2*>(partial + sp * stride + idx);
      y0 += p.x;
      y1 += p.y;
    }
    y0 = __bfloat162float(__float2bfloat16(y0 + b2[col]));
    y1 = __bfloat162float(__float2bfloat16(y1 + b2[col + 1]));
    const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + idx);
    *reinterpret_cast<__nv_bfloat162*>(out + idx) =
        __floats2bfloat162_rn(__low2float(xv) + y0, __high2float(xv) + y1);
  }
}

// out = sum of partials in split order, f32, no bias, no residual (the
// tensor-parallel entry), two columns per thread.
__global__ void mlp_reduce_raw_kernel(const float* __restrict__ partial, int splits,
                                      float* __restrict__ out, int M, int H) {
  const long long pairs = static_cast<long long>(M) * H / 2;
  const long long stride = static_cast<long long>(M) * H;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < pairs; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long idx = 2 * i;
    float2 y = make_float2(0.f, 0.f);
    for (int sp = 0; sp < splits; ++sp) {
      const float2 p = *reinterpret_cast<const float2*>(partial + sp * stride + idx);
      y.x += p.x;
      y.y += p.y;
    }
    *reinterpret_cast<float2*>(out + idx) = y;
  }
}

// ---- v3: many tokens --------------------------------------------------------

// x's LayerNorm written once, in bf16, for v3's fc1 to read by TMA; the
// arithmetic is v2's (ln_row), so the bits are v2's A operand. A row spans
// ln_lanes<H>() lanes: the warp, or 16 lanes at H <= 128, so that Hiera's
// 14-vector rows of 112 go two a warp. A warp loads ln_depth<H>() such row
// groups before it normalises any, about 2 KB of rows in flight however
// narrow they are (one row of 768; eight of 112), since the pass is bound by
// HBM. Warp w of a block takes the ln_rows<H>() rows from
// (8 blockIdx.x + w) ln_rows<H>(), then every 8 gridDim.x ln_rows<H>() on.
// The LayerNorm parameters sit in shared memory and are read again for every
// row group, so a thread holds little besides its rows and the SM keeps
// enough warps to have the bytes of many rows in flight.
template <int H>
__host__ __device__ constexpr int ln_lanes() {
  return H / 8 <= 16 ? 16 : 32;
}
template <int H>
__host__ __device__ constexpr int ln_depth() {
  return 1024 / (H * (32 / ln_lanes<H>())) > 1 ? 1024 / (H * (32 / ln_lanes<H>())) : 1;
}
template <int H>
__host__ __device__ constexpr int ln_rows() {  // rows a warp holds at once
  return (32 / ln_lanes<H>()) * ln_depth<H>();
}

template <int H>
__global__ void __launch_bounds__(256)
mlp_fc1_kernel_ln(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                  const float* __restrict__ ln_b, bf16* __restrict__ xn, int M, float eps) {
  constexpr int kLanes = ln_lanes<H>(), kSide = 32 / kLanes, kDepth = ln_depth<H>();
  constexpr int kRows = ln_rows<H>();
  constexpr int kVecs = H / 8, kPerLane = ln_per_lane<H, kLanes>();
  __shared__ __align__(16) float sw[kPerLane * kLanes * 8], sb[kPerLane * kLanes * 8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = lane % kLanes, side = lane / kLanes;  // place in the row's group; which row
  for (int c = threadIdx.x; c < kPerLane * kLanes * 8; c += 256) {
    sw[c] = ln_w[min(c, H - 1)];
    sb[c] = ln_b[min(c, H - 1)];
  }
  __syncthreads();
  for (int r0 = (blockIdx.x * 8 + warp) * kRows; r0 < M; r0 += gridDim.x * 8 * kRows) {
    float v[kDepth][kPerLane][8];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int r = r0 + kSide * d + side;
      const uint4* src = reinterpret_cast<const uint4*>(x + static_cast<long long>(r) * H);
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int vec = gl + kLanes * u;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (vec < kVecs && (kRows == 1 || r < M)) raw = src[vec];
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int q = 0; q < 8; ++q) v[d][u][q] = __bfloat162float(e[q]);
      }
    }
    asm volatile("" ::: "memory");  // read the parameters anew for each row group
    float lw[kPerLane][8], lb[kPerLane][8];
#pragma unroll
    for (int u = 0; u < kPerLane; ++u)
#pragma unroll
      for (int q = 0; q < 8; q += 4) {
        *reinterpret_cast<float4*>(&lw[u][q]) =
            *reinterpret_cast<const float4*>(&sw[8 * (gl + kLanes * u) + q]);
        *reinterpret_cast<float4*>(&lb[u][q]) =
            *reinterpret_cast<const float4*>(&sb[8 * (gl + kLanes * u) + q]);
      }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int r = r0 + kSide * d + side;
      uint4 packed[kPerLane];
      ln_row<H, kLanes>(v[d], lw, lb, eps, gl, packed);
      uint4* dst = reinterpret_cast<uint4*>(xn + static_cast<long long>(r) * H);
#pragma unroll
      for (int u = 0; u < kPerLane; ++u)
        if (gl + kLanes * u < kVecs && (kRows == 1 || r < M)) dst[u * kLanes + gl] = packed[u];
    }
  }
}

constexpr int kBand = 128;         // v3: tokens per tile, two m64 halves
constexpr int kV3Stages = 5;       // A and B chunks in flight
constexpr int kV3Threads = 384;    // a producer warpgroup and two consumers
constexpr uint32_t kBandBytes = kBand * kTK * 2;  // 128 x 64 bf16, 16 KB
constexpr uint32_t kOutTileBytes = kBand * kTN * 2;  // a consumer's 128 x 128 bf16 tile

constexpr size_t many_smem_bytes() {
  return 1024 + kV3Stages * (kBandBytes + kBTileBytes) + 2 * kOutTileBytes +
         (2 * kV3Stages + 4) * sizeof(uint64_t);
}

// One persistent GEMM of v3: out[m, n] = epilogue(A[m, :] . B[n, :]) over
// K / 64 chunks, in tiles of 128 rows x 128 columns. Block b takes tiles
// b, b + gridDim.x, ..., tile t being (band t / col_tiles, column tile
// t % col_tiles), so the tiles in flight on the card at once cover a few
// neighbouring bands: fc1's LayerNormed rows and fc2's G band are read from
// HBM once and served from L2 to every column tile. Warpgroup 0 is the
// producer (one thread issues every TMA load of the block's tiles, in
// order, through a ring of kV3Stages stages with full and empty
// mbarriers); warpgroups 1 and 2 are consumers and take the block's tiles
// in turn (ping-pong). A consumer starts its tile's products only after
// the other has issued all of its previous tile's (the `turn` mbarriers),
// so the products keep the ring's order and one consumer's epilogue
// overlaps the other's products. The epilogue stages the bf16 tile in
// shared memory in the swizzled layout and stores it by TMA:
//   fc1 (kFc2 false): bf16(GELU_A(acc + b1)) into G;
//   fc2: bf16(x + bf16(acc + b2)), the x tile loaded by TMA into the
//   staging buffer while the products run, into out.
// Each output's K sum is one pass over K in chunk order on one warpgroup,
// with v2's k16 steps: no split, no atomics. Ragged edges (Hiera's widths):
// K (fc1's H of 112 or 224) need not be a multiple of 64, nor N (fc2's H of
// 112, 224 or 448, fc1's F of 448) of 128. TMA reads the columns past K of
// both operands, and the rows past N of B, as zeros, so the last chunk adds
// zeros; the epilogue reads no bias past N and the TMA store writes nothing
// past N (a slab wholly past it is not stored, nor its residual loaded).
template <bool kFc2, int A>
__device__ __forceinline__ void many_gemm(const CUtensorMap* ta, const CUtensorMap* tb,
                                          const CUtensorMap* tout, const CUtensorMap* tres,
                                          const float* __restrict__ bias, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* As = align_1024(smem_raw);            // kV3Stages x (128 x 64)
  unsigned char* Bs = As + kV3Stages * kBandBytes;     // kV3Stages x (128 x 64)
  unsigned char* Os = Bs + kV3Stages * kBTileBytes;    // 2 x (128 x 128), two 64-column slabs
  uint64_t* full = reinterpret_cast<uint64_t*>(Os + 2 * kOutTileBytes);
  uint64_t* empty = full + kV3Stages;
  uint64_t* turn = empty + kV3Stages;  // [2]: consumer w may start its next products
  uint64_t* res_full = turn + 2;       // [2]: fc2's x tile has landed

  const int tid = threadIdx.x, wg = tid >> 7;
  const int col_tiles = (N + kTN - 1) / kTN;
  const int tiles = ((M + kBand - 1) / kBand) * col_tiles;
  const int chunks = (K + kTK - 1) / kTK;
  if (tid == 0) {
    for (int st = 0; st < kV3Stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4);  // lane 0 of each warp of the consuming warpgroup
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(&turn[c], 1);
      mbar_init(&res_full[c], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (tid != 0) return;
    int i = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / col_tiles) * kBand, n0 = (t % col_tiles) * kTN;
      for (int c = 0; c < chunks; ++c, ++i) {
        const int st = i % kV3Stages;
        if (i >= kV3Stages) mbar_wait(&empty[st], ((i / kV3Stages) - 1) & 1);
        mbar_arrive_expect_tx(&full[st], kBandBytes + kBTileBytes);
        tma_load_2d(As + st * kBandBytes, ta, &full[st], c * kTK, m0);
        tma_load_2d(Bs + st * kBTileBytes, tb, &full[st], c * kTK, n0);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int w = wg - 1, ctid = tid & 127, warp = ctid >> 5, lane = tid & 31;
  const int gq = lane >> 2, gt = lane & 3;
  unsigned char* Ob = Os + w * kOutTileBytes;
  int turns = 0, done = 0;  // waits on turn[w]; tiles finished
  int j = 0;                // the block's tile count so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
    if ((j & 1) != w) continue;
    const int m0 = (t / col_tiles) * kBand, n0 = (t % col_tiles) * kTN;
    const int i0 = j * chunks;  // the ring's load index of this tile's first chunk
    if (kFc2 && ctid == 0) {
      bulk_wait_read();  // the previous tile's store has read the staging buffer
      const bool two = n0 + kTK < N;  // the second slab lies wholly past N 448's last tile
      mbar_arrive_expect_tx(&res_full[w], two ? kOutTileBytes : kOutTileBytes / 2);
      tma_load_2d(Ob, tres, &res_full[w], n0, m0);
      if (two) tma_load_2d(Ob + kOutTileBytes / 2, tres, &res_full[w], n0 + kTK, m0);
    }
    if (j > 0) mbar_wait(&turn[w], (turns++) & 1);

    float acc[2][64];
#pragma unroll
    for (int q = 0; q < 64; ++q) acc[0][q] = acc[1][q] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const int i = i0 + c, st = i % kV3Stages;
      mbar_wait(&full[st], (i / kV3Stages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        const uint64_t db = kmajor_desc(Bs + st * kBTileBytes + 32 * kk);
        wgmma_m64n128k16_ss(acc[0], kmajor_desc(As + st * kBandBytes + 32 * kk), db);
        wgmma_m64n128k16_ss(acc[1], kmajor_desc(As + st * kBandBytes + kBandBytes / 2 + 32 * kk),
                            db);
      }
      wgmma_commit();
      if (c == chunks - 1 && ctid == 0) mbar_arrive(&turn[1 - w]);
      wgmma_wait<1>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (c >= 1 && lane == 0) mbar_arrive(&empty[(i - 1) % kV3Stages]);
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (lane == 0) mbar_arrive(&empty[(i0 + chunks - 1) % kV3Stages]);

    // Epilogue. This thread holds, of half h, rows 64 h + 16 warp + gq (+ 8)
    // and columns 8 jj + 2 gt (+ 1) of the tile (hopper.cuh's layout).
    if (kFc2) {
      mbar_wait(&res_full[w], done & 1);
    } else {
      if (ctid == 0) bulk_wait_read();
      named_barrier_sync(1 + w, 128);  // the staging buffer is free
    }
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int col = 8 * jj + 2 * gt;
      float2 bb = make_float2(0.f, 0.f);
      if (n0 + col < N) bb = *reinterpret_cast<const float2*>(bias + n0 + col);
      unsigned char* slab = Ob + (jj / 8) * (kOutTileBytes / 2);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 64 * h + 16 * warp + gq + 8 * half;
          uint32_t* p = reinterpret_cast<uint32_t*>(slab + sw128_offset(row, col % kTK));
          const float a0 = acc[h][4 * jj + 2 * half], a1 = acc[h][4 * jj + 2 * half + 1];
          if (kFc2) {
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(p);
            const float r0 = __bfloat162float(__float2bfloat16(a0 + bb.x));
            const float r1 = __bfloat162float(__float2bfloat16(a1 + bb.y));
            const __nv_bfloat162 o =
                __floats2bfloat162_rn(__low2float(xv) + r0, __high2float(xv) + r1);
            *p = *reinterpret_cast<const uint32_t*>(&o);
          } else {
            *p = pack_bf16(gelu<A>(a0 + bb.x), gelu<A>(a1 + bb.y));
          }
        }
    }
    fence_proxy_async();  // the generic writes before the TMA store reads them
    named_barrier_sync(1 + w, 128);
    if (ctid == 0) {
      tma_store_2d(tout, Ob, n0, m0);
      if (n0 + kTK < N) tma_store_2d(tout, Ob + kOutTileBytes / 2, n0 + kTK, m0);
      bulk_commit();
    }
    ++done;
  }
  if (ctid == 0) bulk_wait();
}

// v3's fc1: G = bf16(GELU_A(xn . W1^T + b1)), xn the LayerNormed x.
template <int A>
__global__ void __launch_bounds__(kV3Threads, 1)
mlp_fc1_kernel_ws(const __grid_constant__ CUtensorMap txn, const __grid_constant__ CUtensorMap tw1,
                  const __grid_constant__ CUtensorMap tg, const float* __restrict__ b1, int M,
                  int F, int H) {
  many_gemm<false, A>(&txn, &tw1, &tg, nullptr, b1, M, F, H);
}

// v3's fc2: out = bf16(x + bf16(G . W2^T + b2)).
__global__ void __launch_bounds__(kV3Threads, 1)
mlp_fc2_kernel_ws(const __grid_constant__ CUtensorMap tg, const __grid_constant__ CUtensorMap tw2,
                  const __grid_constant__ CUtensorMap tout, const __grid_constant__ CUtensorMap tx,
                  const float* __restrict__ b2, int M, int H, int F) {
  many_gemm<true, 0>(&tg, &tw2, &tout, &tx, b2, M, H, F);
}

// A 2-D map over a row-major (rows, cols) bf16 matrix, boxes of
// box_rows x 64 columns.
cudaError_t matrix_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kTK, static_cast<cuuint32_t>(box_rows)};
  return make_tensor_map(map, base, 2, dims, strides, box);
}

template <int H, int A>
cudaError_t launch_fc1_act(const CUtensorMap& tx, const CUtensorMap& tw1, const float* ln_w,
                           const float* ln_b, const float* b1, bf16* g, int M, int F, int runs,
                           int tiles_per_run, float eps, cudaStream_t stream) {
  constexpr size_t smem = fc1_smem_bytes<H>();
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fc1_kernel<H, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kTM - 1) / kTM, runs);
  mlp_fc1_kernel<H, A><<<grid, kFc1Threads, smem, stream>>>(tx, tw1, ln_w, ln_b, b1, g, M, F,
                                                    tiles_per_run, eps);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_fc1(const CUtensorMap& tx, const CUtensorMap& tw1, const float* ln_w,
                       const float* ln_b, const float* b1, bf16* g, int M, int F, int runs,
                       int tiles_per_run, float eps, int act, cudaStream_t stream) {
  if (act == kErfGelu)
    return launch_fc1_act<H, kErfGelu>(tx, tw1, ln_w, ln_b, b1, g, M, F, runs, tiles_per_run,
                                       eps, stream);
  return launch_fc1_act<H, kQuickGelu>(tx, tw1, ln_w, ln_b, b1, g, M, F, runs, tiles_per_run,
                                       eps, stream);
}

// Both entries: fc1 over `runs` x `tiles_per_run` F tiles of 128, fc2 over
// `splits` x `chunks_per_split` chunks of 64 (ops/kernels/mlp.py: mlp_plan).
// With `raw`, out_f32 receives the f32 fc2 sums (no b2, no residual);
// otherwise out receives bf16(x + bf16(fc2 + b2)). `act` picks the GELU.
cudaError_t run_mlp(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                    const void* b1, const void* w2, const void* b2, void* g, void* partial,
                    bf16* out, float* out_f32, bool raw, int M, int H, int F, int runs,
                    int tiles_per_run, int splits, int chunks_per_split, float eps, int act,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int f_tiles = (F + kTN - 1) / kTN, k_chunks = F / kTK;
  if (M <= 0 || F <= 0 || F % kTK != 0 || H % kTN != 0 || runs <= 0 || tiles_per_run <= 0 ||
      (runs - 1) * tiles_per_run >= f_tiles || runs * tiles_per_run < f_tiles ||
      splits <= 0 || chunks_per_split <= 0 || (splits - 1) * chunks_per_split >= k_chunks ||
      splits * chunks_per_split < k_chunks || (splits > 1 && partial == nullptr) ||
      (act != kQuickGelu && act != kErfGelu))
    return cudaErrorInvalidValue;
  const auto* xp = static_cast<const bf16*>(x);
  const auto* lw = static_cast<const float*>(ln_w);
  const auto* lb = static_cast<const float*>(ln_b);
  const auto* b1p = static_cast<const float*>(b1);
  const auto* b2p = static_cast<const float*>(b2);
  auto* gp = static_cast<bf16*>(g);
  auto* pp = static_cast<float*>(partial);
  auto s = static_cast<cudaStream_t>(stream);

  CUtensorMap tx, tw1, tg, tw2;
  if ((err = matrix_map(&tx, x, M, H, kTM)) != cudaSuccess) return err;
  if ((err = matrix_map(&tw1, w1, F, H, kTN)) != cudaSuccess) return err;
  if ((err = matrix_map(&tg, g, M, F, kTM)) != cudaSuccess) return err;
  if ((err = matrix_map(&tw2, w2, H, F, kTN)) != cudaSuccess) return err;

  switch (H) {
#define ISTPU_FC1_CASE(HH)                                                                  \
  case HH:                                                                                  \
    err = launch_fc1<HH>(tx, tw1, lw, lb, b1p, gp, M, F, runs, tiles_per_run, eps, act, s); \
    break;
    ISTPU_FC1_CASE(128)
    ISTPU_FC1_CASE(256)
    ISTPU_FC1_CASE(384)
    ISTPU_FC1_CASE(512)
    ISTPU_FC1_CASE(640)
    ISTPU_FC1_CASE(768)
#undef ISTPU_FC1_CASE
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  constexpr size_t smem2 = fc2_smem_bytes();
  err = cudaFuncSetAttribute(mlp_fc2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return err;
  const dim3 grid2((M + kTM - 1) / kTM, H / kTN, splits);
  mlp_fc2_kernel<<<grid2, 128, smem2, s>>>(tg, tw2, xp, b2p, out,
                                           raw && splits == 1 ? out_f32 : pp, M, H, F,
                                           chunks_per_split, raw);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long pairs = static_cast<long long>(M) * H / 2;
  const int blocks = static_cast<int>(std::min<long long>((pairs + 255) / 256, 1024));
  if (raw)
    mlp_reduce_raw_kernel<<<blocks, 256, 0, s>>>(pp, splits, out_f32, M, H);
  else
    mlp_reduce_kernel<<<blocks, 256, 0, s>>>(pp, splits, xp, b2p, out, M, H);
  return cudaGetLastError();
}

template <int A>
cudaError_t launch_fc1_many(const CUtensorMap& txn, const CUtensorMap& tw1, const CUtensorMap& tg,
                            const float* b1, int M, int F, int H, int blocks, cudaStream_t s) {
  constexpr size_t smem = many_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fc1_kernel_ws<A>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mlp_fc1_kernel_ws<A><<<blocks, kV3Threads, smem, s>>>(txn, tw1, tg, b1, M, F, H);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_ln(const bf16* x, const float* ln_w, const float* ln_b, bf16* xn, int M,
                      float eps, int sms, cudaStream_t s) {
  constexpr int kBlockRows = 8 * ln_rows<H>();
  const int blocks = std::min((M + kBlockRows - 1) / kBlockRows, 8 * sms);
  mlp_fc1_kernel_ln<H><<<blocks, 256, 0, s>>>(x, ln_w, ln_b, xn, M, eps);
  return cudaGetLastError();
}

// v3 (ops/kernels/mlp.py: mlp_plan picks it for many tokens, and at every
// token count at a width v2 does not build): the LayerNorm pass into xn,
// then fc1 into g and fc2 into out, each a persistent grid of at most `sms`
// blocks. H is one of v3's widths: SAM ViT-B's 768 and Hiera-B+'s 112, 224,
// 448 and 896 (mlp.py MANY_TOKEN_HIDDEN).
cudaError_t run_mlp_many(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                         const void* b1, const void* w2, const void* b2, void* xn, void* g,
                         void* out, int M, int H, int F, int sms, float eps, int act, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0 || F <= 0 || F % kTK != 0 || sms <= 0 || (act != kQuickGelu && act != kErfGelu))
    return cudaErrorInvalidValue;
  const auto* xp = static_cast<const bf16*>(x);
  const auto* lw = static_cast<const float*>(ln_w);
  const auto* lb = static_cast<const float*>(ln_b);
  auto* xnp = static_cast<bf16*>(xn);
  auto s = static_cast<cudaStream_t>(stream);

  switch (H) {
#define ISTPU_LN_CASE(HH)                                 \
  case HH:                                                \
    err = launch_ln<HH>(xp, lw, lb, xnp, M, eps, sms, s); \
    break;
    ISTPU_LN_CASE(112)
    ISTPU_LN_CASE(224)
    ISTPU_LN_CASE(448)
    ISTPU_LN_CASE(768)
    ISTPU_LN_CASE(896)
#undef ISTPU_LN_CASE
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  CUtensorMap txn, tw1, tg, tw2, tout, tx;
  if ((err = matrix_map(&txn, xn, M, H, kBand)) != cudaSuccess) return err;
  if ((err = matrix_map(&tw1, w1, F, H, kTN)) != cudaSuccess) return err;
  if ((err = matrix_map(&tg, g, M, F, kBand)) != cudaSuccess) return err;
  if ((err = matrix_map(&tw2, w2, H, F, kTN)) != cudaSuccess) return err;
  if ((err = matrix_map(&tout, out, M, H, kBand)) != cudaSuccess) return err;
  if ((err = matrix_map(&tx, x, M, H, kBand)) != cudaSuccess) return err;

  const int bands = (M + kBand - 1) / kBand;
  const int blocks1 = std::min(sms, bands * ((F + kTN - 1) / kTN));
  const auto* b1p = static_cast<const float*>(b1);
  err = act == kErfGelu ? launch_fc1_many<kErfGelu>(txn, tw1, tg, b1p, M, F, H, blocks1, s)
                        : launch_fc1_many<kQuickGelu>(txn, tw1, tg, b1p, M, F, H, blocks1, s);
  if (err != cudaSuccess) return err;

  constexpr size_t smem = many_smem_bytes();
  err = cudaFuncSetAttribute(mlp_fc2_kernel_ws, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks2 = std::min(sms, bands * ((H + kTN - 1) / kTN));
  mlp_fc2_kernel_ws<<<blocks2, kV3Threads, smem, s>>>(tg, tw2, tout, tx,
                                                      static_cast<const float*>(b2), M, H, F);
  return cudaGetLastError();
}

}  // namespace
}  // namespace istpu

extern "C" {

// x, out: contiguous bf16 (M, H); w1: bf16 (F, H); w2: bf16 (H, F);
// ln_w, ln_b, b2: f32 (H,); b1: f32 (F,); g: bf16 scratch (M, F);
// partial: f32 scratch (splits, M, H), unused when splits is 1.
// H in {128, 256, ..., 768}, F a multiple of 64. fc1 runs over
// `runs` x `tiles_per_run` F tiles of 128, fc2 over `splits` x
// `chunks_per_split` chunks of 64 (ops/kernels/mlp.py: mlp_plan). `act`:
// 0 quick GELU, 1 the exact erf GELU. Returns a cudaError_t.
int istpu_mlp_bf16(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                   const void* b1, const void* w2, const void* b2, void* g, void* partial,
                   void* out, int M, int H, int F, int runs, int tiles_per_run, int splits,
                   int chunks_per_split, float eps, int act, int device, void* stream) {
  if (b2 == nullptr) return cudaErrorInvalidValue;
  return istpu::run_mlp(x, ln_w, ln_b, w1, b1, w2, b2, g, partial,
                        static_cast<istpu::bf16*>(out), nullptr, false, M, H, F, runs,
                        tiles_per_run, splits, chunks_per_split, eps, act, device, stream);
}

// The tensor-parallel entry: out is f32 (M, H), the fc2 sums over this
// rank's F columns, with no b2 and no residual; the other arguments as
// istpu_mlp_bf16's.
int istpu_mlp_partial_bf16(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                           const void* b1, const void* w2, void* g, void* partial, void* out,
                           int M, int H, int F, int runs, int tiles_per_run, int splits,
                           int chunks_per_split, float eps, int device, void* stream) {
  return istpu::run_mlp(x, ln_w, ln_b, w1, b1, w2, nullptr, g, partial, nullptr,
                        static_cast<float*>(out), true, M, H, F, runs, tiles_per_run, splits,
                        chunks_per_split, eps, istpu::kQuickGelu, device, stream);
}

// v3, the many-token design: the arguments as istpu_mlp_bf16's, H one of
// 112, 224, 448, 768 and 896, with xn a bf16 (M, H) scratch for the LayerNormed x and `sms` the persistent
// grid's size (the card's SM count); no partials.
int istpu_mlp_many_bf16(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                        const void* b1, const void* w2, const void* b2, void* xn, void* g,
                        void* out, int M, int H, int F, int sms, float eps, int act, int device,
                        void* stream) {
  if (b2 == nullptr) return cudaErrorInvalidValue;
  return istpu::run_mlp_many(x, ln_w, ln_b, w1, b1, w2, b2, xn, g, out, M, H, F, sms, eps, act,
                             device, stream);
}

}  // extern "C"
