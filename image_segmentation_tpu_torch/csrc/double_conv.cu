// K1 v3: 3x3 convolution (pad 1) with a per-channel scale, bias and ReLU,
// NHWC bf16, for Hopper. Two launches make the fused double conv.
//
// Replaces image_segmentation_tpu/ops/pallas/double_conv.py:_dc_kernel
// (fused_double_conv, pallas_call at :185), the block of every UNet level.
// Semantics are the Pallas kernel's, cast for cast:
//   conv1 accumulated in f32, then * scale1 + bias1 and ReLU in f32;
//   the intermediate is zero outside the image and rounded to bf16;
//   conv2 accumulated in f32, then * scale2 + bias2 and ReLU;
//   the output rounded to bf16.
// The wrapper (ops/kernels/double_conv.py) runs this kernel twice through
// a bf16 intermediate in device memory. Only pixels inside the image are
// written, and the second launch loads the border as zeros, so conv2 sees
// exactly the masked, bf16-rounded intermediate of the Pallas kernel. The
// up block's concat [skip, up] is not materialised: conv1 reads its input
// channels from two tensors (two tensor maps), the skip's first.
//
// What bounds it on an H100: at UNet-64 widths a conv does from 12 (the
// RGB stem's first conv) to about 400 multiply-adds per byte it must move,
// so the nine levels of one 256 px request are bound by the tensor cores
// (92 GFLOP; 0.094 ms at 989 TFLOP/s and 3.35 TB/s) but for the stem and
// the 16x16 level, whose 28 MB of weights are read for 256 pixels. v2 ran
// on the warp-level m16n8k16 product with 16-channel K steps, a two-stage
// ring of per-thread asynchronous copies and 64 output channels a block.
// In practice an implicit GEMM here is bound by
// what feeds the tensor cores: the bytes TMA moves from L2 into shared
// memory per multiply-add (about 8 TB/s at most), the shared-memory reads
// of wgmma, and the epilogue's stores.
// Design of v3:
//   * implicit GEMM per conv: a tile is M = 256 output pixels (16 rows x
//     16 columns of one image) by 64 output channels; K = 9 taps x Cin
//     runs in steps of one 64-channel chunk and one column offset dx;
//   * A operand by TMA, one 4-D box (64 ch, 16 w, 18 h, 1 n) per step at
//     (c, ow0 - 1 + dx, oh0 - 1, n): TMA fills everything outside the
//     tensor with zeros, which is the conv's zero padding, the ragged
//     right and bottom edges and the channels past Cin. The box's rows are
//     its pixels in order, 16 to a line, so the A operand of tap (dy, dx)
//     for a warpgroup's four output lines is the 64 rows starting at line
//     4 wg + dy: a 128-byte-swizzled K-major slab at a 2 KB offset, with
//     no halo arithmetic. One box serves three taps, so the input moves
//     3 x 18/16 times per chunk, not 9 times;
//   * B operand by TMA straight from the HWIO weights, MN-major: three
//     boxes (64 co, 64 ci) of the (Cout, Cin, 9) view per step, one per
//     dy, read with wgmma's transpose flag;
//   * wgmma m64n64k16 (bf16 in, f32 accumulate), four consumer warpgroups
//     of four output lines each; a ring of three 60 KB stages with
//     full/empty mbarriers, kept full by one producer warp;
//   * persistent: one block an SM walks over the tiles, and the producer
//     runs ahead into the next tile's loads while the consumers finish;
//   * the epilogue applies scale, bias and ReLU in f32, writes bf16 into a
//     swizzled 8 KB staging tile per warpgroup and leaves it to one TMA
//     store, which skips pixels outside the image and channels past Cout;
//     the consumers go on to the next tile while it drains;
//   * split-K where the tiles are fewer than the SMs (conv_plan in the
//     wrapper): each split writes f32 partials over its run of K steps and
//     a second kernel adds them in split order and applies the epilogue.
//     No atomics: two calls give the same bits.
// Found on the card (PERF.md): 128-channel tiles fit only two stages
// beside a 36 KB A box and measured slower at every level; the TMA store
// halved the time of the 256x256 levels, whose epilogue of 4-byte global
// stores had taken as long as their products.
#include "common.cuh"
#include "hopper.cuh"

namespace istpu {
namespace {

constexpr int kTH = 16;                      // output rows per block
constexpr int kTW = 16;                      // output columns per block
constexpr int kKC = 64;                      // input channels per K step
constexpr int kConsumerWarps = 16;           // four consumer warpgroups, 4 rows each
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // + one producer warp
constexpr uint32_t kLineBytes = kTW * kKC * 2;       // one input line of the tile, 2 KB
constexpr uint32_t kABytes = (kTH + 2) * kLineBytes; // 18 lines x 16 px x 64 ch, 36 KB

constexpr int kBN = 64;                              // output channels per tile
constexpr uint32_t kBTapBytes = kKC * kBN * 2;       // one tap's 64 ci x 64 co, 8 KB
constexpr uint32_t kStageBytes = kABytes + 3 * kBTapBytes;  // 60 KB
constexpr int kStages = 3;
constexpr uint32_t kOutBytes = 64 * kBN * 2;         // a warpgroup's 64 pixels x 64 co, 8 KB
constexpr size_t kSmemBytes = 1024 + kStages * kStageBytes + 4 * kOutBytes + 2 * kStages * 8;

struct ConvParams {
  const float* scale;   // (Cout)
  const float* bias;    // (Cout)
  bf16* y;              // (N, H, W, Cout)
  float* partial;       // (splits, N*H*W, Cout) when splits > 1
  long long pixels;     // N*H*W
  int H, W, Cout;
  int c0;               // channels of the first source (the weight row of the second's 0)
  int chunks0, chunks;  // K chunks of the first source, of both
  int tiles_w, tiles_hw, tiles_n, tiles, splits, per_split;
};

// Output tile t, spatial tiles fastest, then channel tiles, then (image,
// split): neighbouring blocks share input halos and weights in L2.
struct TileCoord {
  int oh0, ow0, co0, n, split, k0, steps;
  __device__ TileCoord(const ConvParams& p, int t) {
    const int hw = t % p.tiles_hw;
    const int r = t / p.tiles_hw;
    oh0 = (hw / p.tiles_w) * kTH;
    ow0 = (hw % p.tiles_w) * kTW;
    co0 = (r % p.tiles_n) * kBN;
    n = r / p.tiles_n / p.splits;
    split = r / p.tiles_n % p.splits;
    k0 = split * p.per_split;
    steps = min(p.per_split, 3 * p.chunks - k0);
  }
};

// Persistent: block b takes tiles b, b + gridDim.x, ... The producer warp
// runs through the same sequence of K steps, up to kStages ahead of the
// consumers, so the next tile's loads overlap this tile's epilogue.
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap tx0, const __grid_constant__ CUtensorMap tx1,
               const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap ty,
               const ConvParams p) {
  constexpr int S = kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);
  unsigned char* out_stage = ring + S * kStageBytes;  // 4 x 8 KB, one a warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(out_stage + 4 * kOutBytes);
  uint64_t* empty = full + S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();  // every barrier initialised before anyone waits on it

  if (warp == kConsumerWarps) {
    // Producer: step i of a tile is (chunk, dx) = divmod(k0 + i, 3): the
    // tile's 18 input lines at column offset dx - 1, and the weights of
    // the taps (0, dx), (1, dx), (2, dx). q counts steps over all tiles.
    if (lane == 0) {
      int q = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const TileCoord c(p, t);
        for (int i = 0; i < c.steps; ++i, ++q) {
          const int st = q % S;
          if (q >= S) mbar_wait(&empty[st], ((q / S) + 1) & 1);
          const int k = c.k0 + i, chunk = k / 3, dx = k - 3 * chunk;
          const bool second = chunk >= p.chunks0;
          const int ch = (second ? chunk - p.chunks0 : chunk) * kKC;
          unsigned char* a = ring + st * kStageBytes;
          mbar_arrive_expect_tx(&full[st], kStageBytes);
          tma_load_4d(a, second ? &tx1 : &tx0, &full[st], ch, c.ow0 - 1 + dx, c.oh0 - 1, c.n);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
            tma_load_3d(a + kABytes + dy * kBTapBytes, &tw, &full[st], c.co0,
                        second ? p.c0 + ch : ch, 3 * dy + dx);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns output lines 4 wg .. 4 wg + 3. The A
  // operand of tap (dy, dx) is the 64 rows of input lines 4 wg + dy .. + 3
  // of the stage's dx box: 16 rows a line, so a K-major slab at a line
  // offset, 1024-byte aligned like the box.
  const int wg = warp >> 2;
  const int g = lane >> 2, tq = lane & 3;
  const bool partial = p.splits > 1;
  float acc[kBN / 2];
  int q = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const TileCoord c(p, t);
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) acc[j] = 0.f;
    for (int i = 0; i < c.steps; ++i, ++q) {
      const int st = q % S;
      mbar_wait(&full[st], (q / S) & 1);
      const unsigned char* a = ring + st * kStageBytes + 4 * wg * kLineBytes;
      const unsigned char* b = ring + st * kStageBytes + kABytes;
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk)
          wgmma_m64n64k16_ss<1>(acc, kmajor_desc(a + dy * kLineBytes + 32 * kk),
                                mnmajor_desc(b + dy * kBTapBytes + 2048 * kk));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      // This warp's products of step q - 1 are done: release its stage.
      if (i >= 1 && lane == 0) mbar_arrive(&empty[(q - 1) % S]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(q - 1) % S]);  // the tile's last stage

    // Epilogue: acc[4 j + 2 h + e] is pixel (row 4 wg + warp % 4, column
    // g + 8 h), output channel co0 + 8 j + 2 tq + e.
    if (partial) {  // f32 partial sums, straight to global memory
      const int oh = c.oh0 + 4 * wg + (warp & 3);
      if (oh >= p.H) continue;
      const long long row = (static_cast<long long>(c.n) * p.H + oh) * p.W;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int co = c.co0 + 8 * j + 2 * tq;
        if (co >= p.Cout) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ow = c.ow0 + g + 8 * h;
          if (ow < p.W)
            *reinterpret_cast<float2*>(p.partial + (c.split * p.pixels + row + ow) * p.Cout +
                                       co) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      continue;
    }
    // scale, bias and ReLU in f32, bf16 into the warpgroup's 8 KB staging
    // tile (64 pixels x 64 channels, 128-byte swizzle: conflict-free), then
    // one TMA store of it; the tensor store skips pixels outside the image
    // and channels past Cout.
    unsigned char* stage_out = out_stage + wg * kOutBytes;
    if (tid % 128 == 0) bulk_wait_read();  // the last tile's store has read the staging tile
    named_barrier_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int co = min(c.co0 + 8 * j + 2 * tq, p.Cout - 2);
      const float2 sc = *reinterpret_cast<const float2*>(p.scale + co);
      const float2 bi = *reinterpret_cast<const float2*>(p.bias + co);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * (warp & 3) + g + 8 * h;  // r % 8 == g
        *reinterpret_cast<uint32_t*>(stage_out + r * 128 + ((j ^ g) << 4) + 4 * tq) =
            pack_bf16(fmaxf(acc[4 * j + 2 * h] * sc.x + bi.x, 0.f),
                      fmaxf(acc[4 * j + 2 * h + 1] * sc.y + bi.y, 0.f));
      }
    }
    fence_proxy_async();  // the generic writes before the async-proxy store reads them
    named_barrier_sync(1 + wg, 128);
    if (tid % 128 == 0) {
      tma_store_4d(&ty, stage_out, c.co0, c.ow0, c.oh0 + 4 * wg, c.n);
      bulk_commit();
    }
  }
  if (tid % 128 == 0) bulk_wait();  // every store complete before the block exits
}

// Sum of the split-K partials in split order, then scale, bias, ReLU and
// the bf16 store; four channels a thread.
__global__ void splitk_epilogue(const float* __restrict__ partial,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias, bf16* __restrict__ y,
                                long long pixels, int Cout, int splits) {
  const int quads = Cout / 4;
  const long long total = pixels * quads;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long px = i / quads;
    const int co = static_cast<int>(i - px * quads) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float4 q = *reinterpret_cast<const float4*>(partial + (s * pixels + px) * Cout + co);
      v.x += q.x;
      v.y += q.y;
      v.z += q.z;
      v.w += q.w;
    }
    const float4 sc = *reinterpret_cast<const float4*>(scale + co);
    const float4 bi = *reinterpret_cast<const float4*>(bias + co);
    *reinterpret_cast<uint2*>(y + px * Cout + co) =
        make_uint2(pack_bf16(fmaxf(v.x * sc.x + bi.x, 0.f), fmaxf(v.y * sc.y + bi.y, 0.f)),
                   pack_bf16(fmaxf(v.z * sc.z + bi.z, 0.f), fmaxf(v.w * sc.w + bi.w, 0.f)));
  }
}

// A 4-D map over an NHWC bf16 tensor: boxes of 64 channels x 16 columns x
// 18 rows of one image (a tile's rows and their halo).
cudaError_t activation_map(CUtensorMap* map, const void* base, int N, int H, int W, int C) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t box[4] = {kKC, kTW, kTH + 2, 1};
  return make_tensor_map(map, base, 4, dims, strides, box);
}

// A 3-D map over HWIO weights viewed as (Cout, Cin, 9), innermost first:
// boxes of 64 output channels x 64 input channels of one tap.
cudaError_t weight_map(CUtensorMap* map, const void* base, int Cin, int Cout) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Cout), static_cast<cuuint64_t>(Cin), 9};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Cout) * 2,
                                 static_cast<cuuint64_t>(Cin) * Cout * 2};
  const cuuint32_t box[3] = {64, kKC, 1};
  return make_tensor_map(map, base, 3, dims, strides, box);
}

// The output: boxes of 64 channels x 16 columns x 4 rows of one image, a
// warpgroup's share of a tile.
cudaError_t output_map(CUtensorMap* map, const void* base, int N, int H, int W, int C) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t box[4] = {64, kTW, 4, 1};
  return make_tensor_map(map, base, 4, dims, strides, box);
}

cudaError_t launch_conv(const CUtensorMap& tx0, const CUtensorMap& tx1, const CUtensorMap& tw,
                        const CUtensorMap& ty, const ConvParams& p, int blocks,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  conv3x3_kernel<<<blocks, kThreads, kSmemBytes, stream>>>(tx0, tx1, tw, ty, p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace istpu

extern "C" {

// One conv3x3 (pad 1) -> * scale + bias -> ReLU, NHWC bf16 -> NHWC bf16,
// over the channel concat of x0 (C0 channels) and x1 (C1, or none when
// C1 is 0): x0, x1 contiguous (N, H, W, C*) with C* % 8 == 0; w
// contiguous HWIO (3, 3, C0 + C1, Cout) with Cout % 8 == 0; scale, bias:
// f32 (Cout); y: contiguous (N, H, W, Cout); partial: f32 (splits, N*H*W,
// Cout) when splits > 1. All 16-byte aligned. The 3 x (ceil(C0 / 64) +
// ceil(C1 / 64)) K steps are cut into `splits` runs of `per_split`, and
// `blocks` persistent blocks share the tiles x splits
// (ops/kernels/double_conv.py: conv_plan); a cut that does not cover the
// steps is refused. Returns a cudaError_t.
int istpu_conv3x3_bf16(const void* x0, const void* x1, const void* w, const void* scale,
                       const void* bias, void* y, void* partial, int N, int H, int W, int C0,
                       int C1, int Cout, int splits, int per_split, int blocks,
                       int device, void* stream) {
  using namespace istpu;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int chunks0 = (C0 + kKC - 1) / kKC;
  const int chunks = chunks0 + (C1 + kKC - 1) / kKC;
  const int steps = 3 * chunks;
  if (N < 1 || H < 1 || W < 1 || C0 < 8 || C0 % 8 || C1 < 0 || C1 % 8 ||
      (C1 > 0) != (x1 != nullptr) || Cout < 8 || Cout % 8 ||
      splits < 1 || per_split < 1 || (splits - 1) * per_split >= steps ||
      splits * per_split < steps || (splits > 1 && partial == nullptr) || blocks < 1)
    return cudaErrorInvalidValue;
  CUtensorMap tx0, tx1, tw;
  if ((err = activation_map(&tx0, x0, N, H, W, C0)) != cudaSuccess) return err;
  if (C1 > 0) {
    if ((err = activation_map(&tx1, x1, N, H, W, C1)) != cudaSuccess) return err;
  } else {
    tx1 = tx0;
  }
  if ((err = weight_map(&tw, w, C0 + C1, Cout)) != cudaSuccess) return err;
  CUtensorMap ty;
  if ((err = output_map(&ty, y, N, H, W, Cout)) != cudaSuccess) return err;
  const int tiles_w = (W + kTW - 1) / kTW, tiles_hw = (H + kTH - 1) / kTH * tiles_w;
  const int tiles_n = (Cout + kBN - 1) / kBN;
  ConvParams p{static_cast<const float*>(scale), static_cast<const float*>(bias),
               static_cast<bf16*>(y), static_cast<float*>(partial),
               static_cast<long long>(N) * H * W, H, W, Cout, C0, chunks0, chunks,
               tiles_w, tiles_hw, tiles_n, tiles_hw * tiles_n * N * splits, splits, per_split};
  auto s = static_cast<cudaStream_t>(stream);
  blocks = blocks < p.tiles ? blocks : p.tiles;
  err = launch_conv(tx0, tx1, tw, ty, p, blocks, s);
  if (err != cudaSuccess || splits == 1) return err;
  const long long quads = p.pixels * (Cout / 4);
  const long long want = (quads + 255) / 256;
  const int reduce_blocks = static_cast<int>(want < 4096 ? want : 4096);
  splitk_epilogue<<<reduce_blocks, 256, 0, s>>>(p.partial, p.scale, p.bias, p.y, p.pixels, Cout,
                                         splits);
  return cudaGetLastError();
}

}  // extern "C"
