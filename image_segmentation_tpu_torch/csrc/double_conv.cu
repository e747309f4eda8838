// K1: 3x3 convolution (pad 1) with a per-channel scale, bias and ReLU,
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
// exactly the masked, bf16-rounded intermediate of the Pallas kernel.
//
// What bounds it on an H100: at UNet-64 widths a conv does from 12
// (the RGB stem's first conv) to about 400 multiply-adds per byte it must
// move (activations in and out, weights), around the card's ~150 MAC/B
// ridge: the 256x256 levels, and the 16x16 level whose 19 MB of weights
// dominate, sit near it; the middle levels above it. This first kernel is
// slower than either bound: it is bound by mma.sync issue and
// shared-memory traffic at the large levels (each block re-stages its 64
// output channels' weights for 128 pixels), and by parallelism at the
// small ones: 16x16 and 32x32 images give 2 and 8 spatial tiles, 32 and
// 64 blocks on 132 SMs, each walking K = 9 * Cin of up to 9,216. Design:
//   * implicit GEMM: M = output pixels, N = output channels, K = 9 taps x
//     Cin. A block owns 8 rows x 16 columns of output pixels (each row one
//     m16 tile) and 64 output channels; 8 warps, each 2 rows x 32 channels;
//   * the K loop runs over Cin in chunks of 16. Per chunk the block stages
//     the haloed 10 x 18 x 16 input tile and the 9 x 16 x 64 weight slice
//     in shared memory with cp.async (zero fill outside the image, past
//     Cin and past Cout), double-buffered so the next chunk loads while
//     this one computes; all 9 taps then read the same staged tile through
//     ldmatrix at shifted offsets. Weights are read in the caller's HWIO
//     layout (output channels contiguous, ldmatrix.trans), so the wrapper
//     never re-lays them out;
//   * mma.sync.m16n8k16, bf16 in, f32 accumulate; the epilogue applies
//     scale, bias and ReLU in f32 and stores bf16 pairs;
//   * split-K for the small levels: when the spatial tiles and channel
//     blocks give fewer blocks than SMs, the wrapper splits the Cin chunks
//     over gridDim.z; each split writes f32 partial sums and a second
//     kernel adds them and applies the epilogue.
// 58.8 KB of shared memory a block (above the 48 KB default, hence the
// MaxDynamicSharedMemorySize attribute); registers allow two blocks an SM.
// The intermediate is not kept on chip: at C = 1024 an 18 x 18 haloed
// tile of it is 663 KB.
#include "common.cuh"

namespace istpu {
namespace {

constexpr int kTH = 8;               // output rows per block
constexpr int kTW = 16;              // output columns per block (one m16 tile)
constexpr int kBN = 64;              // output channels per block
constexpr int kKC = 16;              // input channels per K chunk
constexpr int kKCP = kKC + kPad;     // smem stride of one input pixel
constexpr int kWLD = kBN + kPad;     // smem stride of one weight row (one ci)
constexpr int kInH = kTH + 2, kInW = kTW + 2;
constexpr int kInElems = kInH * kInW * kKCP;
constexpr int kWElems = 9 * kKC * kWLD;
constexpr int kStageElems = kInElems + kWElems;
constexpr int kThreads = 256;
constexpr size_t kSmemBytes = 2 * kStageElems * sizeof(bf16);

struct ConvArgs {
  const bf16* x;        // (N, H, W, Cin) NHWC, Cin % 8 == 0
  const bf16* w;        // (3, 3, Cin, Cout) HWIO, Cout % 8 == 0
  const float* scale;   // (Cout)
  const float* bias;    // (Cout)
  bf16* y;              // (N, H, W, Cout) NHWC
  float* partial;       // (splits, N*H*W, Cout) f32, when splits > 1
  int N, H, W, Cin, Cout;
  int tiles_w, splits, per_split;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The same for a [k][n] (n contiguous) tile: each 8x8 matrix arrives
// transposed, as the "col" B fragment of mma.m16n8k16 wants it.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Stage input channels [chunk*16, chunk*16+16) of the haloed tile and the
// matching weight slice. Input pixels outside the image and channels past
// Cin land as zeros (src-size 0), which is conv's zero padding; so do
// weights past Cin or Cout.
__device__ __forceinline__ void load_chunk(const ConvArgs& a, bf16* in, bf16* ws, int n,
                                           int oh0, int ow0, int co0, int chunk, int tid) {
  const int c0 = chunk * kKC;
  for (int i = tid; i < kInH * kInW * 2; i += kThreads) {
    const int pix = i >> 1, v = i & 1;
    const int ih = oh0 - 1 + pix / kInW, iw = ow0 - 1 + pix % kInW;
    const int ci = c0 + v * 8;
    const bool ok = ih >= 0 && ih < a.H && iw >= 0 && iw < a.W && ci < a.Cin;
    const bf16* src =
        ok ? a.x + ((static_cast<long long>(n) * a.H + ih) * a.W + iw) * a.Cin + ci : a.x;
    cp_async16(in + pix * kKCP + v * 8, src, ok);
  }
  for (int i = tid; i < 9 * kKC * (kBN / 8); i += kThreads) {
    const int v = i % (kBN / 8), k = (i / (kBN / 8)) % kKC, tap = i / (kKC * kBN / 8);
    const int ci = c0 + k, co = co0 + v * 8;
    const bool ok = ci < a.Cin && co < a.Cout;
    const bf16* src = ok ? a.w + (static_cast<long long>(tap) * a.Cin + ci) * a.Cout + co : a.w;
    cp_async16(ws + (tap * kKC + k) * kWLD + v * 8, src, ok);
  }
}

template <bool kPartial>
__global__ void __launch_bounds__(kThreads, 2) conv3x3_kernel(ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 3;   // output rows 2*wr, 2*wr+1 of the tile
  const int wn = warp >> 2;  // output channels wn*32 .. wn*32+31 of the block
  const int oh0 = (blockIdx.x / a.tiles_w) * kTH;
  const int ow0 = (blockIdx.x % a.tiles_w) * kTW;
  const int co0 = blockIdx.y * kBN;
  const int n = blockIdx.z / a.splits, split = blockIdx.z % a.splits;
  const int chunks = (a.Cin + kKC - 1) / kKC;
  const int c_begin = split * a.per_split;
  const int c_end = min(c_begin + a.per_split, chunks);

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  // ldmatrix row addresses (see common.cuh for the fragment layout): A
  // rows are 16 pixels of one tile row at input channels a_k..a_k+7; B
  // rows are input channels, 8 output channels each, matrices ordered
  // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15).
  const int a_pix = lane & 15, a_k = (lane >> 4) * 8;
  const int b_k = lane & 15, b_n = wn * 32 + (lane >> 4) * 8;

  load_chunk(a, smem, smem + kInElems, n, oh0, ow0, co0, c_begin, tid);
  cp_async_commit();
  for (int c = c_begin; c < c_end; ++c) {
    const int stage = (c - c_begin) & 1;
    if (c + 1 < c_end) {
      bf16* next = smem + (stage ^ 1) * kStageElems;
      load_chunk(a, next, next + kInElems, n, oh0, ow0, co0, c + 1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* in = smem + stage * kStageElems;
    const bf16* ws = in + kInElems;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], in + ((2 * wr + mi + dy) * kInW + dx + a_pix) * kKCP + a_k);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldmatrix_x4_trans(bfr[p], ws + (tap * kKC + b_k) * kWLD + b_n + p * 16);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_bf16_16x8x16(acc[mi][nj], af[mi], bfr[nj >> 1][(nj & 1) * 2],
                           bfr[nj >> 1][(nj & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  // Epilogue. Accumulator rows are the tile's columns (g, g + 8), columns
  // a pair of output channels.
  const int g = lane >> 2, t = lane & 3;
  const long long pixels = static_cast<long long>(a.N) * a.H * a.W;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int oh = oh0 + 2 * wr + mi;
    if (oh >= a.H) continue;
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int co = co0 + wn * 32 + nj * 8 + 2 * t;
      if (co >= a.Cout) continue;
      float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
      if (!kPartial) {
        s0 = a.scale[co];
        s1 = a.scale[co + 1];
        b0 = a.bias[co];
        b1 = a.bias[co + 1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ow = ow0 + g + 8 * h;
        if (ow >= a.W) continue;
        const long long p = (static_cast<long long>(n) * a.H + oh) * a.W + ow;
        const float v0 = acc[mi][nj][2 * h], v1 = acc[mi][nj][2 * h + 1];
        if (kPartial) {
          *reinterpret_cast<float2*>(a.partial + (split * pixels + p) * a.Cout + co) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(a.y + p * a.Cout + co) =
              __floats2bfloat162_rn(fmaxf(v0 * s0 + b0, 0.f), fmaxf(v1 * s1 + b1, 0.f));
        }
      }
    }
  }
}

// Sum of the split-K partials, then scale, bias, ReLU and the bf16 store.
__global__ void splitk_epilogue(const float* __restrict__ partial,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias, bf16* __restrict__ y,
                                long long pixels, int Cout, int splits) {
  const long long pairs = pixels * (Cout / 2);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < pairs;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long p = i / (Cout / 2);
    const int co = static_cast<int>(i % (Cout / 2)) * 2;
    float v0 = 0.f, v1 = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float2 v = *reinterpret_cast<const float2*>(partial + (s * pixels + p) * Cout + co);
      v0 += v.x;
      v1 += v.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(y + p * Cout + co) = __floats2bfloat162_rn(
        fmaxf(v0 * scale[co] + bias[co], 0.f), fmaxf(v1 * scale[co + 1] + bias[co + 1], 0.f));
  }
}

cudaError_t launch_conv3x3(const ConvArgs& a, cudaStream_t stream) {
  const bool partial = a.splits > 1;
  auto kernel = partial ? conv3x3_kernel<true> : conv3x3_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const int tiles_h = (a.H + kTH - 1) / kTH;
  const dim3 grid(tiles_h * a.tiles_w, (a.Cout + kBN - 1) / kBN, a.N * a.splits);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !partial) return err;
  const long long pairs = static_cast<long long>(a.N) * a.H * a.W * (a.Cout / 2);
  const long long want = (pairs + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  splitk_epilogue<<<blocks, 256, 0, stream>>>(a.partial, a.scale, a.bias, a.y,
                                              static_cast<long long>(a.N) * a.H * a.W, a.Cout,
                                              a.splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace istpu

extern "C" {

// One conv3x3 (pad 1) -> * scale + bias -> ReLU, NHWC bf16 -> NHWC bf16.
// x: contiguous (N, H, W, Cin) with Cin % 8 == 0; w: contiguous HWIO
// (3, 3, Cin, Cout) with Cout % 8 == 0; scale, bias: f32 (Cout); y:
// contiguous (N, H, W, Cout); partial: f32 (splits, N*H*W, Cout) when
// splits > 1, else unused. All 16-byte aligned. The ceil(Cin / 16) K
// chunks are cut into `splits` runs of `per_split`. Returns a cudaError_t.
int istpu_conv3x3_bf16(const void* x, const void* w, const void* scale, const void* bias,
                       void* y, void* partial, int N, int H, int W, int Cin, int Cout,
                       int splits, int per_split, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  using istpu::bf16;
  const int chunks = (Cin + istpu::kKC - 1) / istpu::kKC;
  if (Cin < 8 || Cin % 8 || Cout < 8 || Cout % 8 || splits < 1 || per_split < 1 ||
      (splits - 1) * per_split >= chunks || splits * per_split < chunks || N < 1 || H < 1 ||
      W < 1)
    return cudaErrorInvalidValue;
  istpu::ConvArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                    static_cast<const float*>(scale), static_cast<const float*>(bias),
                    static_cast<bf16*>(y), static_cast<float*>(partial),
                    N, H, W, Cin, Cout,
                    (W + istpu::kTW - 1) / istpu::kTW, splits, per_split};
  return istpu::launch_conv3x3(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
