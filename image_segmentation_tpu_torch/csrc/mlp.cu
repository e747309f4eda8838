// K4: fused ViT MLP, x + fc2(quickGELU(fc1(LayerNorm(x)))), for Hopper.
//
// Replaces image_segmentation_tpu/ops/pallas/mlp.py:_mlp_kernel
// (fused_mlp -> _fused_mlp_impl), the second half of every CLIP ViT block.
// Cast points are the Pallas kernel's (mlp.py:75-88):
//   LayerNorm statistics and affine in f32, result rounded to bf16;
//   fc1 accumulated in f32, + f32 bias; quick-GELU h * sigmoid(1.702 h)
//   in f32, rounded to bf16; fc2 accumulated in f32, + f32 bias, rounded
//   to bf16; residual add in bf16.
// Weights use the nn.Linear layout: w1 is (F, H), w2 is (H, F).
//
// What bounds it on an H100: at ViT-B/16 shapes one call is
// 2 x tokens x 768 x 3072 x 2 FLOP against 9.4 MB of bf16 weights, so at
// the 197 tokens of one request it is bound by reading the weights (the
// TPU kernel held both matrices in VMEM; 227 KB of shared memory cannot)
// and by how many SMs share that work.
// Design: a block of eight warps owns a 32-token tile and one split of
// F (the grid is token tiles x F splits, about one block per SM at one
// request). It normalises its tile into shared memory, then walks its
// F range in slices of 64: fc1 for the slice (W1 staged through shared
// memory 64 columns of H at a time), bias + quick-GELU in registers,
// the bf16 (32 x 64) activation parked in shared memory, then fc2
// accumulates the slice into the block's (32 x H) f32 sum in registers
// (warp w owns columns [w H/8, (w+1) H/8)). The (tokens x F)
// intermediate never reaches HBM; each split writes its f32 partial fc2
// sum, and a second kernel adds the partials in split order, then b2,
// the bf16 rounding and the residual. Both products run on mma.sync
// (bf16 in, f32 accumulate).
#include <algorithm>

#include "common.cuh"

namespace istpu {
namespace {

constexpr int kTM = 32;     // tokens per block
constexpr int kFT = 64;     // F slice per step
constexpr int kKC = 64;     // H chunk of the staged W1 tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <int H>
constexpr size_t mlp_smem_bytes() {
  return sizeof(bf16) *
         (kTM * (H + kPad) + kFT * (kKC + kPad) + kTM * (kFT + kPad) + H * (kFT + kPad));
}

// Grid (token tiles, F splits); split s covers F slices
// [s * steps_per_split, (s + 1) * steps_per_split) of kFT columns.
template <int H>
__global__ void __launch_bounds__(kThreads)
mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
           const float* __restrict__ ln_b, const bf16* __restrict__ w1,
           const float* __restrict__ b1, const bf16* __restrict__ w2,
           float* __restrict__ partial, int M, int F, int steps_per_split,
           float eps) {
  static_assert(H % (kWarps * 8) == 0 && H % kKC == 0, "unsupported hidden size");
  constexpr int ldx = H + kPad, ldw1 = kKC + kPad, ldg = kFT + kPad, ldw2 = kFT + kPad;
  constexpr int kNT = H / (kWarps * 8);  // fc2 n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xn = reinterpret_cast<bf16*>(smem);  // [kTM][ldx]  LN(x) in bf16
  bf16* W1s = Xn + kTM * ldx;                 // [kFT][ldw1] W1[f0+n][k0+k]
  bf16* Gs = W1s + kFT * ldw1;                // [kTM][ldg]  quickGELU(fc1) in bf16
  bf16* W2s = Gs + kTM * ldg;                 // [H][ldw2]   W2[o][f0+f]

  const int m0 = blockIdx.x * kTM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // LayerNorm: two-pass f32 statistics, one warp per row.
  for (int r = warp; r < kTM; r += kWarps) {
    bf16* xn = Xn + r * ldx;
    if (m0 + r >= M) {
      for (int c = lane; c < H; c += 32) xn[c] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* xr = x + static_cast<long long>(m0 + r) * H;
    float s = 0.f;
    for (int c = lane; c < H; c += 32) s += __bfloat162float(xr[c]);
    const float mu = warp_sum(s) / H;
    float ss = 0.f;
    for (int c = lane; c < H; c += 32) {
      const float d = __bfloat162float(xr[c]) - mu;
      ss += d * d;
    }
    const float rstd = rsqrtf(warp_sum(ss) / H + eps);
    for (int c = lane; c < H; c += 32)
      xn[c] = __float2bfloat16((__bfloat162float(xr[c]) - mu) * rstd * ln_w[c] + ln_b[c]);
  }

  float acc2[2][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) acc2[mt][nt][0] = acc2[mt][nt][1] = acc2[mt][nt][2] = acc2[mt][nt][3] = 0.f;

  // fc1 split: warp w computes rows [16 (w % 2), +16) x columns
  // [16 (w / 2), +16) of the (32 x 64) slice, as two 16x8 tiles.
  const int mt1 = warp & 1, nc1 = (warp >> 1) * 16;
  constexpr int kRowVecs1 = kKC / 8, kRowVecs2 = kFT / 8;

  const int f_begin = blockIdx.y * steps_per_split * kFT;
  const int f_end = min(F, f_begin + steps_per_split * kFT);
  for (int f0 = f_begin; f0 < f_end; f0 += kFT) {
    __syncthreads();  // previous slice's fc2 is done with Gs and W2s
    for (int i = tid; i < H * kRowVecs2; i += kThreads) {
      const int o = i / kRowVecs2, c = (i % kRowVecs2) * 8;
      *reinterpret_cast<uint4*>(W2s + o * ldw2 + c) =
          *reinterpret_cast<const uint4*>(w2 + static_cast<long long>(o) * F + f0 + c);
    }

    float acc1[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < H; k0 += kKC) {
      __syncthreads();  // W1s free (and, on the first chunk, Xn written)
      for (int i = tid; i < kFT * kRowVecs1; i += kThreads) {
        const int n = i / kRowVecs1, c = (i % kRowVecs1) * 8;
        *reinterpret_cast<uint4*>(W1s + n * ldw1 + c) =
            *reinterpret_cast<const uint4*>(w1 + static_cast<long long>(f0 + n) * H + k0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        uint32_t a[4];
        load_a_frag(a, Xn, ldx, mt1 * 16, k0 + kk, g, t);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bf16* wrow = W1s + (nc1 + j * 8 + g) * ldw1 + kk;
          mma_bf16_16x8x16(acc1[j], a, ld32(wrow + 2 * t), ld32(wrow + 8 + 2 * t));
        }
      }
    }

    // + b1, quick-GELU in f32, round to bf16 into Gs.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = nc1 + j * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mt1 * 16 + g + (e >> 1) * 8, col = c + (e & 1);
        const float hv = acc1[j][e] + b1[f0 + col];
        const float act = hv * (1.f / (1.f + expf(-1.702f * hv)));
        Gs[row * ldg + col] = __float2bfloat16(act);
      }
    }
    __syncthreads();

    // fc2: acc2 += Gs (32 x 64) . W2s^T over this slice.
#pragma unroll
    for (int kk = 0; kk < kFT; kk += 16) {
      uint32_t a0[4], a1[4];
      load_a_frag(a0, Gs, ldg, 0, kk, g, t);
      load_a_frag(a1, Gs, ldg, 16, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const bf16* wrow = W2s + ((warp * kNT + nt) * 8 + g) * ldw2 + kk;
        const uint32_t bb0 = ld32(wrow + 2 * t), bb1 = ld32(wrow + 8 + 2 * t);
        mma_bf16_16x8x16(acc2[0][nt], a0, bb0, bb1);
        mma_bf16_16x8x16(acc2[1][nt], a1, bb0, bb1);
      }
    }
  }

  // This split's f32 partial of fc2 for the tile.
  float* part = partial + static_cast<long long>(blockIdx.y) * M * H;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + mt * 16 + g + half * 8;
        if (row >= M) continue;
        const int col = (warp * kNT + nt) * 8 + 2 * t;
        *reinterpret_cast<float2*>(part + static_cast<long long>(row) * H + col) =
            make_float2(acc2[mt][nt][2 * half], acc2[mt][nt][2 * half + 1]);
      }
}

// out = x + bf16(sum of partials + b2), the sum in split order, two
// columns per thread.
__global__ void mlp_epilogue_kernel(const float* __restrict__ partial, int splits,
                                    const bf16* __restrict__ x,
                                    const float* __restrict__ b2,
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

template <int H>
cudaError_t launch_mlp(const bf16* x, const float* ln_w, const float* ln_b,
                       const bf16* w1, const float* b1, const bf16* w2, const float* b2,
                       float* partial, bf16* out, int M, int F, int splits,
                       int steps_per_split, float eps, cudaStream_t stream) {
  constexpr size_t smem = mlp_smem_bytes<H>();
  cudaError_t err = cudaFuncSetAttribute(
      mlp_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kTM - 1) / kTM, splits);
  mlp_kernel<H><<<grid, kThreads, smem, stream>>>(x, ln_w, ln_b, w1, b1, w2, partial, M,
                                                  F, steps_per_split, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long pairs = static_cast<long long>(M) * H / 2;
  const int blocks = static_cast<int>(std::min<long long>((pairs + 255) / 256, 4096));
  mlp_epilogue_kernel<<<blocks, 256, 0, stream>>>(partial, splits, x, b2, out, M, H);
  return cudaGetLastError();
}

}  // namespace
}  // namespace istpu

extern "C" {

// x, out: contiguous bf16 (M, H); w1: bf16 (F, H); w2: bf16 (H, F);
// ln_w, ln_b, b2: f32 (H,); b1: f32 (F,); partial: f32 scratch
// (splits, M, H). H in {128, 256, ..., 768}, F a multiple of 64; the
// F / 64 slices are cut into `splits` runs of `steps_per_split`.
// Returns a cudaError_t.
int istpu_mlp_bf16(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                   const void* b1, const void* w2, const void* b2, void* partial,
                   void* out, int M, int H, int F, int splits, int steps_per_split,
                   float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int steps = F / istpu::kFT;
  if (M <= 0 || F <= 0 || F % istpu::kFT != 0 || splits <= 0 || steps_per_split <= 0 ||
      splits * steps_per_split < steps || (splits - 1) * steps_per_split >= steps)
    return cudaErrorInvalidValue;
  using istpu::bf16;
  const auto* xp = static_cast<const bf16*>(x);
  const auto* lw = static_cast<const float*>(ln_w);
  const auto* lb = static_cast<const float*>(ln_b);
  const auto* w1p = static_cast<const bf16*>(w1);
  const auto* b1p = static_cast<const float*>(b1);
  const auto* w2p = static_cast<const bf16*>(w2);
  const auto* b2p = static_cast<const float*>(b2);
  auto* pp = static_cast<float*>(partial);
  auto* op = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (H) {
#define ISTPU_MLP_CASE(HH)                                                             \
  case HH:                                                                             \
    return istpu::launch_mlp<HH>(xp, lw, lb, w1p, b1p, w2p, b2p, pp, op, M, F, splits, \
                                 steps_per_split, eps, s);
    ISTPU_MLP_CASE(128)
    ISTPU_MLP_CASE(256)
    ISTPU_MLP_CASE(384)
    ISTPU_MLP_CASE(512)
    ISTPU_MLP_CASE(640)
    ISTPU_MLP_CASE(768)
#undef ISTPU_MLP_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
