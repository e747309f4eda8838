// K3: fused multi-head attention, softmax(Q K^T / sqrt(D)) V, for Hopper.
//
// Replaces image_segmentation_tpu/ops/pallas/attention.py:_attention_kernel
// (fused_attention -> _fused_attention_impl), the kernel every CLIP ViT
// block runs. Semantics are the Pallas kernel's, cast for cast:
//   logits = (q . k) accumulated in f32, THEN times the scale;
//   softmax in f32 over the S true keys (no padding, so no -inf mask);
//   probabilities rounded to bf16 before P . V; P . V accumulated in f32;
//   output written in q's dtype (bf16).
//
// What bounds it on an H100: at ViT-B/16 shapes (S = 197, D = 64) one
// (batch, head) pair is 197x197x64x2x2 = 10 MFLOP against 75 KB of q/k/v,
// so the tensor cores, not HBM, would bound a good kernel; this first
// kernel is bound by latency (few blocks, synchronous shared-memory
// loads, scalar softmax). Design: one block per (query tile of 64, head,
// batch), four warps of 16 query rows each. K and the transposed V of
// the block's (batch, head) are staged whole in shared memory (about
// 57 KB at S = 197, above the 48 KB default, hence the
// MaxDynamicSharedMemorySize attribute); the (64 x S) f32 logits stay in
// shared memory, so neither scores nor probabilities touch HBM. Both
// products run on mma.sync (bf16 in, f32 accumulate). q/k/v are read
// through their (B, S, H, D) strides, so the caller's head split is
// never copied.
#include "common.cuh"

namespace istpu {
namespace {

constexpr int kQTile = 64;  // query rows per block
constexpr int kWarps = kQTile / 16;

struct Strides {  // in elements; the last (D) dimension is contiguous
  long long b, s, h;
};

template <int D>
__host__ __device__ constexpr int attn_ld_qk() { return D + kPad; }

__host__ __device__ inline int seq16(int S) { return (S + 15) & ~15; }

template <int D>
size_t attention_smem_bytes(int S) {
  const int s16 = seq16(S);
  const size_t ldq = attn_ld_qk<D>(), ldp = s16 + kPad, ldl = s16 + 4;
  return sizeof(bf16) * (kQTile * ldq + s16 * ldq + D * ldp + kQTile * ldp) +
         sizeof(float) * kQTile * ldl;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int S, int H,
                 Strides sq, Strides sk, Strides sv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s16 = seq16(S);
  constexpr int ldq = attn_ld_qk<D>();
  const int ldp = s16 + kPad;
  const int ldl = s16 + 4;
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [kQTile][ldq]
  bf16* Ks = Qs + kQTile * ldq;              // [s16][ldq]
  bf16* Vt = Ks + s16 * ldq;                 // [D][ldp]   (V transposed)
  bf16* Ps = Vt + D * ldp;                   // [kQTile][ldp]
  float* Ls = reinterpret_cast<float*>(Ps + kQTile * ldp);  // [kQTile][ldl]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  // Stage Q (this tile), K and V^T (all keys); rows past S are zero so
  // padded keys contribute exact zeros to P . V.
  constexpr int kVec = 8;  // bf16 per 16-byte load
  constexpr int kRowVecs = D / kVec;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < kQTile * kRowVecs; i += blockDim.x) {
    const int r = i / kRowVecs, c = (i % kRowVecs) * kVec;
    uint4 val = zero;
    if (q0 + r < S) val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * sq.s + c);
    *reinterpret_cast<uint4*>(Qs + r * ldq + c) = val;
  }
  for (int i = tid; i < s16 * kRowVecs; i += blockDim.x) {
    const int j = i / kRowVecs, c = (i % kRowVecs) * kVec;
    uint4 kval = zero, vval = zero;
    if (j < S) {
      kval = *reinterpret_cast<const uint4*>(kb + j * sk.s + c);
      vval = *reinterpret_cast<const uint4*>(vb + j * sv.s + c);
    }
    *reinterpret_cast<uint4*>(Ks + j * ldq + c) = kval;
    const bf16* ve = reinterpret_cast<const bf16*>(&vval);
#pragma unroll
    for (int u = 0; u < kVec; ++u) Vt[(c + u) * ldp + j] = ve[u];
  }
  __syncthreads();

  // Logits of this warp's 16 query rows against every key, scaled in f32.
  const int r0 = warp * 16;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) load_a_frag(qa[ks], Qs, ldq, r0, ks * 16, g, t);
  for (int n0 = 0; n0 < s16; n0 += 8) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* krow = Ks + (n0 + g) * ldq;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_bf16_16x8x16(c, qa[ks], ld32(krow + ks * 16 + 2 * t),
                       ld32(krow + ks * 16 + 8 + 2 * t));
    float* l0 = Ls + (r0 + g) * ldl + n0 + 2 * t;
    float* l1 = l0 + 8 * ldl;
    l0[0] = c[0] * scale;
    l0[1] = c[1] * scale;
    l1[0] = c[2] * scale;
    l1[1] = c[3] * scale;
  }
  __syncwarp();

  // Row softmax over the S true keys, then P rounded to bf16 (zero past S).
  for (int rr = 0; rr < 16; ++rr) {
    float* lr = Ls + (r0 + rr) * ldl;
    float m = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < S; j += 32) m = fmaxf(m, lr[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(lr[j] - m);
      lr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    bf16* pr = Ps + (r0 + rr) * ldp;
    for (int j = lane; j < s16; j += 32)
      pr[j] = __float2bfloat16(j < S ? lr[j] / sum : 0.f);
  }
  __syncwarp();

  // out = P . V over the keys, 16 at a time.
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int k0 = 0; k0 < s16; k0 += 16) {
    uint32_t pa[4];
    load_a_frag(pa, Ps, ldp, r0, k0, g, t);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const bf16* vrow = Vt + (nt * 8 + g) * ldp + k0;
      mma_bf16_16x8x16(acc[nt], pa, ld32(vrow + 2 * t), ld32(vrow + 8 + 2 * t));
    }
  }

  // Output is a fresh contiguous (B, S, H, D) tensor.
  const long long ostride = static_cast<long long>(H) * D;
  bf16* ob = o + (static_cast<long long>(b) * S * H + h) * D;
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * ostride + c) =
          __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * ostride + c) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
}

template <int D>
cudaError_t launch_attention(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                             int B, int S, int H, Strides sq, Strides sk, Strides sv,
                             cudaStream_t stream) {
  const size_t smem = attention_smem_bytes<D>(S);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(attention_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kQTile - 1) / kQTile, H, B);
  attention_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, o, S, H, sq, sk, sv, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

}  // namespace
}  // namespace istpu

extern "C" {

// Largest sequence length the kernel's shared-memory plan admits on
// `device` for head dim D (0 for an unsupported D or on error).
int istpu_attention_max_seq(int D, int device) {
  if (D != 64) return 0;
  int max_smem = 0;
  if (cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  int s = 16;
  while (istpu::attention_smem_bytes<64>(s + 16) <= static_cast<size_t>(max_smem)) s += 16;
  return s;
}

// q, k, v: bf16 (B, S, H, D) with the given element strides (D contiguous);
// o: contiguous bf16 (B, S, H, D). Returns a cudaError_t.
int istpu_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                         int S, int H, int D, long long qsb, long long qss,
                         long long qsh, long long ksb, long long kss, long long ksh,
                         long long vsb, long long vss, long long vsh, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  using istpu::bf16;
  if (D != 64) return cudaErrorInvalidValue;
  return istpu::launch_attention<64>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), B, S, H, {qsb, qss, qsh},
      {ksb, kss, ksh}, {vsb, vss, vsh}, static_cast<cudaStream_t>(stream));
}

const char* istpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
