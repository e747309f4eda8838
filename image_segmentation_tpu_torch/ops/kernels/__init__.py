"""Hand-written Hopper kernels, one module per kernel, each with its
plain PyTorch version, its wrapper and its launch counter (`LAUNCHES`).

Every function of the JAX package that reaches `pl.pallas_call`, and
where it stands in the port (paths under image_segmentation_tpu/):

| Kernel | `pallas_call` at | Computes | Shapes / types | Port |
|---|---|---|---|---|
| K3 `ops/pallas/attention.py` `fused_attention` :64 → `_fused_attention_impl` :78 | `attention.py:99` | softmax(QKᵀ/√d)·V; scale on the f32 logits after the product; probs cast to V's dtype before P·V; out in q's dtype | q,k,v (B,S,H,D); ViT-B/16: S=197, H=12, D=64; bf16 in, f32 accumulate; B ≤ 8 under batching (clip family, and the prompt model's clip branch on a score-cache miss); in training the frozen ViT of `clipunet`, `clipunet_noskips` and `prompt` at B = 8, once per train micro-batch (in line), per encode batch (`--cache-features`) and per eval batch | ported: `attention.py` + `csrc/attention.cu` (CUDA C++, sm_90a). v2: one warpgroup per (64-query tile, head, batch), Q/K/V by TMA through 4-D maps over the caller's strides, QKᵀ and P·V on `wgmma` (P from registers, V MN-major), the exact softmax in registers; S ≤ 256 |
| K4 `ops/pallas/mlp.py` `fused_mlp` :92 → `_fused_mlp_impl` :102 | `mlp.py:118` | x + fc2(quickGELU(fc1(LN(x)))); LN stats f32; fc1/fc2 f32 accumulate + f32 bias; casts as mlp.py:75-88 | x (B,S,768), 768→3072→768, bf16 weights, f32 LN params and biases; up to 1576 tokens (B = 8) under batching, as K3 | ported: `mlp.py` + `csrc/mlp.cu` (CUDA C++, sm_90a). v2: two `wgmma` GEMMs fed by TMA rings, fc1 with the LayerNorm prologue on a resident A tile and the bias + quick-GELU epilogue, a bf16 intermediate through L2, fc2 with the bias + residual epilogue or F split into f32 partials reduced in order; cut by `mlp_plan` |
| K1 `ops/pallas/double_conv.py` `fused_double_conv` :129 (+ `fold_bn` :38) | `double_conv.py:185` | [conv3×3 pad 1 → folded-BN scale/bias → ReLU] ×2; intermediate zero outside the image, rounded to the input dtype | x (N,H,W,Cin) NHWC bf16, w (3,3,Cin,C) HWIO bf16, scale/bias f32; UNet-64 at 256 px: 3→64 @256² … 1024→512 @32² … 128→64 @256²; the prompt model's `mask` UNet at 224 px: a Cin = 4 stem (image + heatmap, padded to 8) … 512→1024 @14²; N ≤ 8 under batching; the `unet_noaug` and `unet_aug` trainers' eval epochs run the 256 px UNet-64 at N = 8 and the `prompt` trainer's the 224 px selection UNet (nine launches per eval batch; the augmentation, both autoencoders and every train step run no K1) | ported: `double_conv.py` + `csrc/double_conv.cu` (CUDA C++, sm_90a). v3: two conv launches through a bf16 intermediate; each a persistent implicit GEMM on `wgmma`, 256-pixel × 64-channel tiles, A by TMA as one zero-filled 18-line box per (64-channel chunk, dx) serving three taps, B MN-major from the HWIO weights by TMA, a three-stage mbarrier ring fed by a producer warp, a TMA-store epilogue; split-K with an in-order reduction where the tiles are fewer than the SMs (`conv_plan`); `fused_double_conv_cat` reads the up block's [skip, up] from two tensors |
| K2 `ops/pallas/blocks.py` `fused_down_block` :40, `fused_up_block` :63 | reach `double_conv.py:185` | maxpool 2×2 → K1; transpose-conv 2×2 s2 + bias → concat[skip, up] → K1 | UNet levels, N ≤ 8 | ported: `blocks.py`; the pool and the transpose conv are torch ops, as the JAX package keeps them on XLA; the concat is in K1's load stage (`fused_double_conv_cat`) |
| `models/fused_unet.py` `fused_unet_forward` :56 | reaches `double_conv.py:185` | a whole UNet inference forward from K1/K2 + 1×1 head (f32 product of bf16 operands + f32 bias) | 256 px UNet, base 64 (unet family); 224 px, 4 → 1 channels (prompt `mask`); N ≤ 8 | ported: `models/fused_unet.py`, the forward of `models/unet.py` `UNet(use_kernels=True)` |

Each kernel (and K1's concat entry) is also a `torch.library` op,
`istpu::fused_attention`, `istpu::fused_mlp`, `istpu::fused_double_conv`
and `istpu::fused_double_conv_cat`: the plain version on the CPU, the
same launcher on CUDA. The wrappers emit the ops only while torch.export
traces, so exported programs (serve/export.py) launch the kernels and
eager calls pay no op dispatch.

The kernels build on first CUDA use (`_build.py`); importing this
package compiles nothing.
"""
