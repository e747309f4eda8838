"""Hand-written Hopper kernels, one module per kernel, each with its
plain PyTorch version, its wrapper and its launch counter (`LAUNCHES`).

Every function of the JAX package that reaches `pl.pallas_call`, and
where it stands in the port (paths under image_segmentation_tpu/):

| Kernel | `pallas_call` at | Computes | Shapes / types | Port |
|---|---|---|---|---|
| K3 `ops/pallas/attention.py` `fused_attention` :64 → `_fused_attention_impl` :78 | `attention.py:99` | softmax(QKᵀ/√d)·V; scale on the f32 logits after the product; probs cast to V's dtype before P·V; out in q's dtype | q,k,v (B,S,H,D); ViT-B/16: S=197, H=12, D=64; bf16 in, f32 accumulate; B ≤ 8 under batching (clip family, and the prompt model's clip branch on a score-cache miss) | ported: `attention.py` + `csrc/attention.cu` (CUDA C++, sm_90a) |
| K4 `ops/pallas/mlp.py` `fused_mlp` :92 → `_fused_mlp_impl` :102 | `mlp.py:118` | x + fc2(quickGELU(fc1(LN(x)))); LN stats f32; fc1/fc2 f32 accumulate + f32 bias; casts as mlp.py:75-88 | x (B,S,768), 768→3072→768, bf16 weights, f32 LN params and biases; up to 1576 tokens (B = 8) under batching, as K3 | ported: `mlp.py` + `csrc/mlp.cu` (CUDA C++, sm_90a) |
| K1 `ops/pallas/double_conv.py` `fused_double_conv` :129 (+ `fold_bn` :38) | `double_conv.py:185` | [conv3×3 pad 1 → folded-BN scale/bias → ReLU] ×2; intermediate zero outside the image, rounded to the input dtype | x (N,H,W,Cin) NHWC bf16, w (3,3,Cin,C) HWIO bf16, scale/bias f32; UNet-64 at 256 px: 3→64 @256² … 1024→512 @32² … 128→64 @256²; the prompt model's `mask` UNet at 224 px: a Cin = 4 stem (image + heatmap, padded to 8) … 512→1024 @14²; N ≤ 8 under batching; the `unet_noaug` trainer's eval epochs run the 256 px UNet-64 at N = 8 (nine launches per eval batch) | ported: `double_conv.py` + `csrc/double_conv.cu` (CUDA C++, sm_90a; two conv launches through a bf16 intermediate, split-K at the small levels) |
| K2 `ops/pallas/blocks.py` `fused_down_block` :40, `fused_up_block` :63 | reach `double_conv.py:185` | maxpool 2×2 → K1; transpose-conv 2×2 s2 + bias → concat[skip, up] → K1 | UNet levels, N ≤ 8 | ported: `blocks.py` (pre-stages as torch ops, as the JAX package keeps them on XLA; K1 as the kernel) |
| `models/fused_unet.py` `fused_unet_forward` :56 | reaches `double_conv.py:185` | a whole UNet inference forward from K1/K2 + 1×1 head (f32 product of bf16 operands + f32 bias) | 256 px UNet, base 64 (unet family); 224 px, 4 → 1 channels (prompt `mask`); N ≤ 8 | ported: `models/fused_unet.py`, the forward of `models/unet.py` `UNet(use_kernels=True)` |

The kernels build on first CUDA use (`_build.py`); importing this
package compiles nothing.
"""
