"""The plain reference ClipUNet (in5omnia/Image_Segmentation
`clip/clipunet.py`): a CLIP ViT (openai/clip-vit-base-patch16: patch conv
without bias, class and position embeddings, pre-LayerNorm, pre-norm
blocks with quick-GELU MLPs) whose last hidden state, on its (G, G) grid,
feeds a decoder: a 1x1 conv, then per block a transpose conv 2x2 stride 2
halving the channels, the skip (hidden state 9, 7, 5, 3 in turn) through
a 1x1 conv and a linear resize (triangle weights) to the upsampled grid,
concat [up, skip], and two bias-free conv3x3 -> BatchNorm -> ReLU; a 1x1
head gives the logits.

float32, NHWC in and out; parameter names are the served model's keys.
The ViT is frozen: `forward` runs it without autograd.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from perfbench.reference.geometry import triangle_weights
from perfbench.reference.ops import Ops, layer_norm
from perfbench.reference.unet import Conv, ConvBNRelu


class LN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))


class Attention(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(h, h) for _ in range(4))


class MLP(nn.Module):
    def __init__(self, h: int, f: int):
        super().__init__()
        self.fc1, self.fc2 = Linear(h, f), Linear(f, h)


class Block(nn.Module):
    def __init__(self, h: int, f: int):
        super().__init__()
        self.self_attn = Attention(h)
        self.layer_norm1 = LN(h)
        self.mlp = MLP(h, f)
        self.layer_norm2 = LN(h)


class Embeddings(nn.Module):
    def __init__(self, h: int, patch: int, tokens: int):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(h))
        self.patch_embedding = Conv(3, h, patch, bias=False)
        self.position_embedding = nn.Module()
        self.position_embedding.weight = nn.Parameter(torch.empty(tokens, h))


class Encoder(nn.Module):
    def __init__(self, h: int, f: int, layers: int):
        super().__init__()
        self.layers = nn.ModuleList(Block(h, f) for _ in range(layers))


class ViT(nn.Module):
    def __init__(self, image: int, patch: int, hidden: int, layers: int, heads: int,
                 mlp: int):
        super().__init__()
        self.image, self.patch, self.heads = image, patch, heads
        self.embeddings = Embeddings(hidden, patch, (image // patch) ** 2 + 1)
        self.pre_layrnorm = LN(hidden)
        self.encoder = Encoder(hidden, mlp, layers)

    def run(self, ops: Ops, pixels: torch.Tensor):
        """(N, S, S, 3) -> the hidden states [pre-LN output, block 1, ...]."""
        n, h = pixels.shape[0], self.pre_layrnorm.weight.shape[0]
        e = self.embeddings
        x = ops.conv2d(pixels.permute(0, 3, 1, 2), e.patch_embedding.weight,
                       stride=self.patch).flatten(2).transpose(1, 2)
        x = torch.cat([e.class_embedding.expand(n, 1, h), x], 1) + e.position_embedding.weight
        x = layer_norm(x, self.pre_layrnorm, ops.ln_eps)
        hidden = [x]
        for blk in self.encoder.layers:
            x = x + self._attention(ops, blk.self_attn, layer_norm(x, blk.layer_norm1, ops.ln_eps))
            y = ops.linear(layer_norm(x, blk.layer_norm2, ops.ln_eps), blk.mlp.fc1.weight, blk.mlp.fc1.bias)
            y = y * torch.sigmoid(1.702 * y)  # quick GELU
            x = x + ops.linear(y, blk.mlp.fc2.weight, blk.mlp.fc2.bias)
            hidden.append(x)
        return hidden

    def _attention(self, ops, attn, x):
        n, s, h = x.shape
        d = h // self.heads
        split = lambda t: t.view(n, s, self.heads, d).transpose(1, 2)  # noqa: E731
        q, k, v = (split(ops.linear(x, p.weight, p.bias))
                   for p in (attn.q_proj, attn.k_proj, attn.v_proj))
        probs = torch.softmax(ops.matmul(q, k.transpose(-1, -2)) / math.sqrt(d), dim=-1)
        out = ops.matmul(probs, v).transpose(1, 2).reshape(n, s, h)
        return ops.linear(out, attn.out_proj.weight, attn.out_proj.bias)


def resize_linear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Linear resize of NCHW x with the triangle-weight matrices."""
    wy = torch.as_tensor(triangle_weights(x.shape[2], out_hw[0], True), dtype=x.dtype,
                         device=x.device)
    wx = torch.as_tensor(triangle_weights(x.shape[3], out_hw[1], True), dtype=x.dtype,
                         device=x.device)
    return torch.einsum("oh,nchw,pw->ncop", wy, x, wx)


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, skip: int):
        super().__init__()
        half = cin // 2
        self.up = nn.Module()
        self.up.up = Conv(cin, half, 2, transpose=True)
        self.skip_proj = Conv(skip, half, 1)
        self.conv1 = ConvBNRelu(2 * half, cout, bias=False)
        self.conv2 = ConvBNRelu(cout, cout, bias=False)

    def run(self, ops, x, skip, training):
        up = ops.conv_transpose2d(x, self.up.up.weight, self.up.up.bias)
        skip = ops.conv2d(skip, self.skip_proj.weight, self.skip_proj.bias)
        if skip.shape[2:] != up.shape[2:]:
            skip = resize_linear(skip, up.shape[2:])
        x = torch.cat([up, skip], 1)
        return self.conv2.run(ops, self.conv1.run(ops, x, training), training)


class ClipUNet(nn.Module):
    """forward(x (N, S, S, 3) in [0, 1]) -> float32 logits (N, S, S, classes)."""

    def __init__(self, image: int = 224, patch: int = 16, hidden: int = 768,
                 layers: int = 12, heads: int = 12, mlp: int = 3072,
                 decoder_channels: Sequence[int] = (1024, 512, 256, 128, 64),
                 skip_indices: Sequence[int] = (3, 5, 7, 9), num_classes: int = 4,
                 ops: Ops = None):
        super().__init__()
        self.ops = ops or Ops()
        self.grid = image // patch
        self.skip_indices = tuple(sorted(skip_indices))
        self.vision_model = ViT(image, patch, hidden, layers, heads, mlp)
        ch = list(decoder_channels)
        self.init_conv = Conv(hidden, ch[0], 1)
        n_blocks = min(len(ch) - 1, len(self.skip_indices))
        self.dec = nn.ModuleList(DecoderBlock(ch[i], ch[i + 1], hidden)
                                 for i in range(n_blocks))
        self.head = Conv(ch[n_blocks], num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ops, g = self.ops, self.grid
        with torch.no_grad():
            hidden = self.vision_model.run(ops, x.float())
        grid = lambda t: t[:, 1:].reshape(t.shape[0], g, g, -1).permute(0, 3, 1, 2)  # noqa: E731
        y = ops.conv2d(grid(hidden[-1]), self.init_conv.weight, self.init_conv.bias)
        skips = [grid(hidden[i]) for i in self.skip_indices]
        for block, skip in zip(self.dec, reversed(skips)):
            y = block.run(ops, y, skip, self.training)
        return ops.conv2d(y, self.head.weight, self.head.bias).permute(0, 2, 3, 1)
