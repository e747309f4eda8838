"""Shared conv building blocks and initialisers (eval-mode forward).

Counterpart of image_segmentation_tpu/models/layers.py. Modules take
NCHW tensors (callers keep them in channels_last memory, which is the
JAX package's NHWC) and compute in the dtype of their input: parameters
stay float32 and are cast per call, as flax does with `dtype=bfloat16`.

BatchNorm runs on its running statistics (serving is inference only);
eps 1e-5, normalisation in f32, as flax's BatchNorm. Initialisers match
the JAX package's distributions (not its random bits): decoder convs
are Kaiming-uniform over fan_in (`conv_kernel_init`), dense kernels are
LeCun-normal (flax's default).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


def conv_kernel_init_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """variance_scaling(2.0, 'fan_in', 'uniform'): U(±sqrt(6 / fan_in))."""
    bound = math.sqrt(6.0 / fan_in)
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=generator)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """variance_scaling(1.0, 'fan_in', 'truncated_normal'), flax's default."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over dim 1 with nn.BatchNorm2d's parameter names."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)


class ConvBNRelu(nn.Module):
    """Conv3×3 (pad 1) → BatchNorm → ReLU."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, 3, padding=1, bias=use_bias)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight.to(x.dtype)
        b = None if self.conv.bias is None else self.conv.bias.to(x.dtype)
        return F.relu(self.bn(F.conv2d(x, w, b, padding=1)))

    def init_weights(self, generator: torch.Generator) -> None:
        conv_kernel_init_(self.conv.weight, self.conv.weight[0].numel(), generator)
        if self.conv.bias is not None:
            nn.init.zeros_(self.conv.bias)


class UpConv(nn.Module):
    """Transpose conv, kernel 2 stride 2: exactly doubles H and W."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_features, features, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x, self.up.weight.to(x.dtype), self.up.bias.to(x.dtype), stride=2)

    def init_weights(self, generator: torch.Generator) -> None:
        w = self.up.weight  # (in, out, kH, kW); flax's fan_in is kH·kW·in
        conv_kernel_init_(w, w.shape[0] * w.shape[2] * w.shape[3], generator)
        nn.init.zeros_(self.up.bias)


def conv1x1(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 1×1 conv computed in x's dtype."""
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))


def init_conv1x1_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    conv_kernel_init_(conv.weight, conv.weight[0].numel(), generator)
    nn.init.zeros_(conv.bias)
