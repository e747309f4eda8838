"""The plain reference U-Net (in5omnia/Image_Segmentation `unet/unet.py`):
a DoubleConv stem, four max pool + DoubleConv levels, four up blocks
(transpose conv 2x2 stride 2, concat [skip, up], DoubleConv), a 1x1 head.
Every DoubleConv is [conv3x3 pad 1 with bias -> BatchNorm -> ReLU] x 2.

float32 throughout, NHWC in and out; parameter names are the served
model's state-dict keys, so one set of seeded weights loads into both.
"""
from __future__ import annotations

import torch
from torch import nn

from perfbench.reference.ops import Ops, batch_norm


class Conv(nn.Module):
    """Holds a conv's weight (out, in, k, k) and bias."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True, transpose=False):
        super().__init__()
        shape = (cin, cout, k, k) if transpose else (cout, cin, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None


class BN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))


class ConvBNRelu(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.conv = Conv(cin, cout, 3, bias)
        self.bn = BN(cout)

    def run(self, ops: Ops, x, training: bool):
        y = ops.conv2d(x, self.conv.weight, self.conv.bias, padding=1)
        return torch.relu(batch_norm(ops, y, self.bn, training))


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.conv1 = ConvBNRelu(cin, cout, bias)
        self.conv2 = ConvBNRelu(cout, cout, bias)

    def run(self, ops, x, training):
        return self.conv2.run(ops, self.conv1.run(ops, x, training), training)


class Down(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, cout)

    def run(self, ops, x, training):
        return self.conv.run(ops, torch.nn.functional.max_pool2d(x, 2), training)


class UpConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = Conv(cin, cout, 2, transpose=True)

    def run(self, ops, x):
        return ops.conv_transpose2d(x, self.up.weight, self.up.bias)


class Up(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = UpConv(cin, cout)
        self.conv = DoubleConv(2 * cout, cout)

    def run(self, ops, skip, x, training):
        return self.conv.run(ops, torch.cat([skip, self.up.run(ops, x)], 1), training)


class UNet(nn.Module):
    """forward(x (N, H, W, Cin) in [0, 1]) -> float32 logits (N, H, W, classes)."""

    def __init__(self, base: int = 64, num_classes: int = 4, in_channels: int = 3,
                 ops: Ops = None):
        super().__init__()
        self.ops = ops or Ops()
        b = base
        self.down1 = DoubleConv(in_channels, b)
        self.down2, self.down3 = Down(b, 2 * b), Down(2 * b, 4 * b)
        self.down4, self.down5 = Down(4 * b, 8 * b), Down(8 * b, 16 * b)
        self.up1, self.up2 = Up(16 * b, 8 * b), Up(8 * b, 4 * b)
        self.up3, self.up4 = Up(4 * b, 2 * b), Up(2 * b, b)
        self.output = Conv(b, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ops, t = self.ops, self.training
        x1 = self.down1.run(ops, x.float().permute(0, 3, 1, 2), t)
        x2 = self.down2.run(ops, x1, t)
        x3 = self.down3.run(ops, x2, t)
        x4 = self.down4.run(ops, x3, t)
        y = self.up1.run(ops, x4, self.down5.run(ops, x4, t), t)
        y = self.up2.run(ops, x3, y, t)
        y = self.up3.run(ops, x2, y, t)
        y = self.up4.run(ops, x1, y, t)
        return ops.conv2d(y, self.output.weight, self.output.bias).permute(0, 2, 3, 1)
