"""The reference's arithmetic: convs, products and normalisation in plain
PyTorch, float32, with TF32 off (`fp32_context`).

`Ops()` is the reference itself. `control_ops()` is the control, the
step below the configurations' bfloat16 that would tempt a change: float8
as Hopper's tensor cores take it, each conv's and product's operands in
e4m3 and, in training, the gradient arriving at its output in e5m2, each
tensor under one scale, accumulating in float32.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def fp32_context():
    """float32 products and convs without TF32; the flags restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x through `dtype` under a per-tensor scale that maps its amax to `top`."""
    scale = top / x.abs().amax().clamp(min=1e-12)
    return (x * scale).to(dtype).float() / scale


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3; the gradient passes straight through."""
    return x + (_round(x.detach(), torch.float8_e4m3fn, 448.0) - x).detach()


class _GradE5M2(torch.autograd.Function):
    """The identity; its backward rounds the incoming gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class Ops:
    """The products' rounding, and the normalisations' constants as the
    configuration states them (`configure`): BatchNorm's momentum, the
    weight of the old running statistic as in flax, and epsilon; the
    LayerNorms' epsilon."""

    def __init__(self, quant: Optional[Callable] = None, grad_quant: Optional[Callable] = None):
        self.q = quant or (lambda t: t)
        self.g = grad_quant or (lambda t: t)
        self.bn_momentum, self.bn_eps, self.ln_eps = 0.9, 1e-5, 1e-5

    def configure(self, cfg: dict) -> "Ops":
        self.bn_momentum, self.bn_eps = cfg["bn_momentum"], cfg["bn_eps"]
        self.ln_eps = cfg.get("layer_norm_eps", self.ln_eps)
        return self

    def conv2d(self, x, w, b=None, padding=0, stride=1):
        return self.g(F.conv2d(self.q(x), self.q(w), b, padding=padding, stride=stride))

    def conv_transpose2d(self, x, w, b=None, stride=2):
        return self.g(F.conv_transpose2d(self.q(x), self.q(w), b, stride=stride))

    def linear(self, x, w, b=None):
        return self.g(F.linear(self.q(x), self.q(w), b))

    def matmul(self, a, b):
        return self.g(self.q(a) @ self.q(b))


def control_ops() -> Ops:
    return Ops(fp8_quant, _GradE5M2.apply)


def batch_norm(ops: Ops, x: torch.Tensor, bn, training: bool) -> torch.Tensor:
    """flax BatchNorm semantics on NCHW: in training the batch mean and
    biased variance normalise, and the running statistics move by
    ra = m ra + (1 - m) batch (biased variance); in eval the running ones."""
    shape, m = (1, -1, 1, 1), ops.bn_momentum
    if training:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean.view(shape)) ** 2).mean(dim=(0, 2, 3))
        with torch.no_grad():
            bn.running_mean.mul_(m).add_((1 - m) * mean.detach())
            bn.running_var.mul_(m).add_((1 - m) * var.detach())
    else:
        mean, var = bn.running_mean, bn.running_var
    y = (x - mean.view(shape)) / torch.sqrt(var.view(shape) + ops.bn_eps)
    return y * bn.weight.view(shape) + bn.bias.view(shape)


def layer_norm(x: torch.Tensor, ln, eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * ln.weight + ln.bias
