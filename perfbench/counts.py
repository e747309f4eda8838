"""The yardstick's arithmetic: the card's peaks, and the operations and bytes
of each hand-written kernel's call, computed from its shapes.

A call's bound is the least time the card could take for it: the larger of
its bf16 operations over the peak rate and its bytes over the memory
bandwidth, each input read once and each output written once. Peaks are
NVIDIA's data sheet for the H100 SXM (dense, no sparsity) at its 700 W
limit; `run.py` prints the card's power limit beside every share.
"""
from __future__ import annotations

import math
from typing import Tuple

PEAK_BF16_FLOPS = 989e12  # FLOP/s, bf16 tensor cores, dense
PEAK_HBM_BYTES = 3.35e12  # bytes/s, HBM3
BF16, F32 = 2, 4


def bound_s(flops: float, nbytes: float) -> Tuple[float, str]:
    """(seconds, 'operations' or 'bytes'): the larger of the two times."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_counts(n: int, h: int, w: int, cin: int, c: int) -> Tuple[float, float]:
    """K1, one double conv [conv3x3 -> scale, bias -> ReLU] x 2 on NHWC bf16:
    (FLOPs, bytes). The input's `cin` real channels (a concat's two sources
    together); the bf16 intermediate stays inside the call."""
    pix = n * h * w
    flops = 2 * 9 * pix * (cin * c + c * c)
    nbytes = BF16 * (pix * cin + 9 * cin * c + 9 * c * c + pix * c) + F32 * 4 * c
    return flops, nbytes


def k3_counts(b: int, s: int, heads: int, d: int) -> Tuple[float, float]:
    """K3, softmax(QK^T / sqrt(d)) V on (B, S, H, D) bf16: (FLOPs, bytes)."""
    flops = 2 * 2 * b * heads * s * s * d
    nbytes = BF16 * 4 * b * s * heads * d  # q, k, v in; out
    return flops, nbytes


def k4_counts(tokens: int, hidden: int, ffn: int) -> Tuple[float, float]:
    """K4, x + fc2(quickGELU(fc1(LN(x)))) with bf16 x and weights, f32
    LayerNorm parameters and biases: (FLOPs, bytes)."""
    flops = 2 * 2 * tokens * hidden * ffn
    nbytes = (BF16 * (2 * tokens * hidden + 2 * hidden * ffn)
              + F32 * (2 * hidden + ffn + hidden))
    return flops, nbytes


# the nine double convs of the 256 px UNet-64 as (side, cin, c)
UNET64_LEVELS = ((256, 3, 64), (128, 64, 128), (64, 128, 256), (32, 256, 512),
                 (16, 512, 1024), (32, 1024, 512), (64, 512, 256), (128, 256, 128),
                 (256, 128, 64))


def conv_flops(pixels_out: int, cin: int, cout: int, k: int) -> float:
    """A k x k conv (or a transpose conv's k x k taps per input pixel, with
    `pixels_out` its input pixels): 2 * pixels * k^2 * cin * cout."""
    return 2.0 * pixels_out * k * k * cin * cout


def percent(num: float, den: float):
    """100 * num / den, or None where there is nothing to divide by."""
    if not den or not math.isfinite(num / den):
        return None
    return 100.0 * num / den
