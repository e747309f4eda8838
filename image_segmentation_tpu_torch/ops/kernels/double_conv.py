"""K1: fused double conv, [conv3×3 pad 1 → ·scale + bias → ReLU] × 2, NHWC.

Replaces image_segmentation_tpu/ops/pallas/double_conv.py:fused_double_conv
(the Pallas kernel at `_dc_kernel`) and its `fold_bn`. The CUDA kernel is
csrc/double_conv.cu, one conv3×3 with its epilogue; the wrapper runs it
twice through a bf16 intermediate, which is exactly the Pallas kernel's
result (it rounds the intermediate to the input dtype too). The source
header says what bounds it on an H100 and how the design answers that.

`double_conv_reference` is the same function in plain PyTorch with the
kernel's cast points (reference_double_conv, double_conv.py:209-220):
conv on the f32 values of the operands, ·scale + bias, ReLU, rounded to
x's dtype; twice.

Layout is the JAX package's: x (N, H, W, Cin) NHWC, w (3, 3, Cin, C) HWIO,
scale and bias (C,) f32. `fused_double_conv` takes the plain version only
for tensors on the CPU. On a CUDA tensor it launches the kernel (bf16,
contiguous NHWC, which is an NCHW tensor in channels_last memory
permuted to NHWC) or raises.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from image_segmentation_tpu_torch.ops.kernels import _build

# Calls of the CUDA double conv since the last reset (each is two conv
# launches, plus two split-K epilogues at the small levels); the plain
# version on the CPU does not count.
LAUNCHES = 0

CHUNK = 16  # input channels per K step (csrc/double_conv.cu kKC)
CO_BLOCK = 64  # output channels per block (kBN)
TILE_H, TILE_W = 8, 16  # output pixels per block (kTH, kTW)
MIN_CHUNKS_PER_SPLIT = 4


def fold_bn(conv_bias: Optional[torch.Tensor], bn_mean: torch.Tensor,
            bn_var: torch.Tensor, bn_scale: torch.Tensor, bn_bias: torch.Tensor,
            eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, bias) in f32 with conv(x)·scale + bias ≡ BN(conv(x) + b)."""
    inv = bn_scale.float() / torch.sqrt(bn_var.float() + eps)
    b = conv_bias.float() if conv_bias is not None else 0.0
    return inv, (b - bn_mean.float()) * inv + bn_bias.float()


def _conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC x, HWIO w → NCHW f32 conv (pad 1) of the operands' f32 values."""
    return F.conv2d(x.permute(0, 3, 1, 2).float(), w.permute(3, 2, 0, 1).float(), padding=1)


def double_conv_reference(x, w1, scale1, bias1, w2, scale2, bias2) -> torch.Tensor:
    """Plain PyTorch double conv with the kernel's cast points; NHWC out in x's dtype."""
    def conv_scale_relu(v, w, s, b):
        y = _conv3x3(v, w) * s.float().view(1, -1, 1, 1) + b.float().view(1, -1, 1, 1)
        return torch.relu(y).to(x.dtype).permute(0, 2, 3, 1)

    y = conv_scale_relu(x, w1, scale1, bias1)
    return conv_scale_relu(y, w2, scale2, bias2).contiguous()


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def k_splits(n: int, h: int, w: int, cin: int, cout: int, sms: int) -> Tuple[int, int]:
    """(splits, chunks per split) of the ceil(cin / CHUNK) K steps: none
    when the spatial tiles and channel blocks fill the SMs, else enough for
    about two blocks per SM, each split keeping MIN_CHUNKS_PER_SPLIT."""
    chunks = -(-cin // CHUNK)
    blocks = n * -(-h // TILE_H) * -(-w // TILE_W) * -(-cout // CO_BLOCK)
    want = 1 if blocks >= sms else -(-2 * sms // blocks)
    want = max(1, min(want, chunks // MIN_CHUNKS_PER_SPLIT))
    per = -(-chunks // want)
    return -(-chunks // per), per


def _check_cuda_args(x, w1, scale1, bias1, w2, scale2, bias2) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin), got {tuple(x.shape)}")
    cin, c = x.shape[-1], w1.shape[-1]
    shapes = {"w1": (3, 3, cin, c), "w2": (3, 3, c, c), "scale1": (c,), "bias1": (c,),
              "scale2": (c,), "bias2": (c,)}
    args = {"x": x, "w1": w1, "scale1": scale1, "bias1": bias1, "w2": w2,
            "scale2": scale2, "bias2": bias2}
    for name, t in args.items():
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shapes[name]}")
        want = torch.bfloat16 if name in ("x", "w1", "w2") else torch.float32
        if t.dtype != want:
            raise TypeError(f"the CUDA kernel takes {name} as {want}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must be contiguous and 16-byte aligned (x an NHWC tensor, which "
                f"is an NCHW tensor in channels_last memory permuted to NHWC; w HWIO); "
                f"got strides {t.stride()}")
    if c % 8:
        raise ValueError(f"the CUDA kernel takes C a multiple of 8, got {c}")


def _conv(lib, x: torch.Tensor, w: torch.Tensor, scale, bias, dev: int, stream: int):
    """One kernel conv3×3 → ·scale + bias → ReLU; x NHWC, w HWIO, both
    contiguous bf16 with Cin % 8 == 0."""
    n, h, wd, cin = x.shape
    c = w.shape[-1]
    y = torch.empty((n, h, wd, c), dtype=x.dtype, device=x.device)
    splits, per = k_splits(n, h, wd, cin, c, _sm_count(dev))
    partial = (torch.empty((splits, n * h * wd, c), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    rc = lib.istpu_conv3x3_bf16(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        None if partial is None else partial.data_ptr(), n, h, wd, cin, c, splits, per,
        dev, stream)
    _build.check(rc, "fused_double_conv launch")
    return y


def fused_double_conv(x, w1, scale1, bias1, w2, scale2, bias2) -> torch.Tensor:
    """x (N, H, W, Cin), w (3, 3, Cin, C) HWIO, scale/bias (C,) f32 →
    (N, H, W, C) in x's dtype."""
    if x.device.type == "cpu":
        return double_conv_reference(x, w1, scale1, bias1, w2, scale2, bias2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_double_conv runs on cpu or cuda, not {x.device}")
    _check_cuda_args(x, w1, scale1, bias1, w2, scale2, bias2)
    if x.numel() == 0:
        return torch.empty(x.shape[:3] + (w1.shape[-1],), dtype=x.dtype, device=x.device)
    if x.shape[-1] % 8:  # the RGB stem: zero channels up to 16-byte pixels
        pad = 8 - x.shape[-1] % 8
        x, w1 = F.pad(x, (0, pad)), F.pad(w1, (0, 0, 0, pad))
    lib = _build.load()
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    mid = _conv(lib, x, w1, scale1, bias1, dev, stream)
    out = _conv(lib, mid, w2, scale2, bias2, dev, stream)
    global LAUNCHES
    LAUNCHES += 1
    return out
