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

`fused_double_conv_cat(skip, up, ...)` is the double conv of the channel
concat [skip, up] (the up block's, skip FIRST as in blocks.py:71): on a
card the kernel's first conv reads the two tensors itself, so the concat
is never written; its plain version is `double_conv_reference` of
`torch.cat([skip, up], -1)`.

Layout is the JAX package's: x (N, H, W, Cin) NHWC, w (3, 3, Cin, C) HWIO,
scale and bias (C,) f32. The wrappers take the plain version only for
tensors on the CPU. On a CUDA tensor they launch the kernel (bf16,
contiguous NHWC, which is an NCHW tensor in channels_last memory
permuted to NHWC) or raise. The kernel has no backward: under grad mode
a CUDA argument that requires grad is refused.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from image_segmentation_tpu_torch.ops.kernels import _build

# Calls of the CUDA double conv since the last reset (each is two conv
# launches, plus a split-K epilogue where a conv is split); the plain
# version on the CPU does not count.
LAUNCHES = 0

CHUNK = 64  # input channels per K step (csrc/double_conv.cu kKC)
TILE_H, TILE_W = 16, 16  # output pixels per tile (kTH, kTW)
CO_TILE = 64  # output channels per tile (kBN)
MIN_STEPS_PER_SPLIT = 2  # K steps (chunk, dx) a split keeps at least


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


def double_conv_cat_reference(skip, up, w1, scale1, bias1, w2, scale2,
                              bias2) -> torch.Tensor:
    """The plain version of `fused_double_conv_cat`: concat [skip, up], then
    `double_conv_reference`."""
    return double_conv_reference(torch.cat([skip, up], dim=-1), w1, scale1, bias1, w2,
                                 scale2, bias2)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How csrc/double_conv.cu cuts one conv: tiles of TILE_H × TILE_W
    pixels × CO_TILE output channels, the 3 × chunks K steps (chunk, dx;
    each step the three taps of one column offset) in `splits` runs of
    `per_split`, and `blocks` persistent blocks, one an SM, sharing the
    tiles × splits."""

    splits: int
    per_split: int
    steps: int
    blocks: int


def conv_plan(n: int, h: int, w: int, cin: int, cout: int, sms: int,
              cin2: int = 0) -> ConvPlan:
    """The cut of a conv over `cin` (+ `cin2`, the concat's second source)
    input channels on a card with `sms` SMs, one persistent block an SM.

    K is split only when the tiles are fewer than the SMs (the 16² to 64²
    levels of one request). The split count is the one that minimises the
    K steps the slowest block runs, rounds of tiles × splits over the SMs
    times steps per split, plus one for the reduction kernel; on a tie the
    fewer splits, each of at least MIN_STEPS_PER_SPLIT steps."""
    tiles = n * -(-h // TILE_H) * -(-w // TILE_W) * -(-cout // CO_TILE)
    steps = 3 * (-(-cin // CHUNK) + -(-cin2 // CHUNK))
    best = (steps, 1, steps)  # (cost, splits, per_split) unsplit: one round at most
    if tiles < sms:
        for want in range(2, steps // MIN_STEPS_PER_SPLIT + 1):
            per = -(-steps // want)
            splits = -(-steps // per)
            cost = -(-tiles * splits // sms) * per + 1
            if cost < best[0]:
                best = (cost, splits, per)
    _, splits, per = best
    return ConvPlan(splits, per, steps, min(sms, tiles * splits))


def _check_cuda_args(xs, w1, scale1, bias1, w2, scale2, bias2) -> None:
    x = xs[0]
    if any(t.dim() != 4 for t in xs):
        raise ValueError(f"x must be (N, H, W, Cin), got {[tuple(t.shape) for t in xs]}")
    if any(t.shape[:3] != x.shape[:3] for t in xs):
        raise ValueError(f"skip and up differ in (N, H, W): {[tuple(t.shape) for t in xs]}")
    cin, c = sum(t.shape[-1] for t in xs), w1.shape[-1]
    shapes = {"w1": (3, 3, cin, c), "w2": (3, 3, c, c), "scale1": (c,), "bias1": (c,),
              "scale2": (c,), "bias2": (c,)}
    args = {**dict(zip(("x",) if len(xs) == 1 else ("skip", "up"), xs)),
            "w1": w1, "scale1": scale1, "bias1": bias1, "w2": w2, "scale2": scale2,
            "bias2": bias2}
    for name, t in args.items():
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shapes[name]}")
        want = torch.float32 if name.startswith(("scale", "bias")) else torch.bfloat16
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
    if len(xs) == 2 and any(t.shape[-1] % 8 for t in xs):
        raise ValueError(f"the CUDA kernel takes skip and up channels that are multiples "
                         f"of 8, got {[t.shape[-1] for t in xs]}")
    _build.refuse_grad("fused_double_conv", *args.values())


def _conv(lib, x0: torch.Tensor, x1: Optional[torch.Tensor], w: torch.Tensor, scale, bias,
          dev: int, stream: int) -> torch.Tensor:
    """One kernel conv3×3 → ·scale + bias → ReLU over the channels of x0
    then x1 (NHWC, C % 8 == 0); w HWIO, all contiguous bf16."""
    n, h, wd, c0 = x0.shape
    c1 = 0 if x1 is None else x1.shape[-1]
    c = w.shape[-1]
    y = torch.empty((n, h, wd, c), dtype=x0.dtype, device=x0.device)
    plan = conv_plan(n, h, wd, c0, c, _sm_count(dev), c1)
    partial = (torch.empty((plan.splits, n * h * wd, c), dtype=torch.float32,
                           device=x0.device) if plan.splits > 1 else None)
    rc = lib.istpu_conv3x3_bf16(
        x0.data_ptr(), None if x1 is None else x1.data_ptr(), w.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), y.data_ptr(), None if partial is None else partial.data_ptr(),
        n, h, wd, c0, c1, c, plan.splits, plan.per_split, plan.blocks, dev, stream)
    _build.check(rc, "fused_double_conv launch")
    return y


def _launch(xs, w1, scale1, bias1, w2, scale2, bias2) -> torch.Tensor:
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(f"fused_double_conv runs on cpu or cuda, not {x.device}")
    _check_cuda_args(xs, w1, scale1, bias1, w2, scale2, bias2)
    if x.numel() == 0:
        return torch.empty(x.shape[:3] + (w1.shape[-1],), dtype=x.dtype, device=x.device)
    if len(xs) == 1 and x.shape[-1] % 8:  # the RGB stem: zero channels up to 16-byte pixels
        pad = 8 - x.shape[-1] % 8
        xs, w1 = (F.pad(x, (0, pad)),), F.pad(w1, (0, 0, 0, pad))
    lib = _build.load()
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    mid = _conv(lib, xs[0], xs[1] if len(xs) == 2 else None, w1, scale1, bias1, dev, stream)
    out = _conv(lib, mid, None, w2, scale2, bias2, dev, stream)
    global LAUNCHES
    LAUNCHES += 1
    return out


def fused_double_conv(x, w1, scale1, bias1, w2, scale2, bias2) -> torch.Tensor:
    """x (N, H, W, Cin), w (3, 3, Cin, C) HWIO, scale/bias (C,) f32 →
    (N, H, W, C) in x's dtype."""
    if x.device.type == "cpu":
        return double_conv_reference(x, w1, scale1, bias1, w2, scale2, bias2)
    return _launch((x,), w1, scale1, bias1, w2, scale2, bias2)


def fused_double_conv_cat(skip, up, w1, scale1, bias1, w2, scale2, bias2) -> torch.Tensor:
    """The double conv of concat [skip, up] along channels, without the
    concat: skip (N, H, W, Cs), up (N, H, W, Cu), w1 (3, 3, Cs + Cu, C)."""
    if skip.device.type == "cpu":
        return double_conv_cat_reference(skip, up, w1, scale1, bias1, w2, scale2, bias2)
    return _launch((skip, up), w1, scale1, bias1, w2, scale2, bias2)
