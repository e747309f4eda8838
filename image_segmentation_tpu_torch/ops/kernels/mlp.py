"""K4: fused ViT MLP, x + fc2(quickGELU(fc1(LayerNorm(x)))).

Replaces image_segmentation_tpu/ops/pallas/mlp.py:fused_mlp (the Pallas
kernel at `_fused_mlp_impl`). The CUDA kernel is csrc/mlp.cu; its header
says what bounds it on an H100 and how the design answers that.
`mlp_reference` is the same function in plain PyTorch with the kernel's
cast points (mlp.py:75-88): LayerNorm in f32 → cast to x's dtype → fc1
with f32 accumulation + f32 bias → quick-GELU in f32 → cast → fc2 with
f32 accumulation + f32 bias → cast → residual add in x's dtype.

Weights use the nn.Linear layout: w1 is (F, H), w2 is (H, F).
`fused_mlp` takes the plain version only for tensors on the CPU. On a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import functools

import torch

from image_segmentation_tpu_torch.ops.kernels import _build

# Launches of the CUDA kernel since the last reset (the plain version on
# the CPU does not count).
LAUNCHES = 0

HIDDEN_SIZES = (128, 256, 384, 512, 640, 768)
TOKEN_TILE = 32  # tokens per block (csrc/mlp.cu kTM)
F_SLICE = 64  # F columns per step (csrc/mlp.cu kFT)


def mlp_reference(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5):
    """Plain PyTorch x + fc2(quickGELU(fc1(LN(x)))) with the kernel's casts."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    h = (xf - mu) * torch.rsqrt(var + eps)
    h = (h * ln_w.float() + ln_b.float()).to(x.dtype)
    h = h.float() @ w1.float().t() + b1.float()
    h = (h * torch.sigmoid(1.702 * h)).to(x.dtype)
    y = h.float() @ w2.float().t() + b2.float()
    return x + y.to(x.dtype)


def _check_cuda_args(x, ln_w, ln_b, w1, b1, w2, b2) -> None:
    hdim = x.shape[-1]
    fdim = w1.shape[0]
    if hdim not in HIDDEN_SIZES or fdim % 128:
        raise ValueError(
            f"the CUDA kernel takes H in {HIDDEN_SIZES} and F a multiple of "
            f"128, got H={hdim} F={fdim}")
    shapes = {"ln_w": (hdim,), "ln_b": (hdim,), "w1": (fdim, hdim),
              "b1": (fdim,), "w2": (hdim, fdim), "b2": (hdim,)}
    dtypes = {"x": torch.bfloat16, "w1": torch.bfloat16, "w2": torch.bfloat16,
              "ln_w": torch.float32, "ln_b": torch.float32,
              "b1": torch.float32, "b2": torch.float32}
    args = {"x": x, "ln_w": ln_w, "ln_b": ln_b, "w1": w1, "b1": b1,
            "w2": w2, "b2": b2}
    for name, t in args.items():
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shapes[name]}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"the CUDA kernel takes {name} as {dtypes[name]}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def f_splits(tokens: int, fdim: int, sms: int):
    """(splits, steps per split) cutting the F / F_SLICE steps so that
    token tiles × splits comes to about one block per SM."""
    steps = fdim // F_SLICE
    tiles = -(-tokens // TOKEN_TILE)
    want = max(1, min(steps, -(-sms // tiles)))
    per = -(-steps // want)
    return -(-steps // per), per


def fused_mlp(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5):
    """x: (..., H); returns x + MLP(LN(x)) in x's dtype."""
    if x.device.type == "cpu":
        return mlp_reference(x, ln_w, ln_b, w1, b1, w2, b2, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp runs on cpu or cuda, not {x.device}")
    _check_cuda_args(x, ln_w, ln_b, w1, b1, w2, b2)
    hdim, fdim = x.shape[-1], w1.shape[0]
    m = x.numel() // hdim
    out = torch.empty_like(x)
    if m == 0:
        return out
    lib = _build.load()
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    splits, per = f_splits(m, fdim, _sm_count(dev))
    partial = torch.empty((splits, m, hdim), dtype=torch.float32, device=x.device)
    rc = lib.istpu_mlp_bf16(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), partial.data_ptr(),
        out.data_ptr(), m, hdim, fdim, splits, per, float(eps), dev,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "fused_mlp launch")
    global LAUNCHES
    LAUNCHES += 1
    return out
