"""Online, on-device, batched augmentation.

Counterpart of image_segmentation_tpu/ops/augment.py: the reference's
eight offline augmenters (utils/augmentation.ipynb cells 3-15) as
batched tensor ops on fixed-shape (N, S, S, C) float32 images in [0, 1]
and their (N, S, S) integer labels, run on the batch's device inside the
train step:

  rotation U(45°, 315°), scaled down so the rotated canvas fits  (cell 3)
  centre square crop at 0.75 / random square crop U(0.5, 1)      (cell 5)
  coarse dropout p = 0.15 on a round(S/50)² grid, image AND label (cell 7)
  grayscale (BT.601 luma)                                        (cell 9)
  additive per-channel Laplace noise, scale U(0.1, 0.3)          (cell 11)
  average blur k = 12                                            (cell 13)
  linear contrast alpha U(0.2, 0.6) about 0.5                    (cell 15)

A jax.random key cannot be replayed in torch, so each augmenter here is
a pure function of parameters drawn beforehand (`draw_augment_params`,
from an explicit CPU torch.Generator: each row's augmenter and gate on
the host, the augmenters' values on the batch's device), and a test can
hand JAX's own draws to the port. The geometric ones share JAX's f32
index arithmetic (`affine_sample`, JAX :40-76) and gather directly:
torch.round rounds half to even as jnp.round does, where grid_sample's
normalised coordinates would move rounding ties and flip label pixels.
The dropout grid is resized with half-pixel centres, as
jax.image.resize(method="nearest") does (F.interpolate's "nearest" does
not). The blur zero-pads SAME (5 before, 6 after); the offline blur of
data/augment.py replicates the edge instead, and each copies its own
JAX path.

`random_augment_batch` picks one augmenter per sample, or the identity
with probability 1 − p_augment (JAX :229-253), and applies each
augmenter to its rows as one batched call: no per-sample loop, and no
fetch from the device, since the rows are grouped on the host.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

AUGMENTER_NAMES = ("rotation", "center_crop", "random_crop", "masking", "grayscale",
                   "laplace", "blur", "contrast")
IDENTITY = len(AUGMENTER_NAMES)  # the code of a row left as it is
DROPOUT_P, DROPOUT_SIZE_PERCENT = 0.15, 1 / 50
BLUR_K = 12


def dropout_cells(size: int) -> int:
    """The side of the coarse-dropout grid: round(S/50), at least 1 (5 at
    256 px)."""
    return max(1, int(round(size * DROPOUT_SIZE_PERCENT)))


def affine_sample(img: torch.Tensor, A: torch.Tensor, method: str) -> torch.Tensor:
    """Sample each (H, W, C) image of `img` (N, H, W, C) on the output
    grid mapped through its 2×3 affine A[i] (output (y, x, 1) → input
    (y, x)); taps out of range read 0. "nearest" rounds half to even;
    "linear" zero-fills each of its four taps separately."""
    n, h, w = img.shape[:3]
    dev = img.device
    yy = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    a = A.to(torch.float32).reshape(n, 6, 1, 1)
    sy = a[:, 0] * yy + a[:, 1] * xx + a[:, 2]
    sx = a[:, 3] * yy + a[:, 4] * xx + a[:, 5]
    b = torch.arange(n, device=dev).view(n, 1, 1)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = img[b, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(valid[..., None], v, torch.zeros((), dtype=v.dtype, device=dev))

    if method == "nearest":
        return tap(torch.round(sy).long(), torch.round(sx).long())
    if method != "linear":
        raise ValueError(method)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = (sy - y0)[..., None], (sx - x0)[..., None]
    y0i, x0i = y0.long(), x0.long()
    top = tap(y0i, x0i) * (1 - fx) + tap(y0i, x0i + 1) * fx
    bot = tap(y0i + 1, x0i) * (1 - fx) + tap(y0i + 1, x0i + 1) * fx
    return top * (1 - fy) + bot * fy


def _warp(img, label, A) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image bilinear, label nearest, through the same affines."""
    return (affine_sample(img, A, "linear"),
            affine_sample(label[..., None], A, "nearest")[..., 0])


def _affine(a00, a01, a02, a10, a11, a12) -> torch.Tensor:
    """(N, 2, 3) from six (N,) rows (or scalars broadcast to them)."""
    rows = torch.broadcast_tensors(a00, a01, a02, a10, a11, a12)
    return torch.stack(rows, dim=-1).view(-1, 2, 3)


@functools.lru_cache(maxsize=1)
def _libm():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("cosf", "sinf"):
        fn = getattr(libm, name)
        fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return libm


def _cos_sin(rad: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of (N,) f32 radians. On the CPU they are the C library's
    cosf and sinf, which XLA's CPU backend calls for jnp.cos and jnp.sin.
    On a card, the float64 values rounded to f32. Those differ from cosf
    and sinf by one ulp for about 2% of angles in U(45°, 315°), and one
    ulp of the rotation moves a 256 px sample by up to 1e-4 and flips
    label pixels at rounding ties: past what the CPU parity with JAX
    holds (1e-5), so the CPU keeps the C library's."""
    if rad.device.type != "cpu":
        r = rad.double()
        return torch.cos(r).float(), torch.sin(r).float()
    libm, vals = _libm(), rad.tolist()
    return (torch.tensor([libm.cosf(v) for v in vals], dtype=torch.float32),
            torch.tensor([libm.sinf(v) for v in vals], dtype=torch.float32))


def rotate_fit(img, label, angle_deg):
    """Rotate each sample by its angle (degrees) about the centre, scaled
    by 1 / (|cos| + |sin|) so the rotated canvas fits (JAX `rotate_fit`
    :105, `_center_affine` :79: the inverse map)."""
    rad = angle_deg.to(torch.float32) * (math.pi / 180.0)
    cos, sin = _cos_sin(rad)
    fit = 1.0 / (torch.abs(cos) + torch.abs(sin))
    inv_s = 1.0 / fit
    c = (img.shape[1] - 1) / 2.0
    a00, a01, a10, a11 = cos * inv_s, sin * inv_s, -sin * inv_s, cos * inv_s
    return _warp(img, label, _affine(a00, a01, c - a00 * c - a01 * c,
                                     a10, a11, c - a10 * c - a11 * c))


def random_square_crop(img, label, s, oy, ox):
    """Zoom-crop: output (y, x) samples input (s·y + oy, s·x + ox). The
    draws bound the offset by (S − 1)(1 − s) (JAX :127-133), so the last
    output pixel stays inside the image."""
    zero = torch.zeros_like(s)
    return _warp(img, label, _affine(s, zero, oy, zero, s, ox))


def center_square_crop(img, label, scale: float = 0.75):
    """Centre zoom-crop at a fixed scale (JAX :142)."""
    n, size = img.shape[0], img.shape[1]
    s = torch.full((n,), scale, dtype=torch.float32, device=img.device)
    off = torch.full_like(s, (1.0 - scale) * size / 2.0)
    zero = torch.zeros_like(s)
    return _warp(img, label, _affine(s, zero, off, zero, s, off))


def coarse_dropout(img, label, keep):
    """Zero the image AND the label under the dropped cells of `keep`
    (N, cells, cells) bool, resized to (S, S) with half-pixel centres as
    jax.image.resize(method="nearest") does (JAX :155-167)."""
    size, cells = img.shape[1], keep.shape[1]
    idx = torch.floor((torch.arange(size, dtype=torch.float32, device=img.device) + 0.5)
                      * cells / size).long()
    mask = keep[:, idx][:, :, idx]
    return img * mask[..., None].to(img.dtype), label * mask.to(label.dtype)


def grayscale(img, label):
    """ITU-R BT.601 luma in all three channels (JAX :170)."""
    luma = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return torch.stack([luma, luma, luma], dim=-1), label


def laplace_noise(img, label, scale, noise):
    """clip(img + noise·scale, 0, 1): `noise` unit Laplace of img's shape,
    `scale` (N,) (JAX :176)."""
    return torch.clamp(img + noise * scale.view(-1, 1, 1, 1), 0.0, 1.0), label


def average_blur(img, label, k: int = BLUR_K):
    """k×k box blur, separable, SAME padding with zeros: (k − 1)//2 pixels
    before, k//2 after (5 and 6 at k = 12), as XLA's SAME convolution
    pads (JAX :185-197)."""
    x = img.permute(0, 3, 1, 2)
    lo, hi = (k - 1) // 2, k // 2
    x = F.avg_pool2d(F.pad(x, (0, 0, lo, hi)), (k, 1), stride=1)
    x = F.avg_pool2d(F.pad(x, (lo, hi, 0, 0)), (1, k), stride=1)
    return x.permute(0, 2, 3, 1).contiguous(), label


def linear_contrast(img, label, alpha):
    """clip(0.5 + alpha·(img − 0.5), 0, 1), alpha (N,) (JAX :199)."""
    return torch.clamp(0.5 + alpha.view(-1, 1, 1, 1) * (img - 0.5), 0.0, 1.0), label


class AugmentParams(NamedTuple):
    """Per-sample draws of one batch, each a tensor with the batch as its
    first dim: the augmenter index `sel` and the gate `use`, on the host,
    then every augmenter's own values, on the batch's device (only the
    chosen one's are read)."""

    sel: torch.Tensor  # (N,) int64 in [0, 8), CPU
    use: torch.Tensor  # (N,) bool: augment (else the identity), CPU
    angle: torch.Tensor  # (N,) degrees, rotation
    crop_s: torch.Tensor  # (N,) random crop scale
    crop_oy: torch.Tensor  # (N,) random crop offsets
    crop_ox: torch.Tensor
    keep: torch.Tensor  # (N, cells, cells) bool, coarse dropout
    noise_scale: torch.Tensor  # (N,) Laplace scale
    noise: torch.Tensor  # (N, S, S, C) unit Laplace
    alpha: torch.Tensor  # (N,) contrast

    def take(self, rows: torch.Tensor) -> "AugmentParams":
        """The augmenters' values of `rows` (on their device); `sel` and
        `use` are left out (None): no augmenter reads them."""
        return AugmentParams(None, None, *(t.index_select(0, rows) for t in self[2:]))


# name → fn(img, label, params of those rows), in AUGMENTER_NAMES order
AUGMENTERS: Tuple[Tuple[str, Callable], ...] = (
    ("rotation", lambda im, lb, p: rotate_fit(im, lb, p.angle)),
    ("center_crop", lambda im, lb, p: center_square_crop(im, lb)),
    ("random_crop", lambda im, lb, p: random_square_crop(im, lb, p.crop_s, p.crop_oy,
                                                         p.crop_ox)),
    ("masking", lambda im, lb, p: coarse_dropout(im, lb, p.keep)),
    ("grayscale", lambda im, lb, p: grayscale(im, lb)),
    ("laplace", lambda im, lb, p: laplace_noise(im, lb, p.noise_scale, p.noise)),
    ("blur", lambda im, lb, p: average_blur(im, lb)),
    ("contrast", lambda im, lb, p: linear_contrast(im, lb, p.alpha)),
)


def draw_augment_params(n: int, size: int, generator: torch.Generator, device="cpu",
                        p_augment: float = 0.5, channels: int = 3) -> AugmentParams:
    """Draw a batch's parameters with JAX's distributions: the augmenter
    uniform over the eight, the gate U(0, 1) < p_augment, angle U(45, 315),
    crop s U(0.5, 1) and offsets U(0, (S − 1)(1 − s)), dropout keep
    U(0, 1) ≥ 0.15, Laplace scale U(0.1, 0.3), contrast U(0.2, 0.6).
    `generator` (a CPU generator) draws the augmenter and the gate on the
    host, so that grouping the rows needs nothing from the device, and
    then the seed of a generator on `device` that draws the rest there."""
    sel = torch.randint(0, IDENTITY, (n,), generator=generator)
    use = torch.rand(n, generator=generator) < p_augment
    seed = int(torch.randint(0, 2**62, (), generator=generator))
    dev = torch.device(device)
    dev_gen = torch.Generator(dev).manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=dev_gen, device=dev)

    angle = 45.0 + u(n) * 270.0
    s = 0.5 + u(n) * 0.5
    oy = u(n) * ((size - 1.0) * (1.0 - s))
    ox = u(n) * ((size - 1.0) * (1.0 - s))
    cells = dropout_cells(size)
    keep = u(n, cells, cells) >= DROPOUT_P
    noise_scale = 0.1 + u(n) * 0.2
    # unit Laplace: an Exp(1) magnitude with a fair sign
    mag = torch.empty((n, size, size, channels), device=dev).exponential_(generator=dev_gen)
    noise = torch.where(u(n, size, size, channels) < 0.5, -mag, mag)
    alpha = 0.2 + u(n) * 0.4
    return AugmentParams(sel, use, angle, s, oy, ox, keep, noise_scale, noise, alpha)


def apply_augment_batch(images: torch.Tensor, labels: torch.Tensor,
                        params: AugmentParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply each row's augmenter (or none, where `use` is false): the rows
    are grouped by augmenter and each group goes through its augmenter as
    one batched call. The grouping is done on the host from `sel` and
    `use`, and the row order goes to the device without waiting on it."""
    code = torch.where(params.use, params.sel, torch.full_like(params.sel, IDENTITY))
    order = torch.argsort(code, stable=True)
    counts = torch.bincount(code, minlength=IDENTITY + 1).tolist()
    if images.is_cuda:
        order = order.pin_memory().to(images.device, non_blocking=True)
    out_img, out_lab = images.clone(), labels.clone()
    start = 0
    for (_, fn), count in zip(AUGMENTERS, counts):
        if count:
            rows = order[start:start + count]
            img, lab = fn(images.index_select(0, rows), labels.index_select(0, rows),
                          params.take(rows))
            out_img.index_copy_(0, rows, img)
            out_lab.index_copy_(0, rows, lab)
        start += count
    return out_img, out_lab


def random_augment_batch(images: torch.Tensor, labels: torch.Tensor,
                         generator: torch.Generator, p_augment: float = 0.5,
                         rows: Optional[np.ndarray] = None, total: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One augmenter chosen uniformly per sample, or the identity with
    probability 1 − p_augment (JAX `random_augment_batch` :229): draws
    from `generator` (a CPU generator), then `apply_augment_batch`.

    With `rows` and `total`, `images` and `labels` are those rows of a
    batch of `total` rows (a process's share of a step batch): the draws
    are made for all `total` rows, as one process holding the batch would
    make them, and each row gets its own (every augmenter acts on each row
    alone, so the rows come out as that process's would)."""
    n, size, _, channels = images.shape
    params = draw_augment_params(n if total is None else total, size, generator,
                                 images.device, p_augment, channels)
    if rows is not None:
        host = torch.as_tensor(rows, dtype=torch.long)
        params = AugmentParams(params.sel[host], params.use[host],
                               *params.take(host.to(images.device))[2:])
    return apply_augment_batch(images, labels, params)
