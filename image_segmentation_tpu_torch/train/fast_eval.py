"""Device-side original-resolution evaluation.

Counterpart of image_segmentation_tpu/train/fast_eval.py. The reference
protocol (utils/training.py:67-121) un-pads each prediction, resizes it
bilinearly back to the image's native (h, w), and computes the loss and
the confusion counts there. The inverse is an affine resampling, so each
image's native-size scores fit on a static canvas of the dataset's
largest native size (rounded up to 8), content at [0:h, 0:w]; the label
canvases hold FILL outside the image, which drops out of everything.

Per image the inverse is two interpolation matrices, rows Ay (Hc, T) and
columns Ax (Wc, T): align_corners=False bilinear (output pixel o samples
pad + (o + 0.5)·new/orig − 0.5), taps outside the crop [pad, pad + new)
dropped and the rest renormalised. That is JAX's resample-(scores ·
crop mask)-and-divide-by-resampled-mask (`_invert_one_to_canvas`,
:141-178): the triangle kernel is separable, so the divide is a
per-row and per-column renormalisation. A batch is two batched matmuls,
Ay · S · Axᵀ per image and class. Argmax, the masked per-image loss and
the per-image confusion (FILL dropping out, the padded tail of the last
batch masked by `real`) run on the device; only a (C, C) matrix and (B,)
losses come back.

`pack_label_canvases` and `plan_size_buckets` are numpy, as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from image_segmentation_tpu_torch.losses.combos import DiceCELoss, DiceNLLLoss
from image_segmentation_tpu_torch.losses.dice import keep_vector, one_hot
from image_segmentation_tpu_torch.metrics.confusion import confusion_counts_per_image

FILL = 255  # canvas fill marking out-of-image pixels (labels are 0..C-1)


def pack_label_canvases(orig_labels, multiple: int = 8) -> np.ndarray:
    """Pack native-size (h, w) label maps into one (N, Hc, Wc) uint8 array,
    content top-left, FILL elsewhere; Hc, Wc the dataset maxima rounded up
    to `multiple`."""
    hc = max(l.shape[0] for l in orig_labels)
    wc = max(l.shape[1] for l in orig_labels)
    hc = -(-hc // multiple) * multiple
    wc = -(-wc // multiple) * multiple
    out = np.full((len(orig_labels), hc, wc), FILL, dtype=np.uint8)
    for i, lab in enumerate(orig_labels):
        out[i, : lab.shape[0], : lab.shape[1]] = lab.astype(np.uint8)
    return out


def plan_size_buckets(orig_labels, multiple: int = 8, max_buckets: int = 4,
                      min_bucket: int = 8, min_gain: float = 0.15):
    """Partition image indices into ≤ `max_buckets` canvas-size buckets
    (JAX fast_eval.py:64-138, the same output): sort by rounded canvas
    area, exact DP over the split points minimising Σ size × max_h × max_w
    with every bucket ≥ `min_bucket` images, and accept one more bucket
    only while it saves ≥ `min_gain` of the cost. Returns int index arrays
    (original order inside each bucket)."""
    n = len(orig_labels)
    hs = np.asarray([-(-l.shape[0] // multiple) * multiple for l in orig_labels], np.int64)
    ws = np.asarray([-(-l.shape[1] // multiple) * multiple for l in orig_labels], np.int64)
    if n < 2 * min_bucket or max_buckets <= 1:
        return [np.arange(n)]
    order = np.argsort(hs * ws, kind="stable")
    sh, sw = hs[order], ws[order]
    kmax = min(max_buckets, n // min_bucket)

    # dp[k][j] = least cost of the first j sorted items in k + 1 buckets
    dp = np.full((kmax, n + 1), np.inf)
    parent = np.zeros((kmax, n + 1), np.int64)
    for j in range(1, n + 1):
        rmax_h = np.maximum.accumulate(sh[:j][::-1])[::-1]
        rmax_w = np.maximum.accumulate(sw[:j][::-1])[::-1]
        cost_ij = (j - np.arange(j)) * rmax_h * rmax_w  # cost(i, j), i = 0..j-1
        dp[0][j] = cost_ij[0]
        for k in range(1, kmax):
            lo, hi = k * min_bucket, j - min_bucket + 1
            if hi <= lo or j < (k + 1) * min_bucket:
                continue
            cand = dp[k - 1][lo:hi] + cost_ij[lo:hi]
            a = int(np.argmin(cand))
            dp[k][j] = cand[a]
            parent[k][j] = lo + a

    best_k = 0
    for k in range(1, kmax):
        if dp[k][n] < (1.0 - min_gain) * dp[best_k][n]:
            best_k = k
    bounds = [n]
    k, j = best_k, n
    while k > 0:
        j = int(parent[k][j])
        bounds.append(j)
        k -= 1
    bounds.append(0)
    bounds = bounds[::-1]
    return [np.sort(order[bounds[b]:bounds[b + 1]]) for b in range(len(bounds) - 1)]


def _axis_matrix(orig: torch.Tensor, new: torch.Tensor, pad: torch.Tensor,
                 out_size: int, t: int) -> torch.Tensor:
    """(B, out_size, t) float32 interpolation matrices for one axis: row o
    < orig samples input pad + (o + 0.5)·new/orig − 0.5 with triangle
    weights over the in-crop taps [pad, pad + new), renormalised; rows at
    and past orig are zero (outside the image)."""
    dev = orig.device
    o = torch.arange(out_size, device=dev, dtype=torch.float32)
    j = torch.arange(t, device=dev, dtype=torch.float32)
    ratio = (new.float() / orig.float())[:, None]
    sample = pad.float()[:, None] + (o[None, :] + 0.5) * ratio - 0.5  # (B, out)
    w = (1.0 - (sample[:, :, None] - j).abs()).clamp_min(0.0)
    in_crop = (j >= pad[:, None]) & (j < (pad + new)[:, None])  # (B, t)
    in_image = o[None, :] < orig[:, None]  # (B, out)
    w = w * in_crop[:, None, :] * in_image[:, :, None]
    return w / w.sum(-1, keepdim=True).clamp_min(1e-6)


def invert_to_canvas(scores: torch.Tensor, metas: dict, canvas_hw) -> torch.Tensor:
    """(B, T, T, C) scores → (B, Hc, Wc, C) float32 native-resolution
    scores on the canvas. `metas` maps the ResizeMeta field names to (B,)
    integer tensors on the scores' device."""
    t = scores.shape[1]
    ay = _axis_matrix(metas["orig_h"], metas["new_h"], metas["pad_top"], canvas_hw[0], t)
    ax = _axis_matrix(metas["orig_w"], metas["new_w"], metas["pad_left"], canvas_hw[1], t)
    s = scores.float().permute(0, 3, 1, 2)  # (B, C, T, T)
    out = ay[:, None] @ s @ ax[:, None].transpose(-1, -2)  # (B, C, Hc, Wc)
    return out.permute(0, 2, 3, 1)


def _masked_dice(probs, onehot_valid, valid, ignore_index, class_weights, smooth):
    """Per-image soft Dice over the valid region: (B, H, W, C) → (B,)."""
    num_classes = probs.shape[-1]
    v = valid.unsqueeze(-1).float()
    intersect = (probs * onehot_valid).sum((1, 2))
    sum_pred = (probs * v).sum((1, 2))
    sum_gt = onehot_valid.sum((1, 2))
    dc = (2 * intersect + smooth) / torch.clamp(sum_pred + sum_gt + smooth, min=1e-8)
    w = keep_vector(num_classes, ignore_index, class_weights, probs.device)
    # JAX's unweighted branch divides by max(#kept, 1), the weighted by 1e-8
    floor = 1e-8 if class_weights is not None else 1.0
    return -(dc * w).sum(-1) / torch.clamp(w.sum(), min=floor)


def _masked_pixel_mean(pix, onehot_clip, targets, valid, class_weights, ignore_index):
    """Per-image weighted mean over the valid pixels: (B, H, W) → (B,)."""
    v = valid.float()
    if ignore_index is not None:
        v = v * (targets != ignore_index).float()
    if class_weights is not None:
        w = keep_vector(onehot_clip.shape[-1], None, class_weights, pix.device)
        pw = (onehot_clip * w).sum(-1) * v
    else:
        pw = v
    return (pix * pw).sum((1, 2)) / torch.clamp(pw.sum((1, 2)), min=1e-12)


def make_masked_loss(cfg):
    """Per-image masked loss on canvas scores, batched: f(scores (B, H, W,
    C) f32, targets (B, H, W) int, valid (B, H, W) bool) → (B,). Dispatches
    on the loss dataclass (DiceCELoss | DiceNLLLoss), mirroring losses/host.py
    (JAX fast_eval.py:222-269): Dice on the probabilities (softmax of the
    logits, or the model's own probabilities) and the weighted NLL of
    log_softmax, or of the loss's own `nll_nonlin`."""
    softmax = lambda s: torch.softmax(s, -1)  # noqa: E731
    if isinstance(cfg, DiceCELoss):
        probs_of, logp_of, nll_weight = softmax, (lambda s: torch.log_softmax(s, -1)), cfg.ce_weight
    elif isinstance(cfg, DiceNLLLoss):
        probs_of = softmax if cfg.apply_softmax else (lambda s: s)
        logp_of, nll_weight = cfg.nll_nonlin, cfg.nll_weight
    else:
        raise TypeError(f"no masked-loss mirror for {type(cfg).__name__}")

    def loss(scores, targets, valid):
        c = scores.shape[-1]
        onehot = one_hot(targets, c) * valid.unsqueeze(-1)
        d = _masked_dice(probs_of(scores), onehot, valid, cfg.ignore_index, cfg.class_weights,
                         cfg.smooth_dice)
        ohc = one_hot(targets.clamp(0, c - 1), c)
        pix = -(logp_of(scores) * ohc).sum(-1)
        nll = _masked_pixel_mean(pix, ohc, targets, valid, cfg.class_weights, cfg.ignore_index)
        return cfg.dice_weight * d + nll_weight * nll
    return loss


def eval_batch(scores: torch.Tensor, metas: dict, canvases: torch.Tensor,
               real: torch.Tensor, num_classes: int, loss_fn=None):
    """The protocol after the forward, for one batch: scores (B, T, T, C),
    label canvases (B, Hc, Wc) uint8, real (B,) bool → (confusion (C, C)
    int64 over the real images, per-image losses (B,) f32, or nan without
    a loss)."""
    labels = canvases.long()
    inv = invert_to_canvas(scores, metas, canvases.shape[1:])
    valid = labels != FILL
    pred = inv.argmax(-1)
    conf_per = confusion_counts_per_image(pred, torch.where(valid, labels, -1), num_classes)
    conf = (conf_per * real.view(-1, 1, 1)).sum(0)
    if loss_fn is None:
        return conf, torch.full((inv.shape[0],), float("nan"), device=inv.device)
    return conf, loss_fn(inv, labels, valid)
