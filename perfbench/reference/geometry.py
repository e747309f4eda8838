"""The serving geometry in NumPy, float64: scale the longer side to the
target, keep the aspect ratio, resize linearly (half-pixel centres, a
triangle kernel widened by the scale when shrinking), centre on a zero
canvas; then, for the answer, crop the canvas back and resize it linearly
(no widening) to the photo's own size.
"""
from __future__ import annotations

import numpy as np


def triangle_weights(n_in: int, n_out: int, antialias: bool) -> np.ndarray:
    """(n_out, n_in) weights of a linear resize, each row summing to 1."""
    scale = n_out / n_in
    width = max(1.0 / scale, 1.0) if antialias else 1.0
    centres = (np.arange(n_out) + 0.5) / scale - 0.5
    w = np.clip(1.0 - np.abs(centres[:, None] - np.arange(n_in)[None, :]) / width, 0.0, 1.0)
    total = w.sum(1, keepdims=True)
    return np.where(total > 1e-7, w / np.maximum(total, 1e-7), 0.0)


def resize(img: np.ndarray, out_h: int, out_w: int, antialias: bool) -> np.ndarray:
    wy = triangle_weights(img.shape[0], out_h, antialias)
    wx = triangle_weights(img.shape[1], out_w, antialias)
    rows = np.tensordot(wy, img.astype(np.float64), axes=(1, 0))  # (out_h, w, c)
    return np.tensordot(rows, wx, axes=(1, 1)).transpose(0, 2, 1)  # (out_h, out_w, c)


def placement(h: int, w: int, target: int):
    """(new_h, new_w, top, left) of an h x w photo on the target canvas."""
    scale = min(target / h, target / w)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    return nh, nw, (target - nh) // 2, (target - nw) // 2


def stage(img: np.ndarray, target: int) -> np.ndarray:
    """(H, W, C) in [0, 1] -> the (target, target, C) canvas, as the 8-bit
    values the engine sends to the card, over 255."""
    nh, nw, top, left = placement(img.shape[0], img.shape[1], target)
    canvas = np.zeros((target, target, img.shape[2]))
    canvas[top:top + nh, left:left + nw] = resize(img, nh, nw, antialias=True)
    return np.clip(np.round(canvas * 255.0), 0, 255) / 255.0


def unstage(scores: np.ndarray, h: int, w: int) -> np.ndarray:
    """(T, T, C) canvas scores -> (h, w, C) scores at the photo's size."""
    nh, nw, top, left = placement(h, w, scores.shape[0])
    return resize(scores[top:top + nh, left:left + nw], h, w, antialias=False)
