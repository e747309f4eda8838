"""Visualisation helpers (reference utils/dataset.py:106-128
display_img_label, segmentation_webapp/utils.py plot_tensor_with_custom_colors).

Counterpart of image_segmentation_tpu/utils/viz.py, on numpy arrays.
Matplotlib is imported at the first call, on the Agg backend when no
display is set, so the module imports where matplotlib is missing; every
function takes a `save_path` to write a PNG instead of returning the
figure.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from image_segmentation_tpu_torch.data.labels import COLOR_MAP, colorize_mask


def _plt():
    import matplotlib

    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def display_img_label(
    img: np.ndarray,
    label: np.ndarray,
    save_path: Optional[str] = None,
    titles: Sequence[str] = ("image", "label"),
):
    """Side-by-side image + label map (reference display_img_label)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    axes[0].imshow(np.clip(np.asarray(img), 0, 1))
    axes[0].set_title(titles[0])
    axes[0].axis("off")
    axes[1].imshow(colorize_mask(np.asarray(label)))
    axes[1].set_title(titles[1])
    axes[1].axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=100)
        plt.close(fig)
        return save_path
    return fig


def plot_mask_with_colors(
    mask: np.ndarray,
    class_names: Sequence[str] = ("background", "cat", "dog", "boundary"),
    save_path: Optional[str] = None,
):
    """Colourised class map with a legend (reference
    plot_tensor_with_custom_colors, same 0→black 1→red 2→green 3→blue map)."""
    plt = _plt()
    from matplotlib.patches import Patch

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(colorize_mask(np.asarray(mask)))
    ax.axis("off")
    handles = [
        Patch(color=np.array(COLOR_MAP[i]) / 255.0, label=name)
        for i, name in enumerate(class_names)
    ]
    ax.legend(handles=handles, loc="upper right", fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=100)
        plt.close(fig)
        return save_path
    return fig


def plot_prediction_triptych(
    img: np.ndarray,
    pred_mask: np.ndarray,
    gt_label: Optional[np.ndarray] = None,
    save_path: Optional[str] = None,
):
    """Original / prediction / (optional) ground truth — the webapp's
    3-column display as a static figure."""
    plt = _plt()
    n = 3 if gt_label is not None else 2
    fig, axes = plt.subplots(1, n, figsize=(5 * n, 5))
    axes[0].imshow(np.clip(np.asarray(img), 0, 1))
    axes[0].set_title("original")
    axes[1].imshow(colorize_mask(np.asarray(pred_mask)))
    axes[1].set_title("prediction")
    if gt_label is not None:
        axes[2].imshow(colorize_mask(np.asarray(gt_label)))
        axes[2].set_title("ground truth")
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=100)
        plt.close(fig)
        return save_path
    return fig


def plot_training_curves(history: dict, save_path: Optional[str] = None):
    """Loss + metric curves from a fit() history dict (the reference kept
    per-epoch history lists in MetricsHistory, utils/MetricsHistory.py:26-33)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    axes[0].plot(history.get("train_loss", []), label="train")
    axes[0].plot(history.get("val_loss", []), label="val")
    axes[0].set_title("loss")
    axes[0].legend()
    for key in ("val_dice", "val_iou", "val_acc"):
        if history.get(key):
            axes[1].plot(history[key], label=key)
    axes[1].set_title("val metrics")
    axes[1].legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=100)
        plt.close(fig)
        return save_path
    return fig
