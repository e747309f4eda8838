"""Confusion counts on the device and epoch metrics on the host."""
from image_segmentation_tpu_torch.metrics.confusion import (
    MetricsHistory,
    confusion_counts,
    confusion_counts_per_image,
    counts_from_confusion,
    metrics_from_counts,
)

__all__ = [
    "MetricsHistory",
    "confusion_counts",
    "confusion_counts_per_image",
    "counts_from_confusion",
    "metrics_from_counts",
]
