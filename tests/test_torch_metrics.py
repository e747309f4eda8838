"""The port's confusion counts and MetricsHistory held against the JAX
package's, exactly (integer inputs; the counts are integers on both
sides, the metrics the same float64 host arithmetic)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.metrics import MetricsHistory as JaxHistory
from image_segmentation_tpu.metrics.confusion import confusion_counts as jax_counts
from image_segmentation_tpu_torch.metrics import (
    MetricsHistory,
    confusion_counts,
    confusion_counts_per_image,
)

torch.set_num_threads(1)


def _pairs(seed, shape=(3, 17, 11), c=4):
    rng = np.random.default_rng(seed)
    preds = rng.integers(0, c, shape).astype(np.int32)
    labels = rng.integers(0, c, shape).astype(np.int32)
    labels[0, 0, :5] = 255  # the canvas fill: drops out on both sides
    return preds, labels


@pytest.mark.parametrize("seed", [0, 1])
def test_confusion_counts_equal_jax(seed):
    preds, labels = _pairs(seed)
    want = np.asarray(jax_counts(jnp.asarray(preds), jnp.asarray(labels), 4))
    got = confusion_counts(torch.from_numpy(preds), torch.from_numpy(labels), 4)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    per = confusion_counts_per_image(torch.from_numpy(preds), torch.from_numpy(labels), 4)
    np.testing.assert_array_equal(per.sum(0).numpy(), want)
    for i in range(preds.shape[0]):
        np.testing.assert_array_equal(
            per[i].numpy(), np.asarray(jax_counts(jnp.asarray(preds[i]),
                                                  jnp.asarray(labels[i]), 4)))


def test_metrics_history_equals_jax():
    """Per-image accumulation (scores and hard ids), a pre-reduced device
    matrix, an absent class, two epochs and the getters: every value equal
    to the JAX class's."""
    rng = np.random.default_rng(4)
    port, ref = MetricsHistory(4, ignore_index=3), JaxHistory(4, ignore_index=3)
    for epoch in range(2):
        port.reset()
        ref.reset()
        for i in range(3):
            scores = rng.normal(size=(9, 8, 4)).astype(np.float32)
            scores[..., 2] -= 10.0  # class 2 never predicted
            label = rng.choice(np.array([0, 1, 3]), size=(9, 8))
            port.accumulate(scores, label)
            ref.accumulate(scores, label)
        preds, labels = _pairs(5 + epoch, shape=(2, 6, 6))
        port.accumulate_confusion(confusion_counts(torch.from_numpy(preds),
                                                   torch.from_numpy(labels), 4))
        ref.accumulate_confusion(jax_counts(jnp.asarray(preds), jnp.asarray(labels), 4))
        assert port.compute_epoch_metrics() == ref.compute_epoch_metrics()
    for getter in ("get_mean_dice_history", "get_mean_iou_history", "get_mean_acc_history",
                   "get_class_dice_history", "get_class_iou_history",
                   "get_class_acc_history"):
        np.testing.assert_array_equal(np.asarray(getattr(port, getter)()),
                                      np.asarray(getattr(ref, getter)()))
    np.testing.assert_array_equal(port.get_last_per_class_iou(), ref.get_last_per_class_iou())
    np.testing.assert_array_equal(port.confusion, ref.confusion)
