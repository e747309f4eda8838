"""The port's host geometry, labels and channel rules held against the
JAX package's: the port's numpy path bit-equal to JAX's numpy path, and
the default paths (each package's C++ resampler where it built) within
1e-6."""
import numpy as np
import pytest
import torch

from image_segmentation_tpu.data import dataset as jax_dataset
from image_segmentation_tpu.data import labels as jax_labels
from image_segmentation_tpu.ops import geometry as JG
from image_segmentation_tpu_torch.data import dataset as port_dataset
from image_segmentation_tpu_torch.data import labels as port_labels
from image_segmentation_tpu_torch.ops import geometry as PG

torch.set_num_threads(1)

SIZES = [(375, 500), (224, 224), (512, 333), (400, 1), (3, 192)]


def _img(h, w, c=3, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, c)).astype(np.float32)


@pytest.mark.parametrize("n_in,n_out,aa", [(14, 224, True), (500, 224, True),
                                           (224, 375, False), (1, 7, True), (7, 1, True)])
def test_triangle_weights_bit_equal(n_in, n_out, aa):
    np.testing.assert_array_equal(PG._triangle_weight_matrix_np(n_in, n_out, aa),
                                  JG._triangle_weight_matrix_np(n_in, n_out, aa))


@pytest.mark.parametrize("h,w", SIZES)
def test_resize_with_padding(h, w, monkeypatch):
    img = _img(h, w)
    got, meta = PG.resize_with_padding_np(img, 224)
    want, jmeta = JG.resize_with_padding_np(img, 224)  # native resampler if built
    assert meta == jmeta
    np.testing.assert_allclose(got, want, atol=1e-6)
    monkeypatch.setattr(JG, "_native", lambda: None)  # both packages' numpy paths
    monkeypatch.setattr(PG, "_native", lambda: None)
    want_np, _ = JG.resize_with_padding_np(img, 224)
    np.testing.assert_array_equal(PG.resize_with_padding_np(img, 224)[0], want_np)
    lab = np.random.default_rng(1).integers(0, 4, (h, w, 1)).astype(np.uint8)
    np.testing.assert_array_equal(PG.resize_with_padding_np(lab, 224, "nearest")[0],
                                  JG.resize_with_padding_np(lab, 224, "nearest")[0])


@pytest.mark.parametrize("h,w", SIZES)
def test_invert_resize_padding(h, w, monkeypatch):
    _, meta = PG.resize_with_padding_np(_img(h, w), 224)
    scores = _img(224, 224, 4, seed=2)
    got = PG.invert_resize_padding_np(scores, meta)
    assert got.shape == (h, w, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, JG.invert_resize_padding_np(scores, meta), atol=1e-6)
    monkeypatch.setattr(JG, "_native", lambda: None)
    monkeypatch.setattr(PG, "_native", lambda: None)
    np.testing.assert_array_equal(PG.invert_resize_padding_np(scores, meta),
                                  JG.invert_resize_padding_np(scores, meta))
    np.testing.assert_array_equal(PG.invert_resize_padding_np(scores, meta, "nearest"),
                                  JG.invert_resize_padding_np(scores, meta, "nearest"))


def test_labels_and_channels_bit_equal():
    np.testing.assert_array_equal(port_labels.COLOR_MAP, jax_labels.COLOR_MAP)
    lab = np.random.default_rng(3).choice([0, 1, 2, 255], (20, 30)).astype(np.uint8)
    np.testing.assert_array_equal(port_labels.target_remap(lab), jax_labels.target_remap(lab))
    mask = np.random.default_rng(4).integers(0, 6, (20, 30))
    np.testing.assert_array_equal(port_labels.colorize_mask(mask),
                                  jax_labels.colorize_mask(mask))
    for shape in [(5, 6), (5, 6, 1), (5, 6, 2), (5, 6, 3), (5, 6, 4)]:
        arr = np.random.default_rng(5).integers(0, 255, shape).astype(np.uint8)
        np.testing.assert_array_equal(port_dataset.normalize_image_channels(arr),
                                      jax_dataset.normalize_image_channels(arr))
