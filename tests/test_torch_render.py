"""The port's prompt renderer against the JAX package's: the same prompts
give exactly the same heatmaps (both are numpy and scipy on the host)."""
import numpy as np
import pytest

from image_segmentation_tpu.serve import render as J
from image_segmentation_tpu_torch.serve import render as P


def _same(got, want):
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("points,size", [
    ([{"x": 32, "y": 32}], (64, 64)),
    ([{"x": 10.4, "y": 10.6}, {"x": 54, "y": 54}, {"x": 200, "y": 3}], (375, 500)),
    ([{"x": -15, "y": 30}, {"x": 70, "y": -5}], (60, 60)),  # partly off-canvas
    ([{"x": -100, "y": -100}], (40, 30)),  # wholly off-canvas: zeros
    ([], (16, 24)),
])
def test_points(points, size):
    _same(P.render_points(points, size), J.render_points(points, size))


@pytest.mark.parametrize("bbox", [
    {"x": 10, "y": 20, "width": 30, "height": 10},
    {"x": -10, "y": 5, "width": 20, "height": 10},  # negative origin: clipped
    {"x": 50, "y": 60, "width": 500, "height": 900},  # overflowing extent
    {"x": -50, "y": -50, "width": 20, "height": 20},  # wholly off-canvas
    {"x": 3.6, "y": 2.4, "width": -4, "height": 7.5},  # negative width
])
def test_bbox(bbox):
    _same(P.render_bbox(bbox, (100, 120)), J.render_bbox(bbox, (100, 120)))


@pytest.mark.parametrize("kind", ["gray", "rgb_uint8", "other_size", "unit_float"])
def test_scribble(kind):
    rng = np.random.default_rng(0)
    size = (64, 80)
    if kind == "gray":
        s = rng.choice([0, 5, 11, 200], size).astype(np.uint8)
    elif kind == "rgb_uint8":
        s = rng.integers(0, 30, size + (3,), dtype=np.uint8)
    elif kind == "other_size":
        s = rng.choice([0, 9, 255], (37, 91)).astype(np.uint8)
    else:
        s = rng.uniform(0, 0.08, size).astype(np.float32)
    _same(P.render_scribble(s, size), J.render_scribble(s, size))


@pytest.mark.parametrize("ptype,data", [
    ("text", "a cat"), ("unknown", None), ("points", None),
    ("points", [{"x": 5, "y": 7}]), ("bbox", {"x": 1, "y": 2, "width": 3, "height": 4}),
])
def test_create_prompt_mask(ptype, data):
    _same(P.create_prompt_mask(ptype, data, (32, 48)),
          J.create_prompt_mask(ptype, data, (32, 48)))
