"""The port's datasets and loader held against the JAX package's:
`materialize` bit-equal to the JAX numpy path (`native=False`, with the
JAX package's C++ resampler switched off for the test, so both sides run
the same numpy arithmetic), `train_batches` in the same order from the
same seeded generator, `eval_batches` padding and `count`, and the
datasets' decode and quantisation."""
import os
import sys

import numpy as np
import pytest

from image_segmentation_tpu.data import dataset as jax_dataset
from image_segmentation_tpu.data import loader as jax_loader
from image_segmentation_tpu.ops import geometry as jax_geometry
from image_segmentation_tpu_torch.data import dataset as D
from image_segmentation_tpu_torch.data import loader as L
from image_segmentation_tpu_torch.ops import geometry as G

SIZES = ((40, 29), (32, 32), (400, 1), (1, 37), (17, 64), (33, 20))


def _items(sizes=SIZES, seed=0, heat=False):
    rng = np.random.default_rng(seed)
    items = []
    for i, (h, w) in enumerate(sizes):
        img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
        lab = rng.integers(0, 4, (h, w)).astype(np.int32)
        lab[0, 0] = 255
        if heat:
            items.append((img, rng.uniform(0, 1, (h, w, 1)).astype(np.float32), lab))
        else:
            items.append((img, lab))
    return items


@pytest.fixture
def jax_numpy_path(monkeypatch):
    """The JAX package's materialize on its numpy resampler."""
    monkeypatch.setattr(jax_geometry, "_native", lambda: None)


@pytest.mark.parametrize("heat", [False, True])
def test_materialize_bit_equal_to_jax_numpy_path(jax_numpy_path, heat):
    """Ragged sizes, 400×1 and 1×37 (a side that rounds to 0 and is kept
    at 1 pixel), and an image of exactly the target size (identity)."""
    items = _items(heat=heat)
    got = L.materialize(D.ArrayDataset(items), 32, keep_orig_labels=True)
    want = jax_loader.materialize(jax_dataset.ArrayDataset(items), 32,
                                  keep_orig_labels=True, native=False)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.images.dtype == want.images.dtype and got.labels.dtype == want.labels.dtype
    for f in G.ResizeMeta._fields:
        a, b = getattr(got.metas, f), np.asarray(getattr(want.metas, f))
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    if heat:
        np.testing.assert_array_equal(got.heatmaps, want.heatmaps)
    else:
        assert got.heatmaps is None and want.heatmaps is None
    for a, b in zip(got.orig_labels, want.orig_labels):
        np.testing.assert_array_equal(a, b)
    # the exact-size image passes through unchanged
    np.testing.assert_array_equal(got.images[1], items[1][0])


def test_train_batches_same_order_as_jax(jax_numpy_path):
    items = _items(sizes=[(20 + i, 30 - i) for i in range(11)])
    got = L.materialize(D.ArrayDataset(items), 16)
    want = jax_loader.materialize(jax_dataset.ArrayDataset(items), 16, native=False)
    a = list(L.train_batches(got, 4, np.random.default_rng(7)))
    b = list(jax_loader.train_batches(want, 4, np.random.default_rng(7)))
    assert len(a) == len(b) == 2  # drop_last: 11 → two batches of 4
    for (xa, ya), (xb, yb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    # the trainer's index matrix is the same shuffle
    order = L.epoch_order(np.random.default_rng(7), 11, 4)
    np.testing.assert_array_equal(got.images[order[1]], a[1][0])


def test_eval_batches_pad_and_count_as_jax(jax_numpy_path):
    items = _items()
    got = L.materialize(D.ArrayDataset(items), 16, keep_orig_labels=True)
    want = jax_loader.materialize(jax_dataset.ArrayDataset(items), 16,
                                  keep_orig_labels=True, native=False)
    a, b = list(L.eval_batches(got, 4)), list(jax_loader.eval_batches(want, 4))
    assert [x[4] for x in a] == [x[4] for x in b] == [4, 2]
    for (ia, la, ma, oa, _), (ib, lb, mb, ob, _) in zip(a, b):
        np.testing.assert_array_equal(ia[0], ib[0])
        np.testing.assert_array_equal(la, lb)
        for f in G.ResizeMeta._fields:
            np.testing.assert_array_equal(getattr(ma, f), np.asarray(getattr(mb, f)))
        assert all(np.array_equal(x, y) for x, y in zip(oa, ob))
    # the tail repeats its last real item
    np.testing.assert_array_equal(a[1][0][0][3], a[1][0][0][1])
    assert len(G.metas_to_list(a[1][2])) == 4


def test_u8_dataset_and_label_remap_as_jax():
    items = _items(sizes=[(9, 7), (5, 6)])
    got, want = D.U8ArrayDataset(items), jax_dataset.U8ArrayDataset(items)
    for i in range(2):
        for x, y in zip(got[i], want[i]):
            np.testing.assert_array_equal(x, y)
    remap = lambda lab: np.where(lab == 255, 3, lab)
    got = D.ArrayDataset(items).map_labels(remap)
    want = jax_dataset.ArrayDataset(items).map_labels(remap)
    np.testing.assert_array_equal(got[0][1], want[0][1])


def test_segmentation_dataset_decodes_as_jax(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(1)
    for split in ("color", "label"):
        os.makedirs(tmp_path / split)
    for stem in ("b", "a"):
        Image.fromarray(rng.integers(0, 255, (6, 5, 3), dtype=np.uint8)).save(
            tmp_path / "color" / f"{stem}.jpg")
        Image.fromarray(rng.choice(np.array([0, 1, 2, 255], np.uint8), (6, 5))).save(
            tmp_path / "label" / f"{stem}.png")
    args = (str(tmp_path / "color"), str(tmp_path / "label"))
    got = D.SegmentationDataset(*args, target_transform=lambda l: np.where(l == 255, 3, l))
    want = jax_dataset.SegmentationDataset(
        *args, target_transform=lambda l: np.where(l == 255, 3, l))
    assert got.stems == want.stems == ["a", "b"] and len(got) == 2
    for i in range(2):
        for x, y in zip(got[i], want[i]):
            np.testing.assert_array_equal(x, y)


def test_segmentation_dataset_without_pil_raises_a_clear_error(tmp_path, monkeypatch):
    """The card's machine has no PIL: listing a directory works, decoding
    raises a RuntimeError that says what is missing."""
    for split in ("color", "label"):
        os.makedirs(tmp_path / split)
    (tmp_path / "color" / "x.jpg").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "PIL", None)
    ds = D.SegmentationDataset(str(tmp_path / "color"), str(tmp_path / "label"))
    assert len(ds) == 1
    with pytest.raises(RuntimeError, match="PIL"):
        ds[0]
