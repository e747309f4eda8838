"""Materialisation and batching on the host (numpy).

Counterpart of image_segmentation_tpu/data/loader.py: a dataset is
resized and padded ONCE into fixed-shape arrays, and epochs are array
indexing. A materialised dataset keeps

  images       (N, T, T, 3) float32: resized + padded inputs
  labels       (N, T, T)    int32:   nearest-resized class ids
  heatmaps     (N, T, T, 1) float32: prompt heatmaps (prompt task only)
  metas        ResizeMeta of (N,) arrays, for the inverse eval geometry
  orig_labels  list of native-size label maps (eval only)

`materialize` is the JAX package's numpy path (`native=False` there);
the native C++ decode pipeline comes to the port later. The trainer
(train/loop.py) keeps its device copies on the dataset object.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np

from image_segmentation_tpu_torch.ops import geometry as G


@dataclasses.dataclass
class MaterializedDataset:
    images: np.ndarray
    labels: np.ndarray
    metas: G.ResizeMeta  # arrays of shape (N,)
    heatmaps: Optional[np.ndarray] = None
    orig_labels: Optional[List[np.ndarray]] = None
    # packed by train.fast_eval for the device eval protocol
    label_canvases: Optional[np.ndarray] = None
    # (device, arrays) uploaded once by train.loop's device eval and by
    # fit's device-resident train set; stale if the arrays are mutated
    device_eval_cache: Optional[tuple] = None
    device_train_cache: Optional[tuple] = None
    # canvas-size bucket views built by train.loop's device eval
    # ([] = one bucket); each is a MaterializedDataset of its own
    bucket_views: Optional[list] = None

    def __len__(self) -> int:
        return self.images.shape[0]

    @property
    def has_heatmaps(self) -> bool:
        return self.heatmaps is not None


def materialize(dataset, target_size: int, keep_orig_labels: bool = False,
                antialias: bool = True) -> MaterializedDataset:
    """Resize + pad every item of an (img, label) or (img, heatmap, label)
    dataset to (T, T), once, on the host."""
    images, labels, heatmaps, origs = [], [], [], []
    metas_cols = {f: [] for f in G.ResizeMeta._fields}
    has_heat = False
    for i in range(len(dataset)):
        item = dataset[i]
        if len(item) == 3:
            img, heat, label = item
            has_heat = True
        else:
            img, label = item
            heat = None
        img = np.asarray(img, dtype=np.float32)
        out, meta = G.resize_with_padding_np(img, target_size, method="linear",
                                             antialias=antialias)
        images.append(out.astype(np.float32))
        lab = np.asarray(label)
        lab_out, _ = G.resize_with_padding_np(
            lab[:, :, None].astype(np.float32), target_size, method="nearest")
        labels.append(lab_out[:, :, 0].astype(np.int32))
        if heat is not None:
            h_out, _ = G.resize_with_padding_np(
                np.asarray(heat, dtype=np.float32), target_size, method="linear",
                antialias=antialias)
            heatmaps.append(h_out.astype(np.float32))
        h, w = meta["original_size"]
        nh, nw = meta["new_size"]
        pl_, pt, _, _ = meta["pad"]
        for f, v in zip(G.ResizeMeta._fields, (h, w, nh, nw, pt, pl_, meta["scale"])):
            metas_cols[f].append(v)
        if keep_orig_labels:
            origs.append(lab.astype(np.int32))
    metas = G.ResizeMeta(**{
        f: np.asarray(metas_cols[f], dtype=np.float32 if f == "scale" else np.int32)
        for f in G.ResizeMeta._fields
    })
    return MaterializedDataset(
        images=np.stack(images),
        labels=np.stack(labels),
        metas=metas,
        heatmaps=np.stack(heatmaps) if has_heat else None,
        orig_labels=origs if keep_orig_labels else None,
    )


def epoch_order(rng: np.random.Generator, n: int, batch_size: int) -> np.ndarray:
    """One epoch's shuffle: a permutation of n cut to whole batches,
    (n // batch_size, batch_size) (drop_last)."""
    nsteps = n // batch_size
    return rng.permutation(n)[: nsteps * batch_size].reshape(nsteps, batch_size)


def train_batches(data: MaterializedDataset, batch_size: int,
                  rng: np.random.Generator) -> Iterator[tuple]:
    """Shuffled epoch iterator of stacked fixed-shape batches (drop_last):
    (images, labels) or (images, heatmaps, labels)."""
    for idx in epoch_order(rng, len(data), batch_size):
        if data.has_heatmaps:
            yield data.images[idx], data.heatmaps[idx], data.labels[idx]
        else:
            yield data.images[idx], data.labels[idx]


def eval_batches(data: MaterializedDataset, batch_size: int) -> Iterator[tuple]:
    """Sequential fixed-shape eval batches with per-image metas and
    native-resolution labels. The last batch is padded up to `batch_size`
    by repeating its final item; `count` says how many are real. Yields
    (inputs_tuple, labels, metas, orig_labels, count)."""
    n = len(data)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        count = len(idx)
        while len(idx) < batch_size:
            idx.append(idx[-1])
        ii = np.asarray(idx)
        inputs = (data.images[ii],)
        if data.has_heatmaps:
            inputs = (data.images[ii], data.heatmaps[ii])
        metas = G.ResizeMeta(*(np.asarray(f)[ii] for f in data.metas))
        origs = [data.orig_labels[j] for j in idx] if data.orig_labels is not None else None
        yield inputs, data.labels[ii], metas, origs, count
