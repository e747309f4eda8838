"""Native materialisation: the C++ decode + staging path of `materialize`.

Counterpart of image_segmentation_tpu/data/native_pipeline.py. A
file-backed dataset is materialised through the port's native codec
(ops/native_codec.py → native/imagecodec.cpp): ONE C call per item does
file read → libjpeg/libpng decode → float staging → resize_with_padding
→ centred pad, with the GIL released, fanned out over a thread pool. An
item the codec declines (a CMYK JPEG, a 16-bit PNG, a format it does not
read) falls back to the dataset's own decode and the numpy/C++
geometry, per item, as in JAX; the whole set takes the Python loop of
data/loader.py when the codec is unavailable on the host.

Label transforms: this path applies `label_transform` AFTER the nearest
resize (the Python datasets apply it before), to the content region of
the resized label only. Nearest resizing only copies values, so any
per-pixel VALUE remap commutes with it exactly; spatial label transforms
do not, and the dataset gate accepts only known-elementwise transforms
(`_is_elementwise`). JAX applies the transform to the padded label
whole, so a remap that moves 0 (the prompt relabelling, 0 → 1) also
rewrites the zero padding there, which its Python path leaves 0; the
port's two paths agree.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np

from image_segmentation_tpu_torch.data import dataset as D
from image_segmentation_tpu_torch.data.labels import target_remap
from image_segmentation_tpu_torch.ops import geometry as G
from image_segmentation_tpu_torch.ops import native_codec as nc


def _is_elementwise(fn: Optional[Callable]) -> bool:
    """True for label transforms known to be per-pixel value remaps (safe
    to apply after the nearest resize)."""
    if fn is None or fn is target_remap:
        return True
    return bool(getattr(fn, "elementwise", False))


def default_workers() -> int:
    return max(1, min(16, os.cpu_count() or 1))


def _fallback_item(img_path, label_path, heatmap_path, target, antialias):
    """The dataset's decode + host geometry for one item (the codec
    declined it)."""
    img = D.normalize_image_channels(D._decode_image(img_path)).astype(np.float32) / 255.0
    out, meta = G.resize_with_padding_np(img, target, method="linear", antialias=antialias)
    lab = D._decode_image(label_path)[:, :, 0].astype(np.int32)
    lab_out, _ = G.resize_with_padding_np(lab[:, :, None].astype(np.float32), target,
                                          method="nearest")
    heat_out = None
    if heatmap_path is not None:
        heat = D._decode_image(heatmap_path)[:, :, :1].astype(np.float32) / 255.0
        heat_out, _ = G.resize_with_padding_np(heat, target, method="linear",
                                               antialias=antialias)
    return out.astype(np.float32), lab_out[:, :, 0].astype(np.int32), meta, lab, heat_out


def materialize_paths(img_paths: Sequence[str], label_paths: Sequence[str], target_size: int,
                      heatmap_paths: Optional[Sequence[str]] = None,
                      keep_orig_labels: bool = False, antialias: bool = True,
                      label_transform: Optional[Callable] = None,
                      workers: Optional[int] = None):
    """Materialise (images, labels[, heatmaps], metas[, orig_labels]) from
    file paths through the native codec, threaded across items; returns a
    data.loader.MaterializedDataset. `label_transform` must be an
    elementwise value remap (see the module docstring)."""
    from image_segmentation_tpu_torch.data.loader import MaterializedDataset

    if not nc.available():
        raise RuntimeError(f"native image codec unavailable: {nc.unavailable_reason()}")
    n = len(img_paths)
    if len(label_paths) != n or (heatmap_paths is not None and len(heatmap_paths) != n):
        raise ValueError("img_paths, label_paths and heatmap_paths differ in length")

    images = np.zeros((n, target_size, target_size, 3), np.float32)
    labels = np.zeros((n, target_size, target_size), np.int32)
    heatmaps = (np.zeros((n, target_size, target_size, 1), np.float32)
                if heatmap_paths is not None else None)
    metas_cols = {f: [None] * n for f in G.ResizeMeta._fields}
    origs: List[Optional[np.ndarray]] = [None] * n

    def one(i: int) -> None:
        hp = heatmap_paths[i] if heatmap_paths is not None else None
        try:
            img, meta = nc.load_image(img_paths[i], target_size, antialias=antialias)
            if keep_orig_labels:
                lab, _, orig = nc.load_label(label_paths[i], target_size, want_orig=True)
            else:
                (lab, _), orig = nc.load_label(label_paths[i], target_size), None
            heat = (nc.load_heatmap(hp, target_size, antialias=antialias)[0]
                    if hp is not None else None)
        except nc.CodecError:
            img, lab, meta, orig_full, heat = _fallback_item(
                img_paths[i], label_paths[i], hp, target_size, antialias)
            orig = orig_full if keep_orig_labels else None
        h, w = meta["original_size"]
        nh, nw = meta["new_size"]
        pl_, pt, _, _ = meta["pad"]
        labels[i] = lab
        if label_transform is not None:
            content = labels[i, pt:pt + nh, pl_:pl_ + nw]
            content[...] = np.asarray(label_transform(content.copy()), np.int32)
            if orig is not None:
                orig = np.asarray(label_transform(orig), np.int32)
        images[i] = img
        if heatmaps is not None:
            heatmaps[i] = heat
        origs[i] = orig
        for f, v in zip(G.ResizeMeta._fields, (h, w, nh, nw, pt, pl_, meta["scale"])):
            metas_cols[f][i] = v

    nw_ = workers or default_workers()
    if nw_ <= 1 or n <= 1:
        for i in range(n):
            one(i)
    else:
        with ThreadPoolExecutor(max_workers=nw_) as pool:
            list(pool.map(one, range(n)))

    metas = G.ResizeMeta(**{
        f: np.asarray(metas_cols[f], dtype=np.float32 if f == "scale" else np.int32)
        for f in G.ResizeMeta._fields})
    return MaterializedDataset(images=images, labels=labels, metas=metas, heatmaps=heatmaps,
                               orig_labels=list(origs) if keep_orig_labels else None)


def try_materialize_dataset(dataset, target_size: int, keep_orig_labels: bool = False,
                            antialias: bool = True, workers: Optional[int] = None):
    """Native materialisation of a file-backed dataset, or None where this
    path does not apply: not a SegmentationDataset or PromptDataset, an
    image transform, a label transform not known to be elementwise, or a
    host where the codec is unavailable."""
    if not isinstance(dataset, (D.SegmentationDataset, D.PromptDataset)):
        return None
    if dataset.transform is not None or not _is_elementwise(dataset.target_transform):
        return None
    if not nc.available():
        return None
    stems = dataset.stems
    if isinstance(dataset, D.SegmentationDataset):
        img_ext, label_ext, heat = dataset.img_ext, dataset.label_ext, None
    else:
        img_ext, label_ext = ".jpg", ".png"
        heat = [os.path.join(dataset.heatmap_dir, s + ".png") for s in stems]
    return materialize_paths(
        [os.path.join(dataset.img_dir, s + img_ext) for s in stems],
        [os.path.join(dataset.label_dir, s + label_ext) for s in stems],
        target_size, heatmap_paths=heat, keep_orig_labels=keep_orig_labels,
        antialias=antialias, label_transform=dataset.target_transform, workers=workers)
