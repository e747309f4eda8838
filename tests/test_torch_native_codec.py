"""The port's native codec (ops/native_codec.py, native/imagecodec.cpp),
its materialisation pipeline (data/native_pipeline.py), `PromptDataset`,
`data/png.decode` and the serving decode, held against the JAX package.

- Decode: PNG of every colour type (gray, gray + alpha, RGB, RGBA,
  palette, palette with transparency) equal to JAX's codec and to PIL;
  JPEG (RGB at three chroma subsamplings, gray) equal to JAX's codec and
  within ±1 of PIL; 16-bit PNG and CMYK JPEG declined by both codecs
  with the same error code; probes and error codes as JAX's.
- `load_image`, `load_label` (with the exact original, and the retry
  past the speculative capacity) and `load_heatmap` equal to JAX's
  (arrays and metas).
- `materialize_paths` and `try_materialize_dataset` on
  `SegmentationDataset` and `PromptDataset` files equal to JAX's, with
  `keep_orig_labels` and `target_remap`, per-item fallbacks included;
  against the port's own PIL/numpy path, images within 2e-2 and labels
  and metas exactly (JAX's bound, tests/test_native_codec.py:227-230).
- `png.decode` takes the native codec first: a JPEG decodes with PIL
  reported missing. The serving decode equals JAX's `_decode_upload`
  and `decode_base64_gray`.

Skipped where the codec is unavailable (no g++, or no libpng/libjpeg
headers), as tests/test_native_codec.py skips.
"""
import base64
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from image_segmentation_tpu.data import dataset as JD
from image_segmentation_tpu.data import native_pipeline as JNP
from image_segmentation_tpu.data.labels import remap_for_prompt_task as jax_prompt_remap
from image_segmentation_tpu.data.labels import target_remap as jax_target_remap
from image_segmentation_tpu.ops import native_codec as JC
from image_segmentation_tpu.serve import app as jax_app
from image_segmentation_tpu_torch.data import dataset as D
from image_segmentation_tpu_torch.data import loader as L
from image_segmentation_tpu_torch.data import native_pipeline as NP
from image_segmentation_tpu_torch.data import png
from image_segmentation_tpu_torch.data.labels import remap_for_prompt_task, target_remap
from image_segmentation_tpu_torch.ops import geometry as G
from image_segmentation_tpu_torch.ops import native_codec as PC
from image_segmentation_tpu_torch.serve import app

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def both_built():
    if not PC.available() or not JC.available():
        pytest.skip(f"native codec unavailable: {PC.unavailable_reason()}")


def _smooth(shape, seed):
    """Smooth uint8 content (JPEG-friendly), any trailing channels."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    base = (np.sin(y / 5.0 + seed) + np.cos(x / 7.0)) * 60 + 128
    extra = shape[2:] or (1,)
    out = base[..., None] + rng.normal(0, 6, (h, w) + extra)
    return np.clip(out, 0, 255).astype(np.uint8).reshape(shape)


def _save(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _pngs():
    rgb = _smooth((23, 37, 3), 1)
    pal = Image.fromarray(rgb).quantize(16)
    pal_t = pal.copy()
    pal_t.info["transparency"] = 3
    return {
        "gray": _save(Image.fromarray(_smooth((23, 37), 2), "L"), "PNG"),
        "gray_alpha": _save(Image.fromarray(_smooth((23, 37, 2), 3), "LA"), "PNG"),
        "rgb": _save(Image.fromarray(rgb), "PNG"),
        "rgba": _save(Image.fromarray(_smooth((23, 37, 4), 4), "RGBA"), "PNG"),
        "palette": _save(pal, "PNG"),
        "palette_transparency": _save(pal_t, "PNG", transparency=3),
    }


def _jpegs():
    rgb = _smooth((41, 59, 3), 5)
    out = {f"rgb_sub{s}": _save(Image.fromarray(rgb), "JPEG", quality=90, subsampling=s)
           for s in (0, 1, 2)}
    out["gray"] = _save(Image.fromarray(_smooth((41, 59), 6), "L"), "JPEG", quality=85)
    return out


def _pil(raw: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(raw)) as im:
        if im.mode == "P":
            im = im.convert("RGBA" if "transparency" in im.info else "RGB")
        arr = np.asarray(im)
    return arr[..., None] if arr.ndim == 2 else arr


@pytest.mark.parametrize("kind", list(_pngs()))
def test_png_every_colour_type_exact(kind):
    raw = _pngs()[kind]
    got = PC.decode_bytes(raw)
    np.testing.assert_array_equal(got, JC.decode_bytes(raw))
    np.testing.assert_array_equal(got, _pil(raw))
    assert PC.probe_bytes(raw) == JC.probe_bytes(raw) == got.shape


@pytest.mark.parametrize("kind", list(_jpegs()))
def test_jpeg_exact_to_jax_within_one_of_pil(kind):
    raw = _jpegs()[kind]
    got = PC.decode_bytes(raw)
    np.testing.assert_array_equal(got, JC.decode_bytes(raw))
    assert np.abs(got.astype(int) - _pil(raw)).max() <= 1
    assert PC.probe_bytes(raw) == JC.probe_bytes(raw) == got.shape


def test_declined_and_broken_inputs_raise_as_jax(tmp_path):
    cmyk = _save(Image.fromarray(_smooth((9, 11, 3), 7)).convert("CMYK"), "JPEG")
    bit16 = _save(Image.fromarray((_smooth((9, 11), 8).astype(np.uint16) * 200), "I;16"),
                  "PNG")
    jpeg = _jpegs()["rgb_sub2"]
    cases = {"cmyk": (cmyk, -2), "16-bit": (bit16, -2), "garbage": (b"not an image", -2),
             "empty": (b"", -2), "truncated": (jpeg[: len(jpeg) // 2], -3)}
    for name, (raw, rc) in cases.items():
        for codec in (PC, JC):
            with pytest.raises(codec.CodecError) as e:
                codec.decode_bytes(raw)
            assert e.value.rc == rc, (name, codec.__name__)
    with pytest.raises(PC.CodecError) as e:
        PC.probe(str(tmp_path / "missing.png"))
    assert e.value.rc == -1
    path = tmp_path / "a.jpg"
    path.write_bytes(jpeg)
    assert PC.probe(str(path)) == JC.probe(str(path)) == (41, 59, 3)


def test_load_image_label_heatmap_as_jax(tmp_path):
    img = tmp_path / "i.jpg"
    img.write_bytes(_jpegs()["rgb_sub2"])
    rgba = tmp_path / "rgba.png"
    rgba.write_bytes(_pngs()["rgba"])
    lab = np.random.default_rng(9).choice(np.array([0, 1, 2, 255], np.uint8), (29, 47))
    lpath = tmp_path / "l.png"
    Image.fromarray(lab, "L").save(lpath)
    heat = tmp_path / "h.png"
    heat.write_bytes(_pngs()["gray"])
    for target in (32, 64):
        for p in (img, rgba):
            for aa in (True, False):
                got, gm = PC.load_image(str(p), target, antialias=aa)
                want, wm = JC.load_image(str(p), target, antialias=aa)
                np.testing.assert_array_equal(got, want)
                assert gm == wm
        got = PC.load_label(str(lpath), target, want_orig=True)
        want = JC.load_label(str(lpath), target, want_orig=True)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], lab.astype(np.int32))
        assert got[1] == want[1]
        got = PC.load_label(str(lpath), target, orig_hw=(29, 47))
        np.testing.assert_array_equal(got[2], lab)
        got, gm = PC.load_heatmap(str(heat), target)
        want, wm = JC.load_heatmap(str(heat), target)
        np.testing.assert_array_equal(got, want)
        assert gm == wm and got.shape == (target, target, 1)
    # a label past the speculative capacity (768 × 768) is read again exactly
    big = np.random.default_rng(10).integers(0, 4, (800, 770)).astype(np.uint8)
    bpath = tmp_path / "big.png"
    Image.fromarray(big, "L").save(bpath)
    out, meta, orig = PC.load_label(str(bpath), 48, want_orig=True)
    np.testing.assert_array_equal(orig, big)
    np.testing.assert_array_equal(out, JC.load_label(str(bpath), 48)[0])


def _tree(root, n=5, heatmaps=False, seed=0):
    """A tiny Pet-like file set: JPEG images of mixed sizes, trimap-like
    class-id PNG labels with the 255 sentinel, optional gray heatmaps."""
    rng = np.random.default_rng(seed)
    dirs = {k: os.path.join(root, k) for k in ("color", "label", "heat")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i in range(n):
        h, w = int(rng.integers(20, 90)), int(rng.integers(20, 90))
        Image.fromarray(_smooth((h, w, 3), 20 + i)).save(
            os.path.join(dirs["color"], f"im{i}.jpg"), quality=int(rng.integers(70, 95)))
        lab = rng.integers(1, 4, (h, w)).astype(np.uint8)
        lab[: h // 5] = 255
        Image.fromarray(lab, "L").save(os.path.join(dirs["label"], f"im{i}.png"))
        if heatmaps:
            Image.fromarray(_smooth((h, w), 40 + i), "L").save(
                os.path.join(dirs["heat"], f"im{i}.png"))
    return dirs


def _same(got, want, exact_images=True):
    (np.testing.assert_array_equal if exact_images else
     lambda a, b: np.testing.assert_allclose(a, b, atol=2e-2))(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.images.dtype == np.float32 and got.labels.dtype == np.int32
    for f in G.ResizeMeta._fields:
        np.testing.assert_array_equal(getattr(got.metas, f), np.asarray(getattr(want.metas, f)))
    assert (got.heatmaps is None) == (want.heatmaps is None)
    if got.heatmaps is not None:
        np.testing.assert_allclose(got.heatmaps, want.heatmaps, atol=1e-5 if not exact_images
                                   else 0)
    assert (got.orig_labels is None) == (want.orig_labels is None)
    for a, b in zip(got.orig_labels or [], want.orig_labels or []):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("keep", [False, True])
def test_segmentation_dataset_native_as_jax(tmp_path, keep):
    d = _tree(str(tmp_path))
    port = D.SegmentationDataset(d["color"], d["label"], target_transform=target_remap)
    jax_ds = JD.SegmentationDataset(d["color"], d["label"], target_transform=jax_target_remap)
    got = NP.try_materialize_dataset(port, 48, keep_orig_labels=keep, workers=3)
    want = JNP.try_materialize_dataset(jax_ds, 48, keep_orig_labels=keep, workers=3)
    assert got is not None and want is not None
    _same(got, want)
    assert got.labels.max() <= 3 and all(o.max() <= 3 for o in got.orig_labels or [])
    # materialize takes this path; the item-by-item PIL/numpy path agrees
    _same(L.materialize(port, 48, keep_orig_labels=keep), got)
    _same(L.materialize(port, 48, keep_orig_labels=keep, native=False), got,
          exact_images=False)


def test_prompt_dataset_native_as_jax(tmp_path):
    d = _tree(str(tmp_path), heatmaps=True, seed=1)
    def port_relabel(y):
        return remap_for_prompt_task(y)

    def jax_relabel(y):
        return jax_prompt_remap(y)

    port_relabel.elementwise = jax_relabel.elementwise = True  # a per-pixel value remap
    port = D.PromptDataset(d["color"], d["heat"], d["label"], target_transform=port_relabel)
    jax_ds = JD.PromptDataset(d["color"], d["heat"], d["label"], target_transform=jax_relabel)
    got = NP.try_materialize_dataset(port, 40, keep_orig_labels=True)
    want = JNP.try_materialize_dataset(jax_ds, 40, keep_orig_labels=True)
    assert got.has_heatmaps and got.heatmaps.shape == (5, 40, 40, 1)
    # the dataset's own items: equal to JAX's PromptDataset, item by item
    for i in range(len(port)):
        for a, b in zip(port[i], jax_ds[i]):
            np.testing.assert_array_equal(a, b)
    # the item-by-item path pads the relabelled label with 0; so does the
    # port's native path, which relabels the content region only. JAX's
    # native path relabels the padded label whole, its padding 0 → 1: the
    # reference-side divergence (data/native_pipeline.py). Elsewhere equal.
    slow = L.materialize(port, 40, keep_orig_labels=True, native=False)
    _same(got, slow, exact_images=False)
    pad = np.ones(got.labels.shape, bool)
    for i, (pt, pl, nh, nw) in enumerate(zip(got.metas.pad_top, got.metas.pad_left,
                                             got.metas.new_h, got.metas.new_w)):
        pad[i, pt:pt + nh, pl:pl + nw] = False
    assert pad.any() and (got.labels[pad] == 0).all() and (want.labels[pad] == 1).all()
    want.labels[pad] = 0
    _same(got, want)
    # without the marker the relabelling is not known to be elementwise
    port.target_transform = remap_for_prompt_task
    assert NP.try_materialize_dataset(port, 40) is None


def test_gate_and_per_item_fallbacks_as_jax(tmp_path):
    """A BMP under .jpg, a gray + alpha PNG image and a 16-bit label each
    fall back per item (the codec declines them) to the dataset's decode;
    an image transform or an unknown label transform declines the set."""
    d = _tree(str(tmp_path), n=4, seed=2)
    Image.fromarray(_smooth((25, 25, 3), 50)).save(os.path.join(d["color"], "im0.jpg"),
                                                    format="BMP")
    Image.fromarray(_smooth((25, 31, 2), 51), "LA").save(os.path.join(d["color"], "im1.jpg"),
                                                         format="PNG")
    h, w = np.asarray(Image.open(os.path.join(d["color"], "im2.jpg"))).shape[:2]
    lab16 = np.random.default_rng(3).integers(0, 4, (h, w)).astype(np.uint16) * 1000
    Image.fromarray(lab16, "I;16").save(os.path.join(d["label"], "im2.png"))
    got = NP.try_materialize_dataset(D.SegmentationDataset(d["color"], d["label"]), 32,
                                     keep_orig_labels=True)
    want = JNP.try_materialize_dataset(JD.SegmentationDataset(d["color"], d["label"]), 32,
                                       keep_orig_labels=True)
    _same(got, want)
    assert got.labels.max() >= 256
    np.testing.assert_allclose(got.images[1, ..., 0], got.images[1, ..., 1])
    assert NP.try_materialize_dataset(
        D.SegmentationDataset(d["color"], d["label"], transform=lambda x: x), 32) is None
    assert NP.try_materialize_dataset(
        D.SegmentationDataset(d["color"], d["label"], target_transform=lambda y: y.T),
        32) is None
    assert NP.try_materialize_dataset(D.ArrayDataset([]), 32) is None


def test_materialize_paths_threads_and_serial_agree(tmp_path):
    d = _tree(str(tmp_path), n=6, seed=3)
    imgs = [os.path.join(d["color"], f"im{i}.jpg") for i in range(6)]
    labs = [os.path.join(d["label"], f"im{i}.png") for i in range(6)]
    serial = NP.materialize_paths(imgs, labs, 36, keep_orig_labels=True, workers=1)
    _same(NP.materialize_paths(imgs, labs, 36, keep_orig_labels=True, workers=8), serial)
    _same(serial, JNP.materialize_paths(imgs, labs, 36, keep_orig_labels=True, workers=1))
    with pytest.raises(ValueError, match="differ in length"):
        NP.materialize_paths(imgs, labs[:3], 36)


def test_decode_takes_the_native_codec_first(tmp_path, monkeypatch):
    """With PIL reported missing a JPEG still decodes (natively), as PIL
    decodes it; a format the codec declines then raises, naming both."""
    raw = _jpegs()["rgb_sub0"]
    with_pil = png.decode(raw)
    monkeypatch.setattr(png, "pil_available", lambda: False)
    np.testing.assert_array_equal(png.decode(raw), with_pil)
    path = tmp_path / "x.jpg"
    path.write_bytes(raw)
    np.testing.assert_array_equal(D._decode_image(str(path)), with_pil)
    bmp = _save(Image.fromarray(_smooth((5, 6, 3), 9)), "BMP")
    with pytest.raises(RuntimeError, match="native codec declined.*PIL"):
        png.decode(bmp)


@pytest.mark.parametrize("kind", ["png:rgba", "png:gray", "png:palette", "png:gray_alpha",
                                  "jpeg:rgb_sub2", "jpeg:gray", "bmp"])
def test_serve_decode_as_jax(kind):
    if kind == "bmp":
        raw = _save(Image.fromarray(_smooth((13, 17, 3), 11)), "BMP")
    else:
        fmt, name = kind.split(":")
        raw = (_pngs() if fmt == "png" else _jpegs())[name]
    b64 = base64.b64encode(raw).decode()
    for data in (b64, "data:image/png;base64," + b64):
        got = app.decode_base64_image(data)
        np.testing.assert_array_equal(got, jax_app.decode_base64_image(data))
        assert got.dtype == np.float32 and got.shape[2] == 3
        np.testing.assert_array_equal(
            JD.normalize_image_channels(jax_app._decode_upload(base64.b64decode(b64))),
            np.round(got * 255).astype(np.uint8))
        np.testing.assert_array_equal(app.decode_base64_gray(data),
                                      jax_app.decode_base64_gray(data))
