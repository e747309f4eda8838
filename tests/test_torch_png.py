"""The port's PNG codec (data/png.py), which the serving paths, predict.py
and the file datasets use where neither the native codec nor PIL is
there: held to PIL, bit for bit."""
import base64
import io
import zlib

import numpy as np
import pytest
from PIL import Image

from chip_smoke import _png_every_filter
from image_segmentation_tpu_torch.data import dataset, png
from image_segmentation_tpu_torch.ops import native_codec
from image_segmentation_tpu_torch.serve import app


def _smooth(shape, seed):
    """Row-wise random walks: PIL's encoder picks every filter type on them."""
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.integers(0, 9, shape), axis=1) % 256).astype(np.uint8)


def _pil_png(arr, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("mode,shape", [("L", (37, 53)), ("RGB", (41, 29, 3)),
                                        ("RGBA", (20, 31, 4)), ("LA", (9, 13, 2))])
@pytest.mark.parametrize("optimize", [False, True])
def test_decode_equals_pil(mode, shape, optimize):
    data = _pil_png(_smooth(shape, 0), mode, optimize=optimize)
    want = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(png.decode_png(data).reshape(want.shape), want)


def test_every_row_filter_is_undone():
    """One PNG whose rows use filters 0-4 in turn (PNG spec 9.2), written
    by the writer of chip_smoke.py's phase 13, decodes to its pixels as
    PIL decodes it."""
    arr = _smooth((10, 7, 3), 1)
    data = _png_every_filter(arr)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), arr)
    np.testing.assert_array_equal(png.decode_png(data), arr)


@pytest.mark.parametrize("shape", [(3, 41, 3), (41, 3, 3), (1, 9, 4), (9, 1), (26, 33, 2)])
def test_every_row_filter_on_wide_and_tall_images(shape):
    """The diagonal unfiltering of Average and Paeth rows at both ends of
    its range: images far wider than tall and far taller than wide, one
    row or one column, every channel count."""
    arr = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    data = _png_every_filter(arr)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), arr)
    np.testing.assert_array_equal(png.decode_png(data).reshape(shape), arr)


def test_photo_that_pil_filters_with_paeth():
    """A smooth photo-like image, on which PIL's encoder picks Paeth for
    most rows, decodes as PIL decodes it."""
    rng = np.random.default_rng(9)
    small = Image.fromarray(rng.integers(0, 256, (12, 16, 3)).astype(np.uint8))
    arr = np.asarray(small.resize((160, 120), Image.BICUBIC))
    data = _pil_png(arr, "RGB")
    rows = np.frombuffer(zlib.decompress(b"".join(
        body for t, body in png._chunks(data) if t == b"IDAT")), np.uint8).reshape(120, -1)
    assert (rows[:, 0] == 4).mean() > 0.5
    np.testing.assert_array_equal(png.decode_png(data), arr)


def test_palette_expands_to_rgb():
    img = Image.fromarray(_smooth((30, 20, 3), 2)).quantize(200)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    np.testing.assert_array_equal(png.decode_png(buf.getvalue()),
                                  np.asarray(img.convert("RGB")))


@pytest.mark.parametrize("shape", [(17, 23), (17, 23, 3), (5, 4, 4)])
def test_encode_reads_back_in_pil(shape):
    arr = _smooth(shape, 3)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png.encode_png(arr)))), arr)


def test_to_gray_is_pil_luma():
    arr = np.random.default_rng(4).integers(0, 256, (40, 30, 3), dtype=np.uint8)
    np.testing.assert_array_equal(png.to_gray(arr), np.asarray(Image.fromarray(arr).convert("L")))


def test_refuses_what_it_does_not_read():
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"\xff\xd8\xff\xe0 a jpeg")
    img = Image.fromarray(_smooth((8, 8, 3), 5)).quantize(4)  # 2-bit palette
    buf = io.BytesIO()
    img.save(buf, format="PNG", bits=2)
    with pytest.raises(ValueError, match="8-bit"):
        png.decode_png(buf.getvalue())


def test_serving_and_datasets_without_pil(monkeypatch, tmp_path):
    """On a host without the native codec (no libpng/libjpeg headers), with
    PIL reported missing, uploads, scribbles, masks and dataset files go
    through the PNG codec and give what the PIL paths give; JPEG is
    refused there."""
    monkeypatch.setattr(native_codec, "available", lambda: False)
    rgba = _smooth((21, 34, 4), 6)
    gray = _smooth((21, 34), 7)
    up_rgba = base64.b64encode(_pil_png(rgba, "RGBA")).decode()
    up_gray = "data:image/png;base64," + base64.b64encode(_pil_png(gray, "L")).decode()
    up_rgb = base64.b64encode(_pil_png(rgba[..., :3], "RGB")).decode()
    path = tmp_path / "x.png"
    path.write_bytes(_pil_png(rgba, "RGBA"))
    with_pil = (app.decode_base64_image(up_rgba), app.decode_base64_gray(up_gray),
                app.decode_base64_gray(up_rgb), dataset._decode_image(str(path)))
    monkeypatch.setattr(png, "pil_available", lambda: False)
    without = (app.decode_base64_image(up_rgba), app.decode_base64_gray(up_gray),
               app.decode_base64_gray(up_rgb), dataset._decode_image(str(path)))
    for a, b in zip(with_pil, without):
        np.testing.assert_array_equal(a, b)
    mask = _smooth((21, 34, 3), 8)
    out = base64.b64decode(app.encode_png_base64(mask))
    assert out == png.encode_png(mask)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(out))), mask)
    jpeg = tmp_path / "y.jpg"
    Image.fromarray(rgba[..., :3]).save(jpeg)
    with pytest.raises(RuntimeError, match="only PNG"):
        dataset._decode_image(str(jpeg))
    with pytest.raises(RuntimeError, match="only PNG"):
        app.decode_base64_image(base64.b64encode(jpeg.read_bytes()).decode())
