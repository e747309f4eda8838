"""Image bytes to pixels, and 8-bit PNG without PIL or libpng.

`decode` is the one place that chooses a decoder, in this order: the
port's native PNG/JPEG codec (ops/native_codec.py, libpng and libjpeg)
where it built and accepts the bytes; then PIL where it is installed
(any format it reads: 16-bit PNGs, CMYK JPEGs, GIF, BMP, ...); then this
module's PNG codec, which reads PNG only, so that a host with neither
libpng's headers nor Pillow (no dependency of the port) still decodes
PNG. Uploads, scribbles, labels, `predict.py`'s files and the file
datasets all decode through it. Masks are always written by
`encode_png`. This codec stays until the native codec is shown to
build on the GPU host (ROADMAP).

`decode_png` takes non-interlaced 8-bit PNGs of every colour type
(gray, RGB, palette, gray + alpha, RGBA) and all five row filters, and
returns (H, W, C) uint8 with a palette expanded to RGB, the values PIL
gives after `convert("RGB")` (a palette's transparency is dropped, as
that conversion and the alpha rule of the datasets drop it). The
Average and Paeth filters need each byte's left neighbour, so images
that use them are unfiltered along anti-diagonals, all rows at once.
`encode_png` writes (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8
with filter 0 on every row. `to_gray` is PIL's `convert("L")` of an RGB
image (ITU-R 601-2 luma, PIL's fixed-point rounding).
"""
from __future__ import annotations

import io
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → channels
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def pil_available() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        yield ctype, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec 9.2) of `raw`, h rows of
    1 + stride bytes."""
    rows = raw.reshape(h, stride + 1)
    ftypes = rows[:, 0]
    if ftypes.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown row filter {ftypes.max()}")
    if ftypes.max(initial=0) > 2:
        return _unfilter_diagonals(rows, h, stride // bpp, bpp)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        cur = rows[y, 1:].astype(np.int32)
        if ftypes[y] == 1:  # Sub: a running sum per byte position of a pixel
            cur = np.cumsum(cur.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftypes[y] == 2:  # Up
            cur = (cur + prev) & 0xFF
        out[y] = cur
        prev = cur
    return out


def _unfilter_diagonals(rows: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """`_unfilter` for any filters: pixel (y, x) needs only (y, x-1),
    (y-1, x) and (y-1, x-1), so each anti-diagonal y + x = d is undone at
    once. The pixels are skewed so that a diagonal is one slice:
    q[d + 1, y + 1] holds pixel (y, d - y), and what lies outside the
    image stays 0, the PNG's value left of and above it."""
    ftypes = rows[:, 0]
    ys, xs = np.mgrid[0:h, 0:w]
    skew = (ys + xs + 1, ys + 1)
    filt = np.zeros((h + w, h + 1, bpp), np.int32)
    filt[skew] = rows[:, 1:].reshape(h, w, bpp)
    q = np.zeros_like(filt)
    uses = {k: ((ftypes == k)[:, None].astype(np.int32), np.cumsum(ftypes == k).tolist())
            for k in (1, 2, 3, 4)}

    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        a = q[d, y0 + 1:y1 + 1]  # left
        b = q[d, y0:y1]  # up
        c = q[max(d - 1, 0), y0:y1]  # up-left
        pred = 0
        for k, (mask, count) in uses.items():
            if count[y1 - 1] == (count[y0 - 1] if y0 else 0):
                continue  # no row of this diagonal uses filter k
            if k == 1:
                p = a
            elif k == 2:
                p = b
            elif k == 3:
                p = (a + b) >> 1
            else:
                pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
                p = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            pred = pred + p * mask[y0:y1]
        q[d + 1, y0 + 1:y1 + 1] = (filt[d + 1, y0 + 1:y1 + 1] + pred) & 0xFF
    return q[skew].astype(np.uint8).reshape(h, w * bpp)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, C) uint8, C = 1 (gray), 2 (gray + alpha), 3 or 4;
    a palette comes back as RGB."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG")
    header, idat, palette = None, [], None
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace or color not in _CHANNELS:
        raise ValueError(f"PNG: only non-interlaced 8-bit images are read without PIL "
                         f"(depth {depth}, colour type {color}, interlace {interlace})")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * ch + 1):
        raise ValueError(f"PNG: {raw.size} bytes of image data for {w}x{h}x{ch}")
    px = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if color != 3:
        return px
    if palette is None:
        raise ValueError("PNG: palette image without PLTE")
    return palette[px[..., 0]]


def decode(raw: bytes) -> np.ndarray:
    """Image bytes → (H, W, C) uint8, a palette expanded to RGB (to RGBA
    by the native codec where the palette has transparency): by the native
    codec, else PIL, else `decode_png`; bytes that none of them reads
    raise a RuntimeError that says what is missing."""
    from image_segmentation_tpu_torch.ops import native_codec as nc

    if nc.available():
        try:
            return nc.decode_bytes(raw)
        except nc.CodecError as e:
            native = f"the native codec declined the bytes ({e})"
    else:
        native = f"the native codec is unavailable ({nc.unavailable_reason()})"
    if not pil_available():
        if not raw.startswith(SIGNATURE):
            raise RuntimeError(f"not a PNG, {native}, and PIL (Pillow), which decodes other "
                               f"formats, is not installed: without them only PNG decodes")
        return decode_png(raw)
    from PIL import Image

    with Image.open(io.BytesIO(raw)) as im:
        arr = np.asarray(im.convert("RGB") if im.mode == "P" else im)
    return arr[:, :, None] if arr.ndim == 2 else arr


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 → PNG bytes."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    color = {1: 0, 3: 2, 4: 6}.get(arr.shape[2])
    if arr.ndim != 3 or color is None:
        raise ValueError(f"encode_png takes (H, W), (H, W, 3) or (H, W, 4), got {arr.shape}")
    h, w, _ = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1)
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def to_gray(arr: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 → (H, W) as PIL's convert("L"): gray kept, alpha
    dropped, RGB to L = (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    if arr.shape[2] <= 2:
        return arr[..., 0]
    r, g, b = (arr[..., i].astype(np.uint32) for i in range(3))
    return ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16).astype(np.uint8)
