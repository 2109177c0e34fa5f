"""PNG images without Pillow: a reader and a writer on the standard
library's ``zlib``, and Pillow's crop, ``resize(..., BICUBIC)`` and
``convert("RGB")`` on 8-bit pixels in numpy, bit for bit.

``Image8`` holds what ``PIL.Image.open`` gives for a PNG of 8-bit samples
that is not interlaced: mode "L", "LA", "RGB", "RGBA" or "P" (with its
palette), pixels (h, w, bands) uint8. Its ``size``, ``crop``, ``resize``
and ``convert("RGB")`` follow Pillow's (12.x) arithmetic:

- ``resize`` to the same size returns a copy; mode "P" resizes by
  nearest neighbour (Pillow's affine scale: source x of output x is
  ``int(x0)`` for ``x0 = w_in / w_out * 0.5`` advanced by ``w_in / w_out``
  an output pixel, in float64); "LA" / "RGBA" resize premultiplied by
  alpha ("La" / "RGBa") and divide back;
- bicubic (a = -0.5): per output pixel the window ``[int(c - s + 0.5),
  int(c + s + 0.5))`` of source pixels around ``c = (x + 0.5) * scale``,
  support ``s = 2 * max(scale, 1)``, weights ``cubic((j - c + 0.5) /
  max(scale, 1))`` normalized to sum 1, then rounded to 22-bit fixed
  point; the horizontal pass first, each pass ``(2**21 + sum(pixel *
  weight)) >> 22`` clipped to [0, 255].

Other images (JPEG, BMP, 16-bit or interlaced PNG) are not read here:
``open_image`` hands them to Pillow, imported when such a file is opened
(``MissingDecoderError`` names the file and the package when it is not
installed). ``pillow_image`` opens bytes with Pillow alone, lazily as
``PIL.Image.open`` does (the tar-shard loader's members, as JAX decodes
them).
"""

from __future__ import annotations

import io
import math
import struct
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
BICUBIC = 3  # PIL.Image.Resampling.BICUBIC
PRECISION_BITS = 32 - 8 - 2
_MODES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2), 6: ("RGBA", 4)}


class MissingDecoderError(RuntimeError):
    """An image needs a decoder that is not installed (Pillow for JPEG,
    BMP and the PNG variants the reader here does not take)."""

    def __init__(self, path, package: str = "Pillow"):
        super().__init__(f"{path}: decoding this image needs {package}, which is not installed")
        self.path, self.package = str(path), package


class UnsupportedPNG(ValueError):
    """A valid PNG outside 8-bit, non-interlaced samples."""


class Image8:
    """An 8-bit image: ``pixels`` (h, w, bands) uint8 of ``mode``;
    ``palette`` (256, 3) uint8 for mode "P"."""

    def __init__(self, pixels: np.ndarray, mode: str, palette: Optional[np.ndarray] = None):
        self.pixels, self.mode, self.palette = pixels, mode, palette

    @property
    def size(self) -> Tuple[int, int]:
        return self.pixels.shape[1], self.pixels.shape[0]

    def crop(self, box) -> "Image8":
        left, top, right, bottom = box
        return Image8(self.pixels[top:bottom, left:right].copy(), self.mode, self.palette)

    def resize(self, size, resample: int = BICUBIC) -> "Image8":
        if resample != BICUBIC:
            raise ValueError("only BICUBIC resampling is implemented")
        if tuple(size) == self.size:
            return Image8(self.pixels.copy(), self.mode, self.palette)
        if self.mode == "P":
            return Image8(_nearest(self.pixels, size), self.mode, self.palette)
        if self.mode in ("LA", "RGBA"):
            return Image8(_unpremultiply(_bicubic(_premultiply(self.pixels), size)), self.mode)
        return Image8(_bicubic(self.pixels, size), self.mode)

    def convert(self, mode: str) -> "Image8":
        if mode != "RGB":
            raise ValueError("only convert('RGB') is implemented")
        p = self.pixels
        if self.mode == "P":
            rgb = self.palette[p[..., 0]]
        elif self.mode in ("L", "LA"):
            rgb = np.repeat(p[..., :1], 3, axis=-1)
        else:
            rgb = p[..., :3].copy()
        return Image8(rgb, "RGB")

    def __array__(self, dtype=None, copy=None):
        return self.pixels if dtype is None else self.pixels.astype(dtype)


# ------------------------------------------------------------------- PNG


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG without IEND")


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        row = raw[y * (stride + 1):(y + 1) * (stride + 1)]
        kind, line = row[0], np.frombuffer(row, np.uint8, offset=1)
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum per byte of a pixel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind == 3:
            buf, up = bytearray(line), bytes(prev)
            for i in range(stride):
                a = buf[i - bpp] if i >= bpp else 0
                buf[i] = (buf[i] + ((a + up[i]) >> 1)) & 0xFF
            cur = np.frombuffer(bytes(buf), np.uint8)
        elif kind == 4:
            buf = bytearray(line)
            _paeth_row(buf, bytes(prev), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(data: bytes) -> Image8:
    """Decode a PNG of 8-bit samples, not interlaced. A corrupt file raises
    ``ValueError``; a valid one outside that subset ``UnsupportedPNG``."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in _MODES:
        raise UnsupportedPNG(f"PNG of bit depth {depth}, color type {color}, "
                             f"interlace {interlace}")
    mode, bands = _MODES[color]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG data: {e}") from None
    if len(raw) < h * (w * bands + 1):
        raise ValueError("PNG data is truncated")
    pixels = _unfilter(raw, h, w * bands, bands).reshape(h, w, bands)
    if mode == "P":
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return Image8(pixels, mode, full)
    return Image8(pixels, mode)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def png_bytes(pixels: np.ndarray) -> bytes:
    """(h, w) or (h, w, 1 / 2 / 3 / 4) uint8 ``pixels`` as an 8-bit PNG
    (L, LA, RGB or RGBA), every row unfiltered."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    h, w, bands = pixels.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[bands]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, w * bands)], axis=1)
    return (PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path, pixels: np.ndarray) -> None:
    """``png_bytes(pixels)`` written to ``path``."""
    Path(path).write_bytes(png_bytes(pixels))


# ---------------------------------------------------------------- resize


def _cubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _coefficients(in_size: int, out_size: int):
    """(first source index (out,), fixed-point weights (out, ksize) int64)
    as Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``."""
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_cubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        first[xx] = xmin
        weights[xx, :xmax] = [int(-0.5 + w * (1 << PRECISION_BITS)) if w < 0
                              else int(0.5 + w * (1 << PRECISION_BITS)) for w in k]
    return first, weights


def _pass(pixels: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One fixed-point pass along ``axis`` (0 rows, 1 columns) of (h, w,
    bands) uint8."""
    in_size = pixels.shape[axis]
    first, weights = _coefficients(in_size, out_size)
    idx = np.minimum(first[:, None] + np.arange(weights.shape[1]), in_size - 1)
    src = np.take(pixels.astype(np.int64), idx, axis=axis)  # axis -> (out, ksize)
    w = weights.reshape((1,) * axis + weights.shape + (1,) * (pixels.ndim - axis - 1))
    acc = (1 << (PRECISION_BITS - 1)) + (src * w).sum(axis=axis + 1)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _bicubic(pixels: np.ndarray, size) -> np.ndarray:
    out_w, out_h = size
    if out_w != pixels.shape[1]:
        pixels = _pass(pixels, out_w, 1)
    if out_h != pixels.shape[0]:
        pixels = _pass(pixels, out_h, 0)
    return pixels


def _nearest(pixels: np.ndarray, size) -> np.ndarray:
    def table(in_size: int, out_size: int) -> np.ndarray:
        a = in_size / out_size
        pos, out = a * 0.5, []
        for _ in range(out_size):
            out.append(min(int(pos), in_size - 1))
            pos += a
        return np.array(out)

    out_w, out_h = size
    h, w = pixels.shape[:2]
    return pixels[table(h, out_h)][:, table(w, out_w)]


def _premultiply(p: np.ndarray) -> np.ndarray:
    """RGBA -> RGBa, LA -> La: each colour band times alpha / 255, rounded
    as Pillow's MULDIV255."""
    out = p.copy()
    alpha = p[..., -1:].astype(np.int64)
    tmp = p[..., :-1].astype(np.int64) * alpha + 128
    out[..., :-1] = (((tmp >> 8) + tmp) >> 8).astype(np.uint8)
    return out


def _unpremultiply(p: np.ndarray) -> np.ndarray:
    """RGBa -> RGBA, La -> LA: colour * 255 // alpha, clipped, where alpha
    is neither 0 nor 255."""
    out = p.copy()
    alpha = p[..., -1:].astype(np.int64)
    div = (p[..., :-1].astype(np.int64) * 255) // np.maximum(alpha, 1)
    keep = (alpha == 0) | (alpha == 255)
    out[..., :-1] = np.where(keep, p[..., :-1], np.clip(div, 0, 255)).astype(np.uint8)
    return out


# ------------------------------------------------------------------ open


def pillow_image(data: bytes, name: str = "<bytes>"):
    """``PIL.Image.open`` on ``data``: the header is read now, the pixels
    when first used (``MissingDecoderError`` naming ``name`` without
    Pillow)."""
    try:
        from PIL import Image
    except ImportError:
        raise MissingDecoderError(name) from None
    return Image.open(io.BytesIO(data))


def open_image(path):
    """An ``Image8`` for a PNG the reader takes; otherwise Pillow's image
    (``MissingDecoderError`` without Pillow). Bytes that are no image
    raise ``ValueError`` (or Pillow's ``OSError``)."""
    data = Path(path).read_bytes()
    if data.startswith(PNG_SIGNATURE):
        try:
            return read_png(data)
        except UnsupportedPNG:
            pass
    elif not (data[:3] == b"\xff\xd8\xff" or data[:2] == b"BM"):
        raise ValueError(f"{path}: not a PNG, JPEG or BMP file")
    with pillow_image(data, str(path)) as img:
        img.load()
        return img
