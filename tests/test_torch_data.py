"""The port's data path without Pillow (``data/image_io.py``,
``data/loader.py``) against Pillow and the JAX package's loader.

- The PNG reader against ``PIL.Image.open``, bitwise: the five colour
  types (gray, RGB, palette, gray + alpha, RGBA) of 8-bit samples, each
  with every row under one of the five filter types (None, Sub, Up,
  Average, Paeth) and with the five mixed; the writer's files read back by
  Pillow.
- The resize against ``Image.resize(..., BICUBIC)`` over hypothesis-drawn
  sizes, modes L, RGB, RGBA (premultiplied), LA and P (nearest), bitwise
  (the largest difference found is 0), and ``convert("RGB")``.
- ``TextImageDataset`` and ``DataLoader`` against JAX's on one folder and
  seed (PNGs of every colour type at several sizes, several captions per
  image, the default crops, one file of garbage): the token arrays, the
  pixels and each epoch's batch order, bitwise; the last partial batch
  dropped as JAX drops it; an error on the loader's thread re-raised.
- A JPEG with Pillow blocked: the dataset's constructor raises
  ``MissingDecoderError`` naming the file and Pillow (never a skip as
  corrupt); with Pillow, a JPEG folder gives JAX's samples.
"""

import io
import struct
import sys
import zlib

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from dalle_pytorch_tpu.data import DataLoader as JDataLoader
from dalle_pytorch_tpu.data import TextImageDataset as JDataset
from dalle_pytorch_tpu.data.tokenizers import SimpleTokenizer as JTokenizer
from dalle_pytorch_tpu_torch.data import image_io
from dalle_pytorch_tpu_torch.data.image_io import Image8, MissingDecoderError
from dalle_pytorch_tpu_torch.data.loader import DataLoader, TextImageDataset
from dalle_pytorch_tpu_torch.data.tokenizers import SimpleTokenizer

COLOR_TYPES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2), 6: ("RGBA", 4)}


def _filtered_png(px: np.ndarray, color: int, filters, palette=None) -> bytes:
    """An 8-bit PNG of ``px`` (h, w, bands) whose row y is filtered with
    ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, bpp = px.shape
    rows = px.reshape(h, -1).astype(np.int64)
    prev = np.zeros(rows.shape[1], np.int64)
    out = []
    for y in range(h):
        f, r = filters[y % len(filters)], rows[y]
        a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        b = prev
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(bytes([f]) + ((r - pred) % 256).astype(np.uint8).tobytes())
        prev = r
    chunks = image_io._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
    if palette is not None:
        chunks += image_io._chunk(b"PLTE", palette.tobytes())
    chunks += image_io._chunk(b"IDAT", zlib.compress(b"".join(out)))
    return image_io.PNG_SIGNATURE + chunks + image_io._chunk(b"IEND", b"")


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("color", sorted(COLOR_TYPES))
def test_png_reader_is_bitwise_pillow(color, filters):
    mode, bands = COLOR_TYPES[color]
    rng = np.random.RandomState(color * 10 + len(filters) + filters[0])
    h, w = rng.randint(1, 40, size=2)
    palette = rng.randint(0, 256, size=(23, 3)).astype(np.uint8) if color == 3 else None
    px = rng.randint(0, 23 if color == 3 else 256, size=(h, w, bands)).astype(np.uint8)
    px[: h // 2] //= 16  # smooth rows, where the predictors matter
    data = _filtered_png(px, color, filters, palette)
    pil = Image.open(io.BytesIO(data))
    pil.load()
    mine = image_io.read_png(data)
    assert mine.mode == pil.mode == mode and mine.size == pil.size
    np.testing.assert_array_equal(mine.pixels, np.asarray(pil).reshape(h, w, bands))
    np.testing.assert_array_equal(mine.convert("RGB").pixels, np.asarray(pil.convert("RGB")))


def test_png_reader_refuses_corrupt_and_hands_on_unsupported():
    data = _filtered_png(np.zeros((4, 4, 3), np.uint8), 2, [0])
    broken = bytearray(data)
    broken[40] ^= 0xFF  # inside IDAT: the chunk's CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        image_io.read_png(bytes(broken))
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, format="PNG")  # 16-bit gray
    with pytest.raises(image_io.UnsupportedPNG):
        image_io.read_png(buf.getvalue())


@pytest.mark.parametrize("bands", [1, 2, 3, 4])
def test_png_writer_reads_back_in_pillow(tmp_path, bands):
    px = np.random.RandomState(bands).randint(0, 256, size=(9, 13, bands)).astype(np.uint8)
    image_io.write_png(tmp_path / "x.png", px)
    pil = np.asarray(Image.open(tmp_path / "x.png"))
    np.testing.assert_array_equal(pil.reshape(9, 13, bands), px)
    np.testing.assert_array_equal(image_io.read_png((tmp_path / "x.png").read_bytes()).pixels, px)


def _pil(px: np.ndarray, mode: str, palette=None):
    img = Image.fromarray(px[..., 0] if px.shape[-1] == 1 else px, mode)
    if palette is not None:
        img.putpalette(palette.reshape(-1).tolist())
    return img


@settings(max_examples=120, deadline=None, suppress_health_check=list(HealthCheck))
@given(mode=st.sampled_from(["L", "RGB", "RGBA", "LA", "P"]),
       src=st.tuples(st.integers(1, 96), st.integers(1, 96)),
       dst=st.tuples(st.integers(1, 96), st.integers(1, 96)),
       seed=st.integers(0, 2**31 - 1))
def test_resize_is_bitwise_pillow_bicubic(mode, src, dst, seed):
    bands = {"L": 1, "P": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    rng = np.random.RandomState(seed)
    px = rng.randint(0, 256, size=(src[1], src[0], bands)).astype(np.uint8)
    if mode in ("LA", "RGBA"):  # transparent, opaque and partial alpha
        px[..., -1] = rng.choice([0, 255, 1, 77, 254], size=px.shape[:2])
    palette = rng.randint(0, 256, size=(256, 3)).astype(np.uint8) if mode == "P" else None
    ref = _pil(px, mode, palette).resize(dst, Image.BICUBIC)
    mine = Image8(px, mode, palette).resize(dst)
    np.testing.assert_array_equal(mine.pixels, np.asarray(ref).reshape(dst[1], dst[0], bands))
    np.testing.assert_array_equal(mine.convert("RGB").pixels, np.asarray(ref.convert("RGB")))


@pytest.fixture(scope="module")
def tokenizers():
    return JTokenizer(), SimpleTokenizer()


@pytest.fixture(scope="module")
def mixed_folder(tmp_path_factory):
    """PNGs of every colour type at square and non-square sizes, 1-3
    captions each, and one .png of garbage (skipped by both loaders)."""
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.RandomState(9)
    words = ["a", "red", "cat's", "tiny", "house", "on", "the", "hill", "café", "42"]
    for i in range(14):
        color = sorted(COLOR_TYPES)[i % 5]
        _, bands = COLOR_TYPES[color]
        h, w = (40, 40) if i % 3 == 0 else (rng.randint(24, 60), rng.randint(24, 60))
        palette = rng.randint(0, 256, size=(256, 3)).astype(np.uint8) if color == 3 else None
        px = rng.randint(0, 256, size=(h, w, bands)).astype(np.uint8)
        sub = root / ("sub" if i % 2 else "")
        sub.mkdir(exist_ok=True)
        (sub / f"img_{i:02d}.png").write_bytes(
            _filtered_png(px, color, [i % 5, (i + 2) % 5], palette))
        caps = [" ".join(rng.choice(words, size=rng.randint(2, 7)))
                for _ in range(rng.randint(1, 4))]
        (sub / f"img_{i:02d}.txt").write_text("\n".join(caps) + "\n", encoding="utf8")
    (root / "img_99.png").write_bytes(b"not an image at all")
    (root / "img_99.txt").write_text("garbage\n")
    return root


def _datasets(folder, toks, **kw):
    args = dict(text_len=16, image_size=32, truncate_captions=True, shuffle=True, seed=7)
    args.update(kw)
    return (JDataset(str(folder), tokenizer=toks[0], **args),
            TextImageDataset(str(folder), tokenizer=toks[1], **args))


def test_dataset_samples_are_bitwise_jax(mixed_folder, tokenizers):
    jds, ds = _datasets(mixed_folder, tokenizers)
    assert jds.keys == ds.keys and len(ds) == 15
    for i in list(range(len(ds))) * 2:  # the second pass draws other captions and crops
        (jt, ji), (t, im) = jds[i], ds[i]
        np.testing.assert_array_equal(t, jt)
        assert im.dtype == ji.dtype == np.float32 and im.shape == (32, 32, 3)
        np.testing.assert_array_equal(im, ji)


def test_loader_batches_and_order_are_bitwise_jax(mixed_folder, tokenizers):
    jds, ds = _datasets(mixed_folder, tokenizers, resize_ratio=0.5)
    jl, pl = JDataLoader(jds, 4, seed=7), DataLoader(ds, 4, seed=7)
    assert len(jl) == len(pl) == 3
    for epoch in range(3):
        assert pl.epoch == jl.epoch == epoch
        assert pl.indices() == jl._indices()
        for jb, b in zip(list(jl), list(pl), strict=True):
            np.testing.assert_array_equal(b["text"], jb["text"])
            np.testing.assert_array_equal(b["image"], jb["image"])
            assert b["text"].dtype == np.int32 and b["image"].dtype == np.float32
    jl.epoch = pl.epoch = 1  # a resumed epoch replays its order
    assert pl.indices() == jl._indices()


@pytest.mark.parametrize("batch_size", [2, 6, 15])
def test_loader_drops_the_partial_batch_like_jax(mixed_folder, tokenizers, batch_size):
    jds, ds = _datasets(mixed_folder, tokenizers)
    jl, pl = JDataLoader(jds, batch_size, seed=3), DataLoader(ds, batch_size, seed=3)
    assert len(pl) == len(jl) == 15 // batch_size
    jb, b = list(jl), list(pl)
    assert len(b) == len(jb) == len(pl)
    for x, y in zip(b, jb):
        assert x["text"].shape[0] == batch_size
        np.testing.assert_array_equal(x["text"], y["text"])
        np.testing.assert_array_equal(x["image"], y["image"])


def test_loader_reraises_what_its_thread_raised():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise RuntimeError(f"sample {i}")

    loader = DataLoader(Broken(), 2, shuffle=False)
    with pytest.raises(RuntimeError, match="sample 0"):
        list(loader)
    assert loader.epoch == 0  # the failed pass is not counted


def _jpeg_folder(root):
    rng = np.random.RandomState(2)
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, size=(36, 30, 3)).astype(np.uint8)).save(
            root / f"photo_{i}.jpg", quality=90)
        (root / f"photo_{i}.txt").write_text(f"photo number {i}\n")
    return root


def test_jpeg_needs_pillow_and_is_never_skipped(tmp_path, tokenizers, monkeypatch):
    folder = _jpeg_folder(tmp_path)
    jds, ds = _datasets(folder, tokenizers)
    for i in range(len(ds)):  # with Pillow: JAX's samples
        np.testing.assert_array_equal(ds[i][1], jds[i][1])
        np.testing.assert_array_equal(ds[i][0], jds[i][0])
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(MissingDecoderError, match=r"photo_0\.jpg.*Pillow") as err:
        TextImageDataset(str(folder), tokenizer=tokenizers[1])
    assert err.value.package == "Pillow"
    with pytest.raises(MissingDecoderError):
        ds[0]  # a dataset built before: the sample raises, it is not skipped
