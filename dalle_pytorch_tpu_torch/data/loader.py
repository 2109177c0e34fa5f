"""Folder dataset and host-side batching (counterpart of
``dalle_pytorch_tpu/data/loader.py``).

``TextImageDataset``: images paired with same-stem ``.txt`` caption files,
one random caption a sample, a square random crop resized to
``image_size``, and a file that cannot be read replaced by another sample.
PNGs are read by ``image_io`` (no Pillow); JPEG and BMP files by Pillow,
imported when one is opened: without Pillow the constructor raises
``image_io.MissingDecoderError`` naming the first such file, and such a
file is never skipped as corrupt. Samples are numpy: tokens (text_len,)
int32, images (h, w, 3) float32 in [0, 1].

``ImageFolderDataset``: the VAE trainer's label-free images, every image
file under a folder in sorted order, each a square random crop of at
least 0.75 of its area resized to ``image_size``; a file that cannot be
read is replaced by the next one. Samples (image, 0); its ``collate``
makes ``{"image": (b, h, w, 3) float32}`` batches.

``DataLoader``: one process's ``seed + epoch`` shuffle, the last partial
batch dropped, two batches made ahead on a background thread; batches
``{"text": (b, text_len) int32, "image": (b, h, w, 3) float32}``, or
what a given ``collate_fn`` makes of a list of samples. Its
``epoch`` attribute picks the order, so a resumed run sees the same
batches. JAX's per-host sharding (``process_index``/``process_count``)
comes with the multi-device trainer.

The random draws (``random.Random(seed)``: the caption choice, then the
crop's ``uniform`` and ``randint``) are JAX's, call for call, so on the
same folder and seed both give the same tokens and the same pixels. The
stream runs on across epochs; ``TextImageDataset.rng_state`` /
``set_rng_state`` carry it across a resume at an epoch's end.
"""

from __future__ import annotations

import queue
import random
import threading
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np

from .image_io import BICUBIC, MissingDecoderError, open_image

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")
PILLOW_EXTS = (".jpg", ".jpeg", ".bmp")


def random_resized_crop(img, out_size: int, rng: random.Random, min_scale: float = 0.75):
    """A square crop covering a random [min_scale, 1] share of the area,
    resized to ``out_size`` (bicubic); the largest centred square when ten
    draws do not fit. ``img`` is an ``image_io.Image8`` or a Pillow image."""
    w, h = img.size
    area = w * h
    for _ in range(10):
        target = rng.uniform(min_scale, 1.0) * area
        side = int(round(target**0.5))
        if side <= w and side <= h:
            left = rng.randint(0, w - side)
            top = rng.randint(0, h - side)
            img = img.crop((left, top, left + side, top + side))
            break
    else:
        side = min(w, h)
        left, top = (w - side) // 2, (h - side) // 2
        img = img.crop((left, top, left + side, top + side))
    return img.resize((out_size, out_size), BICUBIC)


def image_to_array(img) -> np.ndarray:
    """Any mode -> (h, w, 3) float32 in [0, 1]."""
    return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0


def pillow_available() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


class TextImageDataset:
    def __init__(self, folder: str, text_len: int = 256, image_size: int = 128,
                 truncate_captions: bool = False, resize_ratio: float = 0.75,
                 tokenizer=None, shuffle: bool = False, seed: int = 0):
        self.shuffle = shuffle
        path = Path(folder)
        text_files = {p.stem: p for p in path.glob("**/*.txt")}
        image_files = {p.stem: p for ext in IMAGE_EXTS for p in path.glob(f"**/*{ext}")}
        self.keys = sorted(image_files.keys() & text_files.keys())
        self.text_files = {k: text_files[k] for k in self.keys}
        self.image_files = {k: image_files[k] for k in self.keys}
        needs_pillow = [self.image_files[k] for k in self.keys
                        if self.image_files[k].suffix in PILLOW_EXTS]
        if needs_pillow and not pillow_available():
            raise MissingDecoderError(needs_pillow[0])
        self.text_len = text_len
        self.truncate_captions = truncate_captions
        self.resize_ratio = resize_ratio
        self.image_size = image_size
        if tokenizer is None:
            from .tokenizers import SimpleTokenizer

            tokenizer = SimpleTokenizer()
        self.tokenizer = tokenizer
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.keys)

    def rng_state(self) -> list:
        """The caption and crop stream's state, as JSON lists: a
        checkpoint written at an epoch's end carries it, so that a run
        resumed there draws what the uninterrupted run draws."""
        version, internal, gauss = self._rng.getstate()
        return [version, list(internal), gauss]

    def set_rng_state(self, state: list) -> None:
        version, internal, gauss = state
        self._rng.setstate((version, tuple(internal), gauss))

    def random_sample(self):
        return self[self._rng.randint(0, len(self) - 1)]

    def sequential_sample(self, ind: int):
        return self[(ind + 1) % len(self)]

    def skip_sample(self, ind: int):
        return self.random_sample() if self.shuffle else self.sequential_sample(ind)

    def __getitem__(self, ind: int) -> Tuple[np.ndarray, np.ndarray]:
        key = self.keys[ind]
        try:
            descriptions = [d for d in self.text_files[key].read_text(encoding="utf8").split("\n")
                            if d]
            description = self._rng.choice(descriptions)  # IndexError if empty
            tokens = self.tokenizer.tokenize(description, self.text_len,
                                             truncate_text=self.truncate_captions)[0]
        except (UnicodeDecodeError, OSError, IndexError):
            return self.skip_sample(ind)
        try:
            img = random_resized_crop(open_image(self.image_files[key]), self.image_size,
                                      self._rng, self.resize_ratio)
            image = image_to_array(img)
        except MissingDecoderError:
            raise
        except (OSError, ValueError):  # undecodable bytes: another sample
            return self.skip_sample(ind)
        return tokens, image


class ImageFolderDataset:
    """Every image file under ``folder`` (sorted), each a random square
    crop resized to ``image_size``; the random draws are JAX's."""

    def __init__(self, folder: str, image_size: int, seed: int = 0):
        path = Path(folder)
        self.files = sorted(p for ext in IMAGE_EXTS for p in path.glob(f"**/*{ext}"))
        if not self.files:
            raise ValueError(f"no images found at {folder}")
        needs_pillow = [p for p in self.files if p.suffix in PILLOW_EXTS]
        if needs_pillow and not pillow_available():
            raise MissingDecoderError(needs_pillow[0])
        self.image_size = image_size
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, ind: int) -> Tuple[np.ndarray, np.ndarray]:
        try:
            img = random_resized_crop(open_image(self.files[ind]), self.image_size,
                                      self._rng, 0.75)
            arr = image_to_array(img)
        except MissingDecoderError:
            raise
        except (OSError, ValueError):  # undecodable bytes: the next file
            return self[(ind + 1) % len(self)]
        return arr, np.zeros((), np.int32)

    @staticmethod
    def collate(batch):
        return {"image": np.stack([b[0] for b in batch])}


class DataLoader:
    """Batches of ``dataset`` with the per-epoch ``seed + epoch`` shuffle,
    the last partial batch dropped and ``PREFETCH`` batches made ahead on
    a background thread, each ``collate_fn`` of its samples (default the
    text-image batch). ``epoch`` counts up after each pass; set it to
    replay an epoch's order."""

    PREFETCH = 2

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 collate_fn=None):
        assert batch_size >= 1
        if collate_fn is not None:
            self._collate = collate_fn
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def indices(self) -> List[int]:
        """This epoch's sample order."""
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        return idx

    def _produce(self, out_q: queue.Queue, errors: list):
        try:
            batch = []
            for i in self.indices():
                batch.append(self.dataset[i])
                if len(batch) == self.batch_size:
                    out_q.put(self._collate(batch))
                    batch = []
        except BaseException as e:  # re-raised on the consuming thread
            errors.append(e)
        finally:
            out_q.put(None)

    @staticmethod
    def _collate(batch):
        return {"text": np.stack([b[0] for b in batch]).astype(np.int32),
                "image": np.stack([b[1] for b in batch])}

    def __iter__(self) -> Iterator[dict]:
        out_q: queue.Queue = queue.Queue(maxsize=self.PREFETCH)
        errors: list = []
        worker = threading.Thread(target=self._produce, args=(out_q, errors), daemon=True)
        worker.start()
        while True:
            item = out_q.get()
            if item is None:
                break
            yield item
        worker.join()
        if errors:
            raise errors[0]
        self.epoch += 1
