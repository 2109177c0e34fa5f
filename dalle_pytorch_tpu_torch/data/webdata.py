"""Streaming tar shards (counterpart of ``dalle_pytorch_tpu/data/webdata.py``,
the webdataset-style input of ``--wds`` and of a ``.tar``
``--image_text_folder``).

``expand_urls`` brace-expands a shard spec (``shard-{0000..0003}.tar``);
``open_shard`` opens a local path or a ``pipe:<command>`` (the command's
standard output, its exit status reported when the stream closes);
``iter_tar_samples`` streams a tar (mode ``r|*``, never seeking, so pipes
work) and groups its members by stem into ``{extension: bytes}`` samples.

``TarImageTextDataset`` iterates (tokens, image) over every shard in
order, mapping each sample as the folder loader does: the caption
tokenized, the image decoded by Pillow (``image_io.pillow_image``),
cropped and resized by ``loader.random_resized_crop`` on the dataset's
``random.Random(0)``. A shard whose open keeps failing after the retries
of ``SHARD_RETRY`` is quarantined for the dataset's life; a sample that
does not decode is dropped; a shard that breaks mid-stream is abandoned
for the next. Each is counted in ``counters``
(``webdata.shard_open_retries``, ``shards_opened``,
``shards_quarantined``, ``quarantined_skips``, ``decode_errors``,
``shard_aborts``), never silent. ``faults`` (a
``utils.faults.FaultRegistry``) arms the ``shard_open`` and
``shard_read`` sites. On the same shards the samples, their order, the
tokens and the pixels are those of JAX's dataset for one process, no
shuffle buffer and seed 0, as JAX's trainer builds it. JAX's
per-host sharding and shuffle buffer come with the multi-device
trainer.

``TarLoader`` batches the stream, ``{"text": (b, text_len) int32,
"image": (b, h, w, 3) float32}``, the last partial batch dropped. It has
no ``epoch``: a tar stream's order is not reproducible across a resume
(the trainer replays a partial epoch from its start).
"""

from __future__ import annotations

import re
import shlex
import subprocess
import sys
import tarfile
from pathlib import Path
from random import Random
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils.metrics import Counters
from ..utils.resilience import RetryPolicy, retry
from .image_io import MissingDecoderError, pillow_image
from .loader import image_to_array, random_resized_crop

IMAGE_KEYS = ("jpg", "jpeg", "png", "img", "image")
CAPTION_KEYS = ("txt", "caption", "text")

# a shard that fails to open (a flaky pipe or disk) is retried with backoff
SHARD_RETRY = RetryPolicy(attempts=3, base_delay=0.5, retry_on=(OSError,))


def expand_urls(spec: str) -> List[str]:
    """Brace expansion: ``shard-{0000..0003}.tar`` -> 4 urls, zero-padded
    to the width of the lower bound."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", spec)
    if not m:
        return [spec]
    lo, hi = m.group(1), m.group(2)
    out = []
    for i in range(int(lo), int(hi) + 1):
        out.extend(expand_urls(spec[:m.start()] + str(i).zfill(len(lo)) + spec[m.end():]))
    return out


class _PipeStream:
    """A command's standard output; ``close`` reaps the command and reports
    a nonzero exit, so a dead pipe is not taken for a short shard."""

    def __init__(self, cmd: str):
        self._proc = subprocess.Popen(shlex.split(cmd), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE)
        self._cmd = cmd

    def read(self, *a):
        return self._proc.stdout.read(*a)

    def close(self):
        self._proc.stdout.close()
        err = self._proc.stderr.read().decode(errors="replace")
        self._proc.stderr.close()
        code = self._proc.wait()
        if code != 0:
            print(f"pipe command failed (exit {code}): {self._cmd}\n{err[-500:]}",
                  file=sys.stderr)


def open_shard(url: str):
    """A binary stream of one shard: a local path, or ``pipe:<command>``."""
    if url.startswith("pipe:"):
        return _PipeStream(url[len("pipe:"):])
    return open(url, "rb")


def iter_tar_samples(stream) -> Iterator[Dict[str, bytes]]:
    """The tar's members grouped by stem into {extension: bytes} samples
    (members of one sample are contiguous, the webdataset layout)."""
    current: Optional[str] = None
    sample: Dict[str, bytes] = {}
    with tarfile.open(fileobj=stream, mode="r|*") as tf:
        for member in tf:
            if not member.isfile():
                continue
            name = Path(member.name)
            stem, ext = str(name.parent / name.stem), name.suffix.lstrip(".").lower()
            if stem != current:
                if sample:
                    yield sample
                current, sample = stem, {}
            f = tf.extractfile(member)
            if f is not None:
                sample[ext] = f.read()
    if sample:
        yield sample


class TarImageTextDataset:
    """An iterable of (tokens (text_len,) int32, image (h, w, 3) float32)
    over the tar shards of ``urls`` (see the module docstring)."""

    def __init__(self, urls: str, text_len: int = 256, image_size: int = 128,
                 truncate_captions: bool = False, resize_ratio: float = 0.75, tokenizer=None,
                 image_key: Optional[str] = None, caption_key: Optional[str] = None,
                 counters: Optional[Counters] = None, faults=None):
        self._quarantined: set = set()
        self.urls = expand_urls(urls)
        assert self.urls, f"no shards matched {urls}"
        self.text_len = text_len
        self.image_size = image_size
        self.truncate_captions = truncate_captions
        self.resize_ratio = resize_ratio
        if tokenizer is None:
            from .tokenizers import get_tokenizer

            tokenizer = get_tokenizer()
        self.tokenizer = tokenizer
        self.image_keys = (image_key,) if image_key else IMAGE_KEYS
        self.caption_keys = (caption_key,) if caption_key else CAPTION_KEYS
        self.counters = counters if counters is not None else Counters()
        self.faults = faults
        self._rng = Random(0)

    def _fault(self, site: str, exc: BaseException) -> None:
        if self.faults is not None:
            self.faults.maybe_raise(site, exc)

    def _map(self, sample: Dict[str, bytes]) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        img_bytes = next((sample[k] for k in self.image_keys if k in sample), None)
        cap_bytes = next((sample[k] for k in self.caption_keys if k in sample), None)
        if img_bytes is None or cap_bytes is None:
            return None
        try:
            caption = cap_bytes.decode("utf-8")
            tokens = self.tokenizer.tokenize(caption, self.text_len,
                                             truncate_text=self.truncate_captions)[0]
            # lazy, as JAX's Image.open: a body that does not decode fails
            # in the crop, after its draws from the shared rng
            with pillow_image(img_bytes) as img:
                img = random_resized_crop(img, self.image_size, self._rng, self.resize_ratio)
                image = image_to_array(img)
        except MissingDecoderError:
            raise
        except Exception as e:  # dropped, but counted
            self.counters.inc("webdata.decode_errors")
            print(f"tar sample skipped: {type(e).__name__}: {e}", file=sys.stderr)
            return None
        return tokens, image

    def _open_with_retry(self, url: str):
        """The shard's stream after retries, or None once it is quarantined."""

        def attempt():
            self._fault("shard_open", OSError("injected shard_open fault"))
            return open_shard(url)

        try:
            stream = retry(attempt, SHARD_RETRY, describe=f"open shard {url}",
                           on_retry=lambda i, e: self.counters.inc("webdata.shard_open_retries"))
        except SHARD_RETRY.retry_on as e:
            self._quarantined.add(url)
            self.counters.inc("webdata.shards_quarantined")
            print(f"shard {url} quarantined after {SHARD_RETRY.attempts} attempts: {e}",
                  file=sys.stderr)
            return None
        self.counters.inc("webdata.shards_opened")
        return stream

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for url in self.urls:
            if url in self._quarantined:
                self.counters.inc("webdata.quarantined_skips")
                continue
            stream = self._open_with_retry(url)
            if stream is None:
                continue
            try:
                for raw in iter_tar_samples(stream):
                    self._fault("shard_read", tarfile.TarError("injected shard_read fault"))
                    mapped = self._map(raw)
                    if mapped is not None:
                        yield mapped
            except tarfile.TarError as e:
                # a shard broken mid-stream: keep what came, go on to the next
                self.counters.inc("webdata.shard_aborts")
                print(f"shard {url} aborted: {e}", file=sys.stderr)
            finally:
                stream.close()


class TarLoader:
    """Batches of a ``TarImageTextDataset``; the last partial batch is
    dropped."""

    def __init__(self, dataset: TarImageTextDataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __iter__(self) -> Iterator[dict]:
        batch: List[Tuple[np.ndarray, np.ndarray]] = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield {"text": np.stack([b[0] for b in batch]).astype(np.int32),
                       "image": np.stack([b[1] for b in batch])}
                batch = []
