"""The native BPE engine's binding (counterpart of
``dalle_pytorch_tpu/data/native_bpe.py``): ``NativeSimpleTokenizer``, the
CLIP byte-level BPE of ``tokenizers.SimpleTokenizer`` with its scanner,
merge loop and decoder in C++ (``native/bpe_tokenizer.cc``, built by
``native/build.py``), byte-exact with it on ``encode``, ``decode`` and
``tokenize``. The text cleaning (NFC, HTML unescape, whitespace, lower
case) stays in Python, shared with ``SimpleTokenizer``. The merges file
is read here, plain or gzipped, and handed to the engine as text. One
engine serves many threads: its token cache is behind a mutex.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterable, List, Optional

import numpy as np

from .tokenizers import (
    _TokenizeMixin,
    basic_clean,
    default_bpe_path,
    read_bpe_text,
    whitespace_clean,
)

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _LOCK:
        if _lib is not None or _lib_failed:
            return _lib
        from ..native.build import build

        so = build()
        if so is None:
            _lib_failed = True
            return None
        lib = ctypes.CDLL(str(so))
        i32p = ctypes.POINTER(ctypes.c_int32)
        for name, argtypes, restype in (
            ("bpe_new", [ctypes.c_char_p, ctypes.c_int64], ctypes.c_void_p),
            ("bpe_free", [ctypes.c_void_p], None),
            ("bpe_vocab_size", [ctypes.c_void_p], ctypes.c_int32),
            ("bpe_encode", [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, i32p,
                            ctypes.c_int64], ctypes.c_int64),
            ("bpe_decode", [ctypes.c_void_p, i32p, ctypes.c_int64, i32p, ctypes.c_int64,
                            ctypes.c_char_p, ctypes.c_int64], ctypes.c_int64),
        ):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
        return lib


def native_available() -> bool:
    return _load_lib() is not None


class NativeSimpleTokenizer(_TokenizeMixin):
    """``SimpleTokenizer`` on the native engine. ``bpe_path``: a merges
    file, plain text or gzip; default ``default_bpe_path()``."""

    def __init__(self, bpe_path: Optional[str] = None):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native BPE engine unavailable (no C++ compiler?); use "
                               "SimpleTokenizer instead")
        bpe_path = bpe_path or default_bpe_path()
        if bpe_path is None:
            raise FileNotFoundError("BPE merges file not found")
        merges = read_bpe_text(bpe_path).encode("utf8")
        self._lib = lib
        self._h = lib.bpe_new(merges, len(merges))
        if not self._h:
            raise RuntimeError(f"native BPE engine failed to load {bpe_path}")
        self.vocab_size = int(lib.bpe_vocab_size(self._h))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.bpe_free(h)
            self._h = None

    def encode(self, text: str) -> List[int]:
        raw = whitespace_clean(basic_clean(text)).lower().encode("utf-8")
        cap = max(len(raw) * 2, 64)
        while True:
            buf = (ctypes.c_int32 * cap)()
            n = self._lib.bpe_encode(self._h, raw, len(raw), buf, cap)
            if n <= cap:
                return list(buf[:n])
            cap = int(n)

    def decode(self, tokens: Iterable[int], pad_tokens: set = frozenset()) -> str:
        """ids -> text, dropping ``pad_tokens`` and 0s."""
        ids = np.asarray([int(t) for t in tokens], np.int32)
        skip = np.asarray(sorted(int(t) for t in pad_tokens), np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        ids_p, skip_p = ids.ctypes.data_as(i32p), skip.ctypes.data_as(i32p)
        cap = max(len(ids) * 16, 64)
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.bpe_decode(self._h, ids_p, len(ids), skip_p, len(skip), buf, cap)
            if n <= cap:
                return buf.raw[:n].decode("utf-8", errors="replace")
            cap = int(n)
