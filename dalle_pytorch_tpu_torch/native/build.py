"""Build and load the native BPE engine (``bpe_tokenizer.cc``).

The engine is host code: ``g++`` (or ``$CXX``) compiles it at first use,
never at import, into ``build/native/libdalle_bpe-<hash>.so`` at the
repository root. The hash is the content hash of ``bpe_tokenizer.cc``
and ``unicode_tables.h``, so an edited source rebuilds. The engine has a
plain C interface, bound with ctypes by ``data/native_bpe.py``.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

NATIVE = Path(__file__).resolve().parent
SOURCE = NATIVE / "bpe_tokenizer.cc"
HEADERS = (NATIVE / "unicode_tables.h",)
BUILD_DIR = NATIVE.parent.parent / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    for header in HEADERS:
        digest.update(header.read_bytes())
    return BUILD_DIR / f"libdalle_bpe-{digest.hexdigest()[:12]}.so"


def build() -> Optional[Path]:
    """The engine's library, compiled if it is missing; None when the
    compiler is missing or fails."""
    with _LOCK:
        path = library_path()
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(tmp, path)  # another process never loads a partial library
        return path
