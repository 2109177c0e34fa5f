"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``build/torch_kernels/
lib<name>-<hash>.so`` at the repository root (the hash is the content
hash of the source and of every ``csrc/*.cuh`` header, so an edited
source or header rebuilds), and bound with ctypes. The build happens at
first use, never at import. ``build()`` starts one ``nvcc`` per source,
all together, and waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every exported entry point: (argtypes, restype)
SIGNATURES = {
    "ragged_attention": {
        "ragged_attention_fwd": ([_P] * 7 + [_I] * 7 + [_P], _I),
        "ragged_attention_fwd_int8": ([_P] * 9 + [_I] * 7 + [_P], _I),
    },
    "fused_qkv_attention": {
        "fused_qkv_attention_fwd": ([_P] * 7 + [_I] * 5 + [_F, _I, _P], _I),
    },
    "fused_qkv_attention_bwd": {
        "fused_qkv_attention_bwd": ([_P] * 11 + [_I] * 5 + [_F, _I, _P], _I),
    },
    "block_sparse_attention": {
        "block_sparse_attention_fwd": ([_P] * 9 + [_I] * 7 + [_F, _I, _P], _I),
        "block_sparse_attention_dq": ([_P] * 12 + [_I] * 7 + [_F, _I, _P], _I),
        "block_sparse_attention_dkdv": ([_P] * 13 + [_I] * 7 + [_F, _I, _P], _I),
    },
    "decode_attention": {
        "decode_attention_fwd": ([_P] * 9 + [_I] * 5 + [_F, _I, _I, _P], _I),
    },
    "flash_attention": {
        "flash_attention_fwd": ([_P] * 8 + [_I] * 4 + [_F, _I, _P], _I),
        "flash_attention_dq": ([_P] * 11 + [_I] * 4 + [_F, _I, _P], _I),
        "flash_attention_dkdv": ([_P] * 11 + [_I] * 4 + [_F, _I, _P], _I),
        "flash_attention_bwd_fused": ([_P] * 12 + [_I] * 4 + [_F, _I, _P], _I),
    },
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library among ``names`` (default: all), one
    nvcc process per source started together; raise on any failure."""
    names = list(SIGNATURES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu:\n{log}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built if needed."""
    if name not in _LOADED:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LOADED[name] = lib
    return _LOADED[name]
