"""Ragged paged attention: one attention call for a mixed prefill+decode
iteration (counterpart of ``dalle_pytorch_tpu/ops/ragged_attention.py``).

Every cache row carries a descriptor (start, length) over a fixed (B, W)
query block: row b's valid queries are columns [0, length[b]) at
positions start[b] + i; a decode row has length 1, a prefill chunk up to
W, an idle row 0. Causal "full" masking: key p is visible to query i iff
p <= start + i.

- ``reference_attend`` is the plain version: ``paged_kv.gather`` builds
  the logical (b, W_cache, h*d) view and ``attention.cache_block_attend``
  runs the masked block attention.
- ``kernel_attend`` is the wrapper of the hand-written CUDA kernel
  (``csrc/ragged_attention.cu``), which walks each row's pages only up to
  its frontier with an online softmax. The tensor's device decides: a
  CUDA tensor launches the kernel or raises, a CPU tensor runs the plain
  version. ``kernel_attend.launches`` counts kernel launches.

The kernel agrees with the plain version on VALID columns (allclose: the
online softmax reassociates the sum); invalid columns and idle rows are
garbage that every caller discards (the kernel writes zeros past a row's
first max(length, 1) columns).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import paged_kv
from .masks import causal_mask

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=8)
def _causal_rows(width: int, device: str) -> torch.Tensor:
    return torch.from_numpy(causal_mask(width)).to(device)


def reference_attend(q, k_flat, v_flat, table, start):
    """Plain version: q (b, n, h, d) pre-scaled; flat pools
    (rows * n_pages + 1, page, h*d); table (b, n_pages) int32 global ids;
    start (b,). Returns (b, n, h, d). The mask rows are the causal
    pattern's rows at each query's position."""
    from .attention import cache_block_attend  # attention imports this module

    b, n = q.shape[:2]
    k_cache = paged_kv.gather(k_flat, table)
    v_cache = paged_kv.gather(v_flat, table)
    W = k_cache.shape[1]
    pos = start.long()[:, None] + torch.arange(n, device=q.device)
    allowed = _causal_rows(W, str(q.device))[pos.clamp(max=W - 1)]
    return cache_block_attend(q, k_cache, v_cache, allowed)


def kernel_attend(q, k_flat, v_flat, table, start, length,
                  k_scales=None, v_scales=None):
    """Ragged paged attention. q (b, n, h, d) pre-scaled, float32 or
    bfloat16; k_flat/v_flat flat pools (rows * n_pages + 1, page, h*d) of
    q's dtype; table (b, n_pages) int32; start, length (b,) int32.
    Returns (b, n, h, d) in q's dtype. CPU tensors run
    ``reference_attend``; CUDA tensors launch the kernel. Int8 pages
    (``k_scales``/``v_scales`` scale pools) are not ported yet."""
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "int8 KV pages (scale pools) are not ported to the CUDA kernel yet"
        )
    if not q.is_cuda:
        return reference_attend(q, k_flat, v_flat, table, start)
    b, n, h, d = q.shape
    _, page, hd = k_flat.shape
    n_pages = table.shape[1]
    tensors = (q, k_flat, v_flat, table, start, length)
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError("kernel_attend: every tensor must be on q's device")
    if q.dtype not in _DTYPE_CODE or k_flat.dtype != q.dtype or v_flat.dtype != q.dtype:
        raise TypeError(
            f"kernel_attend takes float32 or bfloat16 q and pools of its "
            f"dtype, got {q.dtype}, {k_flat.dtype}, {v_flat.dtype}"
        )
    if any(t.dtype != torch.int32 for t in (table, start, length)):
        raise TypeError("kernel_attend: table, start and length must be int32")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("kernel_attend: every tensor must be contiguous")
    if hd != h * d or v_flat.shape != k_flat.shape:
        raise ValueError(
            f"pool width {hd} and shapes {tuple(k_flat.shape)}, "
            f"{tuple(v_flat.shape)} do not match heads*dim_head {h}*{d}"
        )
    if table.shape[0] != b or start.shape != (b,) or length.shape != (b,):
        raise ValueError("table, start and length must cover q's batch")
    from .cuda_build import load_library

    lib = load_library("ragged_attention")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    p = ctypes.c_void_p
    err = lib.ragged_attention_fwd(
        p(q.data_ptr()), p(k_flat.data_ptr()), p(v_flat.data_ptr()),
        p(table.data_ptr()), p(start.data_ptr()), p(length.data_ptr()),
        p(out.data_ptr()), b, n, h, d, page, n_pages, _DTYPE_CODE[q.dtype],
        p(stream),
    )
    if err == -1:
        raise ValueError(
            f"the ragged kernel cannot take width {n}, dim_head {d}, page "
            f"{page}: it has instances for dim_head 32/64/128 and a width "
            "whose tiles fit the card's shared memory per block (see "
            "csrc/ragged_attention.cu)"
        )
    if err != 0:
        raise RuntimeError(f"ragged_attention kernel launch failed: error {err}")
    kernel_attend.launches += 1
    return out


kernel_attend.launches = 0
