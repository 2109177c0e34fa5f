"""Ragged paged attention: one attention call for a mixed prefill+decode
iteration (counterpart of ``dalle_pytorch_tpu/ops/ragged_attention.py``).

Every cache row carries a descriptor (start, length) over a fixed (B, W)
query block: row b's valid queries are columns [0, length[b]) at
positions start[b] + i; a decode row has length 1, a prefill chunk up to
W, an idle row 0. Causal "full" masking: key p is visible to query i iff
p <= start + i.

- ``reference_attend`` is the plain version: ``paged_kv.gather`` builds
  the logical (b, W_cache, h*d) view (dequantized with
  ``paged_kv.dequant`` for int8 pools) and ``attention.cache_block_attend``
  runs the masked block attention.
- ``kernel_attend`` is the wrapper of the hand-written CUDA kernel
  (``csrc/ragged_attention.cu``), which reads each row's keys only up to
  its frontier, split over the blocks of a thread-block cluster (bf16 on
  the tensor cores, float32 on CUDA-core FMAs) and merged in a fixed
  order, so a column's output does not depend on the other rows. Int8
  pools (given with their scale pools) go to ``kernel_attend_int8``, the
  kernel's int8 instance, which dequantizes each key tile as it stages
  it. The tensor's device decides: a CUDA tensor launches the kernel or
  raises, a CPU tensor runs the plain version. ``kernel_attend.launches``
  and ``kernel_attend_int8.launches`` count kernel launches.

The kernel agrees with the plain version on VALID columns (allclose: the
online softmax and the split reassociate the sum); invalid columns and
idle rows are garbage that every caller discards (the kernel writes
zeros past a row's first max(length, 1) columns).
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


def reference_attend(q, k_flat, v_flat, table, start, k_scales=None, v_scales=None):
    """Plain version: q (b, n, h, d) pre-scaled; flat pools
    (rows * n_pages + 1, page, h*d); table (b, n_pages) int32 global ids;
    start (b,); int8 pools come with their (rows * n_pages + 1, page, h)
    float32 scale pools and are dequantized to q's dtype after the
    gather. Returns (b, n, h, d). The mask rows are the causal pattern's
    rows at each query's position."""
    from .attention import cache_block_attend  # attention imports this module

    b, n = q.shape[:2]
    k_cache = paged_kv.read(k_flat, table, k_scales, q.dtype)
    v_cache = paged_kv.read(v_flat, table, v_scales, q.dtype)
    W = k_cache.shape[1]
    pos = start.long()[:, None] + torch.arange(n, device=q.device)
    allowed = _causal_rows(W, str(q.device))[pos.clamp(max=W - 1)]
    return cache_block_attend(q, k_cache, v_cache, allowed)


def _check(q, k_flat, v_flat, table, start, length, pool_dtype, scales=()):
    """Raise on anything the kernel does not take: every tensor on q's
    device and contiguous, q float32 or bfloat16, pools of
    ``pool_dtype``, int32 descriptors, matching widths; scale pools
    float32 (rows * n_pages + 1, page, h)."""
    b, n, h, d = q.shape
    tensors = (q, k_flat, v_flat, table, start, length, *scales)
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError("kernel_attend: every tensor must be on q's device")
    if q.dtype not in _DTYPE_CODE or k_flat.dtype != pool_dtype or v_flat.dtype != pool_dtype:
        raise TypeError(
            f"kernel_attend takes float32 or bfloat16 q and pools of "
            f"{pool_dtype}, got {q.dtype}, {k_flat.dtype}, {v_flat.dtype}"
        )
    if any(s.dtype != paged_kv.SCALE_DTYPE for s in scales):
        raise TypeError(f"kernel_attend: scale pools must be {paged_kv.SCALE_DTYPE}, got "
                        f"{[s.dtype for s in scales]}")
    if any(t.dtype != torch.int32 for t in (table, start, length)):
        raise TypeError("kernel_attend: table, start and length must be int32")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("kernel_attend: every tensor must be contiguous")
    if k_flat.shape[2] != h * d or v_flat.shape != k_flat.shape:
        raise ValueError(
            f"pool shapes {tuple(k_flat.shape)}, {tuple(v_flat.shape)} do not "
            f"match heads*dim_head {h}*{d}"
        )
    if any(s.shape != (*k_flat.shape[:2], h) for s in scales):
        raise ValueError(
            f"scale pools {[tuple(s.shape) for s in scales]} must be "
            f"{(*k_flat.shape[:2], h)}"
        )
    if table.shape[0] != b or start.shape != (b,) or length.shape != (b,):
        raise ValueError("table, start and length must cover q's batch")


def _run(entry: str, q, pools, table, start, length):
    """Launch ``entry`` of the ragged kernel's library on checked tensors:
    q, the pools (content, then scales for int8), table, start, length;
    returns the output. Raises on a shape the kernel cannot take and on a
    failed launch."""
    from .cuda_build import load_library

    b, n, h, d = q.shape
    page, n_pages = pools[0].shape[1], table.shape[1]
    out = torch.empty_like(q)
    p = ctypes.c_void_p
    err = getattr(load_library("ragged_attention"), entry)(
        *(p(t.data_ptr()) for t in (q, *pools, table, start, length, out)),
        b, n, h, d, page, n_pages, _DTYPE_CODE[q.dtype],
        p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    if err == -1:
        raise ValueError(
            f"the ragged kernel cannot take width {n}, dim_head {d}, page "
            f"{page}, {n_pages} pages a row: it has instances for dim_head "
            "32/64/128, bf16 tensors 16-byte aligned, and tiles (float32: "
            "pages) that fit the card's shared memory per block (see "
            "csrc/ragged_attention.cu)"
        )
    if err != 0:
        raise RuntimeError(f"ragged_attention kernel launch failed: error {err}")
    return out


def kernel_attend(q, k_flat, v_flat, table, start, length,
                  k_scales=None, v_scales=None):
    """Ragged paged attention. q (b, n, h, d) pre-scaled, float32 or
    bfloat16; k_flat/v_flat flat pools (rows * n_pages + 1, page, h*d) of
    q's dtype, or int8 with both float32 scale pools ``k_scales`` /
    ``v_scales`` (rows * n_pages + 1, page, h); table (b, n_pages) int32;
    start, length (b,) int32. Returns (b, n, h, d) in q's dtype. CPU
    tensors run ``reference_attend``; CUDA tensors launch the kernel (the
    int8 instance through ``kernel_attend_int8``)."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("kernel_attend: give both scale pools or neither")
    if k_scales is not None and (k_flat.dtype != torch.int8 or v_flat.dtype != torch.int8):
        raise TypeError(f"scale pools come with int8 pools, got {k_flat.dtype}, {v_flat.dtype}")
    if not q.is_cuda:
        return reference_attend(q, k_flat, v_flat, table, start, k_scales, v_scales)
    if k_scales is not None:
        return kernel_attend_int8(q, k_flat, v_flat, k_scales, v_scales, table, start, length)
    _check(q, k_flat, v_flat, table, start, length, q.dtype)
    out = _run("ragged_attention_fwd", q, (k_flat, v_flat), table, start, length)
    kernel_attend.launches += 1
    return out


def kernel_attend_int8(q, k_flat, v_flat, k_scales, v_scales, table, start, length):
    """The int8 instance of the ragged kernel on CUDA tensors: int8 pools
    with their float32 scale pools, each page dequantized as it is staged
    (``paged_kv.dequant``'s formula, including the cast to q's dtype).
    Raises on anything it does not take; never falls back."""
    _check(q, k_flat, v_flat, table, start, length, torch.int8, (k_scales, v_scales))
    out = _run("ragged_attention_fwd_int8", q, (k_flat, v_flat, k_scales, v_scales),
               table, start, length)
    kernel_attend_int8.launches += 1
    return out


kernel_attend.launches = 0
kernel_attend_int8.launches = 0
