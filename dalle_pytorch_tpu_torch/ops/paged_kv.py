"""Block-paged KV storage (counterpart of ``dalle_pytorch_tpu/ops/paged_kv.py``).

K/V live in fixed-size pages of ``page`` rows, reached through a
per-sequence page table of GLOBAL page ids: entry (b, l) names page ``g``
of the flat pool, ``g = row * n_pages + l`` for the identity mapping, so
a table entry may point into another row's storage.

Storage layout. A pool is kept FLAT, ``(rows * n_pages + 1, page, feat)``:
the global id space the tables index plus one SINK page (id
``rows * n_pages``, always the last) that no table ever names. Masked
writes (columns past a row's ``limit``, positions past capacity) are
redirected to the sink, the counterpart of the reference's scatter
``mode="drop"``; that keeps ``append_`` free of data-dependent shapes, so
it never synchronises the host with the device. ``pool_view`` gives the
reference's ``(rows, n_pages, page, feat)`` view of the real pages.

Storage rows may outnumber the table's rows: the serving prefix cache
appends ARENA rows after the slot rows (``alloc(slots + arena, ...)``,
the sink still last). Arena pages hold shared, read-only prompt pages
and are reached only through remapped table entries; ``reset_rows_`` is
only ever given a slot row. ``copy_pages_`` / ``copy_pages_across_`` move
whole pages between ids (publish into the arena, copy-on-write out of
it, restore into a private cache).

Int8 storage (``kv_policy`` "int8"): content pools hold int8 rows and a
parallel SCALE pool per content pool holds one float32 scale per (token,
head), ``(rows * n_pages + 1, page, heads)``. A scale pool is an ordinary
flat pool with ``feat = heads``, written through the same table, index
and limit as its content pool (one ``append_`` writes them all), so
every function here serves it unchanged and a page's scales always
travel with its bytes.

Functions ending in ``_`` update their first argument in place.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .kv_policy import DEFAULT_PAGE_SIZE

# dtype of the per-(token, head) scales
SCALE_DTYPE = torch.float32


def num_pages(length: int, page_size: int = DEFAULT_PAGE_SIZE) -> int:
    """Pages needed to hold ``length`` tokens (ceil division)."""
    assert page_size > 0, page_size
    return -(-length // page_size)


def alloc(rows: int, n_pages: int, page_size: int, feat: int,
          dtype: torch.dtype, device) -> torch.Tensor:
    """A zeroed flat pool of ``rows * n_pages`` pages plus the sink page."""
    return torch.zeros(
        (rows * n_pages + 1, page_size, feat), dtype=dtype, device=device
    )


def pool_view(flat: torch.Tensor, rows: int) -> torch.Tensor:
    """The (rows, n_pages, page, feat) view of a flat pool's real pages;
    ``rows`` counts every storage row, arena rows included."""
    n_real, page, feat = flat.shape[0] - 1, flat.shape[1], flat.shape[2]
    return flat[:n_real].view(rows, n_real // rows, page, feat)


def storage_rows(flat: torch.Tensor, n_pages: int) -> int:
    """Storage rows of a flat pool of ``n_pages`` pages a row (the slot
    rows plus any arena rows)."""
    return (flat.shape[0] - 1) // n_pages


def identity_table(batch: int, n_pages: int, device) -> torch.Tensor:
    """(batch, n_pages) int32 table mapping logical page i of row r to
    global page ``r * n_pages + i``."""
    r = torch.arange(batch, dtype=torch.int32, device=device)[:, None]
    return r * n_pages + torch.arange(n_pages, dtype=torch.int32, device=device)


def append_(
    pools: Sequence[torch.Tensor],
    table: torch.Tensor,
    index: torch.Tensor,
    rows: Sequence[torch.Tensor],
    limit: Optional[torch.Tensor] = None,
) -> None:
    """Write ``rows[i]`` (b, n, feat_i) into ``pools[i]`` at per-sequence
    positions ``index[b] .. index[b] + n`` through ``table`` (b, n_pages)
    of global ids. The pools share one page geometry (a layer's K, V and
    their scale pools), so the slots are computed once for all of them.
    Row j of sequence b lands in page ``pos // page`` at offset
    ``pos % page``. Out-of-capacity positions, and (with ``limit`` (b,))
    columns j >= limit[b], are dropped into the sink page: a decode row
    commits one position, a prefill chunk its width, an idle row none."""
    page = pools[0].shape[1]
    sink = pools[0].shape[0] - 1
    l_pages = table.shape[1]
    n = rows[0].shape[1]
    j = torch.arange(n, device=table.device)
    pos = index.long()[:, None] + j[None]
    logical = pos // page
    off = pos % page
    phys = table.long().gather(1, logical.clamp(max=l_pages - 1))
    valid = logical < l_pages
    if limit is not None:
        valid = valid & (j[None] < limit.long()[:, None])
    phys = torch.where(valid, phys, sink)
    for flat, r in zip(pools, rows, strict=True):
        flat[phys, off] = r.to(flat.dtype)


def gather(flat: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The logical cache view (b, n_pages * page, feat) assembled through
    a global-id table."""
    b, l_pages = table.shape
    g = flat[table.long()]  # (b, l_pages, page, feat)
    return g.reshape(b, l_pages * flat.shape[1], flat.shape[2])


def read(flat: torch.Tensor, table: torch.Tensor, scales: Optional[torch.Tensor] = None,
         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The logical cache view of one pool (``gather``), dequantized to
    ``dtype`` through its scale pool when it is int8."""
    view = gather(flat, table)
    return view if scales is None else dequant(view, gather(scales, table), dtype)


def quantize_rows(rows: torch.Tensor, heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of K/V rows at append: ``rows``
    (b, n, heads*d) -> (int8 rows (b, n, heads*d), float32 scales
    (b, n, heads)). Each (token, head) owns its scale amax/127 (an
    all-zero one gets 1); values round half to even and clip to +-127.
    Re-appending the same rows (a preempted request's replay) writes the
    same bytes and scales."""
    b, n, hd = rows.shape
    d = hd // heads
    assert heads * d == hd, (rows.shape, heads)
    r = rows.float().reshape(b, n, heads, d)
    amax = r.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax)).to(SCALE_DTYPE)
    q = torch.round(r / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q.reshape(b, n, hd), scale


def dequant(view: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """THE dequantization formula, which the int8 ragged kernel applies
    per page: an int8 (b, W, h*d) view widened to float32, times its
    float32 (b, W, h) scales, then cast to the compute ``dtype``."""
    b, W, hd = view.shape
    h = scales.shape[-1]
    x = view.float().reshape(b, W, h, hd // h) * scales.float()[..., None]
    return x.reshape(b, W, hd).to(dtype)


def reset_rows_(flat: torch.Tensor, n_pages: int, row: int) -> None:
    """Zero storage row ``row``'s native pages (the eviction reset: stale
    K/V must not reach the slot's next tenant)."""
    flat[row * n_pages:(row + 1) * n_pages].zero_()


def reset_table_rows_(table: torch.Tensor, row: int) -> None:
    """Restore the identity mapping for one batch row of a page table."""
    n_p = table.shape[1]
    table[row] = row * n_p + torch.arange(
        n_p, dtype=table.dtype, device=table.device
    )


def copy_pages_across_(dst: torch.Tensor, src: torch.Tensor, src_ids, dst_ids,
                       valid=None) -> None:
    """Copy whole pages ``src_ids`` (global ids of ``src``) onto pages
    ``dst_ids`` of ``dst``, both flat pools of one geometry, in place;
    rows at or past ``valid[i]`` (per-page row counts; None = all) are
    written as zeros, so a published terminal page carries no decode
    rows and a copied-on-write page none of its destination's old
    content. Id lists are Python ints or 1-D tensors on any device."""
    dev = dst.device
    s_ids = torch.as_tensor(src_ids, dtype=torch.long).to(dev)
    d_ids = torch.as_tensor(dst_ids, dtype=torch.long).to(dev)
    content = src[s_ids]
    if valid is not None:
        rows = torch.arange(src.shape[1], device=dev)[None]
        keep = rows < torch.as_tensor(valid, dtype=torch.long).to(dev)[:, None]
        content = torch.where(keep[..., None], content, torch.zeros((), dtype=content.dtype,
                                                                    device=dev))
    dst[d_ids] = content


def copy_pages_(flat: torch.Tensor, src_ids, dst_ids, valid=None) -> None:
    """``copy_pages_across_`` within one pool."""
    copy_pages_across_(flat, flat, src_ids, dst_ids, valid)
