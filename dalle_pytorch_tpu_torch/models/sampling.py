"""Decode cache, token sampling and generation (counterpart of
``dalle_pytorch_tpu/models/sampling.py`` and the sampling ops of the
serving engine).

The cache is explicit per-layer state in one of three formats
(``ops/kv_policy.py``): "paged", each attention layer's paged K/V pools
(int8 with their scale pools under ``kv_quant="int8"``), page table and
per-row write index (``ops.attention.PagedKV``); "flat" or "4d", each
layer's contiguous K/V buffers with one scalar write index
(``ops.attention.DenseKV``). With token shift the cache also holds the
attention- and feed-forward-side shift rings with their per-row indices
(``ops.layers.ShiftRing``). The paged indices are per row from the start
(``set_decode_offsets`` only sets them), so rows at different positions
share one engine step. ``insert_decode_cache`` lands a batch-1 cache in
one row of a batched one (the split engine's admission) and
``merge_decode_caches`` stacks caches.

Generation outside the engine: ``decode_tokens`` runs ``DALLE.prefill_step``
over a prompt block, then one ``DALLE.decode_step`` per position,
teacher-forced below ``known_len``, segmented by cache window as JAX's
scan is; ``generate_image_tokens``, ``generate_images`` (VAE decode and
optional CLIP scores) and ``generate_texts`` (tokens only: no tokenizer)
build on it.

Sampling keeps the reference's (seed, position) contract within the port:
the token a request draws at internal position p depends only on its
seed and p. The reference draws with threefry ``fold_in(key(seed), p)``,
whose bits cannot be reproduced here; the port draws Gumbel-max noise
from a counter-based 32-bit hash of (seed, p, vocab index), computed on
the device with integer tensor ops. Outputs therefore match the
reference only where the draw does not depend on the noise (top-k with
k = 1), which is how the tests pin tokens.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from ..ops import kv_policy, paged_kv
from ..ops.attention import DenseKV, PagedKV
from ..ops.layers import ShiftRing
from .dalle import top_k_filter

# the segmented decode's window growth (JAX's default for every
# configuration the port takes; 0 disables segmentation)
DEFAULT_WINDOW_SEG = 512


@dataclass
class DecodeCache:
    """``kv`` one entry per layer, ``PagedKV`` for the "paged" format
    (``n_pages`` pages a row) or ``DenseKV`` for "flat" / "4d"
    (``n_pages`` 0)."""

    kv: List[Union[PagedKV, DenseKV]]
    attn_rings: Optional[List[ShiftRing]]
    ff_rings: Optional[List[ShiftRing]]
    n_pages: int

    def set_window(self, width: int) -> None:
        """Sweep extent of every dense layer (the segmented decode's
        window); the paged format's kernel already stops at each row's
        frontier, so it has none."""
        for kv in self.kv:
            if isinstance(kv, DenseKV):
                kv.width = width

    def reset_row_(self, row: int) -> None:
        """Return one row to pristine: pools (scale pools included)
        zeroed, table to identity, indices and rings zeroed."""
        for kv in self.kv:
            for pool in kv.pools():
                paged_kv.reset_rows_(pool, self.n_pages, row)
            paged_kv.reset_table_rows_(kv.table, row)
            kv.index[row] = 0
        for ring in (self.attn_rings or []) + (self.ff_rings or []):
            ring.hist[row] = 0
            ring.index[row] = 0


def init_decode_cache(dalle, batch_size: int, cache_format: Optional[str] = None,
                      kv_quant: Optional[str] = None,
                      page_size: Optional[int] = None,
                      arena_rows: int = 0) -> DecodeCache:
    """Zeroed decode cache for ``batch_size`` rows on the model's device,
    every row at position 0. ``cache_format`` (``kv_policy.FORMATS``;
    None = ``kv_policy.choose_cache_format(batch_size)``): "paged" pools
    with identity tables, or the "flat" / "4d" dense buffers. ``kv_quant``
    (``kv_policy.QUANTS``; None = "none"): "int8" allocates int8 K/V pools
    and their float32 (rows * n_pages + 1, page, heads) scale pools; paged
    only. ``page_size`` (paged only): rows a page. ``arena_rows`` (paged
    only): storage rows appended after the ``batch_size`` slot rows of
    every pool (the serving prefix cache's arena, ``ops/paged_kv.py``);
    tables, indices and rings stay ``batch_size`` rows. The shift rings
    hold ``image_fmap_size + 1 + dalle.shift_pad`` rows (the speculative
    engine's rollback slack, ``serving.engine.spec_model``)."""
    int8 = kv_policy.resolve_quant(kv_quant) == "int8"
    fmt = kv_policy.resolve_format(cache_format, batch_size)
    if int8 and fmt != "paged":
        raise ValueError(f"int8 KV storage needs the paged format, not {fmt!r}")
    tr = dalle.transformer
    device, dtype = dalle.device, dalle.dtype
    hd = dalle.heads * dalle.dim_head
    if arena_rows and fmt != "paged":
        raise ValueError(f"arena rows need the paged format, not {fmt!r}")
    if fmt == "paged":
        kv, n_p = _paged_layers(dalle, batch_size, int8, kv_policy.page_size(page_size),
                                arena_rows)
    else:
        shape = (batch_size, tr.attn_seq_len, hd)
        kv, n_p = [DenseKV(torch.zeros(shape, dtype=dtype, device=device),
                           torch.zeros(shape, dtype=dtype, device=device), fmt, dalle.heads)
                   for _ in range(dalle.depth)], 0
    rings = None, None
    if tr.shift_tokens:
        R = dalle.image_fmap_size + 1 + dalle.shift_pad
        rings = tuple(
            [
                ShiftRing(
                    hist=torch.zeros((batch_size, R, dalle.dim), dtype=dtype,
                                     device=device),
                    index=_zeros_index(batch_size, device),
                )
                for _ in range(dalle.depth)
            ]
            for _ in range(2)
        )
    return DecodeCache(kv, rings[0], rings[1], n_p)


def _zeros_index(batch_size: int, device) -> torch.Tensor:
    return torch.zeros((batch_size,), dtype=torch.int32, device=device)


def _paged_layers(dalle, batch_size: int, int8: bool, page: int, arena_rows: int = 0):
    """(every layer's zeroed ``PagedKV``, pages a row); the pools hold
    ``arena_rows`` storage rows after the slot rows."""
    device, dtype = dalle.device, dalle.dtype
    n_p = paged_kv.num_pages(dalle.transformer.attn_seq_len, page)
    hd = dalle.heads * dalle.dim_head

    def pool(feat, pool_dtype):
        return paged_kv.alloc(batch_size + arena_rows, n_p, page, feat, pool_dtype, device)

    def scales():
        return pool(dalle.heads, paged_kv.SCALE_DTYPE) if int8 else None

    kv = [
        PagedKV(
            k=pool(hd, torch.int8 if int8 else dtype),
            v=pool(hd, torch.int8 if int8 else dtype),
            table=paged_kv.identity_table(batch_size, n_p, device),
            index=_zeros_index(batch_size, device),
            k_scale=scales(),
            v_scale=scales(),
        )
        for _ in range(dalle.depth)
    ]
    return kv, n_p


def _paged_only(cache: DecodeCache, what: str) -> None:
    if not all(isinstance(kv, PagedKV) for kv in cache.kv):
        raise ValueError(f"{what} needs the paged cache format "
                         '(init_decode_cache(..., cache_format="paged"))')


def _rows(cache: DecodeCache) -> int:
    return cache.kv[0].table.shape[0]


def set_decode_offsets(cache: DecodeCache, offsets: torch.Tensor) -> DecodeCache:
    """Place each row of a paged cache at its own position ``offsets``
    (b,): every layer's write index and every shift ring's index, in
    place; returns the cache. The caller owns the contents: each row must
    hold exactly its positions below its offset. The port's indices are
    per row from the start (``init_decode_cache``), so unlike the
    reference's this converts nothing; it only sets them."""
    _paged_only(cache, "set_decode_offsets")
    if offsets.shape != (_rows(cache),):
        raise ValueError(f"offsets of shape {tuple(offsets.shape)} for a cache of "
                         f"{_rows(cache)} rows")
    for holder in [*cache.kv, *(cache.attn_rings or []), *(cache.ff_rings or [])]:
        holder.index = offsets.to(device=holder.index.device, dtype=torch.int32).clone()
    return cache


def merge_decode_caches(caches: List[DecodeCache]) -> DecodeCache:
    """Stack paged caches (each at its own offsets, any rows) into one
    batched cache, row order preserved: pools' real pages concatenated
    (one sink page after them), tables rebased to the merged pool's
    global ids (a cache landing at row offset r shifts its ids by
    r * n_pages), indices and rings concatenated."""
    for c in caches:
        _paged_only(c, "merge_decode_caches")
    n_p = caches[0].n_pages
    if any(c.n_pages != n_p for c in caches):
        raise ValueError("merge_decode_caches: caches of different page counts")
    offsets = np.cumsum([0] + [_rows(c) for c in caches])[:-1]
    cat = lambda ts: torch.cat(list(ts))  # noqa: E731

    def pool(pools):
        real = [paged_kv.pool_view(t, _rows(c)).flatten(0, 1) for t, c in zip(pools, caches)]
        return torch.cat(real + [torch.zeros_like(pools[0][-1:])])

    kv = []
    for layer in zip(*(c.kv for c in caches)):
        scaled = layer[0].k_scale is not None
        kv.append(PagedKV(
            k=pool([x.k for x in layer]), v=pool([x.v for x in layer]),
            table=cat(x.table + int(o) * n_p for x, o in zip(layer, offsets)),
            index=cat(x.index for x in layer),
            k_scale=pool([x.k_scale for x in layer]) if scaled else None,
            v_scale=pool([x.v_scale for x in layer]) if scaled else None,
        ))

    def rings(side):
        if getattr(caches[0], side) is None:
            return None
        return [ShiftRing(hist=cat(r.hist for r in layer), index=cat(r.index for r in layer))
                for layer in zip(*(getattr(c, side) for c in caches))]

    return DecodeCache(kv, rings("attn_rings"), rings("ff_rings"), n_p)


def insert_decode_cache(batched: DecodeCache, sub: DecodeCache, slot: int) -> DecodeCache:
    """Land a batch-1 paged cache in row ``slot`` of a batched one, in
    place (the serving engine's admission of a prefilled request): every
    pool's row pages (K, V and, for int8 pages, their scale pools), the
    table row rebased to the slot's global ids, the write index, and both
    shift rings' history and index. The row's previous tenant is
    overwritten entirely. Returns ``batched``."""
    _paged_only(batched, "insert_decode_cache")
    _paged_only(sub, "insert_decode_cache")
    if _rows(sub) != 1 or sub.n_pages != batched.n_pages:
        raise ValueError("insert_decode_cache takes a batch-1 cache of the batched "
                         "cache's page count")
    n_p = batched.n_pages
    for b_kv, s_kv in zip(batched.kv, sub.kv, strict=True):
        for b_pool, s_pool in zip(b_kv.pools(), s_kv.pools(), strict=True):
            rows = paged_kv.storage_rows(b_pool, n_p)
            paged_kv.pool_view(b_pool, rows)[slot] = paged_kv.pool_view(s_pool, 1)[0]
        b_kv.table[slot] = s_kv.table[0] + slot * n_p
        b_kv.index[slot] = s_kv.index[0]
    for side in ("attn_rings", "ff_rings"):
        for b_ring, s_ring in zip(getattr(batched, side) or [], getattr(sub, side) or [],
                                  strict=True):
            b_ring.hist[slot] = s_ring.hist[0]
            b_ring.index[slot] = s_ring.index[0]
    return batched


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (bijective on [0, 2**32)) held in int64; each
    product stays below 2**63."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, positions: torch.Tensor,
                 n: int) -> torch.Tensor:
    """(b, n) float32 Gumbel noise; entry (r, c) is a pure function of
    (seeds[r], positions[r], c)."""
    seeds = seeds.long()
    h = _mix32((seeds & _M32) ^ _mix32((seeds >> 32) & _M32))
    h = _mix32(h ^ (positions.long() & _M32))[:, None]
    col = torch.arange(n, device=seeds.device, dtype=torch.int64)[None]
    u = (_mix32(h ^ col).double() + 0.5) / 2.0**32  # in (0, 1)
    return (-(-u.log()).log()).float()


def sample(logits: torch.Tensor, seeds: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """Gumbel-max draw per row: argmax(logits + noise(seed, position)).
    (b,) int32."""
    noise = gumbel_noise(seeds, positions, logits.shape[-1])
    return (logits.float() + noise).argmax(dim=-1).to(torch.int32)


@torch.no_grad()
def decode_tokens(dalle, tokens: torch.Tensor, known_len: int, seed: int,
                  filter_thres: float = 0.5, temperature: float = 1.0, mask=None,
                  num_steps: Optional[int] = None, prefill_len: int = 0,
                  window_seg: Optional[int] = None, cache_format: Optional[str] = None,
                  fused_decode: Optional[bool] = None, kv_quant: Optional[str] = None,
                  page_size: Optional[int] = None) -> torch.Tensor:
    """Fill the internal token buffer: tokens (b, n_internal) int32 on the
    model's device, position 0 <bos>; the first ``known_len`` positions
    are given (teacher-forced), the rest are drawn. Consumes ``num_steps``
    (default n_internal - 1) positions and returns the completed buffer (a
    copy). Text positions hold remapped text ids, image positions image
    ids.

    ``prefill_len`` > 1: that many leading positions (given ones, at most
    text_len_internal) in one ``DALLE.prefill_step``; at text_len_internal
    every later draw is an image token, so the head is the image vocab's
    and top-k keeps the full vocabulary's k. Each draw: ``top_k_filter``,
    / temperature, then ``sample`` with row r's seed ``seed + r`` at the
    drawn token's position (the serving engine's (seed, position) draw).

    ``window_seg`` (default ``DEFAULT_WINDOW_SEG``; 0 = off): the steps
    run in segments ending at multiples of it, each over a dense cache's
    rows [0, min(L, ceil128(end))) (``DecodeCache.set_window``) as JAX's
    segmented scan resizes its caches. ``fused_decode`` chooses the dense
    caches' decode route (``DALLE.decode_step``): by default the fused
    decode kernel on the card, at any window, and the unfused chain on
    the CPU; True on the CPU takes the kernel only where the extent is
    the whole cache, as in JAX. ``cache_format``, ``kv_quant``,
    ``page_size``: as in ``init_decode_cache``."""
    b, n_internal = tokens.shape
    steps = n_internal - 1 if num_steps is None else num_steps
    seg = DEFAULT_WINDOW_SEG if window_seg is None else window_seg
    if seg < 0:
        raise ValueError(f"window_seg must be >= 0 (0 disables segmentation), got {seg}")
    T, ext = dalle.text_len_internal, dalle.num_text_tokens_ext
    if not 0 <= prefill_len <= min(known_len, T):
        raise ValueError(f"prefill_len {prefill_len} must cover given text positions only "
                         f"(known_len {known_len}, text_len_internal {T})")
    tokens = tokens.clone()
    dev = tokens.device
    cache = init_decode_cache(dalle, b, cache_format, kv_quant, page_size)
    image_only = prefill_len == T
    k_full = max(int((1 - filter_thres) * dalle.total_tokens), 1)
    seeds = seed + torch.arange(b, device=dev)

    def draw(logits, i: int) -> None:
        """The token at position i + 1 from position i's logits, unless
        it is given."""
        nxt = i + 1
        if nxt < known_len:
            return
        filtered = (top_k_filter(logits, k=k_full) if image_only
                    else top_k_filter(logits, thres=filter_thres))
        token = sample(filtered / temperature, seeds, torch.full((b,), nxt, device=dev))
        if not image_only and nxt >= T:
            token = token - ext
        tokens[:, nxt] = token

    start = 0
    if prefill_len > 1:
        draw(dalle.prefill_step(tokens[:, :prefill_len], cache, mask, image_only=image_only),
             prefill_len - 1)
        start = prefill_len
    n_cache = dalle.transformer.attn_seq_len
    s = start
    while s < steps:
        e = min(steps, (s // seg + 1) * seg) if seg else steps
        if seg:
            cache.set_window(min(n_cache, -(-e // 128) * 128))
        for i in range(s, e):
            draw(dalle.decode_step(tokens[:, i], i, cache, mask, image_only=image_only,
                                   fused_decode=fused_decode), i)
        s = e
    return tokens


def generate_image_tokens(dalle, text: torch.Tensor, seed: int, *, filter_thres: float = 0.5,
                          temperature: float = 1.0, prime_tokens=None, mask=None,
                          **decode_kw) -> torch.Tensor:
    """text (b, text_seq_len) raw ids -> drawn image token ids
    (b, image_seq_len) int32: the whole prompt prefilled, then one decode
    step a position. ``prime_tokens`` (b, p < image_seq_len): the image's
    first p tokens, given. ``decode_kw``: ``decode_tokens``' window_seg,
    cache_format, fused_decode, kv_quant, page_size."""
    dev = dalle.device
    b = text.shape[0]
    T = dalle.text_len_internal
    tokens = torch.zeros((b, T + dalle.image_seq_len), dtype=torch.int32, device=dev)
    tokens[:, :T] = dalle.remap_text(text[:, :dalle.text_seq_len].to(dev))
    known_len = T
    if prime_tokens is not None:
        p = prime_tokens.shape[1]
        if p >= dalle.image_seq_len:
            raise ValueError(f"number of priming image tokens ({p}) must be < image_seq_len")
        tokens[:, T:T + p] = prime_tokens.to(dev)
        known_len += p
    tokens = decode_tokens(dalle, tokens, known_len, seed, filter_thres, temperature, mask,
                           prefill_len=T, **decode_kw)
    return tokens[:, T:]


@torch.no_grad()
def generate_images(dalle, vae, text: torch.Tensor, seed: int, *, clip=None, mask=None,
                    filter_thres: float = 0.5, temperature: float = 1.0, img=None,
                    num_init_img_tokens: Optional[int] = None, **decode_kw):
    """Text -> pixels (the reference's generate_images): with ``img``
    (b, H, W, C) the VAE's first ``int(0.4375 * image_seq_len)`` tokens
    (or ``num_init_img_tokens``) prime the image, then
    ``generate_image_tokens``, then the VAE decode to (b, H, W, C) pixels
    as the VAE gives them (a ``DiscreteVAE``'s normalized space, the
    pretrained VAEs' [0, 1]: ``denormalize(pixels, vae.normalization)``
    displays either); with ``clip`` also the CLIP scores of (text,
    images), returned as (images, scores)."""
    text = text[:, :dalle.text_seq_len]
    prime = None
    if img is not None:
        indices = vae.get_codebook_indices(img)
        n_prime = (int(0.4375 * dalle.image_seq_len) if num_init_img_tokens is None
                   else num_init_img_tokens)
        prime = indices[:, :n_prime]
    image_tokens = generate_image_tokens(dalle, text, seed, filter_thres=filter_thres,
                                         temperature=temperature, prime_tokens=prime,
                                         mask=mask, **decode_kw)
    images = vae.decode(image_tokens)
    if clip is None:
        return images
    return images, clip(text.to(images.device), images)


def generate_texts(dalle, seed: int, prompt_tokens=None, *, filter_thres: float = 0.5,
                   temperature: float = 1.0, **decode_kw) -> torch.Tensor:
    """Text completion (the reference's generate_texts, without its
    tokenizer): from <bos> (or ``prompt_tokens`` (b, p), remapped ids with
    <bos> first) out to text_seq_len tokens. Returns (b, text_seq_len)
    int32 ids."""
    dev = dalle.device
    if prompt_tokens is None:
        prompt_tokens = torch.zeros((1, 1), dtype=torch.int32)
    b, p = prompt_tokens.shape
    tokens = torch.zeros((b, dalle.text_len_internal + dalle.image_seq_len),
                         dtype=torch.int32, device=dev)
    tokens[:, :p] = prompt_tokens.to(dev)
    tokens = decode_tokens(dalle, tokens, p, seed, filter_thres, temperature,
                           num_steps=dalle.text_seq_len - 1, **decode_kw)
    return tokens[:, :dalle.text_seq_len]
