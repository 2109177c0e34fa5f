"""Decode cache and token sampling (counterpart of the cache part of
``dalle_pytorch_tpu/models/sampling.py`` and the sampling ops of the
serving engine).

The cache is explicit per-layer state: each attention layer's paged K/V
pools (int8 with their scale pools under ``kv_quant="int8"``), page
table and write index (``ops.attention.PagedKV``), and, with
token shift, the attention- and feed-forward-side shift rings with their
indices (``ops.layers.ShiftRing``). Every index is per row from the
start (the reference's ``set_decode_offsets`` has nothing to convert),
so rows at different positions share one step.

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
from typing import List, Optional

import torch

from ..ops import kv_policy, paged_kv
from ..ops.attention import PagedKV
from ..ops.layers import ShiftRing


@dataclass
class DecodeCache:
    kv: List[PagedKV]
    attn_rings: Optional[List[ShiftRing]]
    ff_rings: Optional[List[ShiftRing]]
    n_pages: int

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


def init_decode_cache(dalle, batch_size: int, page_size: Optional[int] = None,
                      kv_quant: Optional[str] = None) -> DecodeCache:
    """Zeroed paged decode cache for ``batch_size`` rows on the model's
    device, every row at position 0 (identity tables). ``kv_quant``
    (``kv_policy.QUANTS``; None = "none"): "int8" allocates int8 K/V pools
    and their float32 (rows * n_pages + 1, page, heads) scale pools."""
    page = kv_policy.page_size(page_size)
    int8 = kv_policy.resolve_quant(kv_quant) == "int8"
    tr = dalle.transformer
    device, dtype = dalle.device, dalle.dtype
    n_p = paged_kv.num_pages(tr.attn_seq_len, page)
    hd = dalle.heads * dalle.dim_head

    def zeros_index():
        return torch.zeros((batch_size,), dtype=torch.int32, device=device)

    def pool(feat, pool_dtype):
        return paged_kv.alloc(batch_size, n_p, page, feat, pool_dtype, device)

    def scales():
        return pool(dalle.heads, paged_kv.SCALE_DTYPE) if int8 else None

    kv = [
        PagedKV(
            k=pool(hd, torch.int8 if int8 else dtype),
            v=pool(hd, torch.int8 if int8 else dtype),
            table=paged_kv.identity_table(batch_size, n_p, device),
            index=zeros_index(),
            k_scale=scales(),
            v_scale=scales(),
        )
        for _ in range(dalle.depth)
    ]
    rings = None, None
    if tr.shift_tokens:
        R = dalle.image_fmap_size + 1
        rings = tuple(
            [
                ShiftRing(
                    hist=torch.zeros((batch_size, R, dalle.dim), dtype=dtype,
                                     device=device),
                    index=zeros_index(),
                )
                for _ in range(dalle.depth)
            ]
            for _ in range(2)
        )
    return DecodeCache(kv, rings[0], rings[1], n_p)


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
