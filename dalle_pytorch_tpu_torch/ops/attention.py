"""Paged causal attention for the fused serving iteration (counterpart of
the ragged branch of ``dalle_pytorch_tpu/ops/attention.py``:
``PatternAttention`` with ``decode=True`` and ``block_len`` set, i.e.
``_paged_caches`` + ``_decode_attend_paged``).

Only the causal "full" pattern over the paged cache is ported; the other
patterns, the flat/4-D caches, key-padding masks and int8 pages raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from . import paged_kv, ragged_attention
from .rotary import apply_rotary_emb

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


@dataclass
class PagedKV:
    """One attention layer's paged cache: flat K/V pools
    (rows * n_pages + 1, page, h*d) (see ``paged_kv``), the (b, n_pages)
    int32 page table of global ids, and the per-sequence (b,) int32 write
    index."""

    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    index: torch.Tensor


def cache_block_attend(q, k_cache, v_cache, allowed):
    """Masked attention of an n-token query block against a W-row cache
    view: q (b, n, h, d) pre-scaled, k_cache/v_cache (b, W, h*d),
    ``allowed`` (b, n, W) bool. Scores and softmax in float32; the
    probabilities are cast to v's dtype before the value product."""
    b, n, h, d = q.shape
    W = k_cache.shape[1]
    k = k_cache.reshape(b, W, h, d)
    v = v_cache.reshape(b, W, h, d)
    scores = torch.einsum("bnhd,blhd->bhnl", q.float(), k.float())
    scores = scores.masked_fill(~allowed[:, None], NEG_INF)
    attn = scores.softmax(dim=-1)
    return torch.einsum("bhnl,blhd->bnhd", attn.to(v.dtype), v)


class Attention(nn.Module):
    """Multi-head causal attention over the block-paged cache: the qkv
    projection (columns ``[q | k | v]``, each (h, d)-major), rotary on
    q, k and v at each token's position, the q * d**-0.5 pre-scale, the
    masked page append, and the ragged attention core
    (``ragged_attention.kernel_attend``)."""

    def __init__(self, dim: int, seq_len: int, heads: int = 8,
                 dim_head: int = 64, attn_type: str = "full",
                 causal: bool = True, device=None, dtype=torch.float32):
        super().__init__()
        if attn_type != "full" or not causal:
            raise NotImplementedError(
                f"only causal 'full' attention is ported, got "
                f"attn_type={attn_type!r}, causal={causal}"
            )
        self.seq_len = seq_len
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False, device=device,
                                dtype=dtype)
        self.to_out = nn.Linear(inner, dim, device=device, dtype=dtype)

    def forward(self, x, kv: PagedKV, rotary, block_len, block_start):
        """x (b, n, dim): row b's valid tokens are columns [0, block_len[b])
        at positions block_start[b] + j. Writes their K/V into ``kv`` and
        advances its index for rows with block_len > 0."""
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        q, k, v = (
            t.reshape(b, n, h, d) for t in self.to_qkv(x).chunk(3, dim=-1)
        )
        idx = block_start
        if rotary is not None:
            pos = idx.long()[:, None] + torch.arange(n, device=x.device)
            rows = rotary[pos.clamp(max=rotary.shape[0] - 1)][:, :, None]
            q, k, v = (apply_rotary_emb(rows, t) for t in (q, k, v))
        q = q * d**-0.5

        paged_kv.append_(kv.k, kv.table, idx, k.reshape(b, n, h * d),
                         limit=block_len)
        paged_kv.append_(kv.v, kv.table, idx, v.reshape(b, n, h * d),
                         limit=block_len)
        kv.index = torch.where(block_len > 0, idx + block_len, kv.index)
        out = ragged_attention.kernel_attend(
            q.contiguous(), kv.k, kv.v, kv.table, idx, block_len
        )
        return self.to_out(out.reshape(b, n, h * d))
