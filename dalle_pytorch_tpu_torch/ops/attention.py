"""Attention for the "full" pattern (counterpart of
``dalle_pytorch_tpu/ops/attention.py``'s ``PatternAttention``), in two
forms:

- decode: causal attention over the block-paged cache for the fused
  serving iteration (``decode=True`` with ``block_len`` set, i.e.
  ``_paged_caches`` + ``_decode_attend_paged``);
- full sequence (the non-decode branch): causal or not, with an optional
  (b, n) key mask and rotary table. Shapes JAX runs through its packed
  kernel (``_flash_block(n) == n`` and ``fused_qkv_supported``) run the
  ``FusedQKVAttention`` autograd function: the packed forward kernel,
  and the packed backward kernel when autograd records (under
  ``no_grad`` it is the forward alone); shapes with no flash block
  run the dense masked softmax; the shapes between, which JAX sends to
  its tiled ``flash_attention``, raise (not ported).

The other patterns, the flat/4-D caches, key masks in decode and int8
pages raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from . import paged_kv, ragged_attention
from .flash_attention import (
    FusedQKVAttention,
    fused_qkv_supported,
    may_attend,
)
from .rotary import apply_rotary_emb, rotate_half

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def flash_block(n: int) -> int:
    """JAX's flash block for a sequence of n: the largest of 1280, 1024,
    640, 512, 384, 256, 128 that divides n, else 0."""
    for b in (1280, 1024, 640, 512, 384, 256, 128):
        if n % b == 0:
            return b
    return 0


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


def full_attend(qkv, heads: int, dim_head: int, mask=None,
                causal: bool = True, rotary=None):
    """Attention over a whole sequence from the packed projection qkv
    (b, n, 3*h*d); ``mask`` (b, >= n) bool key mask, ``rotary`` the
    (cos, sin) pair of ``rotary.rot_tables`` (>= n rows, zero angles past
    the table rotate nothing). Returns (b, n, h*d). The packed kernel takes the
    unscaled q with ``sm_scale = d**-0.5`` (a fully masked row gives 0);
    the dense path pre-scales q and runs a plain softmax (a fully masked
    row is uniform over its keys), as JAX's two paths do."""
    b, n, _ = qkv.shape
    h, d = heads, dim_head
    key_mask = None if mask is None else mask[:, :n]
    if flash_block(n) == n and fused_qkv_supported(n, h, d):
        o, _ = FusedQKVAttention.apply(qkv.contiguous(), key_mask, h, d,
                                       causal, None, rotary, d**-0.5)
        return o
    if flash_block(n) > 0:
        raise NotImplementedError(
            f"n={n}, heads={h}, dim_head={d} takes JAX's tiled flash "
            "attention, which is not ported"
        )
    q, k, v = (t.reshape(b, n, h, d) for t in qkv.chunk(3, dim=-1))
    if rotary is not None:
        cos, sin = (t[:n, None] for t in rotary)  # (n, 1, d) over (b, n, h, d)
        q, k, v = (t * cos + rotate_half(t) * sin for t in (q, k, v))
    allowed = may_attend(n, qkv.device, key_mask, causal)[:, 0].expand(b, n, n)
    out = cache_block_attend(q * d**-0.5, k.reshape(b, n, h * d),
                             v.reshape(b, n, h * d), allowed)
    return out.reshape(b, n, h * d)


class Attention(nn.Module):
    """Multi-head "full" attention: the qkv projection (columns
    ``[q | k | v]``, each (h, d)-major), the attention core, and the
    output projection. With a paged cache (``kv``) it is the causal decode
    form: rotary on q, k and v at each token's position, the q * d**-0.5
    pre-scale, the masked page append, and the ragged attention core
    (``ragged_attention.kernel_attend``). Without one it attends over the
    whole sequence (``full_attend``)."""

    def __init__(self, dim: int, seq_len: int, heads: int = 8,
                 dim_head: int = 64, attn_type: str = "full",
                 causal: bool = True, dropout: float = 0.0, device=None,
                 dtype=torch.float32):
        super().__init__()
        if dropout > 0:
            raise NotImplementedError(f"attention dropout {dropout} is not ported")
        if attn_type != "full":
            raise NotImplementedError(
                f"only 'full' attention is ported, got attn_type={attn_type!r}"
            )
        self.seq_len = seq_len
        self.causal = causal
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False, device=device,
                                dtype=dtype)
        self.to_out = nn.Linear(inner, dim, device=device, dtype=dtype)

    def forward(self, x, kv: Optional[PagedKV] = None, rotary=None,
                block_len=None, block_start=None, mask=None):
        """Decode form (``kv`` given): x (b, n, dim), row b's valid tokens
        are columns [0, block_len[b]) at positions block_start[b] + j;
        writes their K/V into ``kv`` and advances its index for rows with
        block_len > 0; ``rotary`` is the angle table. Full-sequence form
        (no ``kv``): ``mask`` is the optional (b, n) key mask, ``rotary``
        the (cos, sin) pair of ``rotary.rot_tables``."""
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        if kv is None:
            out = full_attend(self.to_qkv(x), h, d, mask, self.causal, rotary)
            return self.to_out(out)
        if not self.causal or mask is not None:
            raise NotImplementedError(
                "the paged decode form is causal and takes no key mask"
            )
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
