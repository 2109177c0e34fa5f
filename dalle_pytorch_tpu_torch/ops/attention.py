"""Attention (counterpart of ``dalle_pytorch_tpu/ops/attention.py``'s
``PatternAttention``) for the patterns "full", "axial_row", "axial_col",
"conv_like" and "sparse", each defined by a static may-attend mask
(``Attention.pattern_mask``, built from ``ops/masks.py``), in two forms:

- decode over the block-paged cache (``PagedKV``): one ragged block,
  row b's tokens at its own positions (the fused serving iteration, and
  generation on the "paged" format), K/V appended in the compute dtype
  or quantized to int8 pages with per-(token, head) scales. A causal
  "full" layer without a key mask runs the ragged kernel
  (``ragged_attention.kernel_attend``, its int8 instance for int8
  pages); every other layer attends over the gathered (and dequantized)
  cache view with the pattern's rows at each query position and the key
  mask (``Attention._gathered_attend``);
- decode over the dense cache (``DenseKV``, the "flat" and "4d"
  formats): a block of n >= 1 tokens, the whole batch at one position
  (``Attention._decode_dense``, JAX's ``_decode_attend``): rotary rows at
  the write index, the q * d**-0.5 pre-scale, the rows written, the
  pattern's rows over the sweep extent W ANDed with the key mask, then
  ``cache_block_attend``. The fused path (JAX's ``_decode_attend_fused``)
  is the kernel (``decode_attention.fused_decode_attention``), which
  attends and returns the rotated k/v rows, written at the index after
  the call. ``fused_decode`` chooses between the two: False the unfused
  chain; None (the default) the kernel on a CUDA device, the unfused
  chain on the CPU (JAX's default); True or None on the card the
  kernel wherever ``decode_kernel_route`` allows it (one token, a causal
  "full" layer, ``fused_decode_supported`` heads; any window, since the
  kernel reads only the rows [0, idx)); True on the CPU JAX's gate
  (``Attention.fused_decode_gate``: the same, and a sweep extent of the
  whole cache), so the CPU parity tests keep JAX's route;
- full sequence (the non-decode branch), with an optional (b, n) key
  mask and rotary table, dispatched as JAX dispatches on the TPU, the
  same on the CPU and on the card:
  1. a non-"full" pattern whose 128-block layout visits at most
     ``ENGAGE_FRAC`` of the dense-causal block pairs (``sparse_block(n)``
     > 0) runs ``BlockSparseAttention`` on split, rotated heads;
  2. otherwise, shapes JAX runs through its packed kernel
     (``flash_block(n) == n`` and ``fused_qkv_supported``) run
     ``FusedQKVAttention`` with the pattern as its mask operand (none for
     "full");
  3. every other shape with a flash block (``flash_block(n) > 0``), which
     JAX sends to its tiled ``flash_attention``, runs ``FlashAttention``
     on split, rotated heads with the pattern as its mask operand: a
     one-block grid (``flash_block(n) == n``, heads the packed kernel
     refuses) backward through the single-block kernel, a tiled grid
     through dq then dk/dv (``full_route`` names the choice);
  4. shapes with no flash block run the dense masked softmax over the
     pattern and the key mask.
  On a CUDA tensor the autograd functions launch the kernels, on a CPU
  tensor their plain versions. JAX's grouped axial/conv forms compute the
  dense form's function with fewer operations; the port uses the dense
  form where JAX would take them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from . import masks as masks_lib
from . import paged_kv, ragged_attention
from .block_sparse_attention import (
    ENGAGE_FRAC,
    BlockLayout,
    BlockSparseAttention,
    compile_block_layout,
)
from .decode_attention import fused_decode_attention, fused_decode_supported
from .flash_attention import (
    FlashAttention,
    FusedQKVAttention,
    flash_block,
    fused_qkv_supported,
    may_attend,
)
from .layers import Linear, dropout
from .rotary import apply_rotary_emb, rotate_half

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
ATTN_TYPES = ("full", "axial_row", "axial_col", "conv_like", "sparse")

# JAX PatternAttention's pattern fields at their defaults, which its
# Transformer never overrides
CONV_KERNEL_SIZE = 5
CONV_DILATION = 1
SPARSE_BLOCK_SIZE = 16
SPARSE_RANDOM_BLOCKS = None  # masks.block_sparse_mask's seq_len // block // 4

# One entry per (pattern config, n), shared by every layer of that config
# (JAX's _cached_flash_mask / _cached_block_layout): pattern tensors (also
# keyed by device) and compiled BlockLayouts, which copy themselves to a
# device once (block_sparse_attention.device_layout).
_PATTERN_CACHE: dict = {}
_LAYOUT_CACHE: dict = {}


def sparse_block(n: int) -> int:
    """JAX's pair-grid block for a sequence of n: 128 when n is a
    multiple of 128 with at least two blocks, else 0."""
    return 128 if n % 128 == 0 and n >= 256 else 0


@dataclass
class PagedKV:
    """One attention layer's paged cache: flat K/V pools
    (rows * n_pages + 1, page, h*d) (see ``paged_kv``), the (b, n_pages)
    int32 page table of global ids, and the per-sequence (b,) int32 write
    index. Int8 pools come with their float32 scale pools
    (rows * n_pages + 1, page, h); both are None when unquantized."""

    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    index: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    def pools(self):
        """Every pool of the layer: content, then scales when int8."""
        return [t for t in (self.k, self.v, self.k_scale, self.v_scale) if t is not None]


def decode_kernel_route(device, n: int, attn_type: str, causal: bool, heads: int,
                        dim_head: int) -> bool:
    """The card's route for a dense decode step (``fused_decode`` None or
    True on a CUDA device): the fused decode kernel for one token of a
    causal "full" layer with heads the kernel takes, at any window;
    never off the card."""
    return (torch.device(device).type == "cuda" and n == 1 and attn_type == "full"
            and causal and fused_decode_supported(heads, dim_head))


@dataclass
class DenseKV:
    """One attention layer's dense decode cache: K and V each one
    contiguous (b, L, h*d) buffer, updated in place; ``fmt`` the format
    ("flat", or "4d": the same memory as its (b, L, h, d) view, see
    ``tagged``); ``index`` the scalar write index, a Python int (the whole
    batch sits at one position); ``width`` the sweep extent W <= L that
    attention reads (the segmented decode's window; L when unwindowed)."""

    k: torch.Tensor
    v: torch.Tensor
    fmt: str
    heads: int
    index: int = 0
    width: int = 0

    def __post_init__(self):
        self.width = self.width or self.k.shape[1]

    def tagged(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (self.k or self.v) in the format's shape."""
        return t.view(*t.shape[:2], self.heads, -1) if self.fmt == "4d" else t


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


def full_route(n: int, heads: int, dim_head: int) -> str:
    """The full-sequence path JAX takes for a sequence of n (after the pair
    grid declines): "packed" (``flash_block(n) == n`` and
    ``fused_qkv_supported``), "tiled_one_block" (a one-block grid the
    packed kernel refuses), "tiled" (a grid of several flash blocks) or
    "dense" (no flash block)."""
    block = flash_block(n)
    if block == n:
        return "packed" if fused_qkv_supported(n, heads, dim_head) else "tiled_one_block"
    return "tiled" if block > 0 else "dense"


def _split_heads(qkv, heads: int, dim_head: int, rotary=None):
    """q, k, v (b, h, n, d) from the packed projection (b, n, 3*h*d),
    rotated with torch ops when ``rotary`` (the (cos, sin) pair of
    ``rotary.rot_tables``) is given."""
    b, n, _ = qkv.shape
    q, k, v = (t.reshape(b, n, heads, dim_head).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    if rotary is not None:
        cos, sin = (t[:n] for t in rotary)  # (n, d) over (b, h, n, d)
        q, k, v = (t * cos + rotate_half(t) * sin for t in (q, k, v))
    return q, k, v


def full_attend(qkv, heads: int, dim_head: int, mask=None,
                causal: bool = True, rotary=None, pattern=None):
    """Attention over a whole sequence from the packed projection qkv
    (b, n, 3*h*d); ``mask`` (b, >= n) bool key mask, ``rotary`` the
    (cos, sin) pair of ``rotary.rot_tables`` (>= n rows, zero angles past
    the table rotate nothing), ``pattern`` an optional (n, n) may-attend
    mask on qkv's device that replaces the causal rule. Returns
    (b, n, h*d), by ``full_route``'s path. The packed and tiled kernels
    take the unscaled q with ``sm_scale = d**-0.5`` (a fully masked row
    gives 0); the dense path pre-scales q and runs a plain softmax (a
    fully masked row is uniform over its keys), as JAX's paths do."""
    b, n, _ = qkv.shape
    h, d = heads, dim_head
    key_mask = None if mask is None else mask[:, :n]
    route = full_route(n, h, d)
    if route == "packed":
        o, _ = FusedQKVAttention.apply(qkv.contiguous(), key_mask, h, d,
                                       causal, pattern, rotary, d**-0.5)
        return o
    if route != "dense":
        return flash_attend(qkv, h, d, mask, causal, rotary, pattern)
    q, k, v = (t.transpose(1, 2) for t in _split_heads(qkv, h, d, rotary))
    allowed = may_attend(n, qkv.device, key_mask, causal, pattern)[:, 0].expand(b, n, n)
    out = cache_block_attend(q * d**-0.5, k.reshape(b, n, h * d),
                             v.reshape(b, n, h * d), allowed)
    return out.reshape(b, n, h * d)


def flash_attend(qkv, heads: int, dim_head: int, mask=None,
                 causal: bool = True, rotary=None, pattern=None):
    """The tiled path (JAX's ``_flash_attend``): qkv (b, n, 3*h*d) split
    into (b, h, n, d) heads, rotated with torch ops, then
    ``FlashAttention`` with ``sm_scale = d**-0.5``; arguments as
    ``full_attend``. Returns (b, n, h*d); a row with every key masked
    gives 0."""
    b, n, _ = qkv.shape
    q, k, v = _split_heads(qkv, heads, dim_head, rotary)
    key_mask = None if mask is None else mask[:, :n]
    o, _ = FlashAttention.apply(q, k, v, key_mask, causal, pattern, dim_head**-0.5)
    return o.transpose(1, 2).reshape(b, n, heads * dim_head)


def block_sparse_attend(qkv, heads: int, dim_head: int, layout: BlockLayout,
                        mask=None, rotary=None):
    """The pair-grid path: qkv (b, n, 3*h*d) split into (b, h, n, d)
    heads, rotated with torch ops (``rotary`` as in ``full_attend``), then
    ``BlockSparseAttention`` with ``sm_scale = d**-0.5``. Returns
    (b, n, h*d); a row with every key masked gives 0."""
    b, n, _ = qkv.shape
    q, k, v = _split_heads(qkv, heads, dim_head, rotary)
    key_mask = None if mask is None else mask[:, :n]
    o, _ = BlockSparseAttention.apply(q, k, v, key_mask, layout, dim_head**-0.5)
    return o.transpose(1, 2).reshape(b, n, heads * dim_head)


class Attention(nn.Module):
    """Multi-head attention with a static pattern: the qkv projection
    (columns ``[q | k | v]``, each (h, d)-major), the attention core, and
    the output projection. ``seq_len`` is the length L the pattern is
    defined over (text with <bos> plus the image grid for DALL-E); the
    pattern fields ``image_fmap_size`` and ``layout_seed`` (read by
    "sparse" only) are JAX's ``PatternAttention``'s, the others its
    defaults (``CONV_*``, ``SPARSE_*``). With a paged cache (``kv``) it is the
    decode form: rotary on q, k and v at each token's position, the
    q * d**-0.5 pre-scale, the masked page append (quantized for int8
    pages), and the attention core of the module docstring. Without one it
    attends over the whole sequence (the module docstring's dispatch).
    The projections compute in ``dtype`` on parameters stored in
    ``param_dtype`` (``layers.Linear``), so q, k and v reach the kernels
    in ``dtype``; the route does not depend on either. A ``stable`` DALLE
    needs nothing here: every einsum path scores in float32, where JAX's
    stable softmax is bitwise the plain one (scaling by 2**10 is exact),
    and the kernels take no ``stable``, as JAX's do not."""

    def __init__(self, dim: int, seq_len: int, heads: int = 8,
                 dim_head: int = 64, attn_type: str = "full",
                 causal: bool = True, dropout: float = 0.0,
                 image_fmap_size: Optional[int] = None, layout_seed: int = 0,
                 device=None, dtype=torch.float32, param_dtype=None):
        super().__init__()
        if attn_type not in ATTN_TYPES:
            raise ValueError(f"attention type {attn_type!r} is not one of {ATTN_TYPES}")
        if attn_type != "full" and image_fmap_size is None:
            raise ValueError(f"attn_type {attn_type!r} needs an image grid (image_fmap_size)")
        self.seq_len = seq_len
        self.attn_type = attn_type
        self.causal = causal
        self.heads, self.dim_head = heads, dim_head
        self.image_fmap_size = image_fmap_size
        self.layout_seed = layout_seed
        self.dropout = dropout
        inner = heads * dim_head
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.to_qkv = Linear(dim, inner * 3, bias=False, **kw)
        self.to_out = Linear(inner, dim, **kw)

    def pattern_mask(self) -> np.ndarray:
        """The static (L, L) may-attend matrix defining this layer."""
        L, fmap = self.seq_len, self.image_fmap_size
        if self.attn_type == "full":
            return masks_lib.causal_mask(L) if self.causal else np.ones((L, L), dtype=bool)
        text_len = L - fmap**2
        if self.attn_type in ("axial_row", "axial_col"):
            return masks_lib.axial_mask(text_len, fmap, axis=int(self.attn_type == "axial_col"))
        if self.attn_type == "conv_like":
            return masks_lib.conv_mask(text_len, fmap, CONV_KERNEL_SIZE, CONV_DILATION)
        return masks_lib.block_sparse_mask(
            L, block_size=SPARSE_BLOCK_SIZE, text_seq_len=text_len - 1,
            num_random_blocks=SPARSE_RANDOM_BLOCKS, causal=self.causal,
            seed=self.layout_seed)

    def _pattern_key(self, n: int) -> tuple:
        """The fields ``pattern_mask()`` reads, and n."""
        seed = self.layout_seed if self.attn_type == "sparse" else None
        return (self.attn_type, self.seq_len, self.causal, self.image_fmap_size, seed, n)

    def pattern(self, n: int, device) -> torch.Tensor:
        """``pattern_mask()[:n, :n]`` as a bool tensor on ``device``."""
        key = self._pattern_key(n) + (torch.device(device),)
        cached = _PATTERN_CACHE.get(key)
        if cached is None:
            cached = _PATTERN_CACHE[key] = torch.from_numpy(
                np.ascontiguousarray(self.pattern_mask()[:n, :n])).to(device)
        return cached

    def decode_rows(self, width: int, device) -> torch.Tensor:
        """``pattern_mask()`` (L, L) with its columns cut or padded with
        False to a cache view of ``width`` rows, as a bool tensor on
        ``device``: row p is what the query at position p may attend."""
        key = ("decode",) + self._pattern_key(width) + (torch.device(device),)
        cached = _PATTERN_CACHE.get(key)
        if cached is None:
            pm = self.pattern_mask()
            L = pm.shape[0]
            pm = pm[:, :width] if width <= L else np.pad(pm, ((0, 0), (0, width - L)))
            cached = _PATTERN_CACHE[key] = torch.from_numpy(np.ascontiguousarray(pm)).to(device)
        return cached

    def block_layout(self, n: int) -> BlockLayout:
        """The compiled 128-block layout of ``pattern_mask()[:n, :n]``."""
        key = self._pattern_key(n)
        cached = _LAYOUT_CACHE.get(key)
        if cached is None:
            block = sparse_block(n)
            cached = _LAYOUT_CACHE[key] = compile_block_layout(
                self.pattern_mask()[:n, :n], block, block)
        return cached

    def uses_block_sparse(self, n: int) -> bool:
        """JAX's TPU routing: a non-"full" pattern at a pair-grid n whose
        layout visits at most ENGAGE_FRAC of the dense-causal pairs."""
        return (self.attn_type != "full" and sparse_block(n) > 0
                and self.block_layout(n).visited_block_frac <= ENGAGE_FRAC)

    def forward(self, x, kv=None, rotary=None, block_len=None, block_start=None,
                mask=None, fused_decode: Optional[bool] = None, rotary_cs=None,
                generator: Optional[torch.Generator] = None):
        """Decode form (``kv`` a ``PagedKV``): x (b, n, dim), row b's valid
        tokens are columns [0, block_len[b]) at positions block_start[b] +
        j; writes their K/V into ``kv`` and advances its index for rows
        with block_len > 0; ``rotary`` is the angle table, ``mask`` the
        optional (b, L) key mask. Decode form over a ``DenseKV``: x's n
        tokens at positions kv.index + j (``_decode_dense``), with
        ``fused_decode`` (None, True or False: the module docstring) and
        ``rotary_cs`` (the (cos, sin) pair of ``rotary.rot_tables`` over
        the whole angle table) for the fused path. Full-sequence form (no
        ``kv``): ``mask`` is the optional (b, n) key mask, ``rotary`` the
        (cos, sin) pair of ``rotary.rot_tables``; with a ``generator`` the
        output of ``to_out`` goes through dropout at rate ``dropout`` (on
        every route: JAX drops after ``to_out``). The decode forms never
        drop."""
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        if isinstance(kv, DenseKV):
            out = self._decode_dense(self.to_qkv(x), kv, rotary, mask, fused_decode, rotary_cs)
            return self.to_out(out)
        if kv is None:
            qkv = self.to_qkv(x)
            if self.uses_block_sparse(n):
                out = block_sparse_attend(qkv, h, d, self.block_layout(n), mask, rotary)
            else:
                pattern = None if self.attn_type == "full" else self.pattern(n, x.device)
                out = full_attend(qkv, h, d, mask, self.causal, rotary, pattern)
            return dropout(self.to_out(out), self.dropout, generator)
        q, k, v = (
            t.reshape(b, n, h, d) for t in self.to_qkv(x).chunk(3, dim=-1)
        )
        idx = block_start
        pos = idx.long()[:, None] + torch.arange(n, device=x.device)
        if rotary is not None:
            rows = rotary[pos.clamp(max=rotary.shape[0] - 1)][:, :, None]
            q, k, v = (apply_rotary_emb(rows, t) for t in (q, k, v))
        q = q * d**-0.5

        rows = [k.reshape(b, n, h * d), v.reshape(b, n, h * d)]
        if kv.k_scale is not None:
            # int8 pages: K and V quantized at append (together: one
            # quantization of the stacked rows), their scales written
            # through the same slots, so a replay or an overwrite rewrites
            # bytes and scales alike
            q8, scales = paged_kv.quantize_rows(torch.cat(rows), h)
            rows = [*q8.split(b), *scales.split(b)]
        # ``pools()`` order: K, V, then their scales
        paged_kv.append_(kv.pools(), kv.table, idx, rows, limit=block_len)
        kv.index = torch.where(block_len > 0, idx + block_len, kv.index)
        if self.attn_type == "full" and self.causal and mask is None:
            out = ragged_attention.kernel_attend(
                q.contiguous(), kv.k, kv.v, kv.table, idx, block_len,
                kv.k_scale, kv.v_scale,
            )
        else:
            out = self._gathered_attend(q, kv, pos, mask)
        return self.to_out(out.reshape(b, n, h * d))

    def fused_decode_gate(self, n: int, kv: DenseKV) -> bool:
        """JAX's gate for the fused decode kernel (given ``fused_decode``),
        the route of ``fused_decode=True`` on the CPU: one token, a causal
        "full" layer, supported heads, and a sweep extent of the whole
        cache (JAX's ``_has_windowed_cache`` false)."""
        return (n == 1 and self.attn_type == "full" and self.causal
                and fused_decode_supported(self.heads, self.dim_head)
                and kv.width == kv.k.shape[1])

    def uses_decode_kernel(self, n: int, kv: DenseKV, device,
                           fused_decode: Optional[bool]) -> bool:
        """Whether a dense decode step of n tokens takes the fused kernel:
        never with ``fused_decode=False``; on a CUDA device
        ``decode_kernel_route`` (None or True); on the CPU JAX's gate
        with True, the unfused chain with None."""
        if fused_decode is False:
            return False
        if torch.device(device).type == "cuda":
            return decode_kernel_route(device, n, self.attn_type, self.causal, self.heads,
                                       self.dim_head)
        return bool(fused_decode) and self.fused_decode_gate(n, kv)

    def _decode_dense(self, qkv, kv: DenseKV, rotary, mask, fused_decode: Optional[bool],
                      rotary_cs):
        """Decode over the dense cache: qkv (b, n, 3*h*d) of n tokens at
        positions kv.index + j. The fused path (``uses_decode_kernel``):
        the kernel, then its k/v rows written at the index. Otherwise
        JAX's ``_decode_attend``. Advances kv.index by n; returns
        (b, n, h*d)."""
        b, n, _ = qkv.shape
        h, d = self.heads, self.dim_head
        idx, W = kv.index, kv.width
        if self.uses_decode_kernel(n, kv, qkv.device, fused_decode):
            cos, sin = rotary_cs if rotary is not None else (None, None)
            key_mask = None if mask is None else mask.to(torch.int32)
            out, k_row, v_row = fused_decode_attention(
                qkv, kv.k, kv.v, idx, cos, sin, key_mask, heads=h)
            kv.k[:, idx] = k_row[:, 0]
            kv.v[:, idx] = v_row[:, 0]
            kv.index = idx + 1
            return out
        q, k, v = (t.reshape(b, n, h, d) for t in qkv.chunk(3, dim=-1))
        if rotary is not None:
            rows = rotary[idx:idx + n][None, :, None]  # over (b, n, h, d)
            q, k, v = (apply_rotary_emb(rows, t) for t in (q, k, v))
        q = q * d**-0.5
        kv.k[:, idx:idx + n] = k.reshape(b, n, h * d)
        kv.v[:, idx:idx + n] = v.reshape(b, n, h * d)
        kv.index = idx + n
        allowed = self.decode_rows(W, qkv.device)[idx:idx + n][None]  # (1, n, W)
        if mask is not None:
            allowed = allowed & mask[:, None, :W]
        out = cache_block_attend(q, kv.k[:, :W], kv.v[:, :W], allowed.expand(b, n, W))
        return out.reshape(b, n, h * d)

    def _gathered_attend(self, q, kv: PagedKV, pos, mask):
        """The decode form of every layer but the causal "full" one without
        a key mask: the gathered (and, for int8 pages, dequantized) cache
        view, the pattern's rows at each query position ``pos`` (b, n),
        ANDed with the key mask, then ``cache_block_attend``."""
        k_cache = paged_kv.read(kv.k, kv.table, kv.k_scale, q.dtype)
        v_cache = paged_kv.read(kv.v, kv.table, kv.v_scale, q.dtype)
        W = k_cache.shape[1]
        rows = self.decode_rows(W, q.device)
        allowed = rows[pos.clamp(max=rows.shape[0] - 1)]  # (b, n, W)
        if mask is not None:
            km = mask[:, :W]
            allowed = allowed & nn.functional.pad(km, (0, W - km.shape[1]))[:, None]
        return cache_block_attend(q, k_cache, v_cache, allowed)
