"""Fused single-token decode attention (counterpart of
``dalle_pytorch_tpu/ops/decode_attention.py``).

One decode step of one causal "full" layer over the dense (flat or 4-D)
cache, from the packed projection row to the attention output:

    rotary(q, k, v) at position idx  ->  scores = q K_cache[:idx]^T plus the
    fresh token's own k  ->  key mask  ->  softmax  ->  out = P [V; v]

- the K/V caches are read only: the fresh token enters the softmax from
  its rotated k/v rounded to the cache dtype, which the call returns as
  ``k_row`` / ``v_row`` for the caller to write at ``idx``;
- the causal rule is strict: cache rows [0, idx) plus the fresh token
  (the row at idx is stale), and the optional key mask applies to the
  fresh key too; a masked fresh key never enters the max, and a step with
  no live key gives 0;
- rotation applies to q, k and v (the DALL-E quirk), in float32 from the
  compute-dtype cos/sin tables that ``rotary.rot_tables`` builds.

``reference_fused_decode`` is the plain version. ``fused_decode_attention``
is the wrapper of the hand-written CUDA kernel
(``csrc/decode_attention.cu``): a CUDA tensor launches the kernel or
raises, a CPU tensor runs the plain version; ``.launches`` counts kernel
launches. The kernel splits each (head, batch row) over a cluster of S
blocks, each sweeping one slice of the cache rows (``decode_slices``),
and merges their partial softmaxes in rank order; ``decode_splits``
chooses S from the shape alone. ``fused_decode_supported`` is JAX's
head-group predicate, which the dispatch in ``ops/attention.py`` uses.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .rotary import rotate_half

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# the kernel's splits: a cluster of at most 8 blocks (the largest portable
# cluster) of 8 warps, at most 64 blocks in all and never fewer than 64
# cache rows a block. Timed on an H100: at batch 1 (16 pairs) S 4 beat
# S 8 and S 2 from idx 512 to 1279; at batch 8 (128 pairs) S 1 matched
# S 2 and beat S 4 (the merge and its barriers cost more as S grows, and
# 128 blocks of 8 warps already cover the card).
DECODE_SPLITS = (1, 2, 4, 8)
DECODE_TARGET_BLOCKS = 64
DECODE_MIN_ROWS = 64


def decode_splits(pairs: int, idx: int) -> int:
    """S, the blocks the kernel splits each of ``pairs`` (batch x heads)
    (head, batch row) pairs over at position ``idx``: the largest of
    ``DECODE_SPLITS`` with pairs * S <= ``DECODE_TARGET_BLOCKS`` and idx
    >= S * ``DECODE_MIN_ROWS``, else 1 (so idx 0 gives 1)."""
    fits = [s for s in DECODE_SPLITS
            if pairs * s <= DECODE_TARGET_BLOCKS and idx >= s * DECODE_MIN_ROWS]
    return max(fits, default=1)


def decode_slices(idx: int, splits: int):
    """The cache rows [lo, hi) that block ``rank`` of a split sweeps, for
    rank 0 .. splits - 1: contiguous, in rank order, covering [0, idx),
    sizes differing by at most one (so a slice is empty only when idx <
    splits)."""
    return [(r * idx // splits, (r + 1) * idx // splits) for r in range(splits)]


def fused_decode_supported(heads: int, dim_head: int) -> bool:
    """JAX's predicate: 128 lanes tile into whole heads and the heads into
    whole groups of 128 // dim_head."""
    return 128 % dim_head == 0 and heads % max(1, 128 // dim_head) == 0


def reference_fused_decode(qkv, k_cache, v_cache, idx: int, cos, sin,
                           key_mask, heads: int):
    """Plain version of ``fused_decode_attention``, same arguments and
    results; float32 arithmetic throughout, the fresh rows rounded to the
    cache dtype before they enter the softmax."""
    b, _, width = qkv.shape
    h = heads
    d = width // (3 * h)
    L = k_cache.shape[1]
    q, k, v = qkv.float().reshape(b, 3, h, d).unbind(1)
    if cos is not None:
        c, s = cos[idx].float(), sin[idx].float()
        q, k, v = (t * c + rotate_half(t) * s for t in (q, k, v))
    k_row, v_row = k.to(k_cache.dtype), v.to(v_cache.dtype)
    qs = q * d**-0.5
    keys = k_cache.reshape(b, L, h, d)[:, :idx].float()
    values = v_cache.reshape(b, L, h, d)[:, :idx].float()
    scores = torch.cat((torch.einsum("bhd,blhd->bhl", qs, keys),
                        (k_row.float() * qs).sum(-1, keepdim=True)), dim=-1)
    if key_mask is None:
        live = torch.ones((b, idx + 1), dtype=torch.bool, device=qkv.device)
    else:
        live = key_mask[:, :idx + 1] > 0
    live = live[:, None]  # (b, 1, idx + 1) over (b, h, idx + 1)
    scores = scores.masked_fill(~live, NEG_INF)
    p = torch.where(live, (scores - scores.amax(-1, keepdim=True)).exp(), 0.0)
    den = p.sum(-1, keepdim=True)
    den = torch.where(den == 0, 1.0, den)
    acc = torch.einsum("bhl,blhd->bhd", p[..., :idx], values) + p[..., idx:] * v_row.float()
    out = (acc / den).to(qkv.dtype)
    return tuple(t.reshape(b, 1, h * d) for t in (out, k_row, v_row))


def _check(qkv, k_cache, v_cache, idx, cos, sin, key_mask, heads):
    """Raise on anything the kernel does not take."""
    b, one, width = qkv.shape
    tensors = [t for t in (qkv, k_cache, v_cache, cos, sin, key_mask) if t is not None]
    if any(not t.is_cuda or t.device != qkv.device for t in tensors):
        raise ValueError("fused_decode_attention: every tensor must be on qkv's device")
    if qkv.dtype not in _DTYPE_CODE or any(
            t.dtype != qkv.dtype for t in (k_cache, v_cache, cos, sin) if t is not None):
        raise TypeError("fused_decode_attention takes float32 or bfloat16 qkv with caches "
                        f"and tables of its dtype, got {[t.dtype for t in tensors]}")
    if key_mask is not None and key_mask.dtype != torch.int32:
        raise TypeError(f"fused_decode_attention: key_mask must be int32, got {key_mask.dtype}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("fused_decode_attention: every tensor must be contiguous")
    if any(t.data_ptr() % 16 for t in (k_cache, v_cache)):
        raise ValueError("fused_decode_attention: the caches must be 16-byte aligned")
    if (cos is None) != (sin is None):
        raise ValueError("fused_decode_attention: give both cos and sin or neither")
    if one != 1 or width % (3 * heads):
        raise ValueError(f"qkv {tuple(qkv.shape)} is not (b, 1, 3*h*d) for {heads} heads")
    L = k_cache.shape[1]
    d = width // (3 * heads)
    if k_cache.shape[0] != b or k_cache.shape[2] != heads * d or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches {tuple(k_cache.shape)}, {tuple(v_cache.shape)} are not "
                         f"(b, L, h*d) for qkv {tuple(qkv.shape)}")
    if not 0 <= idx < L:
        raise ValueError(f"idx {idx} outside the cache's {L} rows")
    if cos is not None and (cos.shape[0] <= idx or cos.shape[1] != d or sin.shape != cos.shape):
        raise ValueError(f"rotary tables {tuple(cos.shape)} do not cover position {idx} at "
                         f"dim_head {d}")
    if key_mask is not None and key_mask.shape != (b, L):
        raise ValueError(f"key_mask {tuple(key_mask.shape)} is not {(b, L)}")


def fused_decode_attention(qkv, k_cache, v_cache, idx: int, cos=None, sin=None,
                           key_mask: Optional[torch.Tensor] = None, *, heads: int,
                           splits: Optional[int] = None):
    """One decode step: qkv (b, 1, 3*h*d) float32 or bfloat16; k_cache,
    v_cache (b, L, h*d) (or their (b, L, h, d) view) of qkv's dtype, read
    only; ``idx`` the step's position, a Python int in [0, L); cos, sin
    (> idx rows, d) in qkv's dtype from ``rotary.rot_tables``, or None
    for no rotary; key_mask (b, L) int32 (> 0 live) or None; ``splits``
    the kernel's S (one of ``DECODE_SPLITS``; default ``decode_splits``).
    Returns (out, k_row, v_row), each (b, 1, h*d): out in qkv's dtype, the
    rotated k and v in the caches' dtype, for the caller to write at
    ``idx``. CPU tensors run ``reference_fused_decode``; CUDA tensors
    launch the kernel, never falling back."""
    if not qkv.is_cuda:
        return reference_fused_decode(qkv, k_cache, v_cache, idx, cos, sin, key_mask, heads)
    from .cuda_build import load_library

    b = qkv.shape[0]
    k_cache, v_cache = (t.reshape(b, t.shape[1], -1) for t in (k_cache, v_cache))
    _check(qkv, k_cache, v_cache, idx, cos, sin, key_mask, heads)
    if splits is None:
        splits = decode_splits(b * heads, idx)
    if splits not in DECODE_SPLITS:
        raise ValueError(f"splits must be one of {DECODE_SPLITS}, got {splits}")
    L, hd = k_cache.shape[1:]
    d = hd // heads
    out = torch.empty((b, 1, hd), dtype=qkv.dtype, device=qkv.device)
    k_row, v_row = torch.empty_like(out), torch.empty_like(out)
    p = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    err = load_library("decode_attention").decode_attention_fwd(
        *(p(t) for t in (qkv, k_cache, v_cache, cos, sin, key_mask, out, k_row, v_row)),
        b, heads, d, L, idx, d**-0.5, splits, _DTYPE_CODE[qkv.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(qkv.device).cuda_stream),
    )
    if err == -1:
        raise ValueError(f"the decode kernel cannot take dim_head {d} at batch {b}: it has "
                         "instances for every dim_head that divides 128 and at most 65535 "
                         "batch rows (see csrc/decode_attention.cu)")
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: error {err}")
    fused_decode_attention.launches += 1
    return out, k_row, v_row


fused_decode_attention.launches = 0
