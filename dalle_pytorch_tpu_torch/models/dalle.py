"""DALL-E text->image transformer (counterpart of
``dalle_pytorch_tpu/models/dalle.py``).

The vocabulary is [text | per-position text pads | image]: ``remap_text``
gives each padding-0 text position its own id and prepends <bos> = 0.
Positions are rotary (``rotary_emb=True``, in every attention layer) or
learned (``rotary_emb=False``, train_dalle.py's default): a table of the
text positions (<bos> included) and the image grid's axial embedding,
added to the token embeddings in the parameters' dtype before the cast
to the compute dtype. ``stable`` divides the transformer's output by its
per-position max before the final norm; its attention is the plain one
(``ops.attention.Attention``: on float32 scores JAX's stable softmax is
bitwise the plain softmax). Two forms, both causal:

- ``forward`` (training): the whole [<bos>, text, image] sequence minus
  its trailing token through the transformer, whose layers cycle
  ``attn_types`` ("full", "axial_row", "axial_col", "conv_like",
  "sparse"), with dropout (``attn_dropout``, ``ff_dropout``) when the
  call has a generator, in the stack's execution (sequential,
  ``reversible`` or ``remat``: ``models/transformer.py``); the float32
  logits with the block-diagonal logits mask, or the weighted split
  cross-entropy.
- ``fused_step`` (serving): one ragged block of a mixed prefill+decode
  iteration through the cached transformer; image-only logits at each
  row's last valid column. Every layer type decodes ("full" through the
  ragged kernel, the others through the gathered cache view).
- ``prefill_step`` / ``prefill_chunk`` / ``decode_step`` (generation
  outside the engine, ``models/sampling.py``, and the engine's split
  path): the first T text positions in one parallel pass or in chunks,
  then one position at a time for the whole batch, over a paged or
  dense decode cache (the engine's rows each at their own position, on
  pages); logits with the logits mask's row, or the image-vocab head
  alone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.attention import PagedKV
from ..ops.layers import (AxialPositionalEmbedding, LayerNorm32, Linear, divide_max,
                          seeded_init_)
from .transformer import Transformer

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def top_k_filter(logits: torch.Tensor, thres: float = 0.5,
                 k: Optional[int] = None) -> torch.Tensor:
    """Keep the top ``max(int((1 - thres) * vocab), 1)`` logits, fill the
    rest with -inf. ``k`` overrides the fraction-derived count (callers
    that pre-slice the logits to the image vocab pass the FULL-vocab k);
    k >= width filters nothing."""
    num_logits = logits.shape[-1]
    if k is None:
        k = max(int((1 - thres) * num_logits), 1)
    if k >= num_logits:
        return logits
    kth = logits.topk(k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


class DALLE(nn.Module):
    """``num_text_tokens`` is the raw text vocab; internally it is extended
    by ``text_seq_len`` per-position padding ids. The model computes in
    ``dtype`` on parameters created on ``device`` in ``param_dtype``
    (default ``dtype``), LayerNorm and LayerScale parameters in float32.
    ``dtype=torch.bfloat16, param_dtype=torch.float32`` is mixed
    precision as flax runs it: float32 embedding tables cast to bfloat16
    before the transformer, every projection's weights cast to bfloat16
    at use, LayerNorm (``final_norm`` too) in float32, and the loss's
    logsumexp in float32. Casting float32 parameters at use computes what
    bfloat16 parameters of the same values compute."""

    def __init__(self, *, dim: int, depth: int, num_text_tokens: int = 10000,
                 text_seq_len: int = 256, num_image_tokens: int = 512,
                 image_fmap_size: int = 32, heads: int = 8,
                 dim_head: int = 64, attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 attn_types: Optional[Tuple[str, ...]] = None,
                 shift_tokens: bool = True, rotary_emb: bool = True,
                 loss_img_weight: float = 7.0, stable: bool = False,
                 reversible: bool = False, remat: bool = False,
                 sparse_layout_seed: int = 0, shift_pad: int = 0,
                 serve_quant: bool = False, device="cuda",
                 dtype=torch.float32, param_dtype=None):
        super().__init__()
        if serve_quant:
            raise NotImplementedError("DALLE(serve_quant) is not ported")
        self.dim, self.depth = dim, depth
        self.heads, self.dim_head = heads, dim_head
        self.attn_dropout, self.ff_dropout = attn_dropout, ff_dropout
        self.num_text_tokens = num_text_tokens
        self.text_seq_len = text_seq_len
        self.num_image_tokens = num_image_tokens
        self.image_fmap_size = image_fmap_size
        self.loss_img_weight = loss_img_weight
        self.stable, self.rotary_emb = stable, rotary_emb
        self.attn_types = None if attn_types is None else tuple(attn_types)
        self.shift_tokens, self.sparse_layout_seed = shift_tokens, sparse_layout_seed
        # extra shift-ring rows of a decode cache built for this model
        # (the speculative engine's rollback slack; models/sampling.py)
        self.shift_pad = shift_pad
        self.reversible, self.remat = reversible, remat
        self.device, self.dtype = torch.device(device), dtype
        self.param_dtype = param_dtype or dtype

        self.text_emb = nn.Embedding(self.num_text_tokens_ext, dim,
                                     device=device, dtype=self.param_dtype)
        self.image_emb = nn.Embedding(num_image_tokens, dim, device=device,
                                      dtype=self.param_dtype)
        if not rotary_emb:
            self.text_pos_emb = nn.Embedding(self.text_len_internal, dim, device=device,
                                             dtype=self.param_dtype)
            self.image_pos_emb = AxialPositionalEmbedding(
                dim, (image_fmap_size, image_fmap_size), device=device,
                param_dtype=self.param_dtype)
        self.transformer = Transformer(
            dim=dim, depth=depth, seq_len=self.total_seq_len, heads=heads,
            dim_head=dim_head, attn_types=attn_types,
            image_fmap_size=image_fmap_size, attn_dropout=attn_dropout,
            ff_dropout=ff_dropout, shift_tokens=shift_tokens,
            rotary_emb=rotary_emb, reversible=reversible, remat=remat,
            sparse_layout_seed=sparse_layout_seed, device=device, dtype=dtype,
            param_dtype=self.param_dtype,
        )
        self.final_norm = LayerNorm32(dim, device=device)
        self.to_logits = Linear(dim, self.total_tokens, device=device, dtype=dtype,
                                param_dtype=self.param_dtype)

    # ------------------------------------------------------------ derived

    @property
    def image_seq_len(self) -> int:
        return self.image_fmap_size**2

    @property
    def num_text_tokens_ext(self) -> int:
        return self.num_text_tokens + self.text_seq_len

    @property
    def total_tokens(self) -> int:
        return self.num_text_tokens_ext + self.num_image_tokens

    @property
    def total_seq_len(self) -> int:
        """Transformer input length (the last token is never fed)."""
        return self.text_seq_len + self.image_seq_len

    @property
    def text_len_internal(self) -> int:
        """Text positions including <bos>."""
        return self.text_seq_len + 1

    # ------------------------------------------------------------ helpers

    def init_weights(self, generator: torch.Generator) -> "DALLE":
        """Seeded random weights (``layers.seeded_init_``)."""
        seeded_init_(self, generator)
        return self

    def remap_text(self, text: torch.Tensor) -> torch.Tensor:
        """(b, text_seq_len) raw ids -> (b, text_seq_len + 1) internal ids:
        each padding-0 position gets its own id, <bos> = 0 prepended."""
        text_range = torch.arange(
            self.text_seq_len, dtype=text.dtype, device=text.device
        ) + (self.num_text_tokens_ext - self.text_seq_len)
        text = torch.where(text == 0, text_range, text)
        return nn.functional.pad(text, (1, 0))

    def _pos_emb(self, pos) -> torch.Tensor:
        """Learned positions at internal positions ``pos``, in the
        parameters' dtype: a Python int gives one row (dim,), an int
        tensor (..., dim). One gather from the text table followed by the
        image grid (text positions come first), at ``pos`` clipped to it
        as JAX clips each table's index."""
        table = torch.cat((self.text_pos_emb.weight, self.image_pos_emb.grid()))
        last = table.shape[0] - 1
        return table[pos.clamp(0, last) if torch.is_tensor(pos) else min(max(pos, 0), last)]

    def _final_norm(self, out: torch.Tensor) -> torch.Tensor:
        """The final norm (float32), after ``divide_max`` with ``stable``."""
        return self.final_norm(divide_max(out) if self.stable else out)

    def _head_image(self, out: torch.Tensor) -> torch.Tensor:
        """Image-vocab-only head: the ``[ext:]`` rows of ``to_logits`` on
        the final-normed hidden states; float32 logits."""
        ext, dt = self.num_text_tokens_ext, self.dtype
        normed = self._final_norm(out).to(dt)
        logits = nn.functional.linear(
            normed, self.to_logits.weight[ext:].to(dt), self.to_logits.bias[ext:].to(dt)
        )
        return logits.float()

    def _head(self, out: torch.Tensor) -> torch.Tensor:
        """The full-vocab head on the final-normed hidden states; float32
        logits."""
        return self.to_logits(self._final_norm(out).to(self.dtype)).float()

    def logits_mask_row(self, pos: int) -> torch.Tensor:
        """``logits_mask``'s row at position ``pos`` (clipped to the last
        one), (total_tokens,) bool."""
        ext = self.num_text_tokens_ext
        logit = torch.arange(self.total_tokens, device=self.device)
        if min(pos, self.total_seq_len - 1) >= self.text_seq_len:
            return logit < ext
        return logit >= ext

    def logits_mask_rows(self, pos: torch.Tensor) -> torch.Tensor:
        """``logits_mask_row`` at each row's position ``pos`` (b,):
        (b, total_tokens) bool."""
        ext = self.num_text_tokens_ext
        logit = torch.arange(self.total_tokens, device=pos.device)[None]
        is_image = (pos.clamp(max=self.total_seq_len - 1) >= self.text_seq_len)[:, None]
        return torch.where(is_image, logit < ext, logit >= ext)

    def logits_mask(self, n: int) -> torch.Tensor:
        """(n, total_tokens) bool, True = forbidden: text positions may
        only predict text tokens, image positions image tokens."""
        seq = torch.arange(n, device=self.device)[:, None]
        logit = torch.arange(self.total_tokens, device=self.device)[None]
        ext, tl = self.num_text_tokens_ext, self.text_seq_len
        return ((seq >= tl) & (logit < ext)) | ((seq < tl) & (logit >= ext))

    def _full_key_mask(self, mask: Optional[torch.Tensor], n: int):
        """Text padding mask (b, text_seq_len) -> (b, n) key mask over the
        internal [<bos>, text, image] sequence."""
        if mask is None:
            return None
        b = mask.shape[0]
        ones = mask.new_ones
        return torch.cat((ones(b, 1), mask, ones(b, self.image_seq_len)), dim=1)[:, :n]

    # ------------------------------------------------------------ training

    def forward(self, text: torch.Tensor, image: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, return_loss: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """text (b, text_seq_len) raw ids; image (b, <= image_seq_len)
        token ids; mask the optional (b, text_seq_len) text key mask.
        Returns the float32 logits (b, n, total_tokens) with the logits
        mask set to NEG_INF, or with ``return_loss`` (the full image
        sequence needed) the weighted split cross-entropy. A call with a
        ``generator`` (on the model's device) drops out with masks drawn
        from it; one without is deterministic."""
        if text.shape[-1] != self.text_seq_len:
            raise ValueError(f"text length {text.shape[-1]} != text_seq_len "
                             f"{self.text_seq_len}")
        text = self.remap_text(text)
        tokens = self.text_emb(text)
        if not self.rotary_emb:
            tokens = tokens + self.text_pos_emb.weight[None]
        if image is not None and image.shape[1] > 0:
            image_tokens = self.image_emb(image)
            if not self.rotary_emb:
                image_tokens = image_tokens + self.image_pos_emb(image.shape[1])
            tokens = torch.cat((tokens, image_tokens), dim=1)
        tokens = tokens[:, :self.total_seq_len]  # the last token predicts nothing
        n = tokens.shape[1]
        out = self.transformer(tokens.to(self.dtype),
                               mask=self._full_key_mask(mask, n), generator=generator)
        normed = self._final_norm(out)
        if not return_loss:
            logits = self.to_logits(normed.to(self.dtype)).float()
            return logits.masked_fill(self.logits_mask(n), NEG_INF)
        if image is None or image.shape[1] != self.image_seq_len:
            raise ValueError("the loss needs the full image sequence of "
                             f"{self.image_seq_len} tokens")
        return self._split_head_loss(normed, text, image)

    def _split_head_loss(self, normed, text, image) -> torch.Tensor:
        """Weighted split cross-entropy over the two live blocks of the
        block-diagonal head (the masked logits have probability 0, so this
        is the masked cross-entropy exactly): text positions predict
        ``text[:, 1:]`` over the ``[:ext]`` rows of ``to_logits``, image
        positions ``image`` over ``[ext:]``; logsumexp in float32; the two
        means weighted (text + loss_img_weight * image) / (1 + weight). The
        two blocks' logits are in the compute dtype, as JAX's are."""
        ext, tl = self.num_text_tokens_ext, self.text_seq_len
        h = normed.to(self.dtype)
        w, bias = (t.to(self.dtype) for t in (self.to_logits.weight, self.to_logits.bias))

        def segment_ll(hidden, rows, labels):
            logits = nn.functional.linear(hidden, w[rows], bias[rows])
            lse = torch.logsumexp(logits.float(), dim=-1)
            picked = logits.gather(-1, labels[..., None].long())[..., 0]
            return picked.float() - lse

        loss_text = -segment_ll(h[:, :tl], slice(None, ext), text[:, 1:]).mean()
        loss_img = -segment_ll(h[:, tl:], slice(ext, None), image).mean()
        weight = self.loss_img_weight
        return (loss_text + weight * loss_img) / (weight + 1)

    # ------------------------------------------------------------ decode

    @torch.no_grad()
    def fused_step(self, tokens, start, length, final, cache,
                   rowwise_head: bool = True, depth_limit: Optional[int] = None,
                   verify_cols: Optional[int] = None):
        """One RAGGED block step of a mixed prefill+decode iteration.

        tokens (b, W): row b's valid tokens are columns [0, length[b]) at
        internal positions start[b] + j — a decode row one image token, a
        prefill-chunk row up to W remapped text ids, an idle row none.
        ``cache`` (``sampling.DecodeCache``) is updated in place: valid
        columns' K/V are written, indices and rings advance by length.
        Returns (b, num_image_tokens) float32 image logits at each row's
        last valid column (garbage for idle rows). ``final`` (b,) bool
        marks rows whose sample is a prefill's first image token; with
        ``rowwise_head`` those rows take their logits from a per-row
        M=1 head (the reference's split-prefill head shape), the others
        from the batched head.

        Speculative decode (``serving/engine.py``): ``depth_limit`` runs
        only the first that many layers (the early-exit drafter; the
        final norm and head apply to that layer's output).
        ``verify_cols`` = k also returns the image logits at each of the
        block's first k columns, (b, k, num_image_tokens), as the pair
        (columns, last-column logits): a verify row's column j predicts
        position start + j + 1. Each column's head is its own (b, dim)
        product, the shape the batched head has, so a verify column's
        logits are those a plain decode step at that position computes
        (JAX's ``all_logits`` runs one (b * W)-row product, which torch's
        CPU GEMM would part from the b-row one in the last bits)."""
        b, n = tokens.shape
        pos = start.long()[:, None] + torch.arange(n, device=tokens.device)
        is_text = pos < self.text_len_internal
        emb = torch.where(
            is_text[..., None],
            self.text_emb(tokens.clamp(0, self.num_text_tokens_ext - 1)),
            self.image_emb(tokens.clamp(0, self.num_image_tokens - 1)),
        )
        if not self.rotary_emb:
            emb = emb + self._pos_emb(pos)
        out = self.transformer(emb.to(self.dtype), cache, block_len=length,
                               block_start=start, depth_limit=depth_limit)
        last = (length.long() - 1).clamp(0, n - 1)
        h_last = out.gather(1, last[:, None, None].expand(b, 1, self.dim))
        logits = self._head_image(h_last)[:, 0]
        if b > 1 and rowwise_head:
            rowwise = torch.cat(
                [self._head_image(h_last[i:i + 1]) for i in range(b)]
            )[:, 0]
            logits = torch.where(final[:, None], rowwise, logits)
        if verify_cols is None:
            return logits
        cols = torch.stack([self._head_image(out[:, j:j + 1].contiguous())[:, 0]
                            for j in range(verify_cols)], dim=1)
        return cols, logits

    def _decode_block(self, emb, pos, cache, mask, fused_decode: Optional[bool] = None):
        """emb (b, n, dim): n tokens at positions pos + j through the
        cached transformer, ``pos`` a Python int (the whole batch at one
        position) or a (b,) tensor of each row's position (the cache's key
        mask is ``mask`` widened to every position)."""
        b, n, _ = emb.shape
        if torch.is_tensor(pos):
            start = pos.to(device=emb.device, dtype=torch.int32)
        else:
            start = torch.full((b,), pos, dtype=torch.int32, device=emb.device)
        length = torch.full((b,), n, dtype=torch.int32, device=emb.device)
        return self.transformer(
            emb.to(self.dtype), cache, block_len=length, block_start=start,
            mask=self._full_key_mask(mask, self.transformer.attn_seq_len),
            fused_decode=fused_decode)

    @torch.no_grad()
    def prefill_step(self, tokens, cache, mask=None, image_only: bool = False) -> torch.Tensor:
        """The first T text positions in one parallel pass: tokens (b, T)
        remapped text ids (<bos> included), T <= text_len_internal, through
        ``cache`` (filled in place, every layer at position 0); ``mask``
        the optional (b, text_seq_len) text key mask. Returns the float32
        logits predicting position T: (b, total_tokens) with the logits
        mask's row T - 1, or with ``image_only`` (T must be the whole
        prompt, so position T is the first image position) the
        (b, num_image_tokens) image-vocab head. Equal to T ``decode_step``
        calls."""
        b, T = tokens.shape
        if T > self.text_len_internal:
            raise ValueError(f"prefill covers text positions only, got {T} > "
                             f"{self.text_len_internal}")
        if image_only and T != self.text_len_internal:
            raise ValueError("image_only prefill needs the whole prompt: position T "
                             "must be the first image position")
        return self.prefill_chunk(tokens, 0, cache, mask, image_only=image_only)

    @torch.no_grad()
    def prefill_chunk(self, tokens, start: int, cache, mask=None, return_logits: bool = True,
                      image_only: bool = False) -> Optional[torch.Tensor]:
        """Text positions [start, start + c) of the prompt over the
        already-written cache (one budget-bounded slice of a prefill, so a
        serving loop can interleave prompt work with decode steps):
        tokens (b, c) remapped text ids, ``start`` a Python int. Chunks
        covering [0, T) fill the cache as one ``prefill_step`` over the
        same tokens does. Returns the float32 logits predicting position
        start + c: (b, total_tokens) with the logits mask's row
        start + c - 1, or with ``image_only`` (the chunk must end the
        prompt) the (b, num_image_tokens) image-vocab head; None with
        ``return_logits=False`` (an intermediate chunk skips the head)."""
        b, c = tokens.shape
        end = start + c
        if not 0 <= start < end <= self.text_len_internal:
            raise ValueError(f"prefill chunks cover text positions only, got "
                             f"[{start}, {end}) of {self.text_len_internal}")
        emb = self.text_emb(tokens)
        if not self.rotary_emb:
            emb = emb + self.text_pos_emb.weight[start:end]
        out = self._decode_block(emb, start, cache, mask)
        if image_only:
            if end != self.text_len_internal:
                raise ValueError("an image_only chunk must end the prompt: position "
                                 f"{end} is not the first image position")
            return self._head_image(out[:, -1:])[:, 0]
        if not return_logits:
            return None
        logits = self._head(out[:, -1:])[:, 0]
        return logits.masked_fill(self.logits_mask_row(end - 1), NEG_INF)

    @torch.no_grad()
    def decode_step(self, token, pos, cache, mask=None, image_only: bool = False,
                    fused_decode: Optional[bool] = None) -> torch.Tensor:
        """One cached decode step for the whole batch: token (b,) the id
        at internal position ``pos``, a remapped text id below
        text_len_internal, else an image id; the embedding is chosen by
        the position. ``pos`` is a Python int (every row at one position)
        or a (b,) tensor of each row's position (rows of a serving batch;
        the paged cache only, its rows written at their own positions).
        Returns the float32 logits predicting pos + 1: (b, total_tokens)
        with the logits mask's row at each row's ``pos``, or with
        ``image_only`` (pos + 1 an image position) the image-vocab head.
        ``fused_decode`` chooses the dense cache's causal "full" layers'
        route: None (default) the fused decode kernel on the card and the
        unfused chain on the CPU, True the kernel (on the CPU under JAX's
        gate), False the unfused chain (``Attention.uses_decode_kernel``)."""
        text_emb = lambda: self.text_emb(token.clamp(0, self.num_text_tokens_ext - 1))  # noqa: E731
        image_emb = lambda: self.image_emb(token.clamp(0, self.num_image_tokens - 1))  # noqa: E731
        ragged = torch.is_tensor(pos)
        if ragged:
            if not all(isinstance(kv, PagedKV) for kv in cache.kv):
                raise ValueError("per-row decode positions need the paged cache format "
                                 '(init_decode_cache(..., cache_format="paged"))')
            pos = pos.to(token.device)
            is_text = (pos < self.text_len_internal)[:, None]
            emb = torch.where(is_text, text_emb(), image_emb())
        else:
            emb = text_emb() if pos < self.text_len_internal else image_emb()
        if not self.rotary_emb:
            emb = emb + self._pos_emb(pos)
        out = self._decode_block(emb[:, None], pos, cache, mask, fused_decode)
        if image_only:
            return self._head_image(out)[:, 0]
        logits = self._head(out)[:, 0]
        if ragged:
            return logits.masked_fill(self.logits_mask_rows(pos), NEG_INF)
        return logits.masked_fill(self.logits_mask_row(pos), NEG_INF)
