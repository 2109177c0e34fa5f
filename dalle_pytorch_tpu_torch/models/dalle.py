"""DALL-E text->image transformer, serving form (counterpart of
``dalle_pytorch_tpu/models/dalle.py``).

The vocabulary is [text | per-position text pads | image]: ``remap_text``
gives each padding-0 text position its own id and prepends <bos> = 0.
``fused_step`` runs one ragged block of a mixed prefill+decode serving
iteration through the cached transformer and returns image-only logits
at each row's last valid column. Only the rotary, causal "full" decode
path is ported; the training forward and loss come in a later slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.layers import LayerNorm32, seeded_init_
from .transformer import Transformer


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
    by ``text_seq_len`` per-position padding ids. Parameters are created on
    ``device`` in ``dtype`` (the compute dtype), LayerNorm and LayerScale
    parameters in float32."""

    def __init__(self, *, dim: int, depth: int, num_text_tokens: int = 10000,
                 text_seq_len: int = 256, num_image_tokens: int = 512,
                 image_fmap_size: int = 32, heads: int = 8,
                 dim_head: int = 64,
                 attn_types: Optional[Tuple[str, ...]] = None,
                 shift_tokens: bool = True, rotary_emb: bool = True,
                 stable: bool = False, reversible: bool = False,
                 remat: bool = False, serve_quant: bool = False,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        for name, value in (("stable", stable), ("serve_quant", serve_quant),
                            ("rotary_emb=False", not rotary_emb)):
            if value:
                raise NotImplementedError(f"DALLE({name}) is not ported")
        self.dim, self.depth = dim, depth
        self.heads, self.dim_head = heads, dim_head
        self.num_text_tokens = num_text_tokens
        self.text_seq_len = text_seq_len
        self.num_image_tokens = num_image_tokens
        self.image_fmap_size = image_fmap_size
        self.device, self.dtype = torch.device(device), dtype

        self.text_emb = nn.Embedding(self.num_text_tokens_ext, dim,
                                     device=device, dtype=dtype)
        self.image_emb = nn.Embedding(num_image_tokens, dim, device=device,
                                      dtype=dtype)
        self.transformer = Transformer(
            dim=dim, depth=depth, seq_len=self.total_seq_len, heads=heads,
            dim_head=dim_head, attn_types=attn_types,
            image_fmap_size=image_fmap_size, shift_tokens=shift_tokens,
            rotary_emb=rotary_emb, reversible=reversible, remat=remat,
            device=device, dtype=dtype,
        )
        self.final_norm = LayerNorm32(dim, device=device)
        self.to_logits = nn.Linear(dim, self.total_tokens, device=device,
                                   dtype=dtype)

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

    def _head_image(self, out: torch.Tensor) -> torch.Tensor:
        """Image-vocab-only head: the ``[ext:]`` rows of ``to_logits`` on
        the final-normed hidden states; float32 logits."""
        ext = self.num_text_tokens_ext
        normed = self.final_norm(out).to(self.dtype)
        logits = nn.functional.linear(
            normed, self.to_logits.weight[ext:], self.to_logits.bias[ext:]
        )
        return logits.float()

    # ------------------------------------------------------------ decode

    @torch.no_grad()
    def fused_step(self, tokens, start, length, final, cache,
                   rowwise_head: bool = True) -> torch.Tensor:
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
        from the batched head."""
        b, n = tokens.shape
        pos = start.long()[:, None] + torch.arange(n, device=tokens.device)
        is_text = pos < self.text_len_internal
        emb = torch.where(
            is_text[..., None],
            self.text_emb(tokens.clamp(0, self.num_text_tokens_ext - 1)),
            self.image_emb(tokens.clamp(0, self.num_image_tokens - 1)),
        )
        out = self.transformer(emb.to(self.dtype), cache, block_len=length,
                               block_start=start)
        last = (length.long() - 1).clamp(0, n - 1)
        h_last = out.gather(1, last[:, None, None].expand(b, 1, self.dim))
        batched = self._head_image(h_last)[:, 0]
        if b == 1 or not rowwise_head:
            return batched
        rowwise = torch.cat(
            [self._head_image(h_last[i:i + 1]) for i in range(b)]
        )[:, 0]
        return torch.where(final[:, None], rowwise, batched)
