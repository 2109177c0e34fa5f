"""DALL-E text->image transformer (counterpart of
``dalle_pytorch_tpu/models/dalle.py``).

The vocabulary is [text | per-position text pads | image]: ``remap_text``
gives each padding-0 text position its own id and prepends <bos> = 0.
Two forms, both rotary, causal "full" attention:

- ``forward`` (training): the whole [<bos>, text, image] sequence minus
  its trailing token through the transformer; the float32 logits with
  the block-diagonal logits mask, or the weighted split cross-entropy.
- ``fused_step`` (serving): one ragged block of a mixed prefill+decode
  iteration through the cached transformer; image-only logits at each
  row's last valid column.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.layers import LayerNorm32, seeded_init_
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
    by ``text_seq_len`` per-position padding ids. Parameters are created on
    ``device`` in ``dtype`` (the compute dtype), LayerNorm and LayerScale
    parameters in float32."""

    def __init__(self, *, dim: int, depth: int, num_text_tokens: int = 10000,
                 text_seq_len: int = 256, num_image_tokens: int = 512,
                 image_fmap_size: int = 32, heads: int = 8,
                 dim_head: int = 64,
                 attn_types: Optional[Tuple[str, ...]] = None,
                 shift_tokens: bool = True, rotary_emb: bool = True,
                 loss_img_weight: float = 7.0, stable: bool = False,
                 reversible: bool = False, remat: bool = False,
                 serve_quant: bool = False, device="cuda",
                 dtype=torch.float32):
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
        self.loss_img_weight = loss_img_weight
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
                mask: Optional[torch.Tensor] = None,
                return_loss: bool = False) -> torch.Tensor:
        """text (b, text_seq_len) raw ids; image (b, <= image_seq_len)
        token ids; mask the optional (b, text_seq_len) text key mask.
        Returns the float32 logits (b, n, total_tokens) with the logits
        mask set to NEG_INF, or with ``return_loss`` (the full image
        sequence needed) the weighted split cross-entropy."""
        if text.shape[-1] != self.text_seq_len:
            raise ValueError(f"text length {text.shape[-1]} != text_seq_len "
                             f"{self.text_seq_len}")
        text = self.remap_text(text)
        tokens = self.text_emb(text)
        if image is not None and image.shape[1] > 0:
            tokens = torch.cat((tokens, self.image_emb(image)), dim=1)
        tokens = tokens[:, :self.total_seq_len]  # the last token predicts nothing
        n = tokens.shape[1]
        out = self.transformer(tokens.to(self.dtype),
                               mask=self._full_key_mask(mask, n))
        normed = self.final_norm(out)
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
        means weighted (text + loss_img_weight * image) / (1 + weight)."""
        ext, tl = self.num_text_tokens_ext, self.text_seq_len
        h = normed.to(self.dtype)
        w, bias = self.to_logits.weight, self.to_logits.bias

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
