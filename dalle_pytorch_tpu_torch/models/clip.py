"""CLIP dual encoder for generation reranking (counterpart of
``dalle_pytorch_tpu/models/clip.py``).

A text transformer and a ViT-style patch image transformer, both
non-causal without rotary; masked-mean (text) and mean (image) pooling,
bias-free latent projections, float32 L2-normalised latents and a learned
temperature used as ``exp(temperature)``. Only the similarity
(``return_loss=False``) is ported; the InfoNCE loss comes with training.
At the reference's widths (text_seq_len 256, 8 heads of 64) every text
layer runs the packed-qkv kernel; the image encoder (64 patches) runs
the dense path.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.layers import seeded_init_
from .transformer import Transformer


def masked_mean(t: torch.Tensor, mask: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Mean over ``dim`` counting only True positions."""
    t = torch.where(mask[..., None], t, torch.zeros((), dtype=t.dtype, device=t.device))
    return t.sum(dim=dim) / mask.sum(dim=dim)[..., None]


class CLIP(nn.Module):
    """Parameters are created on ``device`` in ``dtype`` (the compute
    dtype), LayerNorm, LayerScale and the temperature in float32.
    ``num_visual_tokens`` is accepted so the reference's configurations
    construct this model; like the reference, nothing uses it."""

    def __init__(self, *, dim_text: int = 512, dim_image: int = 512,
                 dim_latent: int = 512, num_text_tokens: int = 10000,
                 text_enc_depth: int = 6, text_seq_len: int = 256,
                 text_heads: int = 8, text_dim_head: int = 64,
                 num_visual_tokens: int = 512, visual_enc_depth: int = 6,
                 visual_heads: int = 8, visual_dim_head: int = 64,
                 visual_image_size: int = 256, visual_patch_size: int = 32,
                 channels: int = 3, device="cuda", dtype=torch.float32):
        super().__init__()
        if visual_image_size % visual_patch_size != 0:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        kw = dict(device=device, dtype=dtype)
        self.text_seq_len = text_seq_len
        self.visual_image_size = visual_image_size
        self.visual_patch_size = visual_patch_size
        self.dtype = dtype
        self.num_patches = (visual_image_size // visual_patch_size) ** 2

        self.text_emb = nn.Embedding(num_text_tokens, dim_text, **kw)
        self.text_pos_emb = nn.Embedding(text_seq_len, dim_text, **kw)
        self.text_transformer = Transformer(
            dim=dim_text, depth=text_enc_depth, seq_len=text_seq_len,
            causal=False, heads=text_heads, dim_head=text_dim_head,
            rotary_emb=False, **kw,
        )
        self.to_text_latent = nn.Linear(dim_text, dim_latent, bias=False, **kw)

        self.to_visual_embedding = nn.Linear(
            channels * visual_patch_size**2, dim_image, **kw)
        self.visual_pos_emb = nn.Embedding(self.num_patches, dim_image, **kw)
        self.visual_transformer = Transformer(
            dim=dim_image, depth=visual_enc_depth, seq_len=self.num_patches,
            causal=False, heads=visual_heads, dim_head=visual_dim_head,
            rotary_emb=False, **kw,
        )
        self.to_visual_latent = nn.Linear(dim_image, dim_latent, bias=False, **kw)
        self.temperature = nn.Parameter(
            torch.ones((), dtype=torch.float32, device=device))

    def init_weights(self, generator: torch.Generator) -> "CLIP":
        """Seeded random weights (``layers.seeded_init_``); the
        temperature keeps its init."""
        seeded_init_(self, generator)
        return self

    def patchify(self, image: torch.Tensor) -> torch.Tensor:
        """(b, h, w, c) NHWC -> (b, num_patches, p*p*c), features ordered
        (row in patch, column in patch, channel)."""
        p = self.visual_patch_size
        b, h, w, c = image.shape
        image = image.reshape(b, h // p, p, w // p, p, c)
        return image.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p), p * p * c)

    def forward(self, text: torch.Tensor, image: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """text (b, text_seq_len) int ids, image (b, h, w, c) pixels,
        text_mask (b, text_seq_len) bool. Returns the per-pair similarity
        (b,) float32."""
        n = text.shape[1]
        pos = torch.arange(n, device=text.device)
        text_tokens = self.text_emb(text) + self.text_pos_emb(pos)[None]

        patches = self.patchify(image.to(self.dtype))
        image_tokens = self.to_visual_embedding(patches)
        pos = torch.arange(image_tokens.shape[1], device=image.device)
        image_tokens = image_tokens + self.visual_pos_emb(pos)[None]

        enc_text = self.text_transformer(text_tokens, mask=text_mask)
        enc_image = self.visual_transformer(image_tokens)

        if text_mask is not None:
            text_latents = masked_mean(enc_text, text_mask, dim=1)
        else:
            text_latents = enc_text.mean(dim=1)
        image_latents = enc_image.mean(dim=1)

        text_latents = self.to_text_latent(text_latents).float()
        image_latents = self.to_visual_latent(image_latents).float()
        text_latents = text_latents / text_latents.norm(dim=-1, keepdim=True)
        image_latents = image_latents / image_latents.norm(dim=-1, keepdim=True)
        return (text_latents * image_latents).sum(dim=-1) * self.temperature.exp()
