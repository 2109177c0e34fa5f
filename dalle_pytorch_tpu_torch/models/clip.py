"""CLIP dual encoder for generation reranking (counterpart of
``dalle_pytorch_tpu/models/clip.py``).

A text transformer and a ViT-style patch image transformer, both
non-causal without rotary; masked-mean (text) and mean (image) pooling,
bias-free latent projections, float32 L2-normalised latents and a learned
temperature used as ``exp(temperature)``. The forward returns each
pair's similarity, or with ``return_loss`` the symmetric InfoNCE loss of
the batch: the (b, b) similarities of every text with every image times
``exp(temperature)``, and the mean of the cross-entropies of its rows and
of its columns against the diagonal. At the reference's widths
(text_seq_len 256, 8 heads of 64) every text layer runs the packed-qkv
kernel, forward and backward, non-causal with the key mask; the image
encoder (64 patches) runs the dense path.

Mixed precision is flax's: ``dtype`` the compute type, ``param_dtype``
the parameters' (default ``dtype``). The text tokens (embedding plus
positions, in the parameters' type) are cast to ``dtype`` before the
text encoder; the image tokens are the patch projection (in ``dtype``)
plus the positions (in the parameters' type), whose sum takes the wider
type, as JAX's promotion does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.layers import Linear, seeded_init_
from .transformer import Transformer


def masked_mean(t: torch.Tensor, mask: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Mean over ``dim`` counting only True positions."""
    t = torch.where(mask[..., None], t, torch.zeros((), dtype=t.dtype, device=t.device))
    return t.sum(dim=dim) / mask.sum(dim=dim)[..., None]


class CLIP(nn.Module):
    """Parameters are created on ``device`` in ``param_dtype`` (default
    ``dtype``, the compute dtype), LayerNorm, LayerScale and the
    temperature in float32. ``num_visual_tokens`` is accepted so the
    reference's configurations construct this model; like the reference,
    nothing uses it. The constructor's arguments are kept as attributes
    of the same names (``models.factory.clip_config`` reads them)."""

    def __init__(self, *, dim_text: int = 512, dim_image: int = 512,
                 dim_latent: int = 512, num_text_tokens: int = 10000,
                 text_enc_depth: int = 6, text_seq_len: int = 256,
                 text_heads: int = 8, text_dim_head: int = 64,
                 num_visual_tokens: int = 512, visual_enc_depth: int = 6,
                 visual_heads: int = 8, visual_dim_head: int = 64,
                 visual_image_size: int = 256, visual_patch_size: int = 32,
                 channels: int = 3, device="cuda", dtype=torch.float32, param_dtype=None):
        super().__init__()
        if visual_image_size % visual_patch_size != 0:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        self.dim_text, self.dim_image, self.dim_latent = dim_text, dim_image, dim_latent
        self.num_text_tokens, self.text_enc_depth = num_text_tokens, text_enc_depth
        self.text_seq_len, self.text_heads, self.text_dim_head = (
            text_seq_len, text_heads, text_dim_head)
        self.num_visual_tokens, self.visual_enc_depth = num_visual_tokens, visual_enc_depth
        self.visual_heads, self.visual_dim_head = visual_heads, visual_dim_head
        self.visual_image_size = visual_image_size
        self.visual_patch_size = visual_patch_size
        self.channels = channels
        self.dtype, self.param_dtype = dtype, param_dtype or dtype
        self.num_patches = (visual_image_size // visual_patch_size) ** 2
        emb = dict(device=device, dtype=self.param_dtype)
        kw = dict(device=device, dtype=dtype, param_dtype=self.param_dtype)

        self.text_emb = nn.Embedding(num_text_tokens, dim_text, **emb)
        self.text_pos_emb = nn.Embedding(text_seq_len, dim_text, **emb)
        self.text_transformer = Transformer(
            dim=dim_text, depth=text_enc_depth, seq_len=text_seq_len,
            causal=False, heads=text_heads, dim_head=text_dim_head,
            rotary_emb=False, **kw,
        )
        self.to_text_latent = Linear(dim_text, dim_latent, bias=False, **kw)

        self.to_visual_embedding = Linear(channels * visual_patch_size**2, dim_image, **kw)
        self.visual_pos_emb = nn.Embedding(self.num_patches, dim_image, **emb)
        self.visual_transformer = Transformer(
            dim=dim_image, depth=visual_enc_depth, seq_len=self.num_patches,
            causal=False, heads=visual_heads, dim_head=visual_dim_head,
            rotary_emb=False, **kw,
        )
        self.to_visual_latent = Linear(dim_image, dim_latent, bias=False, **kw)
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
                text_mask: Optional[torch.Tensor] = None,
                return_loss: bool = False) -> torch.Tensor:
        """text (b, text_seq_len) int ids, image (b, h, w, c) pixels,
        text_mask (b, text_seq_len) bool. Returns the per-pair similarity
        (b,) float32, or with ``return_loss`` the symmetric InfoNCE loss
        of the batch (float32)."""
        text_latents, image_latents = self.latents(text, image, text_mask)
        temp = self.temperature.float().exp()
        if not return_loss:
            return (text_latents * image_latents).sum(dim=-1) * temp
        sim = text_latents @ image_latents.t() * temp
        labels = torch.arange(sim.shape[0], device=sim.device)[:, None]
        loss_t = -torch.log_softmax(sim, dim=-1).gather(-1, labels).mean()
        loss_i = -torch.log_softmax(sim.t(), dim=-1).gather(-1, labels).mean()
        return (loss_t + loss_i) / 2

    def latents(self, text: torch.Tensor, image: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None):
        """The L2-normalised float32 (text, image) latents, (b, dim_latent)
        each, of ``forward``'s inputs."""
        n = text.shape[1]
        pos = torch.arange(n, device=text.device)
        text_tokens = (self.text_emb(text) + self.text_pos_emb(pos)[None]).to(self.dtype)

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
        return text_latents, image_latents
