"""Discrete VAE, encoder and decoder (counterpart of
``dalle_pytorch_tpu/models/vae.py``).

Encode: pixels in [0, 1] -> channel normalization -> ``num_layers``
stride-2 4x4 convs (padding 1, flax's ``padding=1``) + ReLU ->
[ResBlocks] -> 1x1 conv to ``num_tokens`` logits -> argmax token ids.
Decode: token ids -> codebook features -> [1x1 conv + ResBlocks] ->
``num_layers`` stride-2 transposed convs + ReLU -> 1x1 conv to pixels.
The public functions keep the reference's NHWC layout; the convolutions
run NCHW inside. The Gumbel relaxation and the VAE loss come with the
VAE trainer.

The reference's flax ``ConvTranspose(4, strides=2, padding="SAME")`` is a
correlation of the stride-dilated input, padded by 2 on each side, with
the UNFLIPPED kernel. ``nn.ConvTranspose2d(4, stride=2, padding=1)`` is
the same correlation with the kernel flipped, so the converter
(``convert.py``) flips it spatially and swaps HWIO to (in, out, kh, kw).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


# the reference's channel (means, stds)
NORMALIZATION = ((0.5,) * 3, (0.5,) * 3)


def denormalize(images: torch.Tensor, normalization=NORMALIZATION) -> torch.Tensor:
    """Invert the VAE's channel normalization for display: x * std + mean
    over NHWC channels, clipped to [0, 1]."""
    means, stds = (torch.tensor(t, dtype=images.dtype, device=images.device)
                   for t in normalization)
    return (images * stds + means).clamp(0.0, 1.0)


class ResBlock(nn.Module):
    """3x3 -> 3x3 -> 1x1 residual conv block (NCHW)."""

    def __init__(self, chan: int, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv0 = nn.Conv2d(chan, chan, 3, padding=1, **kw)
        self.conv1 = nn.Conv2d(chan, chan, 3, padding=1, **kw)
        self.conv2 = nn.Conv2d(chan, chan, 1, **kw)

    def forward(self, x):
        h = F.relu(self.conv0(x))
        h = F.relu(self.conv1(h))
        return self.conv2(h) + x


class DiscreteVAE(nn.Module):
    """The Gumbel-softmax discrete VAE over NHWC images: the hard-argmax
    encoder that DALL-E training feeds on, and the decoder."""

    def __init__(self, *, image_size: int = 256, num_tokens: int = 512,
                 codebook_dim: int = 512, num_layers: int = 3,
                 num_resnet_blocks: int = 0, hidden_dim: int = 64,
                 channels: int = 3, device="cuda", dtype=torch.float32):
        super().__init__()
        if not math.log2(image_size).is_integer():
            raise ValueError(f"image size must be a power of 2, got {image_size}")
        if num_layers < 1:
            raise ValueError(f"number of layers must be >= 1, got {num_layers}")
        kw = dict(device=device, dtype=dtype)
        self.image_size, self.num_layers = image_size, num_layers
        self.num_tokens = num_tokens
        self.codebook_dim = codebook_dim
        self.codebook = nn.Embedding(num_tokens, codebook_dim, **kw)
        self.enc_convs = nn.ModuleList(
            nn.Conv2d(channels if i == 0 else hidden_dim, hidden_dim, 4,
                      stride=2, padding=1, **kw)
            for i in range(num_layers)
        )
        self.enc_res = nn.ModuleList(
            ResBlock(hidden_dim, **kw) for _ in range(num_resnet_blocks)
        )
        self.enc_out = nn.Conv2d(hidden_dim, num_tokens, 1, **kw)
        self.dec_in = (
            nn.Conv2d(codebook_dim, hidden_dim, 1, **kw)
            if num_resnet_blocks > 0 else None
        )
        self.dec_res = nn.ModuleList(
            ResBlock(hidden_dim, **kw) for _ in range(num_resnet_blocks)
        )
        chans = [hidden_dim if num_resnet_blocks > 0 else codebook_dim]
        chans += [hidden_dim] * num_layers
        self.dec_convs = nn.ModuleList(
            nn.ConvTranspose2d(chans[i], chans[i + 1], 4, stride=2, padding=1,
                               **kw)
            for i in range(num_layers)
        )
        self.dec_out = nn.Conv2d(hidden_dim, channels, 1, **kw)

    @property
    def fmap_size(self) -> int:
        return self.image_size // (2**self.num_layers)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DiscreteVAE":
        """Seeded random weights: each conv weight N(0, 1 / fan_in) (taps
        per output: kernel area over stride area), biases 0, codebook
        N(0, 1). ``generator`` lives on the model's device."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                taps = (m.kernel_size[0] * m.kernel_size[1]
                        // (m.stride[0] * m.stride[1]))
                nn.init.normal_(m.weight, std=(m.in_channels * taps) ** -0.5,
                                generator=generator)
                nn.init.zeros_(m.bias)
        nn.init.normal_(self.codebook.weight, generator=generator)
        return self

    def norm(self, images: torch.Tensor) -> torch.Tensor:
        """Channelwise (x - mean) / std over NHWC channels."""
        means, stds = (torch.tensor(t, dtype=images.dtype, device=images.device)
                       for t in NORMALIZATION)
        return (images - means) / stds

    def encode_logits(self, img: torch.Tensor) -> torch.Tensor:
        """img (b, h, w, c) in [0, 1] -> (b, f, f, num_tokens) logits."""
        x = self.norm(img).to(self.enc_out.weight.dtype).permute(0, 3, 1, 2)
        for conv in self.enc_convs:
            x = F.relu(conv(x))
        for block in self.enc_res:
            x = block(x)
        return self.enc_out(x).permute(0, 2, 3, 1)

    @torch.no_grad()
    def get_codebook_indices(self, img: torch.Tensor) -> torch.Tensor:
        """Hard-argmax token ids (b, f*f) of images (b, h, w, c) in [0, 1]:
        the no-grad encode that feeds DALL-E training."""
        logits = self.encode_logits(img)
        return logits.argmax(dim=-1).reshape(logits.shape[0], -1)

    def decode(self, img_seq: torch.Tensor) -> torch.Tensor:
        """Token ids (b, n) -> pixels (b, h, w, c), normalized space."""
        b, n = img_seq.shape
        f = math.isqrt(n)
        x = self.codebook(img_seq).reshape(b, f, f, self.codebook_dim)
        x = x.permute(0, 3, 1, 2)
        if self.dec_in is not None:
            x = self.dec_in(x)
        for block in self.dec_res:
            x = block(x)
        for conv in self.dec_convs:
            x = F.relu(conv(x))
        return self.dec_out(x).permute(0, 2, 3, 1)
