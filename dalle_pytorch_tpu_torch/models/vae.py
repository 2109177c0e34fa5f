"""Discrete VAE, encoder and decoder (counterpart of
``dalle_pytorch_tpu/models/vae.py``).

Encode: pixels in [0, 1] -> channel normalization -> ``num_layers``
stride-2 4x4 convs (padding 1, flax's ``padding=1``) + ReLU ->
[ResBlocks] -> 1x1 conv to ``num_tokens`` logits -> argmax token ids.
Decode: token ids -> codebook features -> [1x1 conv + ResBlocks] ->
``num_layers`` stride-2 transposed convs + ReLU -> 1x1 conv to pixels.
The public functions keep the reference's NHWC layout; the convolutions
run NCHW inside.

Training (``forward``, JAX's ``__call__``): the encoder's logits, a
Gumbel-softmax relaxation of them (``gumbel_softmax``; straight-through
with ``straight_through``) at temperature ``temp``, its product with the
codebook (one (b·f·f, num_tokens) x (num_tokens, d) matrix product), the
decoder, and the loss: the reconstruction error against ``norm(img)``
in float32 (MSE, or ``smooth_l1_loss``) plus ``kl_div_loss_weight``
times the KL divergence of the code distribution from the uniform one,
with the reference's "batchmean" over an input of size 1: the total sum.
The Gumbel noise is drawn from an explicit generator, or given.

The reference's flax ``ConvTranspose(4, strides=2, padding="SAME")`` is a
correlation of the stride-dilated input, padded by 2 on each side, with
the UNFLIPPED kernel. ``nn.ConvTranspose2d(4, stride=2, padding=1)`` is
the same correlation with the kernel flipped, so the converter
(``convert.py``) flips it spatially and swaps HWIO to (in, out, kh, kw).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block, the previous
    setting restored after."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


# the reference's channel (means, stds)
NORMALIZATION = ((0.5,) * 3, (0.5,) * 3)


def gumbel_noise(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise, float32: ``-log(-log(u))`` of uniform draws
    from ``generator`` (on ``device``) clipped to the smallest normal
    float32 above 0, as ``jax.random.gumbel`` draws it."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp(min=tiny)
    return -torch.log(-torch.log(u))


def gumbel_softmax(logits: torch.Tensor, gumbels: torch.Tensor, temperature: float,
                   hard: bool = False, dim: int = -1) -> torch.Tensor:
    """A relaxed one-hot sample of ``logits`` along ``dim`` given its
    Gumbel noise ``gumbels`` (float32, ``logits``' shape): the softmax of
    ``(logits + gumbels) / temperature`` in float32. ``hard`` is the
    straight-through estimator: the one-hot of its argmax forward, the
    soft sample's gradient backward. In ``logits``' dtype."""
    y_soft = torch.softmax((logits.float() + gumbels) / temperature, dim=dim)
    if not hard:
        return y_soft.to(logits.dtype)
    index = y_soft.argmax(dim=dim, keepdim=True)
    y_hard = torch.zeros_like(y_soft).scatter_(dim, index, 1.0)
    return (y_hard + y_soft - y_soft.detach()).to(logits.dtype)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Huber / smooth-L1 with torch's default beta 1, mean reduction."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff**2 / beta, diff - 0.5 * beta).mean()


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
    encoder that DALL-E training feeds on, the decoder, and the training
    forward. ``smooth_l1_loss``, ``temperature`` (the default ``temp``),
    ``straight_through`` and ``kl_div_loss_weight`` are JAX's fields."""

    def __init__(self, *, image_size: int = 256, num_tokens: int = 512,
                 codebook_dim: int = 512, num_layers: int = 3,
                 num_resnet_blocks: int = 0, hidden_dim: int = 64,
                 channels: int = 3, smooth_l1_loss: bool = False,
                 temperature: float = 0.9, straight_through: bool = False,
                 kl_div_loss_weight: float = 0.0, device="cuda", dtype=torch.float32):
        super().__init__()
        if not math.log2(image_size).is_integer():
            raise ValueError(f"image size must be a power of 2, got {image_size}")
        if num_layers < 1:
            raise ValueError(f"number of layers must be >= 1, got {num_layers}")
        kw = dict(device=device, dtype=dtype)
        self.image_size, self.num_layers = image_size, num_layers
        self.num_tokens = num_tokens
        self.num_resnet_blocks, self.hidden_dim = num_resnet_blocks, hidden_dim
        self.channels = channels
        self.codebook_dim = codebook_dim
        self.smooth_l1_loss, self.temperature = smooth_l1_loss, temperature
        self.straight_through, self.kl_div_loss_weight = straight_through, kl_div_loss_weight
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
        """Token ids (b, n) -> pixels (b, h, w, c), normalized space.
        cuDNN runs the transposed convolutions through its deterministic
        algorithms (with TF32 off some of the others reduce with atomics),
        so the pixels are a function of the tokens."""
        b, n = img_seq.shape
        f = math.isqrt(n)
        with cudnn_deterministic():
            return self._decode_embeds(self.codebook(img_seq).reshape(b, f, f, self.codebook_dim))

    def _decode_embeds(self, embeds: torch.Tensor) -> torch.Tensor:
        """Codebook features (b, f, f, codebook_dim) -> pixels (b, h, w, c)."""
        x = embeds.to(self.dec_out.weight.dtype).permute(0, 3, 1, 2)
        if self.dec_in is not None:
            x = self.dec_in(x)
        for block in self.dec_res:
            x = block(x)
        for conv in self.dec_convs:
            x = F.relu(conv(x))
        return self.dec_out(x).permute(0, 2, 3, 1)

    def forward(self, img: torch.Tensor, return_loss: bool = False,
                return_recons: bool = False, return_logits: bool = False,
                temp: Optional[float] = None, generator: Optional[torch.Generator] = None,
                gumbels: Optional[torch.Tensor] = None):
        """img (b, h, w, c) in [0, 1]. Returns the encoder's logits with
        ``return_logits``; else the reconstruction (b, h, w, c) in
        normalized space through a Gumbel-softmax sample at ``temp``
        (default ``temperature``), the noise ``gumbels`` or drawn from
        ``generator``; with ``return_loss`` the loss instead, and with
        ``return_recons`` too (loss, reconstruction)."""
        if img.shape[1] != self.image_size or img.shape[2] != self.image_size:
            raise ValueError(f"input must have the correct image size {self.image_size}")
        logits = self.encode_logits(img)
        if return_logits:
            return logits
        if gumbels is None:
            if generator is None:
                raise ValueError("the Gumbel sample needs a generator or given noise")
            gumbels = gumbel_noise(logits.shape, generator, logits.device)
        temp = self.temperature if temp is None else temp
        soft_one_hot = gumbel_softmax(logits, gumbels.to(logits.device), temp,
                                      hard=self.straight_through)
        sampled = torch.einsum("bhwn,nd->bhwd", soft_one_hot,
                               self.codebook.weight.to(soft_one_hot.dtype))
        out = self._decode_embeds(sampled)
        if not return_loss:
            return out
        target = self.norm(img).float()
        recon = (smooth_l1_loss(out.float(), target) if self.smooth_l1_loss
                 else ((out.float() - target) ** 2).mean())
        log_qy = torch.log_softmax(logits.float(), dim=-1)
        log_uniform = -torch.tensor(float(self.num_tokens), device=logits.device).log()
        kl_div = (log_qy.exp() * (log_qy - log_uniform)).sum()
        loss = recon + kl_div * self.kl_div_loss_weight
        return (loss, out) if return_recons else loss
