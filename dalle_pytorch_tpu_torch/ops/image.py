"""Image resize with JAX's ``jax.image.resize(..., "bilinear")`` semantics
(the rerank stage resizes the VAE's pixels to CLIP's resolution with it).

That function is ``scale_and_translate`` with the triangle kernel and
antialias on: half-pixel centres, the kernel widened by the scale when
downsampling, weights normalised per output pixel, one weight-matrix
product per resized axis. An axis whose size does not change is left
untouched, so an equal-size resize is the identity.
``torch.nn.functional.interpolate`` is close to it but not the same
function (it does not widen the kernel when downsampling).
"""

from __future__ import annotations

import numpy as np
import torch


def _weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of JAX's ``compute_weight_mat``
    for the triangle kernel with antialias."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float32) + 0.5) * np.float32(inv_scale) - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - np.abs(x)).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_bilinear(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(b, h, w, c) NHWC float -> (b, height, width, c) in the same dtype."""
    _, h, w, _ = images.shape
    if h != height:
        wh = torch.from_numpy(_weights(h, height)).to(images.device, images.dtype)
        images = torch.einsum("bhwc,hy->bywc", images, wh)
    if w != width:
        ww = torch.from_numpy(_weights(w, width)).to(images.device, images.dtype)
        images = torch.einsum("bhwc,wx->bhxc", images, ww)
    return images
