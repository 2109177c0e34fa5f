"""DALL-E rotary position embeddings (counterpart of
``dalle_pytorch_tpu/ops/rotary.py``).

The angle table is numpy, built once per model: text positions carry 1-D
rotary angles and image positions 2-D axial angles, each modality pinned
to a far-away constant position in the other's coordinates (image at 8192
in the text part, text at -10 in the axial part), and the trailing
position dropped because the model never feeds its final token. Rotation
applies to q, k AND v. ``rot_tables`` gives the packed-qkv path its
cos/sin operands; the kernel there rotates each channel with its pair
partner directly, so JAX's signed-permutation matrix is not needed.
"""

from __future__ import annotations

import numpy as np
import torch


def lang_freqs(dim: int, theta: float = 10000.0) -> np.ndarray:
    """1-D rotary frequency ladder for token positions (dim//2 frequencies)."""
    return 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2] / dim))


def pixel_freqs(dim: int, max_freq: float = 10.0) -> np.ndarray:
    """Frequencies for continuous pixel coordinates in [-1, 1]."""
    return np.linspace(1.0, max_freq / 2, dim // 2) * np.pi


def angles(positions: np.ndarray, freqs: np.ndarray) -> np.ndarray:
    """Outer product position x freq, each frequency repeated twice
    (interleaved) so the table lines up with adjacent rotation pairs.
    Returns shape (*positions.shape, 2 * len(freqs))."""
    a = np.einsum("...i,j->...ij", np.asarray(positions, dtype=np.float64), freqs)
    return np.repeat(a, 2, axis=-1).reshape(*positions.shape, -1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Per adjacent channel pair (x1, x2) -> (-x2, x1)."""
    pairs = x.unflatten(-1, (-1, 2))
    return torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)


def apply_rotary_emb(angle_table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotate the leading ``angle_table.shape[-1]`` channels of ``t``;
    channels past it pass through. The table is cast to ``t``'s dtype
    before cos/sin, as the reference does."""
    rot_dim = angle_table.shape[-1]
    angle_table = angle_table.to(t.dtype)
    t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
    t_rot = t_rot * angle_table.cos() + rotate_half(t_rot) * angle_table.sin()
    return torch.cat((t_rot, t_pass), dim=-1)


def rot_tables(table: torch.Tensor, n: int, d: int, dtype):
    """cos/sin (n, d) in the compute dtype for the packed-qkv path: the
    angle table's first n rows, zero-padded to the head dim (zero angle =
    identity rotation), cast to ``dtype`` BEFORE cos/sin as
    ``apply_rotary_emb`` does. The table must be pair-constant (equal
    angles within each (2i, 2i+1) channel pair, as every table ``angles``
    builds is): the packed backward's inverse rotation relies on it.
    The check reads the table, a host sync when it lies on the card."""
    if table.shape[0] < n or table.shape[1] > d:
        raise ValueError(f"angle table {tuple(table.shape)} does not cover n={n}, d={d}")
    table = table[:n].float()
    if table.shape[1] < d:
        table = torch.nn.functional.pad(table, (0, d - table.shape[1]))
    if not torch.equal(table[:, 0::2], table[:, 1::2]):
        raise ValueError(
            "fused rotary requires a pair-constant angle table "
            "(table[:, 0::2] == table[:, 1::2]); see rotary.angles"
        )
    ang = table.to(dtype)
    return ang.cos(), ang.sin()


def dalle_rotary_table(
    dim_head: int,
    text_len: int,
    image_fmap_size: int,
    theta: float = 10000.0,
    max_freq: float = 10.0,
) -> np.ndarray:
    """The DALL-E angle table, shape
    (text_len + image_fmap_size**2 - 1, 3 * 2 * (dim_head // 3 // 2)).

    ``text_len`` counts <bos>. Channel layout: [0, r) 1-D text angles with
    image positions pinned at 8192; [r, 3r) 2-D axial pixel angles (row
    then col) with text pinned at -10; r = 2 * (dim_head // 3 // 2). With
    dim_head 64 the table is 60 wide, so channels 60-63 stay unrotated."""
    rot_dim = dim_head // 3
    img_seq_len = image_fmap_size**2

    lf = lang_freqs(rot_dim, theta)
    pf = pixel_freqs(rot_dim, max_freq)

    text_1d = angles(np.arange(text_len), lf)
    img_1d = angles(np.full((img_seq_len,), 8192.0), lf)
    part_text = np.concatenate((text_1d, img_1d), axis=0)

    axial = angles(np.linspace(-1.0, 1.0, image_fmap_size), pf)  # (f, r)
    rows = np.broadcast_to(axial[:, None, :], (image_fmap_size, image_fmap_size, axial.shape[-1]))
    cols = np.broadcast_to(axial[None, :, :], (image_fmap_size, image_fmap_size, axial.shape[-1]))
    img_2d = np.concatenate((rows, cols), axis=-1).reshape(img_seq_len, -1)
    text_2d = np.tile(angles(np.full((text_len,), -10.0), pf), (1, 2))
    part_axial = np.concatenate((text_2d, img_2d), axis=0)

    table = np.concatenate((part_text, part_axial), axis=-1)
    return table[:-1].astype(np.float32)
