"""Static attention-pattern masks for the mixed text+image sequence.

The reference implements each sparse pattern with dynamic padding, unfolds and
per-forward mask construction (attention.py:90-384). On TPU everything under
jit must be shape-static, so instead each pattern is expressed once, at model
build time, as a boolean (L, L) "may-attend" matrix over the fixed internal
sequence of length L = text_len + image_fmap_size**2 (text_len includes
<bos>). The efficient kernels (axial grouping, conv patches, block-sparse
Pallas) must agree exactly with these masks — that's the parity contract the
tests enforce — and the KV-cached decode path simply gathers rows from them.

True = query row may attend to key column. Key-padding masks are applied
separately at runtime.
"""

from __future__ import annotations

import numpy as np


def causal_mask(n: int) -> np.ndarray:
    """Dense causal: j <= i (reference attention.py:76-79)."""
    return np.tril(np.ones((n, n), dtype=bool))


def _image_query_grid(text_len: int, image_size: int):
    img_seq_len = image_size**2
    p = np.arange(img_seq_len)
    return p // image_size, p % image_size, img_seq_len, text_len + img_seq_len


def axial_mask(text_len: int, image_size: int, axis: int) -> np.ndarray:
    """Axial row/col attention (reference attention.py:211-321).

    Text queries: causal over text. Image query (r, c): all text keys, plus
    image keys along the same row (axis=0) with c' <= c, or the same column
    (axis=1) with r' <= r.
    """
    assert axis in (0, 1)
    row, col, img_seq_len, total = _image_query_grid(text_len, image_size)
    mask = np.zeros((total, total), dtype=bool)
    mask[:text_len, :text_len] = causal_mask(text_len)
    # image -> all text
    mask[text_len:, :text_len] = True
    # image -> image along the axis
    if axis == 0:
        allowed = (row[:, None] == row[None, :]) & (col[:, None] >= col[None, :])
    else:
        allowed = (col[:, None] == col[None, :]) & (row[:, None] >= row[None, :])
    mask[text_len:, text_len:] = allowed
    return mask


def conv_mask(
    text_len: int, image_size: int, kernel_size: int = 5, dilation: int = 1
) -> np.ndarray:
    """Convolution-like local attention (reference attention.py:90-207).

    Image query (r, c) attends to image keys inside its dilated kernel_size x
    kernel_size window whose flat index is <= its own, plus all text. Text
    queries: causal over text.
    """
    assert kernel_size % 2 == 1, "kernel size must be odd"
    row, col, img_seq_len, total = _image_query_grid(text_len, image_size)
    pad = ((kernel_size - 1) * dilation + 1) // 2

    mask = np.zeros((total, total), dtype=bool)
    mask[:text_len, :text_len] = causal_mask(text_len)
    mask[text_len:, :text_len] = True

    dr = np.abs(row[:, None] - row[None, :])
    dc = np.abs(col[:, None] - col[None, :])
    in_window = (
        (dr <= pad)
        & (dc <= pad)
        & (dr % dilation == 0)
        & (dc % dilation == 0)
    )
    q_idx = np.arange(img_seq_len)
    causal = q_idx[:, None] >= q_idx[None, :]
    mask[text_len:, text_len:] = in_window & causal
    return mask


def block_sparse_layout(
    seq_len: int,
    block_size: int = 16,
    text_seq_len: int = 256,
    num_random_blocks: int | None = None,
    num_local_blocks: int = 4,
    causal: bool = True,
    seed: int = 0,
) -> np.ndarray:
    """Block layout with DeepSpeed VariableSparsityConfig semantics
    (reference attention.py:325-351): a sliding window of ``num_local_blocks``
    previous blocks, global blocks covering the text prefix (attending and
    attended bidirectionally), and ``num_random_blocks`` random blocks per
    query block. Random choices are drawn once from a seeded RNG so the
    layout is static across compiles — matching DeepSpeed, which also builds
    its layout at init.

    Returns (nb, nb) bool where nb = ceil(seq_len / block_size).
    """
    nb = -(-seq_len // block_size)
    if num_random_blocks is None:
        num_random_blocks = max(seq_len // block_size // 4, 0)
    num_global = -(-text_seq_len // block_size)

    layout = np.zeros((nb, nb), dtype=bool)
    rng = np.random.RandomState(seed)

    for qb in range(nb):
        lo = max(0, qb - num_local_blocks + 1)
        layout[qb, lo : qb + 1] = True
        # random blocks (causal: only past blocks are useful)
        hi = qb + 1 if causal else nb
        if num_random_blocks > 0 and hi > 0:
            picks = rng.choice(hi, size=min(num_random_blocks, hi), replace=False)
            layout[qb, picks] = True

    # global text-prefix blocks: global rows and global columns
    layout[:num_global, :] = True
    layout[:, :num_global] = True

    if causal:
        layout &= np.tril(np.ones((nb, nb), dtype=bool))
    return layout


def block_sparse_mask(
    seq_len: int,
    block_size: int = 16,
    text_seq_len: int = 256,
    num_random_blocks: int | None = None,
    num_local_blocks: int = 4,
    causal: bool = True,
    seed: int = 0,
) -> np.ndarray:
    """Elementwise (seq_len, seq_len) expansion of the block layout, with the
    elementwise causal triangle applied on top."""
    layout = block_sparse_layout(
        seq_len, block_size, text_seq_len, num_random_blocks, num_local_blocks, causal, seed
    )
    dense = np.kron(layout, np.ones((block_size, block_size), dtype=bool))
    dense = dense[:seq_len, :seq_len]
    if causal:
        dense &= causal_mask(seq_len)
    return dense


def pattern_mask(attn_type: str, text_len: int, image_size: int, **kwargs) -> np.ndarray:
    """Dispatch: the static may-attend mask for a layer's attention type."""
    total = text_len + image_size**2
    if attn_type in ("full", "mlp"):
        return causal_mask(total)
    if attn_type == "axial_row":
        return axial_mask(text_len, image_size, axis=0)
    if attn_type == "axial_col":
        return axial_mask(text_len, image_size, axis=1)
    if attn_type == "conv_like":
        return conv_mask(text_len, image_size, **kwargs)
    if attn_type == "sparse":
        return block_sparse_mask(total, text_seq_len=text_len - 1, **kwargs)
    raise ValueError(f'attention type "{attn_type}" is not valid')
