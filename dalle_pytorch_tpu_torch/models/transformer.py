"""Sequential transformer stack, decode form (counterpart of
``dalle_pytorch_tpu/models/transformer.py``).

Each layer is LayerScale(PreNorm([PreShiftToken](attention))) then the
same around the GEGLU feed-forward, with the DALL-E rotary table. Only
what the fused serving iteration runs is ported: causal "full" layers in
sequential execution over a paged decode cache. Reversible and remat
execution, pipeline and sequence parallelism, MoE, gMLP and the other
attention patterns raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.attention import Attention
from ..ops.layers import FeedForward, LayerScale, PreNorm, PreShiftToken
from ..ops.rotary import dalle_rotary_table


class Transformer(nn.Module):
    """``seq_len`` is the model sequence length (text + image); the
    attention pattern covers ``seq_len + 1`` positions (<bos> included).
    Only the DALL-E form (an image grid of ``image_fmap_size``) is
    ported."""

    def __init__(self, *, dim: int, depth: int, seq_len: int, heads: int = 8,
                 dim_head: int = 64, ff_mult: float = 4,
                 attn_types: Optional[Tuple[str, ...]] = None,
                 image_fmap_size: int, causal: bool = True,
                 shift_tokens: bool = False, rotary_emb: bool = True,
                 reversible: bool = False, remat: bool = False,
                 sp_axis=None, pp_axis=None, ff_experts: int = 0,
                 device=None, dtype=torch.float32):
        super().__init__()
        unsupported = {
            "reversible": reversible, "remat": remat, "sp_axis": sp_axis,
            "pp_axis": pp_axis, "ff_experts": ff_experts,
        }
        for name, value in unsupported.items():
            if value:
                raise NotImplementedError(
                    f"Transformer({name}={value!r}) is not ported; only "
                    "sequential execution is"
                )
        types = tuple(attn_types or ("full",))
        if set(types) != {"full"}:
            raise NotImplementedError(
                f"only 'full' attention layers are ported, got {types}"
            )
        self.depth = depth
        self.shift_tokens = shift_tokens
        self.attn_seq_len = seq_len + 1

        table = None
        if rotary_emb:
            text_len = seq_len - image_fmap_size**2 + 1
            table = torch.from_numpy(
                dalle_rotary_table(dim_head, text_len, image_fmap_size)
            ).to(device)
        self.register_buffer("rotary", table, persistent=False)

        attn_blocks, ff_blocks = [], []
        for ind in range(depth):
            attn = Attention(dim, self.attn_seq_len, heads, dim_head,
                             causal=causal, device=device, dtype=dtype)
            ff = FeedForward(dim, ff_mult, device=device, dtype=dtype)
            if shift_tokens:
                attn = PreShiftToken(attn, image_fmap_size, seq_len,
                                     pass_block=True)
                ff = PreShiftToken(ff, image_fmap_size, seq_len)
            attn_blocks.append(LayerScale(
                dim, ind + 1, PreNorm(dim, attn, device=device), device=device
            ))
            ff_blocks.append(LayerScale(
                dim, ind + 1, PreNorm(dim, ff, device=device), device=device
            ))
        self.attn_blocks = nn.ModuleList(attn_blocks)
        self.ff_blocks = nn.ModuleList(ff_blocks)

    def forward(self, x, cache, block_len, block_start):
        """One ragged block through every layer against ``cache``
        (``models.sampling.DecodeCache``), updated in place."""
        for ind in range(self.depth):
            akw = dict(kv=cache.kv[ind], rotary=self.rotary)
            fkw = {}
            if self.shift_tokens:
                akw.update(ring=cache.attn_rings[ind], block_len=block_len,
                           block_start=block_start)
                fkw.update(ring=cache.ff_rings[ind], block_len=block_len,
                           block_start=block_start)
            else:
                akw.update(block_len=block_len, block_start=block_start)
            x = x + self.attn_blocks[ind](x, **akw)
            x = x + self.ff_blocks[ind](x, **fkw)
        return x
