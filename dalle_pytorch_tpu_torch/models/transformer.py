"""Sequential transformer stack (counterpart of
``dalle_pytorch_tpu/models/transformer.py``).

Each layer is LayerScale(PreNorm([PreShiftToken](attention))) then the
same around the GEGLU feed-forward; layer i's attention has the type
``attn_types[i % len(attn_types)]`` and the layout seed
``sparse_layout_seed + i``, as in JAX. Two forms are ported:

- the DALL-E decode form (``image_fmap_size`` set, the DALL-E rotary
  table or none with learned positions, every layer by its type): one
  block over a decode cache, either ragged over the paged format
  (``PagedKV`` layers) or the whole batch at one position over the
  dense "flat" / "4d" format (``DenseKV`` layers,
  where ``fused_decode`` chooses the causal "full" layers' route:
  ``Attention.uses_decode_kernel``, the fused decode kernel by default
  on the card, the unfused chain by default on the CPU);
- the full-sequence form (``forward(x, mask=...)`` with no cache), every
  attention type but gMLP: the DALL-E training forward (causal, rotary,
  token shift over the whole sequence) and CLIP's encoders
  (``image_fmap_size=None``, no rotary, non-causal, "full"). Without
  rotary (``rotary_emb=False``) the DALLE adds learned positions to its
  embeddings and the layers rotate nothing.

Dropout (``attn_dropout`` after each attention's ``to_out``,
``ff_dropout`` after each feed-forward's gate) runs in the full-sequence
form when it is given a generator, layer by layer in JAX's order
(attention, then feed-forward); the decode form never drops.

Three executions of the full-sequence form, as in JAX:

- sequential (the default): ``x += attn(x)``, then ``x += ff(x)``;
- ``reversible``: the attention and feed-forward blocks as the (f, g)
  pairs of ``ops.reversible`` over the streams (x, x), returning
  ``(y1 + y2) / 2``; ``reversible_sequence`` when a gradient is taken,
  the direct wiring otherwise. The decode form runs the direct wiring;
- ``remat``: sequential, with each attention and each feed-forward block
  recomputed in the backward (``torch.utils.checkpoint``), its dropout
  drawn again from a generator restored to the state the forward drew
  from. With ``reversible`` as well, reversible runs; the decode form and
  a call without a gradient run sequentially.

Every execution draws the same dropout masks in the same order from the
caller's generator and leaves it in the same state. Pipeline and
sequence parallelism, MoE, gMLP ("mlp" layers) and the 1-D rotary table
(rotary without an image grid) raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import Attention
from ..ops.layers import FeedForward, LayerScale, PreNorm, PreShiftToken
from ..ops.reversible import restored, reversible_forward_only, reversible_sequence
from ..ops.rotary import dalle_rotary_table, rot_tables


class Transformer(nn.Module):
    """``seq_len`` is the model sequence length: text + image for DALL-E
    (an image grid of ``image_fmap_size``), whose attention pattern covers
    ``seq_len + 1`` positions (<bos> included); the encoder length for
    CLIP (``image_fmap_size=None``). The projections compute in ``dtype``
    on parameters stored in ``param_dtype`` (default ``dtype``); the
    LayerNorm and LayerScale parameters are float32, the norms run in
    float32 and the residual stream in x's dtype."""

    def __init__(self, *, dim: int, depth: int, seq_len: int, heads: int = 8,
                 dim_head: int = 64, ff_mult: float = 4,
                 attn_types: Optional[Tuple[str, ...]] = None,
                 image_fmap_size: Optional[int] = None, causal: bool = True,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 shift_tokens: bool = False, rotary_emb: bool = True,
                 reversible: bool = False, remat: bool = False,
                 sparse_layout_seed: int = 0,
                 sp_axis=None, pp_axis=None, ff_experts: int = 0,
                 device=None, dtype=torch.float32, param_dtype=None):
        super().__init__()
        unsupported = {"sp_axis": sp_axis, "pp_axis": pp_axis, "ff_experts": ff_experts}
        for name, value in unsupported.items():
            if value:
                raise NotImplementedError(
                    f"Transformer({name}={value!r}) is not ported; only one card is"
                )
        types = tuple(attn_types or ("full",))
        if "mlp" in types:
            raise NotImplementedError(f"gMLP ('mlp') layers are not ported, got {types}")
        if rotary_emb and image_fmap_size is None:
            raise NotImplementedError(
                "the 1-D rotary table (rotary without an image grid) is not ported"
            )
        if shift_tokens and image_fmap_size is None:
            raise ValueError("token shift needs an image grid (image_fmap_size)")
        self.depth = depth
        self.dim_head = dim_head
        self.reversible, self.remat = reversible, remat
        self.attn_types = tuple(types[i % len(types)] for i in range(depth))
        self.shift_tokens = shift_tokens
        self.attn_seq_len = seq_len + (image_fmap_size is not None)

        table = None
        if rotary_emb:
            text_len = seq_len - image_fmap_size**2 + 1
            table = torch.from_numpy(
                dalle_rotary_table(dim_head, text_len, image_fmap_size)
            ).to(device)
        self.register_buffer("rotary", table, persistent=False)
        self._decode_cs = {}  # (dtype, device) -> the fused decode's (cos, sin)

        attn_blocks, ff_blocks = [], []
        for ind in range(depth):
            attn = Attention(dim, self.attn_seq_len, heads, dim_head,
                             attn_type=self.attn_types[ind], causal=causal,
                             image_fmap_size=image_fmap_size,
                             dropout=attn_dropout, layout_seed=sparse_layout_seed + ind,
                             device=device, dtype=dtype, param_dtype=param_dtype)
            ff = FeedForward(dim, ff_mult, dropout=ff_dropout, device=device, dtype=dtype,
                             param_dtype=param_dtype)
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

    def decode_tables(self, dtype):
        """(cos, sin) of the whole angle table in ``dtype`` for the fused
        decode kernel, built once per dtype and device (``rot_tables``
        reads the table: a host sync)."""
        key = (dtype, self.rotary.device)
        if key not in self._decode_cs:
            self._decode_cs[key] = rot_tables(self.rotary, self.rotary.shape[0],
                                              self.dim_head, dtype)
        return self._decode_cs[key]

    def forward(self, x, cache=None, block_len=None, block_start=None,
                mask=None, fused_decode: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                depth_limit: Optional[int] = None):
        """With ``cache`` (``models.sampling.DecodeCache``): one block
        through every layer (row b's tokens at positions block_start[b] +
        j, the valid ones [0, block_len[b])), the cache updated in place;
        ``mask`` the optional (b, L) key mask; ``fused_decode`` (None,
        True or False) chooses the dense layers' decode route
        (``Attention.uses_decode_kernel``); ``depth_limit`` runs only the
        first that many layers (the speculative engine's early-exit
        drafter; None: all). Without: the whole sequence x (b, n, dim),
        ``mask`` the optional (b, n) key mask, dropout drawn from
        ``generator`` when one is given; the rotary cos/sin tables are
        built once for all layers."""
        if cache is None:
            return self._forward_full(x, mask, generator)
        rotary_cs = None
        if self.rotary is not None and (fused_decode or (fused_decode is None and x.is_cuda)):
            rotary_cs = self.decode_tables(x.dtype)

        def layer(ind):
            akw = dict(kv=cache.kv[ind], rotary=self.rotary, mask=mask,
                       fused_decode=fused_decode, rotary_cs=rotary_cs)
            fkw = {}
            if self.shift_tokens:
                akw.update(ring=cache.attn_rings[ind], block_len=block_len,
                           block_start=block_start)
                fkw.update(ring=cache.ff_rings[ind], block_len=block_len,
                           block_start=block_start)
            else:
                akw.update(block_len=block_len, block_start=block_start)
            return (lambda t, gen: self.attn_blocks[ind](t, **akw),
                    lambda t, gen: self.ff_blocks[ind](t, **fkw))

        depth = self.depth if depth_limit is None else min(max(depth_limit, 1), self.depth)
        blocks = [layer(i) for i in range(depth)]
        if self.reversible:
            y1, y2 = reversible_forward_only(blocks, x, x)
            return (y1 + y2) / 2
        for f, g in blocks:
            x = x + f(x, None)
            x = x + g(x, None)
        return x

    def _forward_full(self, x, mask, generator):
        """The full-sequence form in this stack's execution (see the
        module docstring); the rotary cos/sin tables are built once for
        all layers."""
        rot = None
        if self.rotary is not None:
            rot = rot_tables(self.rotary, x.shape[1], self.dim_head, x.dtype)

        def attn(ind):
            return lambda t, gen: self.attn_blocks[ind](t, rotary=rot, mask=mask, generator=gen)

        def ff(ind):
            return lambda t, gen: self.ff_blocks[ind](t, generator=gen)

        blocks = [(attn(i), ff(i)) for i in range(self.depth)]
        grad = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        if self.reversible:
            if grad:
                params = [(list(self.attn_blocks[i].parameters()),
                           list(self.ff_blocks[i].parameters())) for i in range(self.depth)]
                y1, y2 = reversible_sequence(blocks, x, x, params, generator)
            else:
                y1, y2 = reversible_forward_only(blocks, x, x, generator)
            return (y1 + y2) / 2
        for f, g in blocks:
            if self.remat and grad:
                x = x + _recomputed(f, x, generator)
                x = x + _recomputed(g, x, generator)
            else:
                x = x + f(x, generator)
                x = x + g(x, generator)
        return x


def _recomputed(block, x, generator):
    """``block(x, generator)`` whose activations are recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant). Both runs draw
    from a generator at the state ``generator`` has now, and
    ``generator`` then moves on as the block's own call would move it."""
    if generator is None:
        return checkpoint(block, x, None, use_reentrant=False, preserve_rng_state=False)
    state = generator.get_state()
    ended = []

    def run(t):
        fork = restored(generator, state)
        out = block(t, fork)
        ended.append(fork.get_state())
        return out

    out = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
    generator.set_state(ended[0])
    return out
