"""Transformer building blocks (counterpart of ``dalle_pytorch_tpu/ops/layers.py``).

The linear layer with a compute dtype apart from its parameters' (flax's
``nn.Dense`` with ``dtype`` and ``param_dtype``), LayerScale, PreNorm,
dropout (flax's ``nn.Dropout``), the GEGLU feed-forward, the token-shift
wrapper in both forms (over a whole sequence and the decode ring), the
axial positional embedding of the image grid, and the ``stable`` model's
``divide_max``.
Numerics follow the reference: LayerNorm runs in float32 with eps 1e-6
(flax's default, not torch's 1e-5) on float32 parameters whatever the
compute dtype; LayerScale casts its float32 scale to x's dtype; the
GEGLU gate is the tanh-approximated gelu (flax ``nn.gelu``), in the
compute dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


def divide_max(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x divided by its max along ``dim`` (the ``stable`` model's
    transformer output, before the final norm)."""
    return x / x.amax(dim=dim, keepdim=True)


@torch.no_grad()
def seeded_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights for a model built without a checkpoint:
    every linear and embedding weight N(0, 0.02), biases 0; the axial
    positional embedding's two tables N(0, 1), as flax draws them;
    LayerNorm, LayerScale and other parameters keep their init.
    ``generator`` lives on the model's device."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            nn.init.normal_(m.weight, std=0.02, generator=generator)
            if getattr(m, "bias", None) is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, AxialPositionalEmbedding):
            for p in (m.row_emb, m.col_emb):
                nn.init.normal_(p, std=1.0, generator=generator)


def layer_scale_init(depth: int) -> float:
    """Depth-dependent LayerScale init: 0.1 up to depth 18, 1e-5 to 24,
    1e-6 beyond."""
    if depth <= 18:
        return 0.1
    if depth <= 24:
        return 1e-5
    return 1e-6


def keep_mask(generator: torch.Generator, shape, keep_prob: float, device) -> torch.Tensor:
    """A bool mask of ``shape``, each entry True with probability
    ``keep_prob``: uniform draws from ``generator`` (on ``device``) below
    it."""
    return torch.rand(shape, generator=generator, device=device) < keep_prob


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``nn.Dropout``, a generator standing for flax's "dropout"
    rng and its absence for a deterministic call: x itself, with nothing
    drawn, without a generator or for rate 0; zeros for rate 1; else
    ``select(mask, x / keep_prob, 0)`` with the mask from ``keep_mask``
    and the division in x's dtype (keep_prob rounded to it, as flax's
    weakly typed scalar is; a divide, not a product with the
    reciprocal)."""
    if generator is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = keep_mask(generator, x.shape, keep, x.device)
    divisor = torch.tensor(keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / divisor, torch.zeros((), dtype=x.dtype, device=x.device))


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` on parameters stored in
    ``param_dtype`` (default ``dtype``): weight, bias and input are cast
    to ``dtype`` at use, so gradients reach the stored parameters through
    the casts in their own dtype (flax's ``nn.Dense``: float32 master
    params, bfloat16 compute). With the two dtypes equal the casts are
    no-ops and this is ``nn.Linear``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=torch.float32, param_dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in float32 with float32 parameters, whatever the
    input dtype; returns float32."""

    def __init__(self, dim: int, device=None):
        super().__init__(dim, eps=LN_EPS, device=device, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class LayerScale(nn.Module):
    """``fn(x) * scale`` with a learned per-channel gain initialised small."""

    def __init__(self, dim: int, depth: int, fn: nn.Module, device=None):
        super().__init__()
        self.fn = fn
        self.scale = nn.Parameter(torch.full(
            (dim,), layer_scale_init(depth), dtype=torch.float32,
            device=device,
        ))

    def forward(self, x, **kwargs):
        return self.fn(x, **kwargs) * self.scale.to(x.dtype)


class PreNorm(nn.Module):
    """LayerNorm (float32) then ``fn`` on the result cast back to x's dtype."""

    def __init__(self, dim: int, fn: nn.Module, device=None):
        super().__init__()
        self.norm = LayerNorm32(dim, device=device)
        self.fn = fn

    def forward(self, x, **kwargs):
        return self.fn(self.norm(x).to(x.dtype), **kwargs)


class AxialPositionalEmbedding(nn.Module):
    """Learned positions of the image grid, factorized: ``row_emb``
    (rows, 1, dim) and ``col_emb`` (1, cols, dim) in ``param_dtype``,
    whose broadcast sum covers the grid row-major."""

    def __init__(self, dim: int, shape, device=None, param_dtype=torch.float32):
        super().__init__()
        rows, cols = shape
        kw = dict(device=device, dtype=param_dtype)
        self.row_emb = nn.Parameter(torch.randn(rows, 1, dim, **kw))
        self.col_emb = nn.Parameter(torch.randn(1, cols, dim, **kw))

    def grid(self) -> torch.Tensor:
        """Every grid position's embedding, (rows * cols, dim)."""
        return (self.row_emb + self.col_emb).reshape(-1, self.row_emb.shape[-1])

    def forward(self, n: int) -> torch.Tensor:
        """The first n positions' embeddings, (1, n, dim)."""
        return self.grid()[None, :n]


class FeedForward(nn.Module):
    """GEGLU: one projection to 2 * mult * dim, x * gelu_tanh(gates),
    dropout at rate ``dropout`` when called with a generator, back."""

    def __init__(self, dim: int, mult: float = 4.0, dropout: float = 0.0,
                 device=None, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.dropout = dropout
        hidden = int(dim * mult)
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.proj_in = Linear(dim, hidden * 2, **kw)
        self.proj_out = Linear(hidden, dim, **kw)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x, gates = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(dropout(x * F.gelu(gates, approximate="tanh"), self.dropout,
                                     generator))


@dataclass
class ShiftRing:
    """One PreShiftToken's decode state: the last R raw inputs of every row,
    newest last (``hist`` (b, R, dim)), and the position each row consumes
    next (``index`` (b,) int32). Before consuming position p, ring row i
    holds position p - R + i."""

    hist: torch.Tensor
    index: torch.Tensor


def shift_tokens(x: torch.Tensor, text_len: int, image_size: int) -> torch.Tensor:
    """Token shift over a whole mixed text + image sequence x (b, n, d).
    Text positions (the first ``text_len``, <bos> included) take their
    first half of channels from the previous token (zero at position 0).
    The image part is zero-padded to a full image_size x image_size grid,
    where each position takes its first quarter of channels from the
    token one row up and its second quarter from the token one column
    left (zero across the grid's edge), and is cut back to its length."""
    b, n, d = x.shape
    padding = text_len + image_size**2 - n
    x_text, x_img = x[:, :text_len], x[:, text_len:]
    x_img = F.pad(x_img, (0, 0, 0, padding)).reshape(b, image_size, image_size, d)

    half, q = d // 2, d // 4
    x_text = torch.cat((F.pad(x_text[..., :half], (0, 0, 1, 0))[:, :-1],
                        x_text[..., half:]), dim=-1)
    top = F.pad(x_img[..., :q], (0, 0, 0, 0, 1, 0))[:, :-1]
    left = F.pad(x_img[..., q:2 * q], (0, 0, 1, 0))[:, :, :-1]
    x_img = torch.cat((top, left, x_img[..., 2 * q:]), dim=-1)
    x_img = x_img.reshape(b, image_size**2, d)[:, :image_size**2 - padding]
    return torch.cat((x_text, x_img), dim=1)


def shift_tokens_decode(x, pos, prev_token, row_above_token,
                        text_len: int, image_size: int):
    """Token shift for a block of decode positions. x, prev_token,
    row_above_token: (b, n, d); pos: (b, n) per-token positions. Text
    positions take their first half of channels from the previous token
    (zero at position 0); image positions their first quarter from the
    token one row up and the second quarter from the token one column
    left (zero across the grid's edge)."""
    pos = pos[..., None]
    d = x.shape[-1]
    half, quarter = d // 2, d // 4
    is_text = pos < text_len
    p_img = pos - text_len
    col = p_img % image_size
    row = torch.div(p_img, image_size, rounding_mode="floor")
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    text_shift = torch.where((pos > 0) & is_text, prev_token[..., :half], zero)
    text_out = torch.cat((text_shift, x[..., half:]), dim=-1)
    top = torch.where(row > 0, row_above_token[..., :quarter], zero)
    left = torch.where(col > 0, prev_token[..., quarter:2 * quarter], zero)
    img_out = torch.cat((top, left, x[..., 2 * quarter:]), dim=-1)
    return torch.where(is_text, text_out, img_out)


class PreShiftToken(nn.Module):
    """Token shift, then ``fn``. Without a ring it shifts a whole sequence
    (``shift_tokens``; the training forward). With one it is the
    ragged-block decode form (the fused serving iteration), and
    ``pass_block`` forwards ``block_len`` and ``block_start`` to ``fn``
    (attention needs them, the feed-forward not).

    In decode, row b's valid tokens are columns [0, block_len[b]) at positions
    anchor[b] + j, where the anchor is ``block_start`` (the descriptor).
    ``cat = [ring | x]`` maps position anchor + t to column R + t, so the
    previous token is column R + j - 1 and the row-above token column
    R + j - image_size. ``delta`` = stored index - anchor (0 unless a
    caller re-dispatches behind the stored high-water mark) shifts every
    ring read below the anchor. The ring advances PER ROW by block_len:
    idle rows (block_len 0) keep their ring and index.

    R is the ring's own width: ``image_size + 1``, plus ``pad`` rows where
    the cache was built for a model with ``shift_pad`` (the speculative
    engine's rollback slack, JAX's ``PreShiftToken.pad``): a verify block
    advances the ring by its width but commits only the accepted part,
    so the next block's anchor may lag the stored index by up to ``pad``
    positions, and the rows it reads below the anchor must still be
    held. With ``pad`` 0 the arithmetic is the unpadded ring's."""

    def __init__(self, fn: nn.Module, image_size: int, seq_len: int,
                 pass_block: bool = False):
        super().__init__()
        self.fn = fn
        self.image_size = image_size
        self.text_len = seq_len - image_size**2 + 1
        self.pass_block = pass_block

    def forward(self, x, ring: Optional[ShiftRing] = None, block_len=None,
                block_start=None, **kwargs):
        if ring is None:
            return self.fn(shift_tokens(x, self.text_len, self.image_size), **kwargs)
        b, n, d = x.shape
        R, f = ring.hist.shape[1], self.image_size
        dev = x.device
        j = torch.arange(n, device=dev)[None]
        pos = ring.index.long()
        anchor = block_start.long()
        blen = block_len.long()
        delta = torch.where(blen > 0, (pos - anchor).clamp(min=0), 0)[:, None]
        cat = torch.cat((ring.hist, x), dim=1)  # (b, R + n, d)

        def take(ix):
            ix = ix.clamp(0, R + n - 1)
            return cat.gather(1, ix[..., None].expand(*ix.shape, d))

        prev = take(torch.where(j == 0, R - 1 - delta, R - 1 + j))
        row_above = take(R - f + j - torch.where(j >= f, 0, 1) * delta)
        r = torch.arange(R, device=dev)[None]
        ring.hist = take(
            r + blen[:, None] - torch.where(r >= R - blen[:, None], 0, 1) * delta
        )
        ring.index = torch.where(blen > 0, anchor + blen, pos).to(torch.int32)
        x = shift_tokens_decode(
            x, anchor[:, None] + j, prev, row_above, self.text_len, f
        )
        if self.pass_block:
            kwargs.update(block_len=block_len, block_start=block_start)
        return self.fn(x, **kwargs)
