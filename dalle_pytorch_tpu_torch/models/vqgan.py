"""The taming VQGAN, frozen (counterpart of
``dalle_pytorch_tpu/models/vqgan.py``).

``VQGanVAE`` has the ``DiscreteVAE`` surface: ``get_codebook_indices``
scales images (b, h, w, 3) in [0, 1] to [-1, 1], runs the encoder and
``quant_conv`` and takes the nearest codebook entry (``VQQuantizer``) or
the argmax of a 1x1 projection (``GumbelQuantizer``); ``decode`` looks
the ids up, runs ``post_quant_conv`` and the decoder, and maps [-1, 1]
to [0, 1] (``normalization`` is None). The published f=16 model cuts the
image sequence from the dVAE's 1,024 tokens to 256.

The modules keep taming's names (``encoder.down.<i>.block.<j>.norm1``,
``encoder.down.<i>.downsample.conv``, ``decoder.up.<i>.attn.<j>.q``,
``encoder.mid.attn_1.proj_out``, ``quantize.embedding``, ...) and torch's
OIHW layout, so taming's ``last.ckpt`` loads with
``load_state_dict(strict=True)`` once ``checkpoint_state_dict`` has
dropped the loss head and the scheduler's buffers. Parameters stay
float32; ``dtype`` is the type the convolutions compute in, as in JAX.
GroupNorm runs in float32 and returns its input's type, as JAX's
``_norm_apply`` does. The spatial attention block is one head of the
block's full width (512 at f=16), computed with ``torch.matmul`` and a
float32 softmax as JAX computes it with ``einsum`` outside any kernel.
The downsample pads (0, 1, 0, 1) before its stride-2 3x3 conv, as
taming does.

``read_model_yaml`` reads taming's ``model.yaml`` with ``yaml.safe_load``
(pyyaml; no OmegaConf), and ``load_vqgan_vae`` builds the wrapper from a
local config and checkpoint. JAX downloads a missing file; the port never
does and refuses with ``pretrained.MissingWeights``, naming the flag.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .vae import cudnn_deterministic

# taming's checkpoint entries that are not the frozen model's weights
SKIPPED_PREFIXES = ("loss", "temperature_scheduler", "used", "colorize")


def _swish(x):
    return x * torch.sigmoid(x)


class _Conv(nn.Conv2d):
    """``nn.Conv2d`` with float32 parameters that computes in its input's
    type."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class _GroupNorm(nn.GroupNorm):
    """taming's ``Normalize``: GroupNorm(32, eps 1e-6), in float32,
    returned in its input's type."""

    def __init__(self, channels: int, device=None):
        super().__init__(32, channels, eps=1e-6, affine=True, device=device)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.norm1 = _GroupNorm(cin, device)
        self.conv1 = _Conv(cin, cout, 3, padding=1, device=device)
        self.norm2 = _GroupNorm(cout, device)
        self.conv2 = _Conv(cout, cout, 3, padding=1, device=device)
        if cin != cout:
            self.nin_shortcut = _Conv(cin, cout, 1, device=device)

    def forward(self, x):
        h = self.conv1(_swish(self.norm1(x)))
        h = self.conv2(_swish(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention over the h*w positions, the
    head as wide as the channels."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.norm = _GroupNorm(c, device)
        self.q = _Conv(c, c, 1, device=device)
        self.k = _Conv(c, c, 1, device=device)
        self.v = _Conv(c, c, 1, device=device)
        self.proj_out = _Conv(c, c, 1, device=device)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q = self.q(h).reshape(b, c, hh * ww).transpose(1, 2)
        k = self.k(h).reshape(b, c, hh * ww)
        v = self.v(h).reshape(b, c, hh * ww).transpose(1, 2)
        w = torch.matmul(q.float(), k.float())  # products of the input type, float32 sums
        w = torch.softmax(w * (c**-0.5), dim=-1).to(v.dtype)
        h = torch.matmul(w, v).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


class _Level(nn.Module):
    """One resolution of the encoder or decoder: ``block``, ``attn`` and
    a ``downsample`` / ``upsample`` holding ``conv``."""

    def __init__(self, blocks, attns):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)

    def run(self, h):
        for j, block in enumerate(self.block):
            h = block(h)
            if len(self.attn):
                h = self.attn[j](h)
        return h


def _resampler(conv: nn.Module) -> nn.Module:
    holder = nn.Module()
    holder.conv = conv
    return holder


def _mid(c: int, device) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = ResnetBlock(c, c, device)
    mid.attn_1 = AttnBlock(c, device)
    mid.block_2 = ResnetBlock(c, c, device)
    return mid


def _run_mid(mid, h):
    return mid.block_2(mid.attn_1(mid.block_1(h)))


class TamingEncoder(nn.Module):
    """conv_in -> per level [ResnetBlock x n (+ attention at the
    configured resolutions), downsample] -> mid (block, attention, block)
    -> GroupNorm, swish, conv_out to ``z_channels``. NCHW."""

    def __init__(self, *, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int], resolution: int, z_channels: int,
                 in_channels: int = 3, device=None):
        super().__init__()
        self.conv_in = _Conv(in_channels, ch, 3, padding=1, device=device)
        self.down = nn.ModuleList()
        res, cin = resolution, ch
        for i, mult in enumerate(ch_mult):
            cout = ch * mult
            blocks = [ResnetBlock(cin if j == 0 else cout, cout, device)
                      for j in range(num_res_blocks)]
            attns = ([AttnBlock(cout, device) for _ in range(num_res_blocks)]
                     if res in attn_resolutions else [])
            level = _Level(blocks, attns)
            if i != len(ch_mult) - 1:
                level.downsample = _resampler(_Conv(cout, cout, 3, stride=2, device=device))
                res //= 2
            self.down.append(level)
            cin = cout
        self.mid = _mid(cin, device)
        self.norm_out = _GroupNorm(cin, device)
        self.conv_out = _Conv(cin, z_channels, 3, padding=1, device=device)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            h = level.run(h)
            if hasattr(level, "downsample"):
                # taming's Downsample: pad right and bottom by 1, then the
                # unpadded stride-2 conv
                h = level.downsample.conv(F.pad(h, (0, 1, 0, 1)))
        h = _run_mid(self.mid, h)
        return self.conv_out(_swish(self.norm_out(h)))


class TamingDecoder(nn.Module):
    """conv_in -> mid -> levels from the coarsest [ResnetBlock x (n + 1)
    (+ attention), nearest 2x upsample + conv] -> GroupNorm, swish,
    conv_out to ``out_ch``. ``up[i]`` is level i, as in taming. NCHW."""

    def __init__(self, *, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int], resolution: int, z_channels: int,
                 out_ch: int = 3, device=None):
        super().__init__()
        n = len(ch_mult)
        block_in = ch * ch_mult[-1]
        res = resolution // 2 ** (n - 1)
        self.conv_in = _Conv(z_channels, block_in, 3, padding=1, device=device)
        self.mid = _mid(block_in, device)
        levels = []
        cin = block_in
        for i in reversed(range(n)):
            cout = ch * ch_mult[i]
            blocks = [ResnetBlock(cin if j == 0 else cout, cout, device)
                      for j in range(num_res_blocks + 1)]
            attns = ([AttnBlock(cout, device) for _ in range(num_res_blocks + 1)]
                     if res in attn_resolutions else [])
            level = _Level(blocks, attns)
            if i != 0:
                level.upsample = _resampler(_Conv(cout, cout, 3, padding=1, device=device))
                res *= 2
            levels.insert(0, level)
            cin = cout
        self.up = nn.ModuleList(levels)
        self.norm_out = _GroupNorm(cin, device)
        self.conv_out = _Conv(cin, out_ch, 3, padding=1, device=device)

    def forward(self, z):
        h = _run_mid(self.mid, self.conv_in(z))
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            h = level.run(h)
            if hasattr(level, "upsample"):
                h = level.upsample.conv(F.interpolate(h, scale_factor=2, mode="nearest"))
        return self.conv_out(_swish(self.norm_out(h)))


class VQQuantizer(nn.Module):
    """taming's VectorQuantizer at inference: the nearest entry of
    ``embedding`` (n_embed, embed_dim) in L2, and the lookup."""

    def __init__(self, n_embed: int, embed_dim: int, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.embedding = nn.Embedding(n_embed, embed_dim, device=device)

    def scores(self, z):
        """z (b, embed_dim, h, w) -> (b, h*w, n_embed) negated squared L2
        distances to the entries, in float32 through JAX's expansion
        z^2 - 2 z.e + e^2: the argmax is the nearest entry."""
        b = z.shape[0]
        flat = z.permute(0, 2, 3, 1).reshape(b, -1, self.embed_dim).float()
        e = self.embedding.weight.float()
        d = (flat.pow(2).sum(-1, keepdim=True) - 2 * torch.matmul(flat, e.t())
             + e.pow(2).sum(-1))
        return -d

    def lookup(self, ids):
        return self.embedding(ids)


class GumbelQuantizer(nn.Module):
    """taming's GumbelQuantize at inference: the argmax of a 1x1
    projection to ``n_embed`` logits, and a lookup in ``embed``."""

    def __init__(self, num_hiddens: int, n_embed: int, embed_dim: int, device=None):
        super().__init__()
        self.proj = _Conv(num_hiddens, n_embed, 1, device=device)
        self.embed = nn.Embedding(n_embed, embed_dim, device=device)

    def scores(self, z):
        """z (b, c, h, w) -> (b, h*w, n_embed) logits of the projection."""
        return self.proj(z).flatten(2).transpose(1, 2)

    def lookup(self, ids):
        return self.embed(ids)


class VQGanVAE(nn.Module):
    """The frozen taming VQGAN with the ``DiscreteVAE`` surface; JAX's
    fields (defaults: the published imagenet f=16, 1,024-entry model) and
    ``dtype`` (the compute type; parameters are float32)."""

    normalization = None  # decode's pixels are already in [0, 1]

    def __init__(self, *, image_size: int = 256, ch: int = 128,
                 ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4), num_res_blocks: int = 2,
                 attn_resolutions: Tuple[int, ...] = (16,), z_channels: int = 256,
                 n_embed: int = 1024, embed_dim: int = 256, gumbel: bool = False,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        self.image_size, self.ch, self.ch_mult = image_size, ch, tuple(ch_mult)
        self.num_res_blocks, self.attn_resolutions = num_res_blocks, tuple(attn_resolutions)
        self.z_channels, self.n_embed, self.embed_dim = z_channels, n_embed, embed_dim
        self.gumbel, self.dtype = gumbel, dtype
        kw = dict(ch=ch, ch_mult=self.ch_mult, num_res_blocks=num_res_blocks,
                  attn_resolutions=self.attn_resolutions, resolution=image_size,
                  z_channels=z_channels, device=device)
        self.encoder = TamingEncoder(**kw)
        self.decoder = TamingDecoder(**kw)
        # GumbelVQ keeps quant_conv z -> z (taming passes embed_dim=z_channels)
        inner = z_channels if gumbel else embed_dim
        self.quant_conv = _Conv(z_channels, inner, 1, device=device)
        self.post_quant_conv = _Conv(embed_dim, z_channels, 1, device=device)
        self.quantize = (GumbelQuantizer(inner, n_embed, embed_dim, device) if gumbel
                         else VQQuantizer(n_embed, embed_dim, device))
        self.requires_grad_(False)

    @property
    def num_layers(self) -> int:
        return len(self.ch_mult) - 1

    @property
    def num_tokens(self) -> int:
        return self.n_embed

    @property
    def fmap_size(self) -> int:
        return self.image_size // (2**self.num_layers)

    @property
    def image_seq_len(self) -> int:
        return self.fmap_size**2

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VQGanVAE":
        """Seeded random weights: each conv N(0, 1 / fan_in), biases 0,
        GroupNorm 1 and 0, codebooks N(0, 1 / embed_dim). ``generator``
        lives on the model's device."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                nn.init.normal_(m.weight, std=fan_in**-0.5, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, std=m.embedding_dim**-0.5, generator=generator)
        return self

    def encode_latents(self, img: torch.Tensor) -> torch.Tensor:
        """img (b, h, w, 3) in [0, 1] -> ``quant_conv``'s output (b, c, f,
        f) in ``dtype``."""
        x = (2.0 * img.float() - 1.0).to(self.dtype).permute(0, 3, 1, 2)
        return self.quant_conv(self.encoder(x))

    @torch.no_grad()
    def code_scores(self, img: torch.Tensor) -> torch.Tensor:
        """img (b, h, w, 3) in [0, 1] -> (b, fmap_size**2, n_embed): the
        quantizer's scores, whose argmax is each position's id."""
        return self.quantize.scores(self.encode_latents(img))

    @torch.no_grad()
    def get_codebook_indices(self, img: torch.Tensor) -> torch.Tensor:
        """img (b, h, w, 3) in [0, 1] -> (b, fmap_size**2) ids (the first
        best on a tie, as JAX's argmin / argmax)."""
        return self.code_scores(img).argmax(dim=-1)

    @torch.no_grad()
    def decode(self, img_seq: torch.Tensor) -> torch.Tensor:
        """Ids (b, n) -> (b, H, W, 3) float32 pixels in [0, 1]."""
        b, n = img_seq.shape
        f = math.isqrt(n)
        z = self.quantize.lookup(img_seq.long()).reshape(b, f, f, self.embed_dim)
        with cudnn_deterministic():
            dec = self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2).to(self.dtype)))
        return ((dec.float().clamp(-1.0, 1.0) + 1.0) * 0.5).permute(0, 2, 3, 1)

    def forward(self, img):
        raise NotImplementedError("VQGanVAE is frozen and inference-only")


def checkpoint_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """taming's checkpoint state dict less what the frozen wrapper does
    not hold: the loss head (discriminator, perceptual net) and the
    Gumbel temperature scheduler's buffers."""
    return {k: v for k, v in sd.items() if k.split(".")[0] not in SKIPPED_PREFIXES}


def read_model_yaml(config_path: str) -> Tuple[dict, int, int, bool]:
    """taming's OmegaConf ``model.yaml`` -> (ddconfig, n_embed,
    embed_dim, gumbel), read with ``yaml.safe_load``."""
    import yaml

    with open(config_path) as f:
        cfg = yaml.safe_load(f)
    model = cfg["model"]
    target = model.get("target", "")
    p = model["params"]
    return (p["ddconfig"], int(p["n_embed"]), int(p["embed_dim"]),
            "Gumbel" in target or "gumbel" in target)


def load_vqgan_vae(config_path: Optional[str], model_path: Optional[str],
                   dtype=torch.float32, device="cuda") -> VQGanVAE:
    """The VQGAN of taming's ``model.yaml`` and ``last.ckpt`` (local
    files; ``MissingWeights`` names the flag otherwise), computing in
    ``dtype``."""
    from .pretrained import load_torch_checkpoint, require_file

    config_path = require_file(config_path, "--vqgan_config_path", "the VQGAN config")
    model_path = require_file(model_path, "--vqgan_model_path", "the VQGAN checkpoint")
    dd, n_embed, embed_dim, gumbel = read_model_yaml(config_path)
    vae = VQGanVAE(image_size=int(dd["resolution"]), ch=int(dd["ch"]),
                   ch_mult=tuple(dd["ch_mult"]), num_res_blocks=int(dd["num_res_blocks"]),
                   attn_resolutions=tuple(dd["attn_resolutions"]),
                   z_channels=int(dd["z_channels"]), n_embed=n_embed, embed_dim=embed_dim,
                   gumbel=gumbel, device=device, dtype=dtype)
    vae.load_state_dict(checkpoint_state_dict(load_torch_checkpoint(model_path)), strict=True)
    return vae
