"""The OpenAI discrete VAE, frozen (counterpart of
``dalle_pytorch_tpu/models/pretrained.py``).

``OpenAIDiscreteVAE`` has the ``DiscreteVAE`` surface the trainer, the
sampler and the serving stages use: ``fmap_size``, ``image_seq_len``,
``num_tokens``, ``image_size``, ``get_codebook_indices`` (images (b, h, w,
3) in [0, 1] -> (b, f*f) ids: ``map_pixels``, the encoder, argmax over
its logits) and ``decode`` (ids -> (b, H, W, 3) pixels already in [0, 1]:
the decoder, sigmoid of the first 3 of its 6 output channels,
``unmap_pixels``), so ``normalization`` is None. Calling the module
raises: it is inference-only.

The modules keep the names and layout of OpenAI's ``dall_e`` package
(``blocks.input``, ``blocks.group_<g>.block_<i>.id_path`` /
``res_path.conv_<k>``, ``blocks.output.conv``; each conv's ``w`` is OIHW,
its ``b`` a vector), so a published state dict loads with
``load_state_dict(strict=True)`` and only the flax direction
(``convert.py``) transposes. Parameters stay float32 (JAX's
``param_dtype``); ``dtype`` is the type the convolutions compute in, each
weight cast to it at use, as JAX's ``OAIConv`` does.

The decoder's first layer is a 1x1 convolution of a one-hot over the
vocabulary. ``OpenAIDecoder.embed_tokens`` takes the ids instead and
gathers the weight's columns: every other term of the one-hot's sum is
an exact 0, so in float32 the two give the same bits
(``tests/test_torch_pretrained.py`` holds them), and the gather reads
b*f*f columns where the convolution reads a (b, 8192, f, f) one-hot.

``load_torch_checkpoint`` reads OpenAI's whole-module pickles without
the ``dall_e`` classes, and plain state-dict pickles; ``load_openai_vae``
builds the wrapper from two local files. JAX downloads a missing file;
the port never fetches anything and refuses with ``MissingWeights``,
which names the flag to set.
"""

from __future__ import annotations

import io
import math
import os
import pickle
import types
from collections import OrderedDict
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .vae import cudnn_deterministic

LOGIT_LAPLACE_EPS = 0.1


class MissingWeights(FileNotFoundError):
    """A pretrained VAE's weight file was not given or does not exist:
    the port reads local files only, and never downloads."""


def require_file(path: Optional[str], flag: str, what: str) -> str:
    """``path`` when it names a file; else ``MissingWeights`` naming
    ``flag``, the option that gives it."""
    if not path:
        raise MissingWeights(f"{what}: no local file given; set {flag} (weights are never "
                             "downloaded)")
    if not os.path.isfile(path):
        raise MissingWeights(f"{what}: {path} does not exist; set {flag} to a local file "
                             "(weights are never downloaded)")
    return path


def map_pixels(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> the logit-Laplace domain."""
    return (1 - 2 * LOGIT_LAPLACE_EPS) * x + LOGIT_LAPLACE_EPS


def unmap_pixels(x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``map_pixels``, clipped to [0, 1]."""
    return ((x - LOGIT_LAPLACE_EPS) / (1 - 2 * LOGIT_LAPLACE_EPS)).clamp(0, 1)


class OAIConv(nn.Module):
    """The dVAE's square conv, (kw - 1) // 2 same padding; ``w`` OIHW,
    ``b``; computes in its input's type."""

    def __init__(self, n_in: int, n_out: int, kw: int, device=None):
        super().__init__()
        self.kw = kw
        self.w = nn.Parameter(torch.empty(n_out, n_in, kw, kw, device=device))
        self.b = nn.Parameter(torch.zeros(n_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.w.to(x.dtype), self.b.to(x.dtype), padding=(self.kw - 1) // 2)


class _Block(nn.Module):
    """Bottleneck residual block: ``id_path`` (a 1x1 conv on a channel
    change) plus ``post_gain`` times the ReLU-conv ``res_path`` of
    ``kernels``."""

    def __init__(self, n_in: int, n_out: int, n_layers: int, kernels, device=None):
        super().__init__()
        n_hid = n_out // 4
        self.post_gain = 1 / n_layers**2
        self.id_path = OAIConv(n_in, n_out, 1, device) if n_in != n_out else nn.Identity()
        chans = (n_in, n_hid, n_hid, n_hid, n_out)
        layers = []
        for k, kw in enumerate(kernels, start=1):
            layers += [(f"relu_{k}", nn.ReLU()),
                       (f"conv_{k}", OAIConv(chans[k - 1], chans[k], kw, device))]
        self.res_path = nn.Sequential(OrderedDict(layers))

    def forward(self, x):
        return self.id_path(x) + self.post_gain * self.res_path(x)


class OAIEncoderBlock(_Block):
    """The encoder's block: res path kernels 3, 3, 3, 1."""

    def __init__(self, n_in: int, n_out: int, n_layers: int, device=None):
        super().__init__(n_in, n_out, n_layers, (3, 3, 3, 1), device)


class OAIDecoderBlock(_Block):
    """The decoder's block: res path kernels 1, 3, 3, 3."""

    def __init__(self, n_in: int, n_out: int, n_layers: int, device=None):
        super().__init__(n_in, n_out, n_layers, (1, 3, 3, 3), device)


class OpenAIEncoder(nn.Module):
    """7x7 input conv, 4 groups of ``n_blk_per_group`` blocks at 1, 2, 4,
    8 x ``n_hid`` channels with a 2x2 max pool between groups, ReLU and a
    1x1 conv to ``vocab_size`` logits. NCHW in the logit-Laplace domain
    -> (b, vocab, f, f)."""

    def __init__(self, group_count: int = 4, n_hid: int = 256, n_blk_per_group: int = 2,
                 vocab_size: int = 8192, device=None):
        super().__init__()
        n_layers = group_count * n_blk_per_group
        groups = [("input", OAIConv(3, n_hid, 7, device))]
        n_in = n_hid
        for g, mult in enumerate((1, 2, 4, 8)[:group_count], start=1):
            blocks = []
            for i in range(n_blk_per_group):
                blocks.append((f"block_{i + 1}",
                               OAIEncoderBlock(n_in, mult * n_hid, n_layers, device)))
                n_in = mult * n_hid
            if g < group_count:
                blocks.append(("pool", nn.MaxPool2d(kernel_size=2)))
            groups.append((f"group_{g}", nn.Sequential(OrderedDict(blocks))))
        groups.append(("output", nn.Sequential(OrderedDict(
            [("relu", nn.ReLU()), ("conv", OAIConv(n_in, vocab_size, 1, device))]))))
        self.blocks = nn.Sequential(OrderedDict(groups))

    def forward(self, x):
        return self.blocks(x)


class OpenAIDecoder(nn.Module):
    """1x1 input conv from a one-hot over ``vocab_size``, 4 groups of
    blocks at 8, 4, 2, 1 x ``n_hid`` channels with a nearest 2x upsample
    between groups, ReLU and a 1x1 conv to 2 * ``output_channels``
    statistics. NCHW."""

    def __init__(self, group_count: int = 4, n_init: int = 128, n_hid: int = 256,
                 n_blk_per_group: int = 2, output_channels: int = 3,
                 vocab_size: int = 8192, device=None):
        super().__init__()
        n_layers = group_count * n_blk_per_group
        groups = [("input", OAIConv(vocab_size, n_init, 1, device))]
        n_in = n_init
        for g, mult in enumerate((8, 4, 2, 1)[-group_count:], start=1):
            blocks = []
            for i in range(n_blk_per_group):
                blocks.append((f"block_{i + 1}",
                               OAIDecoderBlock(n_in, mult * n_hid, n_layers, device)))
                n_in = mult * n_hid
            if g < group_count:
                blocks.append(("upsample", nn.Upsample(scale_factor=2, mode="nearest")))
            groups.append((f"group_{g}", nn.Sequential(OrderedDict(blocks))))
        groups.append(("output", nn.Sequential(OrderedDict(
            [("relu", nn.ReLU()), ("conv", OAIConv(n_in, 2 * output_channels, 1, device))]))))
        self.blocks = nn.Sequential(OrderedDict(groups))

    def forward(self, z):
        """z: (b, vocab, f, f) one-hot -> (b, 2 * output_channels, 8f, 8f)."""
        return self.blocks(z)

    def embed_tokens(self, ids: torch.Tensor, dtype) -> torch.Tensor:
        """The input conv of the one-hot of ``ids`` (b, f, f), as a gather
        of its weight's columns: (b, n_init, f, f) in ``dtype``."""
        conv = self.blocks.input
        cols = conv.w[:, :, 0, 0].t().to(dtype)  # (vocab, n_init)
        return (cols[ids] + conv.b.to(dtype)).permute(0, 3, 1, 2)

    def from_tokens(self, ids: torch.Tensor, dtype) -> torch.Tensor:
        """``forward`` of the one-hot of ``ids`` (b, f, f), through
        ``embed_tokens``."""
        return self.blocks[1:](self.embed_tokens(ids, dtype))


class OpenAIDiscreteVAE(nn.Module):
    """The frozen OpenAI dVAE with the ``DiscreteVAE`` surface; JAX's
    fields ``image_size``, ``num_layers``, ``num_tokens``, ``n_hid`` and
    ``dtype`` (the compute type; parameters are float32). Its weights
    are ``enc`` and ``dec``."""

    normalization = None  # decode's pixels are already in [0, 1]

    def __init__(self, *, image_size: int = 256, num_layers: int = 3, num_tokens: int = 8192,
                 n_hid: int = 256, device="cuda", dtype=torch.float32):
        super().__init__()
        self.image_size, self.num_layers = image_size, num_layers
        self.num_tokens, self.n_hid, self.dtype = num_tokens, n_hid, dtype
        self.enc = OpenAIEncoder(n_hid=n_hid, vocab_size=num_tokens, device=device)
        self.dec = OpenAIDecoder(n_hid=n_hid, vocab_size=num_tokens, device=device)
        self.requires_grad_(False)

    @property
    def fmap_size(self) -> int:
        return self.image_size // (2**self.num_layers)

    @property
    def image_seq_len(self) -> int:
        return self.fmap_size**2

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "OpenAIDiscreteVAE":
        """Seeded random weights: each ``w`` N(0, 1 / (n_in kw^2)) (JAX's
        ``OAIConv`` initializer), ``b`` 0. ``generator`` lives on the
        model's device."""
        for m in self.modules():
            if isinstance(m, OAIConv):
                n_in = m.w.shape[1]
                nn.init.normal_(m.w, std=1 / math.sqrt(n_in * m.kw**2), generator=generator)
                nn.init.zeros_(m.b)
        return self

    def encode_logits(self, img: torch.Tensor) -> torch.Tensor:
        """img (b, h, w, 3) in [0, 1] -> (b, f, f, num_tokens) logits in
        ``dtype``."""
        x = map_pixels(img.float()).to(self.dtype).permute(0, 3, 1, 2)
        return self.enc(x).permute(0, 2, 3, 1)

    @torch.no_grad()
    def code_scores(self, img: torch.Tensor) -> torch.Tensor:
        """img (b, h, w, 3) in [0, 1] -> (b, f*f, num_tokens) logits,
        whose argmax is each position's id."""
        logits = self.encode_logits(img)
        return logits.reshape(logits.shape[0], -1, self.num_tokens)

    @torch.no_grad()
    def get_codebook_indices(self, img: torch.Tensor) -> torch.Tensor:
        """img (b, h, w, 3) in [0, 1] -> (b, f*f) token ids."""
        return self.code_scores(img).argmax(dim=-1)

    @torch.no_grad()
    def decode(self, img_seq: torch.Tensor) -> torch.Tensor:
        """Token ids (b, n) -> (b, H, W, 3) float32 pixels in [0, 1]."""
        b, n = img_seq.shape
        f = math.isqrt(n)
        ids = img_seq.long().reshape(b, f, f)
        with cudnn_deterministic():
            stats = self.dec.from_tokens(ids, self.dtype).float()
        return unmap_pixels(torch.sigmoid(stats[:, :3])).permute(0, 2, 3, 1)

    def forward(self, img):
        raise NotImplementedError("OpenAIDiscreteVAE is frozen and inference-only")


# ------------------------------------------------------- torch-pickle ingest


class _StandIn:
    """Stands in for a class the unpickler cannot import (``dall_e.*``):
    takes any construction protocol and keeps the pickled state."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_pickled_state"] = state


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_StandIn,), {"__module__": module})


def _walk_module_tree(obj, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The flat {dotted name: tensor} state dict of an unpickled (possibly
    stand-in) ``nn.Module`` graph."""
    out: Dict[str, torch.Tensor] = {}
    d = getattr(obj, "__dict__", None) or {}
    for coll in ("_parameters", "_buffers"):
        for k, v in (d.get(coll) or {}).items():
            if v is not None:
                out[prefix + k] = v.detach()
    for k, v in (d.get("_modules") or {}).items():
        if v is not None:
            out.update(_walk_module_tree(v, prefix + k + "."))
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch pickle -> a flat state dict of CPU tensors: a plain state
    dict (or one under ``state_dict`` / ``model`` / ``sd``, as taming's
    ``last.ckpt`` keeps it), or a whole pickled module whose package
    (``dall_e``) is not installed, walked out of its stand-ins.

    ``torch.load`` is given the unpickler explicitly, with
    ``weights_only=False``: since torch 2.6 the default is
    ``weights_only=True``, whose restricted unpickler refuses the module
    classes OpenAI's pickles hold. The file is then unpickled in full, so
    read only files from a trusted source."""
    shim = types.ModuleType("tolerant_pickle")
    shim.Unpickler = _TolerantUnpickler
    shim.load = lambda f, **kw: _TolerantUnpickler(f).load()
    shim.loads = lambda b, **kw: _TolerantUnpickler(io.BytesIO(b)).load()
    shim.dump, shim.dumps, shim.HIGHEST_PROTOCOL = pickle.dump, pickle.dumps, pickle.HIGHEST_PROTOCOL
    obj = torch.load(path, map_location="cpu", pickle_module=shim, weights_only=False)
    if isinstance(obj, dict):
        for key in ("state_dict", "model", "sd"):
            if isinstance(obj.get(key), dict):
                obj = obj[key]
                break
        return {k: (v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(v))
                for k, v in obj.items() if hasattr(v, "shape") and hasattr(v, "dtype")}
    return _walk_module_tree(obj)


def load_openai_vae(enc_path: Optional[str], dec_path: Optional[str], dtype=torch.float32,
                    device="cuda") -> OpenAIDiscreteVAE:
    """The OpenAI dVAE from OpenAI's ``encoder.pkl`` / ``decoder.pkl`` (or
    state dicts in their names), computing in ``dtype``. Each file must
    exist locally (``MissingWeights`` names the flag otherwise)."""
    enc_path = require_file(enc_path, "--openai_enc_path", "the OpenAI dVAE encoder")
    dec_path = require_file(dec_path, "--openai_dec_path", "the OpenAI dVAE decoder")
    vae = OpenAIDiscreteVAE(device=device, dtype=dtype)
    vae.enc.load_state_dict(load_torch_checkpoint(enc_path), strict=True)
    vae.dec.load_state_dict(load_torch_checkpoint(dec_path), strict=True)
    return vae
