"""flax parameter trees -> the port's state dicts.

Input is a nested dict of numpy arrays (the JAX package's ``params``
collection after ``jax.device_get``); output is a ``state_dict`` for
``models.dalle.DALLE``, ``models.vae.DiscreteVAE`` or ``models.clip.CLIP``.
Rules:

- Dense kernels are (in, out); ``nn.Linear.weight`` is (out, in).
- The attention ``to_qkv`` columns are ``[q | k | v]``, each (h, d)-major,
  the layout ``Attention`` splits with ``chunk(3)``: a plain transpose.
- Embeddings and LayerNorm (scale -> weight) copy over.
- Conv kernels are HWIO in flax, OIHW in torch. flax's ConvTranspose
  (padding "SAME", no kernel flip) becomes ``nn.ConvTranspose2d(padding=1)``
  with the kernel flipped spatially and laid out (in, out, kh, kw); see
  ``models/vae.py``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _norm(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def dalle_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for ``DALLE`` from the JAX ``DALLE``'s params; a model
    with learned positions (``rotary_emb=False``) brings its text table
    and the image grid's ``row_emb`` / ``col_emb`` as they are."""
    out: Dict[str, torch.Tensor] = {
        "text_emb.weight": _t(params["text_emb"]["embedding"]),
        "image_emb.weight": _t(params["image_emb"]["embedding"]),
    }
    if "text_pos_emb" in params:
        out["text_pos_emb.weight"] = _t(params["text_pos_emb"]["embedding"])
        for name in ("row_emb", "col_emb"):
            out[f"image_pos_emb.{name}"] = _t(params["image_pos_emb"][name])
    _norm(params["final_norm"], "final_norm", out)
    _dense(params["to_logits"], "to_logits", out)
    _transformer(params["transformer"], "transformer", out)
    return out


def _transformer(tr: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    depth = sum(1 for k in tr if k.startswith("attn_"))
    for i in range(depth):
        for kind, names in (("attn", ("to_qkv", "to_out")),
                            ("ff", ("Dense_0", "Dense_1"))):
            block = tr[f"{kind}_{i}"]
            pre = f"{prefix}.{kind}_blocks.{i}"
            out[f"{pre}.scale"] = _t(block["scale"])
            _norm(block["fn"]["LayerNorm_0"], f"{pre}.fn.norm", out)
            inner = block["fn"]["fn"]
            shift = ""
            if set(inner) == {"fn"}:  # a PreShiftToken wraps the module
                inner, shift = inner["fn"], ".fn"
            torch_names = (
                ("to_qkv", "to_out") if kind == "attn" else ("proj_in", "proj_out")
            )
            for name, tname in zip(names, torch_names):
                _dense(inner[name], f"{pre}.fn.fn{shift}.{tname}", out)


def clip_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for ``CLIP`` from the JAX ``CLIP``'s params."""
    out: Dict[str, torch.Tensor] = {
        f"{name}.weight": _t(params[name]["embedding"])
        for name in ("text_emb", "text_pos_emb", "visual_pos_emb")
    }
    for name in ("to_visual_embedding", "to_text_latent", "to_visual_latent"):
        _dense(params[name], name, out)
    for name in ("text_transformer", "visual_transformer"):
        _transformer(params[name], name, out)
    out["temperature"] = _t(params["temperature"])
    return out


def _conv(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    out[f"{prefix}.bias"] = _t(p["bias"])


def _conv_transpose(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    k = np.asarray(p["kernel"])[::-1, ::-1]  # (kh, kw, in, out), flipped
    out[f"{prefix}.weight"] = _t(k.transpose(2, 3, 0, 1))
    out[f"{prefix}.bias"] = _t(p["bias"])


def vae_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for ``DiscreteVAE`` from the JAX ``DiscreteVAE``'s
    params: the codebook, the encoder and the decoder. A tree initialised
    for decoding only (``init(..., method="decode")``) has no encoder, and
    its state dict then has no ``enc_*`` entries."""
    out: Dict[str, torch.Tensor] = {
        "codebook.weight": _t(params["codebook"]["embedding"]),
    }
    kinds = ("enc", "dec") if "enc_out" in params else ("dec",)
    for kind in kinds:
        if f"{kind}_in" in params:
            _conv(params[f"{kind}_in"], f"{kind}_in", out)
        i = 0
        while f"{kind}_res_{i}" in params:
            for j in range(3):
                _conv(params[f"{kind}_res_{i}"][f"Conv_{j}"],
                      f"{kind}_res.{i}.conv{j}", out)
            i += 1
        i = 0
        convert = _conv if kind == "enc" else _conv_transpose
        while f"{kind}_convs_{i}" in params:
            convert(params[f"{kind}_convs_{i}"], f"{kind}_convs.{i}", out)
            i += 1
        _conv(params[f"{kind}_out"], f"{kind}_out", out)
    return out
