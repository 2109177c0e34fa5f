"""flax parameter trees <-> the port's state dicts.

Input is a nested dict of numpy arrays (the JAX package's ``params``
collection after ``jax.device_get``, or a checkpoint's tree of tensors);
output is a ``state_dict`` for ``models.dalle.DALLE``,
``models.vae.DiscreteVAE``, ``models.clip.CLIP``,
``models.pretrained.OpenAIDiscreteVAE`` (``openai_vae_state_dict``) or
``models.vqgan.VQGanVAE`` (``vqgan_state_dict``). ``dalle_params``,
``vae_params``, ``clip_params``, ``openai_vae_params`` and
``vqgan_params`` go the other way, to the tree the JAX
module's ``init`` gives (float32 numpy arrays), and ``optax_adam_state`` /
``adam_from_optax`` carry the train step's ``AdamState`` to and from
optax's ``chain(clip_by_global_norm, scale_by_adam)`` state as flax
serializes it, ``{"0": {}, "1": {"count", "mu", "nu"}}`` (the DALLE
trainer's), or ``chain(clip_by_global_norm, adam(lr))``'s, ``{"0": {},
"1": {"0": {"count", "mu", "nu"}, "1": {}}}`` (the CLIP trainer's,
``scaled``), and its ``MultiStepsState`` (gradient accumulation) to and
from ``optax.MultiSteps``' around the first, ``{"mini_step",
"gradient_step", "inner_opt_state": <the chain's>, "acc_grads": <a params
tree>, "skip_state": {}}``; the moments' trees are a DALLE's, or with
``clip_params`` / ``clip_state_dict`` a CLIP's. A flax -> torch -> flax
round trip is bitwise. Rules:

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

import re
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


# ------------------------------------------------- torch -> flax (inverse)


def _a(t, perm=None, flip=()) -> np.ndarray:
    """A float32 C-order copy of ``t`` with its axes permuted by ``perm``
    and ``flip`` reversed; a tensor is laid out on its own device first,
    so a card's tensor crosses to the host once, in its final layout."""
    if isinstance(t, torch.Tensor):
        t = t.detach().float()
        if perm is not None:
            t = t.permute(*perm)
        if flip:
            t = t.flip(flip)
        return t.contiguous().to("cpu", copy=True).numpy()
    a = np.asarray(t, dtype=np.float32)
    if perm is not None:
        a = a.transpose(perm)
    if flip:
        a = np.flip(a, flip)
    return np.array(a, order="C")


def _dense_inv(sd: Mapping, prefix: str) -> dict:
    out = {"kernel": _a(sd[f"{prefix}.weight"], (1, 0))}
    if f"{prefix}.bias" in sd:
        out["bias"] = _a(sd[f"{prefix}.bias"])
    return out


def _norm_inv(sd: Mapping, prefix: str) -> dict:
    return {"scale": _a(sd[f"{prefix}.weight"]), "bias": _a(sd[f"{prefix}.bias"])}


def dalle_params(sd: Mapping) -> dict:
    """The JAX ``DALLE``'s params from the port's state dict (the inverse
    of ``dalle_state_dict``); token shift shows in the parameter names."""
    out = {
        "text_emb": {"embedding": _a(sd["text_emb.weight"])},
        "image_emb": {"embedding": _a(sd["image_emb.weight"])},
    }
    if "text_pos_emb.weight" in sd:
        out["text_pos_emb"] = {"embedding": _a(sd["text_pos_emb.weight"])}
        out["image_pos_emb"] = {name: _a(sd[f"image_pos_emb.{name}"])
                                for name in ("row_emb", "col_emb")}
    out["final_norm"] = _norm_inv(sd, "final_norm")
    out["to_logits"] = _dense_inv(sd, "to_logits")
    out["transformer"] = _transformer_inv(sd, "transformer")
    return out


def _transformer_inv(sd: Mapping, prefix: str) -> dict:
    out = {}
    i = 0
    while f"{prefix}.attn_blocks.{i}.scale" in sd:
        for kind, names in (("attn", ("to_qkv", "to_out")), ("ff", ("Dense_0", "Dense_1"))):
            pre = f"{prefix}.{kind}_blocks.{i}"
            torch_names = ("to_qkv", "to_out") if kind == "attn" else ("proj_in", "proj_out")
            shift = f"{pre}.fn.fn.fn.{torch_names[0]}.weight" in sd
            base = f"{pre}.fn.fn.fn" if shift else f"{pre}.fn.fn"
            inner = {name: _dense_inv(sd, f"{base}.{tname}")
                     for name, tname in zip(names, torch_names)}
            out[f"{kind}_{i}"] = {
                "fn": {"LayerNorm_0": _norm_inv(sd, f"{pre}.fn.norm"),
                       "fn": {"fn": inner} if shift else inner},
                "scale": _a(sd[f"{pre}.scale"]),
            }
        i += 1
    return out


def clip_params(sd: Mapping) -> dict:
    """The JAX ``CLIP``'s params from the port's state dict (the inverse
    of ``clip_state_dict``)."""
    out = {name: {"embedding": _a(sd[f"{name}.weight"])}
           for name in ("text_emb", "text_pos_emb", "visual_pos_emb")}
    for name in ("to_visual_embedding", "to_text_latent", "to_visual_latent"):
        out[name] = _dense_inv(sd, name)
    for name in ("text_transformer", "visual_transformer"):
        out[name] = _transformer_inv(sd, name)
    out["temperature"] = _a(sd["temperature"])
    return out


def _conv_inv(sd: Mapping, prefix: str) -> dict:
    return {"kernel": _a(sd[f"{prefix}.weight"], (2, 3, 1, 0)), "bias": _a(sd[f"{prefix}.bias"])}


def _conv_transpose_inv(sd: Mapping, prefix: str) -> dict:
    return {"kernel": _a(sd[f"{prefix}.weight"], (2, 3, 0, 1), flip=(0, 1)),
            "bias": _a(sd[f"{prefix}.bias"])}


def vae_params(sd: Mapping) -> dict:
    """The JAX ``DiscreteVAE``'s params from the port's state dict (the
    inverse of ``vae_state_dict``)."""
    out = {"codebook": {"embedding": _a(sd["codebook.weight"])}}
    kinds = ("enc", "dec") if "enc_out.weight" in sd else ("dec",)
    for kind in kinds:
        if f"{kind}_in.weight" in sd:
            out[f"{kind}_in"] = _conv_inv(sd, f"{kind}_in")
        i = 0
        while f"{kind}_res.{i}.conv0.weight" in sd:
            out[f"{kind}_res_{i}"] = {f"Conv_{j}": _conv_inv(sd, f"{kind}_res.{i}.conv{j}")
                                      for j in range(3)}
            i += 1
        i = 0
        convert = _conv_inv if kind == "enc" else _conv_transpose_inv
        while f"{kind}_convs.{i}.weight" in sd:
            out[f"{kind}_convs_{i}"] = convert(sd, f"{kind}_convs.{i}")
            i += 1
        out[f"{kind}_out"] = _conv_inv(sd, f"{kind}_out")
    return out


# ------------------------------------------------ the pretrained VAEs


def _oihw(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _openai_torch_name(name: str) -> str:
    """A flax child of JAX's ``OpenAIEncoder`` / ``OpenAIDecoder``
    (``input``, ``output_conv``, ``group_<g>_block_<i>/id_path``,
    ``group_<g>_block_<i>/res_conv_<k>``) -> its ``dall_e`` module path."""
    if name == "input":
        return "blocks.input"
    if name == "output_conv":
        return "blocks.output.conv"
    block, sub = name.split("/")
    group, index = re.fullmatch(r"(group_\d+)_(block_\d+)", block).groups()
    path = "id_path" if sub == "id_path" else f"res_path.{sub[len('res_'):]}"
    return f"blocks.{group}.{index}.{path}"


def openai_vae_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for ``OpenAIDiscreteVAE`` from JAX's params (``enc`` /
    ``dec``, each an ``OpenAIEncoder`` / ``OpenAIDecoder`` tree whose
    convs hold ``w`` HWIO and ``b``); a tree with one of the two gives
    that one's entries."""
    out: Dict[str, torch.Tensor] = {}
    for part in ("enc", "dec"):
        for name, node in params.get(part, {}).items():
            convs = ({name: node} if "w" in node
                     else {f"{name}/{sub}": leaf for sub, leaf in node.items()})
            for flax_name, conv in convs.items():
                base = f"{part}.{_openai_torch_name(flax_name)}"
                out[f"{base}.w"] = _oihw(conv["w"])
                out[f"{base}.b"] = _t(conv["b"])
    return out


def openai_vae_params(sd: Mapping) -> dict:
    """JAX's ``OpenAIDiscreteVAE`` params from the port's state dict (the
    inverse of ``openai_vae_state_dict``)."""
    out: dict = {}
    for key in sd:
        part, rest = key.split(".", 1)
        if not rest.endswith(".w"):
            continue
        base = rest[:-2]
        conv = {"w": _a(sd[key], (2, 3, 1, 0)), "b": _a(sd[f"{part}.{base}.b"])}
        tree = out.setdefault(part, {})
        if base == "blocks.input":
            tree["input"] = conv
        elif base == "blocks.output.conv":
            tree["output_conv"] = conv
        else:
            _, group, block, *sub = base.split(".")
            name = "id_path" if sub == ["id_path"] else f"res_{sub[1]}"
            tree.setdefault(f"{group}_{block}", {})[name] = conv
    return out


def _taming_torch_name(flat: str) -> str:
    """JAX's flat child name inside the VQGAN's encoder / decoder
    (taming's dotted path with the dots as underscores) -> the dotted
    path."""
    m = re.fullmatch(r"mid_((?:block|attn)_\d+)_(.+)", flat)
    if m:
        return f"mid.{m[1]}.{m[2]}"
    m = re.fullmatch(r"(down|up)_(\d+)_(block|attn)_(\d+)_(.+)", flat)
    if m:
        return f"{m[1]}.{m[2]}.{m[3]}.{m[4]}.{m[5]}"
    m = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)_conv", flat)
    if m:
        return f"{m[1]}.{m[2]}.{m[3]}.conv"
    return flat  # conv_in, conv_out, norm_out


def _conv_or_norm(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _oihw(p["kernel"]) if "kernel" in p else _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def vqgan_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for ``VQGanVAE`` (taming's names) from JAX's params:
    ``encoder`` / ``decoder`` with flat children, ``quant_conv``,
    ``post_quant_conv`` and ``quantize`` (``embedding``, or ``proj`` and
    ``embed``, tables kept (n_embed, embed_dim))."""
    out: Dict[str, torch.Tensor] = {}
    for top in ("encoder", "decoder"):
        for flat, p in params.get(top, {}).items():
            _conv_or_norm(p, f"{top}.{_taming_torch_name(flat)}", out)
    for top in ("quant_conv", "post_quant_conv"):
        if top in params:
            _conv_or_norm(params[top], top, out)
    quantize = params.get("quantize", {})
    for table in ("embedding", "embed"):
        if table in quantize:
            out[f"quantize.{table}.weight"] = _t(quantize[table])
    if "proj" in quantize:
        _conv_or_norm(quantize["proj"], "quantize.proj", out)
    return out


def vqgan_params(sd: Mapping) -> dict:
    """JAX's ``VQGanVAE`` params from the port's state dict (the inverse
    of ``vqgan_state_dict``)."""
    out: dict = {}
    for key, value in sd.items():
        parts = key.split(".")
        top, leaf = parts[0], parts[-1]
        if top == "quantize" and parts[1] in ("embedding", "embed"):
            out.setdefault("quantize", {})[parts[1]] = _a(value)
            continue
        if leaf == "weight":
            leaf, value = ("kernel", _a(value, (2, 3, 1, 0))) if len(value.shape) == 4 \
                else ("scale", _a(value))
        else:
            value = _a(value)
        if top in ("encoder", "decoder"):
            node = out.setdefault(top, {}).setdefault("_".join(parts[1:-1]), {})
        elif top == "quantize":
            node = out.setdefault("quantize", {}).setdefault("proj", {})
        else:
            node = out.setdefault(top, {})
        node[leaf] = value
    return out


def _int32(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype=np.int32)


def optax_adam_state(opt, to_flax=dalle_params, scaled: bool = False) -> dict:
    """optax's state, as flax serializes it, of a train step's optimizer
    state: ``chain(clip_by_global_norm, scale_by_adam)``'s of an
    ``AdamState`` (``chain(clip_by_global_norm, adam(lr))``'s with
    ``scaled``), ``MultiSteps``' around it of a ``MultiStepsState``; the
    moments' trees by ``to_flax`` (``dalle_params``, ``clip_params``)."""
    from .parallel.step import MultiStepsState

    if isinstance(opt, MultiStepsState):
        return {"mini_step": _int32(opt.mini_step), "gradient_step": _int32(opt.gradient_step),
                "inner_opt_state": optax_adam_state(opt.inner, to_flax, scaled),
                "acc_grads": to_flax(opt.acc), "skip_state": {}}
    adam = {"count": _int32(opt.count), "mu": to_flax(opt.mu), "nu": to_flax(opt.nu)}
    return {"0": {}, "1": {"0": adam, "1": {}} if scaled else adam}


def _counter(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.int32).reshape(()).to(device)


def adam_from_optax(tree: Mapping, device=None, to_torch=dalle_state_dict):
    """The train step's optimizer state of optax's (``optax_adam_state``'s
    forms, either chain): an ``AdamState``, or a ``MultiStepsState`` for
    ``MultiSteps``' state; counters () int32 tensors, moments and
    accumulator float32 tensors keyed by parameter name (``to_torch``:
    ``dalle_state_dict``, ``clip_state_dict``), on ``device``."""
    from .parallel.step import AdamState, MultiStepsState

    def named(t):
        return {k: v.to(device) for k, v in to_torch(t).items()}

    if "mini_step" in tree:
        return MultiStepsState(_counter(tree["mini_step"], device),
                               _counter(tree["gradient_step"], device),
                               adam_from_optax(tree["inner_opt_state"], device, to_torch),
                               named(tree["acc_grads"]))
    adam = tree["1"] if "count" in tree["1"] else tree["1"]["0"]
    return AdamState(_counter(adam["count"], device), named(adam["mu"]), named(adam["nu"]))
