"""Models from checkpoints and back (counterpart of
``dalle_pytorch_tpu/models/factory.py``).

A checkpoint is the plain format of ``utils/checkpoint.py``: its meta
carries the model class and JAX's constructor fields under JAX's names and
values (``config``, and for a DALLE also ``vae_class`` / ``vae_config``),
its state the params as the JAX module's tree (``convert.dalle_params``,
``convert.vae_params``, ``convert.clip_params``), the optimizer state as
optax's (``convert.optax_adam_state``: the clipped Adam's, or
``MultiSteps``' around it with gradient accumulation; a CLIP's the clipped
``optax.adam``'s) and the step. Fields the port does not
model are written at JAX's defaults (``ff_experts: 0``,
``sp_axis: null``, ...), so JAX's
``dalle_from_checkpoint`` rebuilds the same module, and this one reads
JAX's files.

The VAE of a checkpoint is one of ``vae_classes()``: the trainable
``DiscreteVAE``, bundled with its weights, or a frozen pretrained one
(``OpenAIDiscreteVAE``, ``VQGanVAE``), which a DALLE checkpoint stores by
class and config only, as JAX does: ``dalle_from_checkpoint`` reads its
weights from the local files of ``vae_weight_paths`` (JAX's keys
``openai_enc_path``, ``openai_dec_path``, ``vqgan_config_path``,
``vqgan_model_path``) and never downloads them
(``pretrained.MissingWeights``).

On load, a config value the port does not run raises
``NotImplementedError``: experts, gMLP ("mlp") layers, ``serve_quant``,
a float16 model, parameters in another type than float32 for a
pretrained VAE, and a ``DiscreteVAE`` normalization other than the
default. ``sp_axis`` / ``pp_axis`` are a run's layout, not the model's:
the port runs on one card and ignores them, as JAX's command line
re-clones them per run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..convert import (
    adam_from_optax,
    clip_params,
    clip_state_dict,
    dalle_params,
    dalle_state_dict,
    openai_vae_params,
    openai_vae_state_dict,
    optax_adam_state,
    vae_params,
    vae_state_dict,
    vqgan_params,
    vqgan_state_dict,
)
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from .clip import CLIP
from .dalle import DALLE
from .pretrained import OpenAIDiscreteVAE, load_openai_vae
from .vae import NORMALIZATION, DiscreteVAE
from .vqgan import VQGanVAE, load_vqgan_vae

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}

# JAX's DALLE fields in declaration order, at their defaults
DALLE_FIELDS = dict(
    dim=None, depth=None, num_text_tokens=10000, text_seq_len=256, num_image_tokens=512,
    image_fmap_size=32, heads=8, dim_head=64, reversible=False, attn_dropout=0.0,
    ff_dropout=0.0, attn_types=None, loss_img_weight=7.0, stable=False, shift_tokens=True,
    shift_pad=0, rotary_emb=True, remat=False, sparse_layout_seed=0, use_flash=True,
    sp_axis=None, pp_axis=None, pp_microbatches=4, ff_experts=0, moe_every=2,
    moe_capacity_factor=1.25, serve_quant=False, dtype="float32", param_dtype="float32",
)
# JAX's DiscreteVAE fields in declaration order, at their defaults
VAE_FIELDS = dict(
    image_size=256, num_tokens=512, codebook_dim=512, num_layers=3, num_resnet_blocks=0,
    hidden_dim=64, channels=3, smooth_l1_loss=False, temperature=0.9, straight_through=False,
    kl_div_loss_weight=0.0, normalization=[list(t) for t in NORMALIZATION],
    dtype="float32", param_dtype="float32",
)
# JAX's OpenAIDiscreteVAE fields in declaration order, at their defaults
OPENAI_VAE_FIELDS = dict(image_size=256, num_layers=3, num_tokens=8192, n_hid=256,
                         dtype="float32", param_dtype="float32")
# JAX's VQGanVAE fields in declaration order, at their defaults
VQGAN_FIELDS = dict(
    image_size=256, ch=128, ch_mult=[1, 1, 2, 2, 4], num_res_blocks=2, attn_resolutions=[16],
    z_channels=256, n_embed=1024, embed_dim=256, gumbel=False, dtype="float32",
    param_dtype="float32",
)
# JAX's CLIP fields in declaration order, at their defaults
CLIP_FIELDS = dict(
    dim_text=512, dim_image=512, dim_latent=512, num_text_tokens=10000, text_enc_depth=6,
    text_seq_len=256, text_heads=8, text_dim_head=64, num_visual_tokens=512,
    visual_enc_depth=6, visual_heads=8, visual_dim_head=64, visual_image_size=256,
    visual_patch_size=32, channels=3, dtype="float32", param_dtype="float32",
)


def _dtype_name(dtype) -> str:
    if dtype not in _DTYPE_NAMES:
        raise NotImplementedError(f"dtype {dtype} is not ported")
    return _DTYPE_NAMES[dtype]


def dalle_config(dalle: DALLE) -> dict:
    """JAX's constructor fields of the JAX ``DALLE`` equal to ``dalle``."""
    cfg = dict(DALLE_FIELDS)
    cfg.update(
        dim=dalle.dim, depth=dalle.depth, num_text_tokens=dalle.num_text_tokens,
        text_seq_len=dalle.text_seq_len, num_image_tokens=dalle.num_image_tokens,
        image_fmap_size=dalle.image_fmap_size, heads=dalle.heads, dim_head=dalle.dim_head,
        attn_dropout=dalle.attn_dropout, ff_dropout=dalle.ff_dropout,
        attn_types=None if dalle.attn_types is None else list(dalle.attn_types),
        loss_img_weight=dalle.loss_img_weight, stable=dalle.stable,
        shift_tokens=dalle.shift_tokens, shift_pad=dalle.shift_pad,
        rotary_emb=dalle.rotary_emb, reversible=dalle.reversible, remat=dalle.remat,
        sparse_layout_seed=dalle.sparse_layout_seed, dtype=_dtype_name(dalle.dtype),
        param_dtype=_dtype_name(dalle.param_dtype))
    return cfg


def _discrete_config(vae: DiscreteVAE) -> dict:
    dtype = _dtype_name(vae.codebook.weight.dtype)
    return dict(VAE_FIELDS, image_size=vae.image_size, num_tokens=vae.num_tokens,
                codebook_dim=vae.codebook_dim, num_layers=vae.num_layers,
                num_resnet_blocks=vae.num_resnet_blocks, hidden_dim=vae.hidden_dim,
                channels=vae.channels, smooth_l1_loss=vae.smooth_l1_loss,
                temperature=vae.temperature, straight_through=vae.straight_through,
                kl_div_loss_weight=vae.kl_div_loss_weight, dtype=dtype, param_dtype=dtype)


def _openai_config(vae: OpenAIDiscreteVAE) -> dict:
    return dict(OPENAI_VAE_FIELDS, image_size=vae.image_size, num_layers=vae.num_layers,
                num_tokens=vae.num_tokens, n_hid=vae.n_hid, dtype=_dtype_name(vae.dtype))


def _vqgan_config(vae: VQGanVAE) -> dict:
    return dict(VQGAN_FIELDS, image_size=vae.image_size, ch=vae.ch,
                ch_mult=list(vae.ch_mult), num_res_blocks=vae.num_res_blocks,
                attn_resolutions=list(vae.attn_resolutions), z_channels=vae.z_channels,
                n_embed=vae.n_embed, embed_dim=vae.embed_dim, gumbel=vae.gumbel,
                dtype=_dtype_name(vae.dtype))


def clip_config(clip: CLIP) -> dict:
    """JAX's constructor fields of the JAX ``CLIP`` equal to ``clip``."""
    cfg = {k: getattr(clip, k) for k in CLIP_FIELDS if k not in ("dtype", "param_dtype")}
    return {**cfg, "dtype": _dtype_name(clip.dtype), "param_dtype": _dtype_name(clip.param_dtype)}


def _refuse(what: str, value, where: str) -> None:
    raise NotImplementedError(f"{where}: {what}={value!r} is not ported")


def build_dalle(config: dict, device="cuda") -> DALLE:
    """The port's DALLE of JAX's constructor fields ``config`` (random
    weights): refuses what the port does not run."""
    cfg = {**DALLE_FIELDS, **config}
    for name, off in (("ff_experts", 0), ("serve_quant", False)):
        if cfg[name] != off:
            _refuse(name, cfg[name], "DALLE checkpoint")
    types = None if cfg["attn_types"] is None else tuple(cfg["attn_types"])
    if types is not None and "mlp" in types:
        _refuse("attn_types", types, "DALLE checkpoint (gMLP)")
    for name in ("dtype", "param_dtype"):
        if cfg[name] not in _DTYPES:
            _refuse(name, cfg[name], "DALLE checkpoint")
    return DALLE(
        dim=cfg["dim"], depth=cfg["depth"], num_text_tokens=cfg["num_text_tokens"],
        text_seq_len=cfg["text_seq_len"], num_image_tokens=cfg["num_image_tokens"],
        image_fmap_size=cfg["image_fmap_size"], heads=cfg["heads"], dim_head=cfg["dim_head"],
        attn_dropout=cfg["attn_dropout"], ff_dropout=cfg["ff_dropout"], attn_types=types,
        shift_tokens=cfg["shift_tokens"], shift_pad=cfg["shift_pad"],
        rotary_emb=cfg["rotary_emb"], loss_img_weight=cfg["loss_img_weight"], stable=cfg["stable"],
        reversible=bool(cfg["reversible"]), remat=bool(cfg["remat"]),
        sparse_layout_seed=cfg["sparse_layout_seed"], device=device,
        dtype=_DTYPES[cfg["dtype"]], param_dtype=_DTYPES[cfg["param_dtype"]])


def _pretrained_config(fields: dict, config: dict, what: str) -> dict:
    cfg = {**fields, **config}
    if cfg["dtype"] not in _DTYPES or cfg["param_dtype"] != "float32":
        _refuse("dtype", (cfg["dtype"], cfg["param_dtype"]), what)
    return cfg


def _build_discrete(config: dict, device) -> DiscreteVAE:
    cfg = {**VAE_FIELDS, **config}
    norm = [list(t) for t in cfg["normalization"]] if cfg["normalization"] else None
    if norm != VAE_FIELDS["normalization"]:
        _refuse("normalization", cfg["normalization"], "DiscreteVAE checkpoint")
    if cfg["dtype"] not in _DTYPES or cfg["param_dtype"] != cfg["dtype"]:
        _refuse("dtype", (cfg["dtype"], cfg["param_dtype"]), "DiscreteVAE checkpoint")
    return DiscreteVAE(
        image_size=cfg["image_size"], num_tokens=cfg["num_tokens"],
        codebook_dim=cfg["codebook_dim"], num_layers=cfg["num_layers"],
        num_resnet_blocks=cfg["num_resnet_blocks"], hidden_dim=cfg["hidden_dim"],
        channels=cfg["channels"], smooth_l1_loss=cfg["smooth_l1_loss"],
        temperature=cfg["temperature"], straight_through=cfg["straight_through"],
        kl_div_loss_weight=cfg["kl_div_loss_weight"], device=device,
        dtype=_DTYPES[cfg["dtype"]])


def _build_openai(config: dict, device) -> OpenAIDiscreteVAE:
    cfg = _pretrained_config(OPENAI_VAE_FIELDS, config, "OpenAIDiscreteVAE checkpoint")
    return OpenAIDiscreteVAE(image_size=cfg["image_size"], num_layers=cfg["num_layers"],
                             num_tokens=cfg["num_tokens"], n_hid=cfg["n_hid"],
                             device=device, dtype=_DTYPES[cfg["dtype"]])


def _build_vqgan(config: dict, device) -> VQGanVAE:
    cfg = _pretrained_config(VQGAN_FIELDS, config, "VQGanVAE checkpoint")
    return VQGanVAE(image_size=cfg["image_size"], ch=cfg["ch"], ch_mult=tuple(cfg["ch_mult"]),
                    num_res_blocks=cfg["num_res_blocks"],
                    attn_resolutions=tuple(cfg["attn_resolutions"]),
                    z_channels=cfg["z_channels"], n_embed=cfg["n_embed"],
                    embed_dim=cfg["embed_dim"], gumbel=cfg["gumbel"], device=device,
                    dtype=_DTYPES[cfg["dtype"]])


def _load_openai(wp: dict, dtype, device) -> OpenAIDiscreteVAE:
    return load_openai_vae(wp.get("openai_enc_path"), wp.get("openai_dec_path"),
                           dtype=dtype, device=device)


def _load_vqgan(wp: dict, dtype, device) -> VQGanVAE:
    return load_vqgan_vae(wp.get("vqgan_config_path"), wp.get("vqgan_model_path"),
                          dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class _VaeKind:
    """What the factory knows of one VAE class: JAX's fields at their
    defaults, its config and build, its converters, and for a frozen
    pretrained VAE the reader of its local files (None: the weights go
    into the checkpoint)."""
    cls: type
    fields: dict
    config: Callable
    build: Callable
    to_torch: Callable
    to_jax: Callable
    load_local: Optional[Callable] = None


_VAES = {
    "DiscreteVAE": _VaeKind(DiscreteVAE, VAE_FIELDS, _discrete_config, _build_discrete,
                            vae_state_dict, vae_params),
    "OpenAIDiscreteVAE": _VaeKind(OpenAIDiscreteVAE, OPENAI_VAE_FIELDS, _openai_config,
                                  _build_openai, openai_vae_state_dict, openai_vae_params,
                                  _load_openai),
    "VQGanVAE": _VaeKind(VQGanVAE, VQGAN_FIELDS, _vqgan_config, _build_vqgan,
                         vqgan_state_dict, vqgan_params, _load_vqgan),
}


def vae_classes() -> dict:
    """Name -> class of every VAE a checkpoint may carry."""
    return {name: kind.cls for name, kind in _VAES.items()}


def vae_config(vae) -> dict:
    """JAX's constructor fields of the JAX VAE equal to ``vae`` (any of
    ``vae_classes()``)."""
    return _VAES[type(vae).__name__].config(vae)


def build_vae(vae_class: Optional[str], config: dict, device="cuda"):
    """The port's VAE of class ``vae_class`` (a name of ``vae_classes()``)
    and JAX's constructor fields ``config`` (random weights)."""
    if vae_class not in _VAES:
        raise ValueError(f"unknown VAE class {vae_class!r}")
    return _VAES[vae_class].build(config, device)


def build_clip(config: dict, device="cuda", dtype=None) -> CLIP:
    """The port's CLIP of JAX's constructor fields ``config`` (random
    weights), computing in ``dtype`` when given, else in the config's."""
    cfg = {**CLIP_FIELDS, **config}
    for name in ("dtype", "param_dtype"):
        if cfg[name] not in _DTYPES:
            _refuse(name, cfg[name], "CLIP checkpoint")
    fields = {k: cfg[k] for k in CLIP_FIELDS if k not in ("dtype", "param_dtype")}
    return CLIP(**fields, device=device, dtype=dtype or _DTYPES[cfg["dtype"]],
                param_dtype=_DTYPES[cfg["param_dtype"]])


def _load_into(module, sd) -> None:
    own = module.state_dict()
    module.load_state_dict({k: v.to(own[k].dtype) for k, v in sd.items()})


# ------------------------------------------------------------------- VAE


# the keys of ``vae_weight_paths``: the command lines' flags (dests) that
# name a pretrained VAE's local files
VAE_WEIGHT_KEYS = ("openai_enc_path", "openai_dec_path", "vqgan_config_path",
                   "vqgan_model_path")


def save_vae_checkpoint(path, vae, extra: Optional[dict] = None) -> None:
    """A VAE checkpoint (any of ``vae_classes()``) with its weights, as
    JAX's ``save_vae_checkpoint`` writes it."""
    name = type(vae).__name__
    meta = {"model_class": name, "config": vae_config(vae), **(extra or {})}
    save_checkpoint(path, {"params": _VAES[name].to_jax(vae.state_dict())}, meta)


def vae_from_checkpoint(path, device="cuda"):
    """-> (vae with its weights, meta)."""
    state, meta = load_checkpoint(path)
    if meta.get("model_class") not in vae_classes():
        raise ValueError(f"not a VAE checkpoint: {meta.get('model_class')}")
    vae = build_vae(meta["model_class"], meta["config"], device)
    _load_into(vae, _VAES[meta["model_class"]].to_torch(state["params"]))
    return vae, meta


def load_pretrained_vae(vae_class: str, vae_weight_paths: Optional[dict], dtype,
                        device="cuda"):
    """The frozen ``vae_class`` (``OpenAIDiscreteVAE`` or ``VQGanVAE``)
    computing in ``dtype``, from the local files of ``vae_weight_paths``
    (JAX's keys); ``MissingWeights`` names the flag of a missing one."""
    kind = _VAES.get(vae_class)
    if kind is None or kind.load_local is None:
        raise ValueError(f"{vae_class!r} is not a pretrained VAE")
    return kind.load_local(vae_weight_paths or {}, dtype, device)


# ------------------------------------------------------------------ DALLE


def save_dalle_checkpoint(path, dalle: DALLE, vae=None,
                          extra: Optional[dict] = None, opt_state=None,
                          step: Optional[int] = None) -> None:
    """The plain DALLE checkpoint JAX's command line writes: the params,
    the VAE (a ``DiscreteVAE`` with its weights; a frozen pretrained one
    by class and config only), the optimizer state (an ``AdamState`` or
    a ``MultiStepsState``) and the step."""
    meta = {"model_class": "DALLE", "config": dalle_config(dalle), **(extra or {})}
    state = {"params": dalle_params(dalle.state_dict())}
    if vae is not None:
        kind = _VAES[type(vae).__name__]
        meta["vae_class"] = type(vae).__name__
        meta["vae_config"] = kind.config(vae)
        if kind.load_local is None:
            state["vae_params"] = kind.to_jax(vae.state_dict())
    if opt_state is not None:
        state["opt_state"] = optax_adam_state(opt_state)
        meta["has_opt_state"] = True
    if step is not None:
        state["step"] = int(step)
    save_checkpoint(path, state, meta)


def dalle_from_checkpoint(path, device="cuda", loaded=None,
                          vae_weight_paths: Optional[dict] = None):
    """-> (dalle, vae, meta) with their weights; vae is None when the
    checkpoint carries none. A frozen pretrained VAE stored by class and
    config is read from ``vae_weight_paths``' local files, computing in
    its config's type. ``loaded``: ``load_checkpoint(path)``'s result,
    when the caller has read the file already."""
    state, meta = loaded if loaded is not None else load_checkpoint(path)
    if meta.get("model_class") != "DALLE":
        raise ValueError(f"not a DALLE checkpoint: {meta.get('model_class')}")
    dalle = build_dalle(meta["config"], device)
    _load_into(dalle, dalle_state_dict(state["params"]))
    vae = None
    if "vae_config" in meta:
        vae_class = meta.get("vae_class")
        kind = _VAES.get(vae_class)
        if "vae_params" in state:
            vae = build_vae(vae_class, meta["vae_config"], device)
            _load_into(vae, kind.to_torch(state["vae_params"]))
        elif kind is not None and kind.load_local is not None:
            cfg = _pretrained_config(kind.fields, meta["vae_config"], f"{vae_class} checkpoint")
            vae = kind.load_local(vae_weight_paths or {}, _DTYPES[cfg["dtype"]], device)
        else:
            build_vae(vae_class, meta["vae_config"], "meta")  # refuses an unknown class
            raise ValueError(f"{path}: the checkpoint names a VAE but carries no weights")
    return dalle, vae, meta


def restore_opt_state(path, device="cuda", loaded=None):
    """The optimizer state saved by ``save_dalle_checkpoint`` or
    ``save_clip_checkpoint`` (or JAX's): an ``AdamState``, a
    ``MultiStepsState`` for ``MultiSteps``' state, or None when the
    checkpoint carries none."""
    state, meta = loaded if loaded is not None else load_checkpoint(path)
    if not meta.get("has_opt_state"):
        return None
    to_torch = clip_state_dict if meta.get("model_class") == "CLIP" else dalle_state_dict
    return adam_from_optax(state["opt_state"], device=device, to_torch=to_torch)


# ------------------------------------------------------------------- CLIP


def save_clip_checkpoint(path, clip: CLIP, extra: Optional[dict] = None,
                         opt_state=None) -> None:
    """The plain CLIP checkpoint JAX's ``train_clip.py`` writes: the
    params and, when given, the optimizer state (an ``AdamState``) as
    ``chain(clip_by_global_norm, adam(lr))``'s."""
    meta = {"model_class": "CLIP", "config": clip_config(clip), **(extra or {})}
    state = {"params": clip_params(clip.state_dict())}
    if opt_state is not None:
        state["opt_state"] = optax_adam_state(opt_state, clip_params, scaled=True)
        meta["has_opt_state"] = True
    save_checkpoint(path, state, meta)


def clip_from_checkpoint(path, device="cuda", dtype=None, loaded=None) -> Tuple[CLIP, dict]:
    """-> (clip with its weights, meta); ``dtype`` overrides the compute
    type the checkpoint names (its parameters keep theirs), as JAX's
    ``train_clip.py`` re-clones a resumed CLIP."""
    state, meta = loaded if loaded is not None else load_checkpoint(path)
    if meta.get("model_class") != "CLIP":
        raise ValueError(f"not a CLIP checkpoint: {meta.get('model_class')}")
    clip = build_clip(meta["config"], device, dtype)
    _load_into(clip, clip_state_dict(state["params"]))
    return clip, meta
