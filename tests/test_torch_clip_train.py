"""CLIP training in the port against the JAX package on the CPU: the
symmetric InfoNCE loss (``CLIP(..., return_loss=True)``) and every
parameter's gradient against ``jax.value_and_grad`` of JAX's, on
converted weights (every leaf perturbed), with prompts padded by zeros
and the key mask ``text != 0``, at a text length both sides run on the
packed-qkv path (text_seq_len 128, 2 heads of 64: JAX's kernel in
interpret mode, the port's plain version, non-causal with the key mask;
its bfloat16 check runs in test_torch_clip_train_bf16.py, the dense tiny
CLIP's in test_torch_clip_train_dense.py, the checkpoints in
test_torch_clip_checkpoint.py).

- float32: the loss to rtol 1e-5 and each gradient within 1e-4 of its
  tensor's max abs gradient (test_torch_train.py's tolerances);
- bfloat16 compute on float32 parameters (JAX's
  ``CLIP(dtype=jnp.bfloat16)``): within ``testing.BF16_GAP_FACTOR``
  times JAX's own bf16-to-float32 gap (``testing.gap_ratio``) every
  gradient of more than one entry, the (b, b) similarity logits and the
  2b cross-entropy terms whose mean is the loss, and the two scalars, the
  loss and the temperature's gradient, whose gaps are measured on what
  they sum: the loss's relative error within the factor times the terms'
  relative gap, the temperature's gradient's within the factor times
  that of its (b, b) summands ``dloss/dlogits * logits``. (A scalar's
  own gap is one draw: JAX's text-side and image-side bf16 errors can
  cancel in it, to a tenth of either alone.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models.clip import CLIP as JCLIP
from dalle_pytorch_tpu_torch.convert import clip_state_dict
from dalle_pytorch_tpu_torch.models.clip import CLIP
from dalle_pytorch_tpu_torch.ops.attention import full_route
from dalle_pytorch_tpu_torch.testing import BF16_GAP_FACTOR, gap_ratio, rel_l2
from test_torch_clip import CANON, KERNEL_TEXT, converted, inputs

torch.set_num_threads(2)

CONFIGS = {"packed": KERNEL_TEXT, "dense": CANON}


def _jax_loss_and_grads(config, params, text, image, dtype=jnp.float32):
    jclip = JCLIP(**config, dtype=dtype)

    def loss_fn(p):
        return jclip.apply({"params": p}, jnp.asarray(text), jnp.asarray(image, dtype),
                           text_mask=jnp.asarray(text != 0), return_loss=True)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), clip_state_dict(jax.device_get(grads))


def _port_loss_and_grads(config, params, text, image, dtype=torch.float32):
    model = CLIP(**config, device="cpu", dtype=dtype, param_dtype=torch.float32)
    model.load_state_dict(clip_state_dict(params))
    t = torch.from_numpy(text).long()
    loss = model(t, torch.from_numpy(image).to(dtype), text_mask=t != 0, return_loss=True)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.item(), dict(zip([k for k, _ in model.named_parameters()], grads))


def clip_case(name):
    """(route name, config, perturbed JAX params, text, image)."""
    config = CONFIGS[name]
    _, params, _ = converted(config, seed=3)
    text, image = inputs(config, b=4, seed=5)
    return name, config, params, text, image


@pytest.fixture(scope="module")
def case():
    return clip_case("packed")


def test_text_encoder_takes_the_named_route(case):
    name, config, *_ = case
    assert full_route(config["text_seq_len"], config["text_heads"],
                      config["text_dim_head"]) == name


def test_loss_and_every_gradient_match_jax_float32(case):
    _, config, params, text, image = case
    assert (text == 0).any()  # the key mask matters
    ref_loss, ref = _jax_loss_and_grads(config, params, text, image)
    loss, grads = _port_loss_and_grads(config, params, text, image)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert sorted(grads) == sorted(ref)
    for name, g in grads.items():
        scale = ref[name].abs().max().item()
        err = (g - ref[name]).abs().max().item()
        assert err <= 1e-4 * scale + 1e-12, (name, err, scale)


def _jax_logits(config, params, text, image, dtype):
    """JAX's (b, b) similarity logits, its ``__call__`` up to the loss."""

    def logits(m):
        from dalle_pytorch_tpu.models.clip import masked_mean

        mask = jnp.asarray(text != 0)
        tokens = m.text_emb(jnp.asarray(text)) + m.text_pos_emb(jnp.arange(text.shape[1]))[None]
        enc = m.text_transformer(tokens.astype(dtype), mask=mask)
        patches = m.patchify(jnp.asarray(image, dtype))
        img = m.to_visual_embedding(patches) + m.visual_pos_emb(
            jnp.arange(patches.shape[1]))[None]
        tl = m.to_text_latent(masked_mean(enc, mask, axis=1)).astype(jnp.float32)
        il = m.to_visual_latent(m.visual_transformer(img).mean(axis=1)).astype(jnp.float32)
        tl, il = (t / jnp.linalg.norm(t, axis=-1, keepdims=True) for t in (tl, il))
        return tl @ il.T * jnp.exp(m.temperature)

    return np.asarray(JCLIP(**config, dtype=dtype).apply({"params": params}, method=logits),
                      np.float64)


def _port_logits(config, params, text, image, dtype):
    model = CLIP(**config, device="cpu", dtype=dtype, param_dtype=torch.float32)
    model.load_state_dict(clip_state_dict(params))
    t = torch.from_numpy(text).long()
    with torch.no_grad():
        tl, il = model.latents(t, torch.from_numpy(image).to(dtype), text_mask=t != 0)
        return (tl @ il.t() * model.temperature.exp()).double().numpy()


def _terms_and_summands(logits):
    """(the 2b cross-entropy terms, the (b, b) summands of the loss's
    gradient with respect to the temperature), float64."""
    b = logits.shape[0]
    rows = logits - logits.max(-1, keepdims=True)
    cols = logits.T - logits.T.max(-1, keepdims=True)
    log_p = rows - np.log(np.exp(rows).sum(-1, keepdims=True))
    log_q = cols - np.log(np.exp(cols).sum(-1, keepdims=True))
    terms = -np.concatenate([np.diag(log_p), np.diag(log_q)])
    dlogits = (np.exp(log_p) - np.eye(b)) / (2 * b) + (np.exp(log_q) - np.eye(b)).T / (2 * b)
    return terms, dlogits * logits


def check_loss_and_every_gradient_bf16(case):
    _, config, params, text, image = case
    f32_loss, f32 = _jax_loss_and_grads(config, params, text, image)
    ref_loss, ref = _jax_loss_and_grads(config, params, text, image, jnp.bfloat16)
    loss, grads = _port_loss_and_grads(config, params, text, image, torch.bfloat16)
    assert all(g.dtype == torch.float32 for g in grads.values())
    worst = max((gap_ratio(g, ref[k], f32[k]), k) for k, g in grads.items() if g.numel() > 1)
    assert worst[0] <= BF16_GAP_FACTOR, worst

    lf32, lref, lport = (f(config, params, text, image, dt) for f, dt in (
        (_jax_logits, jnp.float32), (_jax_logits, jnp.bfloat16),
        (_port_logits, torch.bfloat16)))
    assert gap_ratio(lport, lref, lf32) <= BF16_GAP_FACTOR
    (tf32, sf32), (tref, sref), (tport, sport) = map(_terms_and_summands, (lf32, lref, lport))
    assert gap_ratio(tport, tref, tf32) <= BF16_GAP_FACTOR
    assert gap_ratio(sport, sref, sf32) <= BF16_GAP_FACTOR
    np.testing.assert_allclose(tref.mean(), ref_loss, rtol=1e-5)  # the terms are the loss's
    np.testing.assert_allclose(sref.sum(), ref["temperature"].item(), rtol=1e-4)
    assert rel_l2(torch.tensor(loss), torch.tensor(ref_loss)) <= BF16_GAP_FACTOR * rel_l2(
        torch.from_numpy(tref), torch.from_numpy(tf32))
    assert rel_l2(grads["temperature"], ref["temperature"]) <= BF16_GAP_FACTOR * rel_l2(
        torch.from_numpy(sref), torch.from_numpy(sf32))


def test_similarity_unchanged_by_return_loss(case):
    """Without ``return_loss`` the forward is the rerank's similarity:
    the diagonal of the loss's matrix over exp(temperature)."""
    _, config, params, text, image = case
    model = CLIP(**config, device="cpu")
    model.load_state_dict(clip_state_dict(params))
    t = torch.from_numpy(text).long()
    with torch.no_grad():
        sim = model(t, torch.from_numpy(image), text_mask=t != 0)
    jsim = JCLIP(**config).apply({"params": params}, jnp.asarray(text), jnp.asarray(image),
                                 text_mask=jnp.asarray(text != 0))
    np.testing.assert_allclose(sim.numpy(), np.asarray(jsim), atol=1e-5)
