"""Dropout in the port (``ops/layers.dropout``, after each attention's
``to_out`` and after each feed-forward's gate) against the JAX package's
flax ``nn.Dropout`` on the CPU, float32.

JAX's keep masks are read from ``capture_intermediates``: the non-zero
pattern of each ``Dropout`` output of a small ``DALLE`` with both rates
0.1 (``deterministic=False``, one "dropout" key). The port draws them
through ``testing.dropout_masks(replay=...)`` in JAX's module order. On
the same weights, batch and masks, the loss within rtol 1e-5 and every
parameter's gradient within 1e-4 of its tensor's max abs gradient
(``tests/test_torch_train.py``'s float32 tolerances), on the packed route
(n 128, rotary, token shift) and the dense route (n 24, learned
positions). Also:

- the formula bit for bit: ``select(mask, x / keep_prob, 0)``, divided in
  x's dtype (float32 and bfloat16), against the same select in JAX;
- rate 0, or a deterministic call (no generator), is bitwise the model without dropout
  and draws nothing; rate 1 gives zeros, and the rate-1 model's loss
  matches JAX's;
- the same generator state gives bitwise the same loss, another seed
  another loss, and the kept share is near 0.9;
- ``DalleTrainer`` keys each dispatch's generator by the applied steps:
  a step the NaN guard rejects is retried with the masks it drew, and the
  faulted run ends bitwise the clean one.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import DALLE as JDALLE
from dalle_pytorch_tpu_torch import train_dalle
from dalle_pytorch_tpu_torch.convert import dalle_state_dict
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
from dalle_pytorch_tpu_torch.ops import layers
from dalle_pytorch_tpu_torch.ops.attention import full_route
from dalle_pytorch_tpu_torch.testing import dropout_masks

torch.set_num_threads(2)

RATES = dict(attn_dropout=0.1, ff_dropout=0.1)
CONFIGS = {
    "packed": dict(dim=128, depth=2, num_text_tokens=50, text_seq_len=64, num_image_tokens=40,
                   image_fmap_size=8, heads=2, dim_head=64, shift_tokens=True, rotary_emb=True),
    "dense": dict(dim=64, depth=2, num_text_tokens=50, text_seq_len=8, num_image_tokens=40,
                  image_fmap_size=4, heads=2, dim_head=32, shift_tokens=False,
                  rotary_emb=False),
}


def batch(config, seed, b=2):
    rng = np.random.RandomState(seed)
    t = config["text_seq_len"]
    text = rng.randint(1, config["num_text_tokens"], size=(b, t)).astype(np.int32)
    for i in range(b):
        text[i, rng.randint(2, t):] = 0
    image = rng.randint(0, config["num_image_tokens"],
                        size=(b, config["image_fmap_size"] ** 2)).astype(np.int32)
    return text, image


def jax_params(config, seed=0):
    jmodel = JDALLE(**config, **RATES)
    text, image = batch(config, 0)
    params = jmodel.init(jax.random.key(seed), jnp.asarray(text), jnp.asarray(image))["params"]
    rng = np.random.RandomState(seed + 1)
    return jmodel, jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        + 0.02 * rng.randn(*a.shape).astype(np.float32), params)


def jax_dropout_masks(jmodel, params, text, image, key):
    """JAX's keep masks of a training call with ``key``, in the port's
    draw order (attention then feed-forward, layer by layer)."""
    _, state = jmodel.apply(
        {"params": params}, jnp.asarray(text), jnp.asarray(image), return_loss=True,
        deterministic=False, rngs={"dropout": key}, mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
    found = {}
    for path, value in jax.tree_util.tree_flatten_with_path(state["intermediates"])[0]:
        block = path[1].key  # "attn_3" / "ff_3"
        kind, layer = block.split("_")
        found[(int(layer), kind != "attn")] = np.asarray(value) != 0
    return [found[k] for k in sorted(found)]


def port(params, config, **kw) -> DALLE:
    model = DALLE(**config, **{**RATES, **kw}, device="cpu")
    model.load_state_dict(dalle_state_dict(params))
    return model


def _t(*arrays):
    return [torch.from_numpy(a).long() for a in arrays]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_every_gradient_on_jax_masks(name):
    config = CONFIGS[name]
    jmodel, params = jax_params(config)
    text, image = batch(config, 3)
    key = jax.random.key(11)

    def loss_fn(p):
        return jmodel.apply({"params": p}, jnp.asarray(text), jnp.asarray(image),
                            return_loss=True, deterministic=False, rngs={"dropout": key})

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)
    ref = dalle_state_dict(jax.device_get(ref_grads))
    masks = jax_dropout_masks(jmodel, params, text, image, key)
    assert len(masks) == 2 * config["depth"]
    assert all(abs(m.mean() - 0.9) < 0.02 for m in masks)
    model = port(params, config)
    n = config["text_seq_len"] + config["image_fmap_size"] ** 2
    assert full_route(n, config["heads"], config["dim_head"]) == name
    with dropout_masks(replay=masks) as drawn:
        loss = model(*_t(text, image), return_loss=True,
                     generator=torch.Generator().manual_seed(0))
    assert len(drawn) == len(masks)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    # dropout moved the loss: the masks were applied
    with torch.no_grad():
        assert abs(model(*_t(text, image), return_loss=True).item() - loss.item()) > 1e-4
    for pname, p in model.named_parameters():
        scale = ref[pname].abs().max().item()
        err = (p.grad - ref[pname]).abs().max().item()
        assert err <= 1e-4 * scale + 1e-12, (pname, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_formula_bitwise_jax(dtype):
    x = torch.randn(4, 33, 17, generator=torch.Generator().manual_seed(2)).to(dtype)
    gen = torch.Generator().manual_seed(5)
    with dropout_masks() as drawn:
        got = layers.dropout(x, 0.1, gen)
    mask = drawn[0].numpy()
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = jnp.asarray(x.float().numpy(), jdtype)
    want = jax.lax.select(jnp.asarray(mask), jx / (1.0 - 0.1), jnp.zeros_like(jx))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    reciprocal = torch.where(drawn[0], x * (1 / 0.9), torch.zeros((), dtype=dtype))
    assert not torch.equal(got, reciprocal)  # a divide, not the reciprocal's product


def test_rate_zero_and_deterministic_are_bitwise_no_dropout():
    config = CONFIGS["packed"]
    _, params = jax_params(config)
    text, image = _t(*batch(config, 4))
    plain = port(params, config, attn_dropout=0.0, ff_dropout=0.0)
    with torch.no_grad():
        ref = plain(text, image, return_loss=True)
        with dropout_masks() as drawn:
            zero = plain(text, image, return_loss=True,
                         generator=torch.Generator().manual_seed(1))
            det = port(params, config)(text, image, return_loss=True)
    assert drawn == [] and torch.equal(ref, zero) and torch.equal(ref, det)
    x = torch.randn(3, 5)
    assert layers.dropout(x, 0.0, torch.Generator()) is x
    assert layers.dropout(x, 0.3, None) is x


def test_rate_one_gives_zeros_and_matches_jax():
    x = torch.randn(3, 5)
    with dropout_masks() as drawn:
        assert torch.equal(layers.dropout(x, 1.0, torch.Generator()), torch.zeros_like(x))
    assert drawn == []
    config = CONFIGS["dense"]
    _, params = jax_params(config)
    ones = dict(attn_dropout=1.0, ff_dropout=1.0)
    jmodel = JDALLE(**config, **ones)
    text, image = batch(config, 5)
    ref = jmodel.apply({"params": params}, jnp.asarray(text), jnp.asarray(image),
                       return_loss=True, deterministic=False,
                       rngs={"dropout": jax.random.key(0)})
    with torch.no_grad():
        got = port(params, config, **ones)(*_t(text, image), return_loss=True,
                                           generator=torch.Generator())
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def test_same_generator_state_same_loss():
    config = CONFIGS["dense"]
    _, params = jax_params(config)
    model = port(params, config)
    text, image = _t(*batch(config, 6))
    losses = []
    with torch.no_grad(), dropout_masks() as drawn:
        for seed in (3, 3, 4):
            losses.append(model(text, image, return_loss=True,
                                generator=torch.Generator().manual_seed(seed)))
    assert torch.equal(losses[0], losses[1]) and not torch.equal(losses[0], losses[2])
    kept = torch.stack([m.float().mean() for m in drawn])
    assert ((kept - 0.9).abs() < 0.05).all()


def _vae():
    return DiscreteVAE(image_size=16, num_layers=2, hidden_dim=8, num_tokens=40,
                       codebook_dim=8, device="cpu").init_weights(torch.Generator().manual_seed(3))


def test_nan_retried_step_redraws_its_masks():
    config = CONFIGS["dense"]
    _, params = jax_params(config)
    vae = _vae()
    runs = {}
    for inject in (None, 1):
        trainer = train_dalle.DalleTrainer(vae, port(params, config), batch_size=2, device="cpu",
                                           nan_inject_step=inject, **RATES)
        assert not trainer.deterministic
        with dropout_masks() as drawn:
            losses = []
            for i in range(3):
                text, _ = batch(config, 20 + i)
                images = torch.from_numpy(np.random.RandomState(i).rand(2, 16, 16, 3)
                                          .astype(np.float32))
                losses.append(trainer.train_step(torch.from_numpy(text).long(), images))
        runs[inject] = (trainer, losses, drawn)
    (clean, clean_losses, clean_masks), (faulted, losses, masks) = runs[None], runs[1]
    per = 2 * config["depth"]
    assert len(clean_masks) == 3 * per and len(masks) == 4 * per  # one dispatch retried
    assert faulted.retries == 1 and faulted.steps == clean.steps == 3
    # the rejected dispatch (the second) and its retry drew the same masks,
    # those of the clean run's second step
    for j in range(per):
        assert torch.equal(masks[per + j], masks[2 * per + j])
        assert torch.equal(masks[per + j], clean_masks[per + j])
        assert not torch.equal(masks[j], masks[per + j])
    assert clean_losses == losses and all(math.isfinite(x) for x in losses)
    for a, b in zip(clean.dalle.parameters(), faulted.dalle.parameters()):
        assert torch.equal(a, b)
    gen = clean.generator()
    assert gen.initial_seed() == clean.steps == 3
