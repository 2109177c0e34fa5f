"""The port's sparse-attention DALLE (layers cycling "full", "axial_row",
"axial_col", "conv_like") against the JAX package on the CPU, float32:
depth 4, dim 64, 4 heads of 32, text 64 + a 24 x 24 image grid, so n =
640, where the axial_row and conv_like layers take the pair grid and the
full and axial_col layers the packed path (JAX with
``DALLE_TPU_SPARSE_KERNEL=1``, in interpret mode), token shift, rotary;
JAX-initialised, every leaf perturbed, and converted. At
``tests/test_torch_train.py``'s tolerances:

- logits to atol 1e-4 and the loss to rtol 1e-5;
- every parameter's gradient within 1e-4 of the tensor's max abs
  gradient;
- params and Adam moments after 3 clipped-Adam steps against the JAX
  ``make_train_step``: per tensor, the update's relative L2 error within
  1e-3 and each moment's within 1e-5, losses to rtol 1e-5.

Also: layer i's attention type, layout seed and pattern are JAX's;
``DalleTrainer`` builds and trains the four-type cycle and refuses gMLP
layers. Serving this configuration is held by test_torch_sparse_serve.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle_pytorch_tpu.models import DALLE as JDALLE
from dalle_pytorch_tpu.models import DiscreteVAE as JVAE
from dalle_pytorch_tpu.parallel import create_train_state as j_create_state
from dalle_pytorch_tpu.parallel import make_runtime
from dalle_pytorch_tpu.parallel import make_train_step as j_make_step
from dalle_pytorch_tpu_torch import train_dalle
from dalle_pytorch_tpu_torch.convert import dalle_state_dict, vae_state_dict
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
from dalle_pytorch_tpu_torch.ops import block_sparse_attention as bs
from dalle_pytorch_tpu_torch.parallel.step import create_train_state, make_train_step

torch.set_num_threads(2)

TYPES = ("full", "axial_row", "axial_col", "conv_like")
CONFIG = dict(dim=64, depth=4, num_text_tokens=50, text_seq_len=64,
              num_image_tokens=40, image_fmap_size=24, heads=4, dim_head=32,
              shift_tokens=True, rotary_emb=True, attn_types=TYPES)
N = 64 + 24 * 24
LR, CLIP = 3e-4, 0.5


@pytest.fixture(autouse=True)
def _pair_grid_in_jax(monkeypatch):
    """JAX routes the sparse patterns as on the TPU (interpret mode)."""
    monkeypatch.setenv("DALLE_TPU_SPARSE_KERNEL", "1")


def _batch(seed, b=2):
    """Seeded captions with zero tails and image tokens."""
    rng = np.random.RandomState(seed)
    text = rng.randint(1, CONFIG["num_text_tokens"], size=(b, 64)).astype(np.int32)
    for i in range(b):
        text[i, rng.randint(5, 64):] = 0
    image = rng.randint(0, CONFIG["num_image_tokens"], size=(b, 24 * 24)).astype(np.int32)
    return text, image


@pytest.fixture(scope="module")
def jax_model():
    """(JAX DALLE, its params with every leaf perturbed)."""
    jmodel = JDALLE(**CONFIG)
    text, image = _batch(0)
    params = jmodel.init(jax.random.key(0), jnp.asarray(text), jnp.asarray(image))["params"]
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        + 0.02 * rng.randn(*a.shape).astype(np.float32),
        params,
    )
    return jmodel, params


def _port(params) -> DALLE:
    model = DALLE(**CONFIG, device="cpu")
    model.load_state_dict(dalle_state_dict(params))
    return model


def _t(*arrays):
    return [torch.from_numpy(a).long() for a in arrays]


def test_converted_sparse_model_loads_every_key(jax_model):
    _, params = jax_model
    model = DALLE(**CONFIG, device="cpu")
    missing, unexpected = model.load_state_dict(dalle_state_dict(params), strict=False)
    assert missing == [] and unexpected == []


def test_layer_types_seeds_and_patterns_are_jax(jax_model):
    """Five layers over ("full", "sparse", "axial_row") with layout seed 7:
    layer i has JAX's type, seed 7 + i and pattern; at n 640 the port
    routes each layer as JAX's TPU dispatch does."""
    cfg = {**CONFIG, "depth": 5, "attn_types": ("full", "sparse", "axial_row"),
           "sparse_layout_seed": 7}
    jmodel = JDALLE(**cfg)
    text, image = _batch(0)
    params = jmodel.init(jax.random.key(0), jnp.asarray(text), jnp.asarray(image))["params"]
    jtr = jmodel.bind({"params": params}).transformer
    model = DALLE(**cfg, device="cpu")
    assert model.transformer.attn_types == jtr.layer_kinds
    for i, block in enumerate(model.transformer.attn_blocks):
        ours = block.fn.fn.fn  # LayerScale -> PreNorm -> PreShiftToken -> Attention
        theirs = jtr.attn_blocks[i].fn.fn.fn
        assert (ours.attn_type, ours.layout_seed) == (theirs.attn_type, theirs.layout_seed)
        assert ours.layout_seed == 7 + i
        assert np.array_equal(ours.pattern_mask(), theirs.pattern_mask())
    routes = [block.fn.fn.fn.uses_block_sparse(N) for block in _port(jax_model[1]).transformer.attn_blocks]
    assert routes == [False, True, False, True]


def test_logits_and_loss_match(jax_model):
    jmodel, params = jax_model
    text, image = _batch(2)
    ref_logits = jmodel.apply({"params": params}, jnp.asarray(text), jnp.asarray(image))
    ref_loss = jmodel.apply({"params": params}, jnp.asarray(text), jnp.asarray(image),
                            return_loss=True)
    model = _port(params)
    with torch.no_grad():
        logits = model(*_t(text, image))
        loss = model(*_t(text, image), return_loss=True)
    assert logits.shape == (2, N, model.total_tokens)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-4, rtol=0)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)


def test_text_key_mask_matches(jax_model):
    jmodel, params = jax_model
    text, image = _batch(3)
    mask = text != 0
    ref = jmodel.apply({"params": params}, jnp.asarray(text), jnp.asarray(image),
                       mask=jnp.asarray(mask))
    with torch.no_grad():
        got = _port(params)(*_t(text, image), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_every_gradient_matches(jax_model):
    jmodel, params = jax_model
    text, image = _batch(4)

    def loss_fn(p):
        return jmodel.apply({"params": p}, jnp.asarray(text), jnp.asarray(image),
                            return_loss=True)

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)
    ref = dalle_state_dict(jax.device_get(ref_grads))
    model = _port(params)
    loss = model(*_t(text, image), return_loss=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    names = [k for k, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref)
    for name, p in model.named_parameters():
        scale = ref[name].abs().max().item()
        err = (p.grad - ref[name]).abs().max().item()
        assert err <= 1e-4 * scale + 1e-12, (name, err, scale)


def test_three_steps_match_jax_step(jax_model):
    jmodel, params = jax_model
    batches = [_batch(10 + i) for i in range(3)]
    runtime = make_runtime(devices=jax.devices()[:1])
    opt = optax.chain(optax.clip_by_global_norm(CLIP), optax.scale_by_adam())

    def j_loss(p, batch, rng):
        return jmodel.apply({"params": p}, batch["text"], batch["image"],
                            return_loss=True)

    jstate, shardings = j_create_state(jax.device_get(params), opt, runtime)
    jstep = j_make_step(j_loss, opt, runtime, shardings, dynamic_lr=True)
    model = _port(params)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = create_train_state(model)
    step = make_train_step(train_dalle.dalle_loss, CLIP)
    for i, (text, image) in enumerate(batches):
        jstate, jloss = jstep(jstate, {"text": jnp.asarray(text), "image": jnp.asarray(image)},
                              jax.random.key(i), jnp.asarray(LR, jnp.float32))
        text_t, image_t = _t(text, image)
        state, loss = step(state, model, {"text": text_t, "image": image_t}, LR)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    adam = jstate.opt_state[1]
    for ours, theirs, origin, tol in (
        (state.params, jstate.params, before, 1e-3),
        (state.opt_state.mu, adam.mu, None, 1e-5),
        (state.opt_state.nu, adam.nu, None, 1e-5),
    ):
        ref = dalle_state_dict(jax.device_get(theirs))
        for name, t in ours.items():
            got, want = t.detach(), ref[name]
            if origin is not None:
                got, want = got - origin[name], want - origin[name]
            err = ((got - want).norm() / want.norm()).item()
            assert err <= tol, (name, err)


def _vae():
    """A converted VAE of 64-pixel images and a 16 x 16 grid."""
    cfg = dict(image_size=64, num_layers=2, num_resnet_blocks=1, hidden_dim=8,
               num_tokens=40, codebook_dim=8)
    jvae = JVAE(**cfg)
    params = jvae.init({"params": jax.random.key(3), "gumbel": jax.random.key(4)},
                       jnp.zeros((1, 64, 64, 3)))["params"]
    vae = DiscreteVAE(**cfg, device="cpu")
    vae.load_state_dict(vae_state_dict(jax.device_get(params)))
    return vae


def test_trainer_trains_the_four_type_cycle():
    """Built from the flags (attn_types as train_dalle.py spells it), one
    step on seeded images (text 64 + 16 x 16 tokens, n 320, the dense
    path): the layers cycle the four types, the loss is finite, and on the
    CPU no kernel launches."""
    before = bs.block_sparse_attention.launches
    trainer = train_dalle.DalleTrainer(
        _vae(), num_text_tokens=50, device="cpu", dim=64, depth=4, heads=4,
        dim_head=32, text_seq_len=64, shift_tokens=True, rotary_emb=True,
        attn_types=",".join(TYPES), batch_size=2, seed=0)
    assert trainer.dalle.transformer.attn_types == TYPES
    text, _ = _batch(8)
    images = torch.from_numpy(np.random.RandomState(9).rand(2, 64, 64, 3).astype(np.float32))
    assert math.isfinite(trainer.train_step(torch.from_numpy(text).long(), images))
    assert trainer.steps == 1 and bs.block_sparse_attention.launches == before


def test_trainer_refuses_gmlp_layers():
    with pytest.raises(NotImplementedError, match="mlp"):
        train_dalle.DalleTrainer(_vae(), device="cpu", attn_types="full,mlp")
