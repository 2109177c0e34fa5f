"""Learned positions (``rotary_emb=False``, train_dalle.py's default) and
``stable`` in the port's DALLE against the JAX package on the CPU, on
converted weights (every leaf perturbed), float32 unless named:

- the axial positional embedding of the image grid against JAX's on its
  converted tables; ``dalle_state_dict`` carries ``text_pos_emb`` and the
  grid's ``row_emb`` / ``col_emb``; ``divide_max`` against JAX's; JAX's
  ``stable_softmax`` bitwise its plain softmax on float32 scores
  (dividing and multiplying by 2**10 is exact), so the port's attention,
  which scores in float32, takes no ``stable``: its softmax and its
  ragged plain version against JAX's stable ones;
- forward logits (atol 1e-4), the loss (rtol 1e-5) and every gradient
  (max abs error within 1e-4 of the tensor's max abs gradient, as in
  test_torch_train.py) on the tiny DALLE of test_torch_dalle.py with
  learned positions, on ``stable`` with ("conv_like", "axial_col") as
  JAX's test_models.py builds it, and on test_torch_train.py's n = 128
  model with learned positions, whose "full" layers take the packed
  route without a rotary table;
- the decode paths: test_torch_learned_pos_decode.py; the engines and
  generation: test_torch_learned_pos_serve.py;
- ``DalleTrainer(vae)`` with train_dalle.py's default flags (learned
  positions) takes a finite step that moves the positional tables, and
  ``stable_softmax`` builds a ``stable`` DALLE;
- mixed precision: the port's bf16 loss on float32 parameters within
  ``testing.BF16_GAP_FACTOR`` times JAX's own bf16-to-float32 gap.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import DALLE as JDALLE
from dalle_pytorch_tpu.ops import layers as jlayers
from dalle_pytorch_tpu.ops import ragged_attention as jra
from dalle_pytorch_tpu_torch import train_dalle
from dalle_pytorch_tpu_torch.convert import dalle_state_dict
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.ops import layers, paged_kv
from dalle_pytorch_tpu_torch.ops import ragged_attention as ra
from dalle_pytorch_tpu_torch.testing import BF16_GAP_FACTOR, gap_ratio
from test_torch_dalle import CONFIG, PAGE, tiny_models
from test_torch_train import CONFIG as TRAIN_CONFIG
from test_torch_train import _batch as train_batch
from test_torch_train import _images, _vae

torch.set_num_threads(1)

# the two configurations JAX's test_models.py decodes besides its default
CASES = {"learned_pos": dict(rotary_emb=False),
         "stable": dict(stable=True, attn_types=("conv_like", "axial_col"))}


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)).long() for a in arrays]


def _inputs(model, b=2, seed=0):
    """Seeded raw text (b, text_seq_len) with zero tails and image tokens."""
    rng = np.random.RandomState(seed)
    text = rng.randint(1, model.num_text_tokens, size=(b, model.text_seq_len)).astype(np.int32)
    text[0, -2:] = 0
    image = rng.randint(0, model.num_image_tokens, size=(b, model.image_seq_len)).astype(np.int32)
    return text, image


def test_axial_embedding_and_converter():
    jmodel, params, model = tiny_models(rotary_emb=False)
    state = dalle_state_dict(params)
    assert {"text_pos_emb.weight", "image_pos_emb.row_emb", "image_pos_emb.col_emb"} <= set(state)
    assert set(state) == set(model.state_dict())
    f, dim = model.image_fmap_size, model.dim
    ref = jlayers.AxialPositionalEmbedding(dim=dim, shape=(f, f)).apply(
        {"params": params["image_pos_emb"]}, f * f - 3)
    with torch.no_grad():
        got = model.image_pos_emb(f * f - 3)
    assert got.shape == (1, f * f - 3, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    # every grid cell from _pos_emb's row + column gather, bitwise the grid
    T = model.text_len_internal
    pos = torch.arange(T + f * f + 2)  # past the grid: clipped to its last cell
    with torch.no_grad():
        rows = model._pos_emb(pos)
        grid = model.image_pos_emb.grid()
        assert torch.equal(rows[:T], model.text_pos_emb.weight)
        assert torch.equal(rows[T:T + f * f], grid)
        assert torch.equal(rows[-1], grid[-1])
        assert all(torch.equal(model._pos_emb(int(p)), rows[i]) for i, p in enumerate(pos))
    # seeded init: the grid's tables N(0, 1) as flax draws them, the text table N(0, 0.02)
    fresh = DALLE(**CONFIG, rotary_emb=False, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    assert 0.7 < fresh.image_pos_emb.row_emb.std().item() < 1.3
    assert fresh.text_pos_emb.weight.std().item() < 0.05


def _stable_softmax(t, alpha=32.0**2):
    """JAX's ``stable_softmax`` in torch, as the reference of the identity."""
    t = t / alpha
    return ((t - t.amax(-1, keepdim=True)) * alpha).softmax(-1)


def test_stable_softmax_and_divide_max_match_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 17) * 30).astype(np.float32)
    x[..., 3:6] = -0.7 * np.finfo(np.float32).max  # masked lanes
    ref = jlayers.stable_softmax(jnp.asarray(x))
    # on float32 scores the stable softmax is bitwise the plain one, in JAX and in torch
    assert np.array_equal(np.asarray(ref), np.asarray(jax.nn.softmax(jnp.asarray(x))))
    got = torch.from_numpy(x).softmax(-1)
    assert torch.equal(got, _stable_softmax(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    y = rng.rand(3, 5, 17).astype(np.float32) + 0.1
    np.testing.assert_allclose(layers.divide_max(torch.from_numpy(y)).numpy(),
                               np.asarray(jlayers.divide_max(jnp.asarray(y))), atol=1e-7, rtol=0)
    # the ragged plain version against JAX's jnp reference with and without ``stable``
    b, n, h, d, n_p = 2, 3, 2, 8, 3
    q = rng.randn(b, n, h, d).astype(np.float32)
    pools = [rng.randn(b, n_p, PAGE, h * d).astype(np.float32) for _ in range(2)]
    start = np.array([2, 5], np.int32)
    flat = []
    for pool in pools:
        f = paged_kv.alloc(b, n_p, PAGE, h * d, torch.float32, "cpu")
        paged_kv.pool_view(f, b).copy_(torch.from_numpy(pool))
        flat.append(f)
    table = torch.arange(b * n_p, dtype=torch.int32).reshape(b, n_p)
    args = (torch.from_numpy(q), *flat, table, torch.from_numpy(start))
    got = ra.reference_attend(*args)
    pos = jnp.asarray(start)[:, None] + jnp.arange(n)[None]
    allowed = (jnp.arange(n_p * PAGE)[None, None] <= pos[..., None])[:, None]
    plain, stable = (np.asarray(jra.reference_attend(
        jnp.asarray(q), *map(jnp.asarray, pools), jnp.asarray(table), allowed, stable=s))
        for s in (False, True))
    assert np.array_equal(plain, stable)
    np.testing.assert_allclose(got.numpy(), stable, atol=1e-6, rtol=1e-6)


def _grads_case(name):
    """(JAX model, params, port model, text, image) of a forward case."""
    if name == "learned_pos_packed":
        config = {**TRAIN_CONFIG, "rotary_emb": False}
        text, image = train_batch(0)
        jmodel = JDALLE(**config)
        params = jmodel.init(jax.random.key(0), jnp.asarray(text), jnp.asarray(image))["params"]
        rng = np.random.RandomState(1)
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a) * (1 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
            + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
        model = DALLE(**config, device="cpu")
        model.load_state_dict(dalle_state_dict(params))
        return jmodel, params, model, *train_batch(4)
    jmodel, params, model = tiny_models(**CASES[name])
    return jmodel, params, model, *_inputs(model)


@pytest.mark.parametrize("name", [*CASES, "learned_pos_packed"])
def test_logits_loss_and_every_gradient_match(name):
    jmodel, params, model, text, image = _grads_case(name)
    ref_logits = jmodel.apply({"params": params}, jnp.asarray(text), jnp.asarray(image))

    def loss_fn(p):
        return jmodel.apply({"params": p}, jnp.asarray(text), jnp.asarray(image),
                            return_loss=True)

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)
    ref = dalle_state_dict(jax.device_get(ref_grads))
    with torch.no_grad():
        logits = model(*_t(text, image))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-4, rtol=0)
    loss = model(*_t(text, image), return_loss=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    names = [k for k, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref)
    for key, p in model.named_parameters():
        scale = ref[key].abs().max().item()
        err = (p.grad - ref[key]).abs().max().item()
        assert err <= 1e-4 * scale + 1e-12, (key, err, scale)


def test_default_flags_trainer_takes_a_finite_step():
    vae = _vae()
    small = dict(dim=64, depth=1, heads=2, dim_head=32, text_seq_len=16, batch_size=2)
    trainer = train_dalle.DalleTrainer(vae, device="cpu", **small)
    dalle = trainer.dalle
    assert not dalle.rotary_emb and not dalle.stable and dalle.transformer.rotary is None
    before = {k: p.detach().clone() for k, p in dalle.named_parameters()}
    text = torch.from_numpy(np.random.RandomState(0).randint(1, 100, size=(2, 16)))
    loss = trainer.train_step(text, _images(8))
    assert math.isfinite(loss) and trainer.steps == 1
    for key in ("text_pos_emb.weight", "image_pos_emb.row_emb", "image_pos_emb.col_emb"):
        assert not torch.equal(before[key], dict(dalle.named_parameters())[key]), key
    stable = train_dalle.DalleTrainer(vae, device="cpu", stable_softmax=True, **small)
    assert stable.dalle.stable


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_loss_within_jax_bf16_gap(name):
    config = {**CONFIG, **CASES[name]}
    jmodel, params, model = tiny_models(**CASES[name])
    text, image = _inputs(model, seed=3)
    losses = [float(JDALLE(**config, dtype=dt).apply(
        {"params": params}, jnp.asarray(text), jnp.asarray(image), return_loss=True))
        for dt in (jnp.bfloat16, jnp.float32)]
    port = DALLE(**config, device="cpu", dtype=torch.bfloat16, param_dtype=torch.float32)
    port.load_state_dict(dalle_state_dict(params))
    with torch.no_grad():
        got = port(*_t(text, image), return_loss=True).item()
    assert math.isfinite(got)
    assert gap_ratio(got, *losses) <= BF16_GAP_FACTOR, (got, losses)
