"""Reversible execution in the port (``ops/reversible.py``,
``Transformer(reversible=True)``) against the JAX package on the CPU,
float32, on a JAX-initialised DALLE with every leaf perturbed and
converted, depth 3, dropout 0, on the packed route (n 128, rotary, token
shift; the dense route, n 24 with learned positions, in
test_torch_reversible_dense.py). At ``tests/test_torch_train.py``'s
tolerances:

- the loss to rtol 1e-5 and every parameter's gradient within 1e-4 of
  its tensor's max abs gradient, against ``jax.grad`` of JAX's
  ``DALLE(reversible=True)`` (its ``custom_vjp``);
- params and Adam moments after 3 clipped-Adam steps against JAX's
  ``make_train_step``: per tensor, the update's relative L2 error within
  1e-3 and each moment's within 1e-5, losses to rtol 1e-5;
- logits without a gradient (the direct wiring) to atol 1e-4.

Within the port, with both dropout rates 0.1: the Function's loss
bitwise and its gradients within 1e-5 of their tensor's max (float32
reconstruction error) of autograd through the direct wiring
(``reversible_forward_only``) on the same generator state; the forward
draws the sequential masks in the sequential order, the backward draws
them again (last block first), and the generator ends where a
sequential step leaves it. ``DalleTrainer(reversible=True)`` retries a
rejected step with the masks it drew and ends bitwise the clean run.
The sparse configuration is held by test_torch_reversible_sparse.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle_pytorch_tpu.models import DALLE as JDALLE
from dalle_pytorch_tpu.parallel import create_train_state as j_create_state
from dalle_pytorch_tpu.parallel import make_runtime
from dalle_pytorch_tpu.parallel import make_train_step as j_make_step
from dalle_pytorch_tpu_torch import train_dalle
from dalle_pytorch_tpu_torch.convert import dalle_state_dict
from dalle_pytorch_tpu_torch.models import transformer
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
from dalle_pytorch_tpu_torch.ops import reversible
from dalle_pytorch_tpu_torch.ops.attention import full_route
from dalle_pytorch_tpu_torch.parallel.step import create_train_state, make_train_step
from dalle_pytorch_tpu_torch.testing import dropout_masks

torch.set_num_threads(2)

LR, CLIP = 3e-4, 0.5
RATES = dict(attn_dropout=0.1, ff_dropout=0.1)
CONFIGS = {
    "packed": dict(dim=128, depth=3, num_text_tokens=50, text_seq_len=64, num_image_tokens=40,
                   image_fmap_size=8, heads=2, dim_head=64, shift_tokens=True, rotary_emb=True),
    "dense": dict(dim=64, depth=3, num_text_tokens=50, text_seq_len=8, num_image_tokens=40,
                  image_fmap_size=4, heads=2, dim_head=32, shift_tokens=False,
                  rotary_emb=False),
}


def batch(config, seed, b=2):
    """Seeded captions with zero tails, and image tokens."""
    rng = np.random.RandomState(seed)
    t = config["text_seq_len"]
    text = rng.randint(1, config["num_text_tokens"], size=(b, t)).astype(np.int32)
    for i in range(b):
        text[i, rng.randint(t // 2, t):] = 0
    image = rng.randint(0, config["num_image_tokens"],
                        size=(b, config["image_fmap_size"] ** 2)).astype(np.int32)
    return text, image


def jax_params(config, seed=0):
    """(JAX DALLE of ``config``, its params with every leaf perturbed)."""
    jmodel = JDALLE(**config)
    text, image = batch(config, 0)
    params = jmodel.init(jax.random.key(seed), jnp.asarray(text), jnp.asarray(image))["params"]
    rng = np.random.RandomState(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        + 0.02 * rng.randn(*a.shape).astype(np.float32),
        params,
    )
    return jmodel, params


def port(params, config) -> DALLE:
    model = DALLE(**config, device="cpu")
    model.load_state_dict(dalle_state_dict(params))
    return model


def _t(*arrays):
    return [torch.from_numpy(a).long() for a in arrays]


def check_loss_and_gradients(jmodel, params, model, text, image):
    """The loss to rtol 1e-5 and every gradient within 1e-4 of its
    tensor's max abs gradient, against ``jax.value_and_grad``."""

    def loss_fn(p):
        return jmodel.apply({"params": p}, jnp.asarray(text), jnp.asarray(image),
                            return_loss=True)

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)
    ref = dalle_state_dict(jax.device_get(ref_grads))
    loss = model(*_t(text, image), return_loss=True)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    names = [k for k, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref)
    for name, g in zip(names, grads):
        scale = ref[name].abs().max().item()
        err = (g - ref[name]).abs().max().item()
        assert err <= 1e-4 * scale + 1e-12, (name, err, scale)


def check_three_steps(jmodel, params, model, batches):
    """3 clipped-Adam steps against JAX's ``make_train_step``: losses to
    rtol 1e-5, per tensor the update's relative L2 error within 1e-3 and
    each moment's within 1e-5. The port steps on one CPU thread: Adam
    turns a difference in the last bits of a gradient element near the
    cancellation of its terms into one of a good part of lr, and torch's
    CPU sums took another order now and then in the suite's parallel
    runs (seen on the remat model's <bos> embedding); one thread gives
    them one order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _three_steps(jmodel, params, model, batches)
    finally:
        torch.set_num_threads(threads)


def _three_steps(jmodel, params, model, batches):
    runtime = make_runtime(devices=jax.devices()[:1])
    opt = optax.chain(optax.clip_by_global_norm(CLIP), optax.scale_by_adam())

    def j_loss(p, b, rng):
        return jmodel.apply({"params": p}, b["text"], b["image"], return_loss=True)

    jstate, shardings = j_create_state(jax.device_get(params), opt, runtime)
    jstep = j_make_step(j_loss, opt, runtime, shardings, dynamic_lr=True)
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
    assert int(state.opt_state.count) == int(adam.count) == len(batches)
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


def reversible_case(name):
    """(route name, the reversible config, JAX DALLE, perturbed params)."""
    config = {**CONFIGS[name], "reversible": True}
    return (name, config, *jax_params(config))


@pytest.fixture(scope="module")
def case():
    return reversible_case("packed")


def test_routes_are_the_ones_named(case):
    name, config, _, params = case
    model = port(params, config)
    n = model.total_seq_len
    assert full_route(n, config["heads"], config["dim_head"]) == name
    assert model.transformer.reversible and model.reversible


def test_logits_without_a_gradient_match(case):
    _, config, jmodel, params = case
    text, image = batch(config, 2)
    ref = jmodel.apply({"params": params}, jnp.asarray(text), jnp.asarray(image))
    with torch.no_grad():
        got = port(params, config)(*_t(text, image))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_loss_and_every_gradient_match_jax(case):
    _, config, jmodel, params = case
    check_loss_and_gradients(jmodel, params, port(params, config), *batch(config, 4))


def test_three_adam_steps_match_jax(case):
    _, config, jmodel, params = case
    check_three_steps(jmodel, params, port(params, config),
                      [batch(config, 10 + i) for i in range(3)])


def test_function_runs_only_with_a_gradient(case, monkeypatch):
    """The Function where a gradient is taken, the direct wiring in a call
    without one."""
    _, config, _, params = case
    calls = []
    fn = transformer.reversible_sequence
    monkeypatch.setattr(transformer, "reversible_sequence",
                        lambda *a: calls.append(1) or fn(*a))
    model = port(params, config)
    text, image = _t(*batch(config, 3))
    with torch.no_grad():
        model(text, image, return_loss=True)
    assert calls == []
    model(text, image, return_loss=True)
    assert calls == [1]


def _direct(monkeypatch):
    """Route the model's reversible stack through the direct wiring."""
    monkeypatch.setattr(
        transformer, "reversible_sequence",
        lambda blocks, x1, x2, params, gen: reversible.reversible_forward_only(
            blocks, x1, x2, gen))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dropout_gradient_equals_direct_wiring(name, monkeypatch):
    """Both rates 0.1, one generator state: the Function's loss is the
    direct wiring's bit for bit, its gradients within float32
    reconstruction error (1e-5 of each tensor's max), and both leave the
    generator in the same state."""
    config = {**CONFIGS[name], **RATES, "reversible": True}
    _, params = jax_params(CONFIGS[name])
    text, image = _t(*batch(config, 5))
    runs = []
    for direct in (False, True):
        if direct:
            _direct(monkeypatch)
        model = port(params, config)
        gen = torch.Generator().manual_seed(11)
        loss = model(text, image, return_loss=True, generator=gen)
        runs.append((loss, torch.autograd.grad(loss, list(model.parameters())),
                     gen.get_state()))
    (loss, grads, state), (ref_loss, ref_grads, ref_state) = runs
    assert torch.equal(loss, ref_loss) and torch.equal(state, ref_state)
    for g, r in zip(grads, ref_grads):
        assert (g - r).abs().max().item() <= 1e-5 * r.abs().max().item() + 1e-12


def test_dropout_masks_are_sequential_and_redrawn_in_the_backward():
    config = {**CONFIGS["dense"], **RATES}
    _, params = jax_params(CONFIGS["dense"])
    text, image = _t(*batch(config, 6))
    per = 2 * config["depth"]
    runs = {}
    for rev in (False, True):
        model = port(params, {**config, "reversible": rev})
        gen = torch.Generator().manual_seed(3)
        with dropout_masks() as drawn:
            loss = model(text, image, return_loss=True, generator=gen)
            torch.autograd.grad(loss, list(model.parameters()))
        runs[rev] = (drawn, gen.get_state())
    (seq, seq_state), (rev, rev_state) = runs[False], runs[True]
    assert len(seq) == per and len(rev) == 2 * per
    assert all(torch.equal(a, b) for a, b in zip(seq, rev[:per]))
    assert all(torch.equal(a, b) for a, b in zip(reversed(seq), rev[per:]))
    assert torch.equal(seq_state, rev_state)


def _vae():
    return DiscreteVAE(image_size=16, num_layers=2, hidden_dim=8, num_tokens=40,
                       codebook_dim=8, device="cpu").init_weights(torch.Generator().manual_seed(3))


def test_trainer_retries_a_rejected_reversible_step_bitwise():
    config = CONFIGS["dense"]
    _, params = jax_params(config)
    vae = _vae()
    runs = {}
    for inject in (None, 1):
        model = port(params, {**config, **RATES, "reversible": True})
        trainer = train_dalle.DalleTrainer(vae, model, batch_size=2, device="cpu",
                                           nan_inject_step=inject, **RATES)
        losses = []
        for i in range(3):
            text, _ = batch(config, 20 + i)
            images = torch.from_numpy(np.random.RandomState(i).rand(2, 16, 16, 3)
                                      .astype(np.float32))
            losses.append(trainer.train_step(torch.from_numpy(text).long(), images))
        runs[inject] = (trainer, losses)
    (clean, clean_losses), (faulted, losses) = runs[None], runs[1]
    assert faulted.retries == 1 and faulted.steps == clean.steps == 3
    assert clean_losses == losses and all(math.isfinite(x) for x in losses)
    for a, b in zip(clean.dalle.parameters(), faulted.dalle.parameters()):
        assert torch.equal(a, b)
