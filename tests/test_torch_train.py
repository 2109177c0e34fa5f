"""The port's training slice against the JAX package on the CPU, float32,
for a small DALLE (depth 2, dim 128, 2 heads of 64, text 64 + an 8 x 8
image grid, so n = 128 takes the packed-qkv path; token shift, rotary),
JAX-initialised, every leaf perturbed, and converted:

- logits to atol 1e-4 and the loss to rtol 1e-5 against
  ``dalle.apply(..., return_loss=True)``;
- every parameter's gradient against ``jax.grad``, mapped through
  ``convert.dalle_state_dict``: max abs error within 1e-4 of the tensor's
  max abs gradient;
- params and Adam moments after 3 steps against ``parallel.step.
  make_train_step`` with ``optax.chain(clip_by_global_norm(0.5),
  scale_by_adam())`` and ``dynamic_lr=True`` (lr 3e-4): per tensor, the
  relative L2 error of the 3 steps' update (params after minus before)
  within 1e-3 and of each moment within 1e-5, losses to rtol 1e-5. (Adam
  divides by sqrt(nu) + 1e-8, so at an element whose gradient is near
  1e-8 a float32 difference of the gradients moves the update by a good
  part of lr: element-wise bounds on the params would hold nothing
  else);
- the NaN guard: an injected NaN leaves params and moments bit-identical
  with the counters up; a finite step is bit-identical guarded and
  unguarded; a finite loss with non-finite gradients is rejected too;
- ``DalleTrainer``: a rejected step is retried on the same batch and ends
  bit-identical to an unfaulted run, persistent NaNs abort, and its flags
  are ``train_dalle.py``'s;
- the copied schedules against ``utils/schedules.py`` on one metric
  sequence.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import train_dalle as j_train_dalle
from dalle_pytorch_tpu.models import DALLE as JDALLE
from dalle_pytorch_tpu.models import DiscreteVAE as JVAE
from dalle_pytorch_tpu.parallel import create_train_state as j_create_state
from dalle_pytorch_tpu.parallel import make_runtime
from dalle_pytorch_tpu.parallel import make_train_step as j_make_step
from dalle_pytorch_tpu.utils import schedules as j_schedules
from dalle_pytorch_tpu_torch import train_dalle
from dalle_pytorch_tpu_torch.convert import dalle_state_dict, vae_state_dict
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
from dalle_pytorch_tpu_torch.parallel.step import create_train_state, make_train_step
from dalle_pytorch_tpu_torch.utils import schedules

torch.set_num_threads(2)

CONFIG = dict(dim=128, depth=2, num_text_tokens=50, text_seq_len=64,
              num_image_tokens=40, image_fmap_size=8, heads=2, dim_head=64,
              shift_tokens=True, rotary_emb=True)
VAE_CONFIG = dict(image_size=32, num_layers=2, num_resnet_blocks=1,
                  hidden_dim=16, num_tokens=40, codebook_dim=8)
LR, CLIP = 3e-4, 0.5


def _batch(seed, b=2):
    """Seeded captions with zero tails and image tokens."""
    rng = np.random.RandomState(seed)
    text = rng.randint(1, CONFIG["num_text_tokens"], size=(b, 64)).astype(np.int32)
    for i in range(b):
        text[i, rng.randint(5, 64):] = 0
    image = rng.randint(0, CONFIG["num_image_tokens"], size=(b, 64)).astype(np.int32)
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
    assert logits.shape == (2, 128, model.total_tokens) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-4, rtol=0)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)


def test_text_key_mask_matches(jax_model):
    """The optional text mask reaches the packed kernel as a key mask."""
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
    assert int(state.step) == 3 and int(state.opt_state.count) == 3
    adam = jstate.opt_state[1]
    assert int(adam.count) == 3
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


def _snapshot(state):
    return [t.detach().clone() for d in (state.params, state.opt_state.mu,
                                         state.opt_state.nu) for t in d.values()]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_injected_nan_leaves_state_bit_identical(jax_model):
    _, params = jax_model
    model = _port(params)
    text, image = _batch(5)
    batch = dict(zip(("text", "image"), _t(text, image)))
    state = create_train_state(model)
    state, loss = make_train_step(train_dalle.dalle_loss, CLIP)(state, model, batch, LR)
    assert math.isfinite(loss.item())
    before = _snapshot(state)
    count = int(state.opt_state.count)
    step = make_train_step(train_dalle.dalle_loss, CLIP, nan_inject_step=1)
    state, loss = step(state, model, batch, LR)
    assert math.isnan(loss.item())
    assert _same(before, _snapshot(state))
    assert int(state.opt_state.count) == count and int(state.step) == 2
    assert int(state.skipped) == 1 and int(state.consec_skipped) == 1
    state, loss = step(state, model, batch, LR)  # step 2: finite again
    assert math.isfinite(loss.item()) and int(state.consec_skipped) == 0
    assert int(state.skipped) == 1


def test_finite_step_is_bit_identical_guarded_and_unguarded(jax_model):
    _, params = jax_model
    text, image = _batch(6)
    results = []
    for guard in (True, False):
        model = _port(params)
        batch = dict(zip(("text", "image"), _t(text, image)))
        state = create_train_state(model)
        state, loss = make_train_step(train_dalle.dalle_loss, CLIP, nan_guard=guard)(
            state, model, batch, LR)
        results.append((loss, _snapshot(state)))
    assert torch.equal(results[0][0], results[1][0])
    assert _same(results[0][1], results[1][1])


def test_finite_loss_with_nonfinite_gradient_is_rejected():
    """sqrt(sum(w * 0)) is 0, its gradient 0 / 0: the guard keys on the
    gradient norm too, and the returned loss signals the rejection."""
    model = torch.nn.Linear(4, 4, bias=False)
    state = create_train_state(model)
    before = _snapshot(state)
    step = make_train_step(lambda m, batch: torch.sqrt((m.weight * 0.0).sum()), CLIP)
    state, loss = step(state, model, {}, 0.1)
    assert math.isnan(loss.item())
    assert int(state.skipped) == 1 and _same(before, _snapshot(state))


def _vae():
    jvae = JVAE(**VAE_CONFIG)
    params = jvae.init({"params": jax.random.key(3), "gumbel": jax.random.key(4)},
                       jnp.zeros((1, 32, 32, 3)))["params"]
    vae = DiscreteVAE(**VAE_CONFIG, device="cpu")
    vae.load_state_dict(vae_state_dict(jax.device_get(params)))
    return vae


def _images(seed, b=2):
    return torch.from_numpy(np.random.RandomState(seed).rand(b, 32, 32, 3).astype(np.float32))


def test_trainer_retries_a_rejected_step_and_matches_a_clean_run(jax_model):
    _, params = jax_model
    vae = _vae()
    runs = {}
    for inject in (None, 1):
        trainer = train_dalle.DalleTrainer(vae, _port(params), batch_size=2,
                                           nan_inject_step=inject, device="cpu")
        losses = []
        for i in range(3):
            text, _ = _batch(20 + i)
            losses.append(trainer.train_step(torch.from_numpy(text).long(), _images(i)))
        runs[inject] = (trainer, losses)
    clean, faulted = runs[None][0], runs[1][0]
    assert clean.retries == 0 and faulted.retries == 1
    assert faulted.steps == clean.steps == 3
    assert int(faulted.state.skipped) == 1 and int(faulted.state.consec_skipped) == 0
    assert int(faulted.state.step) == 4
    assert runs[None][1] == runs[1][1] and all(math.isfinite(x) for x in runs[1][1])
    assert _same(_snapshot(clean.state), _snapshot(faulted.state))


def test_trainer_aborts_on_persistent_nans(jax_model):
    _, params = jax_model
    model = _port(params)
    with torch.no_grad():
        model.final_norm.weight[0] = float("nan")
    trainer = train_dalle.DalleTrainer(_vae(), model, batch_size=2,
                                       nan_abort_after=2, device="cpu")
    text, _ = _batch(7)
    with pytest.raises(train_dalle.NanAbort):
        trainer.train_step(torch.from_numpy(text).long(), _images(7))
    assert trainer.retries == 2 and int(trainer.state.consec_skipped) == 2


def test_trainer_builds_from_flags_and_steps_the_scheduler():
    vae = _vae()
    trainer = train_dalle.DalleTrainer(
        vae, num_text_tokens=50, device="cpu", dim=64, depth=1, heads=2,
        dim_head=64, text_seq_len=64, shift_tokens=True, rotary_emb=True,
        batch_size=2, lr_decay=True, learning_rate=1e-3, seed=0)
    assert trainer.dalle.image_fmap_size == 8 and trainer.dalle.num_image_tokens == 40
    assert isinstance(trainer.sched, schedules.ReduceLROnPlateau) and trainer.lr == 1e-3
    text, _ = _batch(8)
    loss = trainer.train_step(torch.from_numpy(text).long(), _images(8))
    assert math.isfinite(loss) and trainer.sched.best == loss


def test_trainer_flags_are_train_dalle_flags():
    dests = {a.dest for a in j_train_dalle.build_parser()._actions if a.dest != "help"}
    assert set(train_dalle.FLAGS) | set(train_dalle.NOT_PORTED) == dests
    assert not set(train_dalle.FLAGS) & set(train_dalle.NOT_PORTED)
    defaults = {a.dest: a.default for a in j_train_dalle.build_parser()._actions}
    assert {k: defaults[k] for k in train_dalle.FLAGS} == train_dalle.FLAGS
    vae = _vae()
    with pytest.raises(NotImplementedError, match="ga_steps"):
        train_dalle.DalleTrainer(vae, device="cpu", ga_steps=2)
    with pytest.raises(TypeError):
        train_dalle.DalleTrainer(vae, device="cpu", no_such_flag=1)
    with pytest.raises(ValueError):
        train_dalle.DalleTrainer(vae, _port_small(), device="cpu", dim=64)
    with pytest.raises(NotImplementedError, match="ff_dropout"):  # not ported
        train_dalle.DalleTrainer(vae, device="cpu", ff_dropout=0.1)


def _port_small():
    return DALLE(**{**CONFIG, "depth": 1}, device="cpu")


@pytest.mark.parametrize("name,kwargs", [
    ("ReduceLROnPlateau", dict(lr=1e-3, patience=2, cooldown=1)),
    ("ExponentialDecay", dict(lr=1e-3, gamma=0.9)),
    ("ConstantLR", dict(lr=1e-3)),
])
def test_schedules_match_reference(name, kwargs):
    ours, ref = getattr(schedules, name)(**kwargs), getattr(j_schedules, name)(**kwargs)
    metrics = [5.0, 4.0, 4.0, 4.1, 4.2, 3.0, 3.5, 3.6, 3.7, 3.8, 2.0, 2.5, 2.6, 2.7]
    for m in metrics:
        assert ours.step(m) == ref.step(m)
        assert ours.state_dict() == ref.state_dict()
    restored = getattr(schedules, name)(**kwargs)
    restored.load_state_dict(ours.state_dict())
    assert restored.state_dict() == ref.state_dict()


def test_gumbel_temperature_matches_reference():
    for step in (0, 100, 5000, 10**6):
        assert schedules.gumbel_temperature(step, 1.0, 1e-4, 0.5) == \
            j_schedules.gumbel_temperature(step, 1.0, 1e-4, 0.5)
