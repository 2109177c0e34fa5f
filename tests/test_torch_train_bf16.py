"""The port's mixed-precision training (``DALLE(dtype=torch.bfloat16,
param_dtype=torch.float32)``, ``DalleTrainer(bf16=True)``) against the
JAX package's ``DALLE(dtype=jnp.bfloat16)`` on the CPU, on converted
float32 weights (JAX-initialised, every leaf perturbed), at four small
configurations, one for each attention route of training:

- "dense": ``test_torch_train.py``'s config (n 128, the packed path);
- "sparse": ``test_torch_sparse_train.py``'s (n 640; the axial_row and
  conv_like layers on the pair grid, JAX with
  ``DALLE_TPU_SPARSE_KERNEL=1`` in interpret mode);
- "tiled": ``test_torch_flash_tiled.py``'s "n1152" (the tiled forward,
  dq then dk/dv);
- "one_block": its "n384_three_heads" (one flash block at 3 heads, the
  single-block backward).

bfloat16 rounds at every operation, so the float32 tests' fixed bounds
cannot hold; the bound is JAX's own bfloat16 error
(``testing.gap_ratio``). Per quantity, the gap between the port's bf16
run and JAX's bf16 run stays within ``testing.BF16_GAP_FACTOR`` (2)
times the gap between JAX's bf16 and float32 runs on the same weights
and batch: the loss, every parameter's gradient, and after 3
clipped-Adam steps against JAX ``make_train_step`` each step's loss,
every parameter's update (params after minus before) and both Adam
moments (relative L2 per tensor). JAX's own gaps, measured on the CPU:
the loss 3.7e-4 to 1.8e-3 relative, the gradients 0.045-0.62 relative
L2 (medians 0.15-0.26), the updates 0.007-0.81. The port's gaps to
JAX's bf16 run in units of those (``gap_ratios``, the largest over each
kind's tensors): dense loss 0.0008, step losses 0.40, gradients 0.12,
update 0.51, mu 0.15, nu 0.28; sparse 0.039, 0.17, 0.085, 0.43, 0.092,
0.10; tiled 0.062, 0.064, 0.082, 0.42, 0.080, 0.092; one_block 0.029,
0.44, 0.14, 0.87, 0.13, 0.15. The updates' ratio is the largest: Adam's
first steps divide by sqrt(nu), so a bf16 difference of a small
gradient moves its element's update by a good part of lr.

Also: parameters, gradients and Adam moments are float32 while the
activations are bfloat16; the forward of float32 parameters cast at use
is bitwise that of bfloat16 parameters of the same values; the NaN guard
leaves the bf16 state bit-identical; ``DalleTrainer(bf16=True)`` builds
the mixed-precision model, retries a rejected step and ends bitwise as
an unfaulted run, and refuses a model of another precision; and the
float32 model's loss and gradients are bitwise those of stock
``nn.Linear`` layers (``layers.Linear`` adds no operation in float32).
"""

import math
import types

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
from dalle_pytorch_tpu_torch.ops import layers
from dalle_pytorch_tpu_torch.ops.attention import Attention, full_route
from dalle_pytorch_tpu_torch.parallel.step import create_train_state, make_train_step
from dalle_pytorch_tpu_torch.testing import BF16_GAP_FACTOR, gap_ratio

torch.set_num_threads(2)

BF16 = dict(dtype=torch.bfloat16, param_dtype=torch.float32)
COMMON = dict(num_text_tokens=50, num_image_tokens=40, shift_tokens=True, rotary_emb=True)
CONFIGS = {
    "dense": dict(COMMON, dim=128, depth=2, text_seq_len=64, image_fmap_size=8, heads=2,
                  dim_head=64),
    "sparse": dict(COMMON, dim=64, depth=4, text_seq_len=64, image_fmap_size=24, heads=4,
                   dim_head=32, attn_types=("full", "axial_row", "axial_col", "conv_like")),
    "tiled": dict(COMMON, dim=128, depth=2, text_seq_len=128, image_fmap_size=32, heads=2,
                  dim_head=64),
    "one_block": dict(COMMON, dim=128, depth=2, text_seq_len=128, image_fmap_size=16, heads=3,
                      dim_head=64),
}
# the full-sequence route of each config's "full" layers, and whether its
# axial_row / conv_like layers take the pair grid
ROUTES = {"dense": ("packed", False), "sparse": ("packed", True),
          "tiled": ("tiled", False), "one_block": ("tiled_one_block", False)}
LR, CLIP, STEPS = 3e-4, 0.5, 3


def _batch(config, seed, b=2):
    """Seeded captions with zero tails and image tokens."""
    rng = np.random.RandomState(seed)
    t = config["text_seq_len"]
    text = rng.randint(1, config["num_text_tokens"], size=(b, t)).astype(np.int32)
    for i in range(b):
        text[i, rng.randint(5, t):] = 0
    image = rng.randint(0, config["num_image_tokens"],
                        size=(b, config["image_fmap_size"] ** 2)).astype(np.int32)
    return text, image


def _params(config):
    """JAX-initialised float32 params with every leaf perturbed."""
    text, image = _batch(config, 0)
    params = JDALLE(**config).init(jax.random.key(0), jnp.asarray(text),
                                   jnp.asarray(image))["params"]
    rng = np.random.RandomState(1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        + 0.02 * rng.randn(*a.shape).astype(np.float32),
        params,
    )


def _port(config, params, **dtypes) -> DALLE:
    model = DALLE(**config, device="cpu", **dtypes)
    model.load_state_dict(dalle_state_dict(params))
    return model


def _t(*arrays):
    return [torch.from_numpy(a).long() for a in arrays]


def _jax_run(jmodel, params, config):
    """JAX's loss and gradients on batch 2, then ``STEPS`` clipped-Adam
    steps of ``make_train_step`` from ``params``: (loss, {name: grad},
    [step losses], {name: update}, {name: mu}, {name: nu}), names and
    layouts the port's."""
    text, image = _batch(config, 2)

    def loss_fn(p):
        return jmodel.apply({"params": p}, jnp.asarray(text), jnp.asarray(image),
                            return_loss=True)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    runtime = make_runtime(devices=jax.devices()[:1])
    opt = optax.chain(optax.clip_by_global_norm(CLIP), optax.scale_by_adam())

    def j_loss(p, batch, rng):
        return jmodel.apply({"params": p}, batch["text"], batch["image"], return_loss=True)

    state, shardings = j_create_state(jax.device_get(params), opt, runtime)
    step = j_make_step(j_loss, opt, runtime, shardings, dynamic_lr=True)
    losses = []
    for i in range(STEPS):
        text_i, image_i = _batch(config, 10 + i)
        state, step_loss = step(state, {"text": jnp.asarray(text_i), "image": jnp.asarray(image_i)},
                                jax.random.key(i), jnp.asarray(LR, jnp.float32))
        losses.append(float(step_loss))
    adam = state.opt_state[1]
    before = dalle_state_dict(params)
    after = dalle_state_dict(jax.device_get(state.params))
    return (float(loss), dalle_state_dict(jax.device_get(grads)), losses,
            {k: after[k] - before[k] for k in after},
            dalle_state_dict(jax.device_get(adam.mu)), dalle_state_dict(jax.device_get(adam.nu)))


def _port_run(config, params):
    """The port's bf16 run of ``_jax_run``'s work."""
    model = _port(config, params, **BF16)
    text, image = _batch(config, 2)
    loss = model(*_t(text, image), return_loss=True)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = create_train_state(model)
    step = make_train_step(train_dalle.dalle_loss, CLIP)
    losses = []
    for i in range(STEPS):
        text_i, image_i = _t(*_batch(config, 10 + i))
        state, step_loss = step(state, model, {"text": text_i, "image": image_i}, LR)
        losses.append(step_loss.item())
    return (loss.item(), grads, losses,
            {k: p.detach() - before[k] for k, p in state.params.items()},
            state.opt_state.mu, state.opt_state.nu)


_RUNS: dict = {}


def runs(name):
    """{"f32": JAX float32, "bf16": JAX bf16, "port": the port's bf16}
    runs of ``name``'s config, each ``_jax_run``'s tuple; made once."""
    if name not in _RUNS:
        config = CONFIGS[name]
        params = _params(config)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DALLE_TPU_SPARSE_KERNEL", "1")  # JAX routes as on the TPU
            _RUNS[name] = {
                "f32": _jax_run(JDALLE(**config), params, config),
                "bf16": _jax_run(JDALLE(**config, dtype=jnp.bfloat16), params, config),
                "port": _port_run(config, params),
            }
    return _RUNS[name]


def gap_ratios(name) -> dict:
    """{quantity: (port gap / JAX gap, worst tensor)}: the largest ratio of
    |port bf16 - JAX bf16| to |JAX bf16 - JAX float32| over the tensors of
    each quantity (relative L2; the losses absolute)."""
    r = runs(name)
    f32, bf16, port = r["f32"], r["bf16"], r["port"]
    out = {"loss": (gap_ratio(port[0], bf16[0], f32[0]), "loss"),
           "step losses": max((gap_ratio(*losses), f"step {i}") for i, losses
                              in enumerate(zip(port[2], bf16[2], f32[2])))}
    for index, kind in ((1, "gradients"), (3, "update"), (4, "mu"), (5, "nu")):
        assert sorted(port[index]) == sorted(bf16[index])
        out[kind] = max((gap_ratio(port[index][k], bf16[index][k], f32[index][k]), k)
                        for k in bf16[index])
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_route_is_the_float32_route(name):
    """bf16 takes the float32 config's attention route: the route does not
    depend on the dtype."""
    config = CONFIGS[name]
    model = DALLE(**config, device="cpu", **BF16)
    n = model.total_seq_len
    route, pair_grid = ROUTES[name]
    assert full_route(n, config["heads"], config["dim_head"]) == route
    attns = [m for m in model.modules() if isinstance(m, Attention)]
    assert any(a.uses_block_sparse(n) for a in attns) == pair_grid
    assert all(a.to_qkv.weight.dtype == torch.float32 for a in attns)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_every_gradient_within_twice_jax_bf16_gap(name):
    ratios = gap_ratios(name)
    for kind in ("loss", "gradients"):
        ratio, worst = ratios[kind]
        assert ratio <= BF16_GAP_FACTOR, (name, kind, worst, ratio)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_steps_within_twice_jax_bf16_gap(name):
    """Each step's loss, every parameter's update and both Adam moments
    after 3 clipped-Adam steps (lr 3e-4, clip 0.5)."""
    ratios = gap_ratios(name)
    for kind in ("step losses", "update", "mu", "nu"):
        ratio, worst = ratios[kind]
        assert ratio <= BF16_GAP_FACTOR, (name, kind, worst, ratio)


def test_params_and_moments_float32_activations_bf16():
    config = CONFIGS["dense"]
    model = _port(config, _params(config), **BF16)
    seen = {}

    def spy(module, args, out):
        seen[type(module).__name__ + str(len(seen))] = (args[0].dtype, out.dtype)

    for m in model.modules():
        if isinstance(m, (layers.Linear, layers.LayerNorm32, layers.FeedForward)):
            m.register_forward_hook(spy)
    state = create_train_state(model)
    text, image = _t(*_batch(config, 3))
    state, loss = make_train_step(train_dalle.dalle_loss, CLIP)(
        state, model, {"text": text, "image": image}, LR)
    assert math.isfinite(loss.item()) and loss.dtype == torch.float32
    for part in (state.params, state.opt_state.mu, state.opt_state.nu):
        assert all(t.dtype == torch.float32 for t in part.values())
    for key, (x, out) in seen.items():
        if key.startswith("LayerNorm32"):
            assert out == torch.float32, key   # the norms run in float32
        else:
            assert out == torch.bfloat16, key  # projections and the GEGLU in bf16
            assert x == torch.bfloat16 or key.startswith("Linear"), key
    logits = model(text, image)
    assert logits.dtype == torch.float32


def test_float32_parameters_cast_at_use_equal_bf16_parameters():
    """The forward of float32 master params cast at use is bitwise that of
    a model holding bfloat16 params of the same values (the serving form),
    logits and loss."""
    config = CONFIGS["dense"]
    params = _params(config)
    mixed = _port(config, params, **BF16)
    pure = _port(config, params, dtype=torch.bfloat16)
    assert pure.to_logits.weight.dtype == torch.bfloat16
    with torch.no_grad():
        for name, p in mixed.named_parameters():  # the values bf16 holds
            p.copy_(dict(pure.named_parameters())[name].float())
    text, image = _t(*_batch(config, 4))
    with torch.no_grad():
        assert torch.equal(mixed(text, image), pure(text, image))
        assert torch.equal(mixed(text, image, return_loss=True),
                           pure(text, image, return_loss=True))


def _snapshot(state):
    return [t.detach().clone() for d in (state.params, state.opt_state.mu,
                                         state.opt_state.nu) for t in d.values()]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_injected_nan_leaves_bf16_state_bit_identical():
    config = CONFIGS["dense"]
    model = _port(config, _params(config), **BF16)
    batch = dict(zip(("text", "image"), _t(*_batch(config, 5))))
    state = create_train_state(model)
    state, loss = make_train_step(train_dalle.dalle_loss, CLIP)(state, model, batch, LR)
    assert math.isfinite(loss.item())
    before = _snapshot(state)
    step = make_train_step(train_dalle.dalle_loss, CLIP, nan_inject_step=1)
    state, loss = step(state, model, batch, LR)
    assert math.isnan(loss.item()) and _same(before, _snapshot(state))
    assert int(state.skipped) == 1 and int(state.consec_skipped) == 1
    assert int(state.opt_state.count) == 1
    state, loss = step(state, model, batch, LR)
    assert math.isfinite(loss.item()) and int(state.consec_skipped) == 0


def _vae():
    cfg = dict(image_size=32, num_layers=2, num_resnet_blocks=1, hidden_dim=16,
               num_tokens=40, codebook_dim=8)
    params = JVAE(**cfg).init({"params": jax.random.key(3), "gumbel": jax.random.key(4)},
                              jnp.zeros((1, 32, 32, 3)))["params"]
    vae = DiscreteVAE(**cfg, device="cpu")
    vae.load_state_dict(vae_state_dict(jax.device_get(params)))
    return vae


def _images(seed, b=2):
    return torch.from_numpy(np.random.RandomState(seed).rand(b, 32, 32, 3).astype(np.float32))


def test_bf16_trainer_retries_a_rejected_step_bitwise():
    config = CONFIGS["dense"]
    params, vae = _params(config), _vae()
    runs_ = {}
    for inject in (None, 1):
        trainer = train_dalle.DalleTrainer(vae, _port(config, params, **BF16), batch_size=2,
                                           bf16=True, nan_inject_step=inject, device="cpu")
        losses = [trainer.train_step(torch.from_numpy(_batch(config, 20 + i)[0]).long(),
                                     _images(i)) for i in range(3)]
        runs_[inject] = (trainer, losses)
    clean, faulted = runs_[None][0], runs_[1][0]
    assert clean.retries == 0 and faulted.retries == 1 and faulted.steps == 3
    assert runs_[None][1] == runs_[1][1] and all(math.isfinite(x) for x in runs_[1][1])
    assert _same(_snapshot(clean.state), _snapshot(faulted.state))


def test_bf16_flag_builds_mixed_precision_and_trains():
    """``bf16`` is no longer refused: from the flags it builds the DALLE in
    bfloat16 on float32 parameters (the float32 build's weights) and
    trains; a model of another precision is refused; every flag still in
    ``NOT_PORTED`` still raises."""
    assert "bf16" not in train_dalle.NOT_PORTED and train_dalle.FLAGS["bf16"] is False
    vae = _vae()
    flags = dict(num_text_tokens=50, device="cpu", dim=64, depth=1, heads=2, dim_head=64,
                 text_seq_len=64, shift_tokens=True, rotary_emb=True, batch_size=2, seed=0)
    trainer = train_dalle.DalleTrainer(vae, bf16=True, **flags)
    f32 = train_dalle.DalleTrainer(vae, **flags)
    assert (trainer.dalle.dtype, trainer.dalle.param_dtype) == (torch.bfloat16, torch.float32)
    assert f32.dalle.dtype == torch.float32
    assert _same(list(trainer.dalle.parameters()), list(f32.dalle.parameters()))
    loss = trainer.train_step(torch.from_numpy(_batch(CONFIGS["dense"], 8)[0]).long(),
                              _images(8))
    assert math.isfinite(loss) and trainer.steps == 1
    config = {**CONFIGS["dense"], "depth": 1}
    for model, bf16 in ((DALLE(**config, device="cpu"), True),
                        (DALLE(**config, device="cpu", **BF16), False),
                        (DALLE(**config, device="cpu", dtype=torch.bfloat16), True)):
        with pytest.raises(ValueError, match="bf16"):
            train_dalle.DalleTrainer(vae, model, bf16=bf16, device="cpu")
    for flag in train_dalle.NOT_PORTED:
        with pytest.raises(NotImplementedError, match=flag):
            train_dalle.DalleTrainer(vae, device="cpu", **{flag: None})


def test_float32_model_is_bitwise_stock_linear():
    """``param_dtype`` changes nothing in float32: the loss and every
    gradient are bitwise those of the same model whose projections run
    ``nn.Linear.forward``, as before ``layers.Linear``."""
    config = CONFIGS["dense"]
    params = _params(config)
    text, image = _t(*_batch(config, 6))
    results = []
    for stock in (False, True):
        model = _port(config, params, param_dtype=torch.float32 if stock else None)
        if stock:
            for m in model.modules():
                if isinstance(m, layers.Linear):
                    m.forward = types.MethodType(torch.nn.Linear.forward, m)
        loss = model(text, image, return_loss=True)
        loss.backward()
        results.append((loss.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(results[0][0], results[1][0])
    assert _same(results[0][1], results[1][1])
