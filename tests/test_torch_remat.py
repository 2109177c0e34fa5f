"""Remat in the port (``Transformer(remat=True)``: each attention and
each feed-forward block recomputed in the backward) on the CPU, float32:

- against JAX's ``DALLE(remat=True)`` (``jax.checkpoint`` per block) on
  test_torch_reversible.py's packed DALLE (depth 3, n 128, rotary, token
  shift), JAX-initialised, every leaf perturbed and converted: the loss
  and every gradient against ``jax.grad`` (3 clipped-Adam steps against
  JAX's ``make_train_step`` in test_torch_remat_steps.py), at
  test_torch_train.py's tolerances;
- bit for bit the port's own sequential execution: the loss, every
  gradient and 3 clipped-Adam steps, on the packed and the dense route,
  without dropout and with both rates 0.1 (the generator ending in the
  sequential run's state, the backward redrawing the forward's masks);
- ``remat`` with ``reversible`` runs reversible, as in JAX; a call
  without a gradient and the decode form run sequentially.
"""

import pytest
import torch

import test_torch_reversible as rev
from dalle_pytorch_tpu_torch import train_dalle
from dalle_pytorch_tpu_torch.models import transformer
from dalle_pytorch_tpu_torch.parallel.step import create_train_state, make_train_step
from dalle_pytorch_tpu_torch.testing import dropout_masks

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def remat_case():
    config = {**rev.CONFIGS["packed"], "remat": True}
    return (config, *rev.jax_params(config))


def test_loss_and_every_gradient_match_jax_remat(remat_case):
    config, jmodel, params = remat_case
    rev.check_loss_and_gradients(jmodel, params, rev.port(params, config),
                                 *rev.batch(config, 4))


def _steps(model, config, dropout: bool):
    """(losses, gradients of the first step, params after 3 clipped-Adam
    steps, masks drawn, the last generator's state)."""
    state = create_train_state(model)
    step = make_train_step(train_dalle.dalle_loss, rev.CLIP)
    text, image = rev._t(*rev.batch(config, 30))
    gen = torch.Generator().manual_seed(4) if dropout else None
    loss = model(text, image, return_loss=True, generator=gen)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    losses = [loss]
    with dropout_masks() as drawn:
        for i in range(3):
            text, image = rev._t(*rev.batch(config, 31 + i))
            gen = torch.Generator().manual_seed(i) if dropout else None
            state, loss = step(state, model, {"text": text, "image": image}, rev.LR, gen)
            losses.append(loss)
    return (losses, grads, [p.detach().clone() for p in model.parameters()], drawn,
            None if gen is None else gen.get_state())


@pytest.mark.parametrize("route", list(rev.CONFIGS))
@pytest.mark.parametrize("dropout", [False, True], ids=["no_dropout", "dropout"])
def test_bitwise_sequential(route, dropout):
    config = {**rev.CONFIGS[route], **(rev.RATES if dropout else {})}
    _, params = rev.jax_params(rev.CONFIGS[route])
    seq = _steps(rev.port(params, config), config, dropout)
    remat = _steps(rev.port(params, {**config, "remat": True}), config, dropout)
    assert all(torch.equal(a, b) for a, b in zip(seq[0], remat[0]))
    for part in (1, 2):
        assert all(torch.equal(a, b) for a, b in zip(seq[part], remat[part]))
    per = 2 * config["depth"] * 3 if dropout else 0
    assert len(seq[3]) == per and len(remat[3]) == 2 * per
    if dropout:
        assert torch.equal(seq[4], remat[4])


def test_remat_with_reversible_runs_reversible(monkeypatch):
    config = {**rev.CONFIGS["dense"], "remat": True, "reversible": True}
    _, params = rev.jax_params(rev.CONFIGS["dense"])
    calls = []
    fn = transformer.reversible_sequence
    monkeypatch.setattr(transformer, "reversible_sequence",
                        lambda *a: calls.append(1) or fn(*a))
    rev_only = rev.port(params, {**config, "remat": False})
    text, image = rev._t(*rev.batch(config, 5))
    ref = rev_only(text, image, return_loss=True)
    got = rev.port(params, config)(text, image, return_loss=True)
    assert calls == [1, 1] and torch.equal(got, ref)


def test_no_gradient_runs_sequentially(monkeypatch):
    config = {**rev.CONFIGS["dense"], "remat": True}
    _, params = rev.jax_params(rev.CONFIGS["dense"])
    calls = []
    fn = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint", lambda *a, **k: calls.append(1) or fn(*a, **k))
    model = rev.port(params, config)
    text, image = rev._t(*rev.batch(config, 6))
    with torch.no_grad():
        got = model(text, image, return_loss=True)
        ref = rev.port(params, rev.CONFIGS["dense"])(text, image, return_loss=True)
    assert calls == [] and torch.equal(got, ref)
    model(text, image, return_loss=True)
    assert len(calls) == 2 * config["depth"]
