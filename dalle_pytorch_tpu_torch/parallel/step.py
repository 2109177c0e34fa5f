"""Single-device train step (counterpart of
``dalle_pytorch_tpu/parallel/step.py``'s ``TrainState`` and
``make_train_step``).

One step: the loss and its gradients by autograd; optax's
``clip_by_global_norm`` then ``scale_by_adam`` (b1 0.9, b2 0.999,
eps 1e-8, bias-corrected), written out on tensors in optax's order of
operations; the update ``-lr * direction`` with a learning rate given per
call (the host-side schedulers change it without rebuilding anything);
and the NaN guard. The guard checks on the device that the loss and the
global gradient norm are finite; if not, the prior params and Adam state
stay (``torch.where`` selects them, so a finite step is bit-identical to
an unguarded one), ``skipped`` and ``consec_skipped`` count up, and the
returned loss is NaN: the host's retry and abort key off exactly that.
No value is read back to the host inside the step.

Params, and the Adam moments, are updated in place, one tensor at a
time, so that the step holds no second copy of the model: ``params`` maps
names to the model's own parameters. The mesh, shardings and donation of
the JAX step have no single-card counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
from torch import nn

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the () int32 step count and the first
    and second moments, one tensor per parameter name."""

    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    """(step, params, opt_state) and the NaN guard's counters: ``skipped``
    (non-finite steps rejected in all) and ``consec_skipped`` (the current
    run of rejections). The counters are () int32 tensors on the model's
    device."""

    step: torch.Tensor
    params: Dict[str, torch.Tensor]
    opt_state: AdamState
    skipped: torch.Tensor
    consec_skipped: torch.Tensor


def create_train_state(model: nn.Module) -> TrainState:
    """The state of a fresh run: the model's parameters, zero moments and
    counters."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device

    def zero():
        return torch.zeros((), dtype=torch.int32, device=dev)

    moments = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
    return TrainState(zero(), params, AdamState(zero(), moments(), moments()),
                      zero(), zero())


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square (optax.global_norm)."""
    return torch.sqrt(sum(t.square().sum() for t in tensors))


def make_train_step(loss_fn: Callable[[nn.Module, dict], torch.Tensor],
                    max_grad_norm: float, nan_guard: bool = True,
                    nan_inject_step: Optional[int] = None):
    """``(state, model, batch, lr) -> (state, loss)``. ``loss_fn(model,
    batch)`` returns the scalar loss; ``lr`` is a float. The returned
    state holds the same param and moment tensors, updated in place, and
    new counters; the loss is a () tensor on the device, NaN for a
    rejected step. ``nan_inject_step`` forces the loss to NaN at that
    step (the fault hook; None adds nothing)."""

    def train_step(state: TrainState, model: nn.Module, batch, lr: float):
        names = list(state.params)
        params = [state.params[k] for k in names]
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        loss = loss.detach()
        nan = torch.full_like(loss, float("nan"))
        if nan_inject_step is not None:
            loss = torch.where(state.step == nan_inject_step, nan, loss)

        with torch.no_grad():
            g_norm = global_norm(grads)
            finite = torch.isfinite(loss) & torch.isfinite(g_norm)
            clip = g_norm < max_grad_norm
            adam = state.opt_state
            count = torch.where(adam.count < torch.iinfo(torch.int32).max,
                                adam.count + 1, adam.count)
            bc1 = 1 - ADAM_B1 ** count.float()
            bc2 = 1 - ADAM_B2 ** count.float()
            for name, p, g in zip(names, params, grads):
                g = torch.where(clip, g, (g / g_norm) * max_grad_norm)
                mu, nu = adam.mu[name], adam.nu[name]
                mu_new = (1 - ADAM_B1) * g + ADAM_B1 * mu
                nu_new = (1 - ADAM_B2) * g**2 + ADAM_B2 * nu
                direction = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + ADAM_EPS)
                p_new = p + -lr * direction
                if nan_guard:
                    p_new, mu_new, nu_new = (torch.where(finite, new, old) for new, old in
                                             ((p_new, p), (mu_new, mu), (nu_new, nu)))
                p.copy_(p_new)
                mu.copy_(mu_new)
                nu.copy_(nu_new)
            skipped, consec = state.skipped, state.consec_skipped
            if nan_guard:
                count = torch.where(finite, count, adam.count)
                skipped = skipped + (~finite).to(torch.int32)
                consec = torch.where(finite, 0, consec + 1).to(torch.int32)
                loss = torch.where(finite, loss, nan)
        new_state = TrainState(state.step + 1, state.params,
                               AdamState(count, adam.mu, adam.nu), skipped, consec)
        return new_state, loss

    return train_step
