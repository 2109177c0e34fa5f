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

A model that computes in bfloat16 on float32 parameters (mixed
precision, ``DALLE(dtype=torch.bfloat16, param_dtype=torch.float32)``)
gets float32 gradients through its casts, and the clip, Adam, the update
and the guard run in float32 as for a float32 model; there is no loss
scaling, as in JAX.

Gradient accumulation (``ga_steps`` k > 1) is optax's ``MultiSteps``
around that chain, written out the same way: each micro-step folds its
gradients into a running mean, ``acc + (g - acc) / (mini_step + 1)``;
the clip and Adam run on that mean only on the emitting micro-step
(``mini_step`` k - 1), after which the mean is zeroed; ``mini_step`` and
``gradient_step`` count. A micro-step the guard rejects leaves all of it
as it was. Whether a micro-step emits is the caller's to say (``emit``):
the host knows ``mini_step`` from the verdicts it reads, so the step
launches the clip and Adam only when they apply and reads nothing back,
as optax's ``lax.cond`` runs its inner update only on the emitting step.
A non-emitting micro-step checks on the device that ``mini_step`` is not
k - 1 (``torch._assert_async``).

A ``generator`` given to the step reaches the loss function (the
dropout masks' or the Gumbel noise's draws); without one the loss
function is called as ``loss_fn(model, batch)``. ``max_grad_norm=None``
leaves out the clip: optax's ``scale_by_adam`` alone (the VAE trainer's
chain), the NaN guard as it is. ``has_aux`` is JAX's: the loss function
returns (loss, aux) and the step (state, loss, aux), aux detached.

Params, and the Adam moments, are updated in place, one tensor at a
time, so that the step holds no second copy of the model: ``params`` maps
names to the model's own parameters. The mesh, shardings and donation of
the JAX step have no single-card counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Union

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


@dataclass
class MultiStepsState:
    """optax's ``MultiStepsState`` around the Adam state: the () int32
    ``mini_step`` (micro-steps folded into ``acc`` since the last emit) and
    ``gradient_step`` (emits so far), the ``inner`` Adam state and ``acc``,
    the running mean of the micro-steps' gradients by parameter name."""

    mini_step: torch.Tensor
    gradient_step: torch.Tensor
    inner: AdamState
    acc: Dict[str, torch.Tensor]


OptState = Union[AdamState, MultiStepsState]


class TrainState(NamedTuple):
    """(step, params, opt_state) and the NaN guard's counters: ``skipped``
    (non-finite steps rejected in all) and ``consec_skipped`` (the current
    run of rejections). The counters are () int32 tensors on the model's
    device; ``opt_state`` is an ``AdamState``, or a ``MultiStepsState``
    with gradient accumulation."""

    step: torch.Tensor
    params: Dict[str, torch.Tensor]
    opt_state: OptState
    skipped: torch.Tensor
    consec_skipped: torch.Tensor


def adam_state(opt: OptState) -> AdamState:
    """The Adam state of either optimizer state."""
    return opt.inner if isinstance(opt, MultiStepsState) else opt


def create_train_state(model: nn.Module, ga_steps: int = 1) -> TrainState:
    """The state of a fresh run: the model's parameters, zero moments and
    counters (and a zero accumulator with ``ga_steps`` above 1)."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device

    def zero():
        return torch.zeros((), dtype=torch.int32, device=dev)

    moments = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
    opt = AdamState(zero(), moments(), moments())
    if ga_steps > 1:
        opt = MultiStepsState(zero(), zero(), opt, moments())
    return TrainState(zero(), params, opt, zero(), zero())


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    """count + 1, held at the int32 maximum (optax's safe_increment)."""
    return torch.where(count < torch.iinfo(torch.int32).max, count + 1, count)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square (optax.global_norm)."""
    return torch.sqrt(sum(t.square().sum() for t in tensors))


def make_train_step(loss_fn: Callable[..., torch.Tensor],
                    max_grad_norm: Optional[float], nan_guard: bool = True,
                    nan_inject_step: Optional[int] = None, ga_steps: int = 1,
                    has_aux: bool = False):
    """``(state, model, batch, lr, generator=None) -> (state, loss)``.
    ``loss_fn(model, batch)`` (``loss_fn(model, batch, generator)`` when
    the step is given a generator) returns the scalar loss; ``lr`` is a
    float. The returned state holds the same param and moment tensors,
    updated in place, and new counters; the loss is a () tensor on the
    device, NaN for a rejected step. ``nan_inject_step`` forces the loss
    to NaN at that step (the fault hook; None adds nothing). ``ga_steps``
    above 1 accumulates as optax's ``MultiSteps`` (the state from
    ``create_train_state(model, ga_steps)``); ``emit`` then says whether
    the state's ``mini_step`` is ``ga_steps - 1``, so that this micro-step
    ends an optimizer step (with ``ga_steps`` 1 every step does).
    ``max_grad_norm`` None steps without the clip; ``has_aux``: the loss
    function returns (loss, aux) and the step (state, loss, aux)."""

    def train_step(state: TrainState, model: nn.Module, batch, lr: float,
                   generator: Optional[torch.Generator] = None, emit: bool = True):
        names = list(state.params)
        params = [state.params[k] for k in names]
        loss = loss_fn(model, batch) if generator is None else loss_fn(model, batch, generator)
        aux = None
        if has_aux:
            loss, aux = loss
            aux = aux.detach()
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
            if ga_steps > 1:
                multi = _multi_step if emit else _accumulate
                opt = multi(names, params, grads, state.opt_state, finite, lr, max_grad_norm,
                            ga_steps, nan_guard)
                return _counted(state, opt, finite, loss, nan, nan_guard) + (
                    (aux,) if has_aux else ())
            adam = state.opt_state
            count = _safe_increment(adam.count)
            clip, bc = _clip_test(g_norm, max_grad_norm), _bias_corrections(count)
            for name, p, g in zip(names, params, grads):
                mu, nu = adam.mu[name], adam.nu[name]
                mu_new, nu_new, direction = _clipped_adam(g, g_norm, clip, max_grad_norm,
                                                          mu, nu, bc)
                p_new = p + -lr * direction
                if nan_guard:
                    p_new, mu_new, nu_new = (torch.where(finite, new, old) for new, old in
                                             ((p_new, p), (mu_new, mu), (nu_new, nu)))
                p.copy_(p_new)
                mu.copy_(mu_new)
                nu.copy_(nu_new)
            if nan_guard:
                count = torch.where(finite, count, adam.count)
            return _counted(state, AdamState(count, adam.mu, adam.nu), finite, loss, nan,
                            nan_guard) + ((aux,) if has_aux else ())

    return train_step


def _clip_test(g_norm, max_grad_norm: Optional[float]):
    """Whether the norm is below the limit (None without a clip)."""
    return None if max_grad_norm is None else g_norm < max_grad_norm


def _counted(state: TrainState, opt: OptState, finite, loss, nan, nan_guard: bool):
    """(the next state with ``opt``, the loss): the step counted, and with
    the guard its counters moved and a rejected step's loss NaN."""
    skipped, consec = state.skipped, state.consec_skipped
    if nan_guard:
        skipped = skipped + (~finite).to(torch.int32)
        consec = torch.where(finite, 0, consec + 1).to(torch.int32)
        loss = torch.where(finite, loss, nan)
    return TrainState(state.step + 1, state.params, opt, skipped, consec), loss


def _bias_corrections(count: torch.Tensor):
    """Adam's (1 - b1**count, 1 - b2**count) at the new count."""
    return 1 - ADAM_B1 ** count.float(), 1 - ADAM_B2 ** count.float()


def _clipped_adam(g, g_norm, clip, max_grad_norm: Optional[float], mu, nu, bc):
    """One tensor of optax's ``clip_by_global_norm`` (``clip``: the norm
    is below the limit; no clip with ``max_grad_norm`` None) then
    ``scale_by_adam`` (``bc``: ``_bias_corrections``), in optax's order of
    operations: (new mu, new nu, the update direction)."""
    if max_grad_norm is not None:
        g = torch.where(clip, g, (g / g_norm) * max_grad_norm)
    mu_new = (1 - ADAM_B1) * g + ADAM_B1 * mu
    nu_new = (1 - ADAM_B2) * g**2 + ADAM_B2 * nu
    direction = (mu_new / bc[0]) / (torch.sqrt(nu_new / bc[1]) + ADAM_EPS)
    return mu_new, nu_new, direction


def _accumulate(names, params, grads, opt: MultiStepsState, finite, lr: float,
                max_grad_norm: float, k: int, nan_guard: bool) -> MultiStepsState:
    """A micro-step of ``_multi_step`` that does not emit: the gradients
    folded into the accumulator in place and ``mini_step`` counted, the
    params and the Adam state untouched (bitwise what ``_multi_step``
    gives there, without its clip and Adam)."""
    mini = opt.mini_step
    torch._assert_async(mini != k - 1)  # the caller's emit=False agrees with the device
    for name, g in zip(names, grads):
        acc = opt.acc[name]
        a = acc + (g - acc) / (mini + 1)
        acc.copy_(torch.where(finite, a, acc) if nan_guard else a)
    mini_next = _safe_increment(mini) % k
    if nan_guard:
        mini_next = torch.where(finite, mini_next, mini)
    return MultiStepsState(mini_next.to(torch.int32), opt.gradient_step, opt.inner, opt.acc)


def _multi_step(names, params, grads, opt: MultiStepsState, finite, lr: float,
                max_grad_norm: float, k: int, nan_guard: bool) -> MultiStepsState:
    """One micro-step of optax's ``MultiSteps(chain(clip_by_global_norm,
    scale_by_adam), k)`` with the update ``-lr * direction``: params,
    moments and the accumulator updated in place; the new counters. Each
    is also selected on the device by ``mini_step == k - 1``, so a call on
    a micro-step that does not emit leaves params and Adam as they
    were."""
    adam, mini = opt.inner, opt.mini_step
    acc = [opt.acc[n] + (g - opt.acc[n]) / (mini + 1) for n, g in zip(names, grads)]
    a_norm = global_norm(acc)
    emit = mini == k - 1
    apply = emit & finite if nan_guard else emit
    count = _safe_increment(adam.count)
    clip, bc = _clip_test(a_norm, max_grad_norm), _bias_corrections(count)
    for name, p, a in zip(names, params, acc):
        mu, nu = adam.mu[name], adam.nu[name]
        mu_new, nu_new, direction = _clipped_adam(a, a_norm, clip, max_grad_norm, mu, nu, bc)
        p.copy_(torch.where(apply, p + -lr * direction, p))
        mu.copy_(torch.where(apply, mu_new, mu))
        nu.copy_(torch.where(apply, nu_new, nu))
        a_next = a * (~emit).to(a.dtype)  # optax's (1 - emit) * acc
        opt.acc[name].copy_(torch.where(finite, a_next, opt.acc[name]) if nan_guard else a_next)
    count = torch.where(apply, count, adam.count)
    mini_next = _safe_increment(mini) % k
    grad_step = torch.where(emit, _safe_increment(opt.gradient_step), opt.gradient_step)
    if nan_guard:
        mini_next = torch.where(finite, mini_next, mini)
        grad_step = torch.where(finite, grad_step, opt.gradient_step)
    return MultiStepsState(mini_next.to(torch.int32), grad_step.to(torch.int32),
                           AdamState(count, adam.mu, adam.nu), opt.acc)


def train_state_tree(state: TrainState) -> dict:
    """The state as a checkpoint tree: the counters, the params and the
    Adam state keyed by parameter name, with accumulation also
    ``mini_step``, ``gradient_step`` and the accumulator ``acc``."""
    opt = state.opt_state
    adam = adam_state(opt)
    tree = {"count": adam.count, "mu": dict(adam.mu), "nu": dict(adam.nu)}
    if isinstance(opt, MultiStepsState):
        tree.update(mini_step=opt.mini_step, gradient_step=opt.gradient_step,
                    acc=dict(opt.acc))
    return {"step": state.step, "params": dict(state.params), "opt_state": tree,
            "skipped": state.skipped, "consec_skipped": state.consec_skipped}


def _copy_named(own: Dict[str, torch.Tensor], new) -> None:
    if set(own) != set(new):
        raise ValueError(f"checkpoint names differ from the model's: "
                         f"{sorted(set(own) ^ set(new))[:4]}")
    for name, t in own.items():
        t.copy_(new[name])


def _counter(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32).reshape(()).to(dev)


@torch.no_grad()
def load_opt_state(state: TrainState, saved: OptState) -> TrainState:
    """``state`` with the values of ``saved`` (an optimizer state of the
    same kind, on any device): moments and accumulator copied into
    ``state``'s own tensors, the counters new tensors on its device."""
    opt, dev = state.opt_state, state.step.device
    if isinstance(opt, MultiStepsState) != isinstance(saved, MultiStepsState):
        kinds = ["MultiSteps (ga_steps > 1)" if isinstance(o, MultiStepsState) else "Adam"
                 for o in (saved, opt)]
        raise ValueError(f"the checkpoint's optimizer state is {kinds[0]}, this run's {kinds[1]}")
    adam, new = adam_state(opt), adam_state(saved)
    _copy_named(adam.mu, new.mu)
    _copy_named(adam.nu, new.nu)
    inner = AdamState(_counter(new.count, dev), adam.mu, adam.nu)
    if isinstance(opt, MultiStepsState):
        _copy_named(opt.acc, saved.acc)
        inner = MultiStepsState(_counter(saved.mini_step, dev),
                                _counter(saved.gradient_step, dev), inner, opt.acc)
    return state._replace(opt_state=inner)


@torch.no_grad()
def load_train_state(state: TrainState, tree: dict) -> TrainState:
    """``state`` with the values of a ``train_state_tree``: params,
    moments and accumulator copied into its own tensors (the model's
    parameters), the counters new tensors on their device. The names and
    the optimizer's kind must match."""
    _copy_named(state.params, tree["params"])
    saved = tree["opt_state"]
    opt = AdamState(saved["count"], saved["mu"], saved["nu"])
    if "mini_step" in saved:
        opt = MultiStepsState(saved["mini_step"], saved["gradient_step"], opt, saved["acc"])
    state = load_opt_state(state, opt)
    dev = state.step.device
    return state._replace(step=_counter(tree["step"], dev),
                          skipped=_counter(tree["skipped"], dev),
                          consec_skipped=_counter(tree["consec_skipped"], dev))
