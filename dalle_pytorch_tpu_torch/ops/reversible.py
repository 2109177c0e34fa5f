"""Reversible residual execution (counterpart of
``dalle_pytorch_tpu/ops/reversible.py``).

The wiring of RevNet-style blocks: two residual streams, and for each
block (f, g) ``y1 = x1 + f(x2)``, then ``y2 = x2 + g(y1)``.

- ``reversible_sequence`` runs it as a ``torch.autograd.Function`` that
  keeps only the final pair of streams: its backward rebuilds each
  block's inputs from its outputs, last block first (``x2 = y2 - g(y1)``,
  then ``x1 = y1 - f(x2)``), re-runs g and f with autograd on and takes
  their vector-Jacobian products. Activation memory is O(1) in depth at
  about one more forward of compute. The blocks' parameters are inputs of
  the Function and their gradients its outputs, as JAX's ``_bwd`` returns
  ``dparams``, so ``torch.autograd.grad(loss, params)`` reaches them.
- ``reversible_forward_only`` is the same wiring without the Function,
  for calls that take no gradient (decode, evaluation).

A block is a callable ``(x, generator) -> delta``; the generator (or
None) is the one its dropout draws from. The forward snapshots the
generator's state before each block and lets the block draw from the
generator itself, so the generator ends where sequential execution of the
same blocks leaves it and every mask is the one the same call order
draws. The backward re-runs each block on a generator restored from its
snapshot, so the recompute draws the forward's masks again.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

Block = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


def _snapshot(generator: Optional[torch.Generator]):
    return None if generator is None else generator.get_state()


def restored(generator: Optional[torch.Generator], state) -> Optional[torch.Generator]:
    """A new generator on ``generator``'s device at ``state`` (None
    without a generator)."""
    if generator is None:
        return None
    fork = torch.Generator(device=generator.device)
    fork.set_state(state)
    return fork


class _ReversibleSequence(torch.autograd.Function):
    """``apply(blocks, counts, generator, x1, x2, *params) -> (y1, y2)``:
    ``blocks`` the (f, g) pairs, ``counts`` each pair's (len(f params),
    len(g params)), ``params`` every block's parameters in that order."""

    @staticmethod
    def forward(ctx, blocks, counts, generator, x1, x2, *params):
        states = []
        for f, g in blocks:
            state_f = _snapshot(generator)
            x1 = x1 + f(x2, generator)
            state_g = _snapshot(generator)
            x2 = x2 + g(x1, generator)
            states.append((state_f, state_g))
        ctx.blocks, ctx.counts, ctx.generator, ctx.states = blocks, counts, generator, states
        ctx.save_for_backward(x1, x2, *params)
        return x1, x2

    @staticmethod
    def backward(ctx, dy1, dy2):
        y1, y2, *params = ctx.saved_tensors
        groups, at = [], 0
        for nf, ng in ctx.counts:
            groups.append((params[at:at + nf], params[at + nf:at + nf + ng]))
            at += nf + ng
        grads: List[Tuple] = []
        for (f, g), (pf, pg), (state_f, state_g) in zip(
                reversed(ctx.blocks), reversed(groups), reversed(ctx.states)):
            dpg, y1, y2, dy1 = _block_vjp(g, pg, y1, y2, dy2, dy1,
                                          restored(ctx.generator, state_g))
            dpf, y2, y1, dy2 = _block_vjp(f, pf, y2, y1, dy1, dy2,
                                          restored(ctx.generator, state_f))
            grads.append(dpf + dpg)
        flat = [g for block in reversed(grads) for g in block]
        return (None, None, None, dy1, dy2, *flat)


def _block_vjp(fn, params, inp, out, d_out, d_inp, generator):
    """One half-step of the backward: ``out = prev + fn(inp)``. Re-runs
    fn on ``inp`` with autograd on, rebuilds ``prev = out - fn(inp)`` and
    takes fn's vector-Jacobian product with ``d_out``. Returns (the
    parameters' gradients, ``inp``, ``prev``, ``d_inp`` plus fn's
    gradient with respect to ``inp``)."""
    with torch.enable_grad():
        leaf = inp.detach().requires_grad_()
        delta = fn(leaf, generator)
    trainable = [p for p in params if p.requires_grad]
    got = torch.autograd.grad(delta, (leaf, *trainable), d_out, allow_unused=True)
    by_param = iter(got[1:])
    dparams = tuple(next(by_param) if p.requires_grad else None for p in params)
    with torch.no_grad():
        prev = out - delta
    d_leaf = got[0]
    return dparams, inp, prev, d_inp if d_leaf is None else d_inp + d_leaf


def reversible_sequence(blocks: Sequence[Tuple[Block, Block]], x1: torch.Tensor,
                        x2: torch.Tensor, params: Sequence[Tuple[Sequence[torch.Tensor],
                                                                 Sequence[torch.Tensor]]],
                        generator: Optional[torch.Generator] = None):
    """The streams (x1, x2) through ``blocks`` with O(1) activation
    memory: returns (y1, y2). ``params`` gives each (f, g) pair's
    parameters, (f's, g's), whose gradients the backward returns."""
    counts = tuple((len(pf), len(pg)) for pf, pg in params)
    flat = [p for pf, pg in params for p in (*pf, *pg)]
    return _ReversibleSequence.apply(tuple(blocks), counts, generator, x1, x2, *flat)


def reversible_forward_only(blocks: Sequence[Tuple[Block, Block]], x1: torch.Tensor,
                            x2: torch.Tensor, generator: Optional[torch.Generator] = None):
    """The same wiring run directly: (y1, y2). Autograd through it is
    ordinary (every activation kept)."""
    for f, g in blocks:
        x1 = x1 + f(x2, generator)
        x2 = x2 + g(x1, generator)
    return x1, x2
