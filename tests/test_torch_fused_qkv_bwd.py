"""The port's packed-qkv attention backward (plain version, which every
CPU tensor runs) against ``jax.vjp`` of the JAX package's
``fused_qkv_attention`` in interpret mode, on the CPU in float32 at
n = 128, b = 2, for 2 heads of 64 and 4 heads of 32: dqkv to atol 1e-5
with rtol 1e-5, for causal attention with the DALL-E rotary table,
non-causal attention with a key mask that masks one batch row entirely
(dqkv exactly 0 there), and a static pattern mask. Also against torch
autograd of ``reference_fused_qkv`` (same tolerance), the
``FusedQKVAttention`` function on the CPU (identical to the plain
backward), the inverse rotation needs a pair-constant table (which
``rot_tables`` enforces), and a CPU tensor counts no launch. The same
cases in bfloat16 against ``jax.vjp`` in bfloat16: dqkv by the floored
row metric of ``dalle_pytorch_tpu_torch.testing`` within 1e-2, rows the
masks leave without a key exactly 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops.flash_attention import fused_qkv_attention as j_fused
from dalle_pytorch_tpu_torch.ops import flash_attention as fa
from dalle_pytorch_tpu_torch.ops.rotary import rot_tables
from dalle_pytorch_tpu_torch.testing import BWD_BF16_ROW_REL, bwd_errors, bwd_inputs
from tests.test_torch_fused_qkv import B, N, _case

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
CASES = ["causal_rotary", "key_mask", "pattern"]
HEADS = pytest.mark.parametrize("h,d", [(2, 64), (4, 32)], ids=["h2d64", "h4d32"])


def _inputs(name, h, d):
    qkv, jkw, tkw = _case(name, h, d)
    do = np.random.RandomState(7).randn(B, N, h * d).astype(np.float32)
    return qkv, do, jkw, tkw


@pytest.mark.parametrize("name", CASES)
@HEADS
def test_plain_backward_matches_jax_vjp(name, h, d):
    qkv, do, jkw, tkw = _inputs(name, h, d)

    def attend(x):
        return j_fused(x, jkw["key_mask"], h, d, jkw["rot"], jkw["causal"],
                       jkw["pattern_mask"], d**-0.5, True)

    _, vjp = jax.vjp(attend, jnp.asarray(qkv))
    (ref,) = vjp(jnp.asarray(do))
    t_qkv = torch.from_numpy(qkv)
    o, lse = fa.fused_qkv_attention(t_qkv, h, d, sm_scale=d**-0.5, **tkw)
    got = fa.fused_qkv_attention_bwd(t_qkv, o, lse, torch.from_numpy(do), h, d,
                                     sm_scale=d**-0.5, **tkw)
    assert got.shape == (B, N, 3 * h * d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if name == "key_mask":
        assert (got[1] == 0).all()


@pytest.mark.parametrize("name", CASES)
@HEADS
def test_plain_backward_matches_autograd_and_function(name, h, d):
    qkv, do, _, tkw = _inputs(name, h, d)
    t_qkv = torch.from_numpy(qkv).requires_grad_()
    t_do = torch.from_numpy(do)
    o, lse = fa.reference_fused_qkv(t_qkv, h, d, **tkw)
    (autograd,) = torch.autograd.grad(o, t_qkv, t_do)
    plain = fa.reference_fused_qkv_bwd(t_qkv.detach(), o.detach(), lse.detach(), t_do, h, d,
                                       **tkw)
    np.testing.assert_allclose(plain.numpy(), autograd.numpy(), **TOL)

    fo, flse = fa.FusedQKVAttention.apply(
        t_qkv, tkw.get("key_mask"), h, d, tkw["causal"], tkw.get("pattern_mask"),
        tkw.get("rot"), None)
    assert not flse.requires_grad
    (function,) = torch.autograd.grad(fo, t_qkv, t_do)
    assert torch.equal(fo, o.detach()) and torch.equal(function, plain)


@pytest.mark.parametrize("name", CASES)
@HEADS
def test_plain_bf16_backward_matches_jax_vjp(name, h, d):
    qkv, jkw, tkw = _case(name, h, d, dtype=torch.bfloat16)
    do = np.random.RandomState(7).randn(B, N, h * d).astype(np.float32)

    def attend(x):
        return j_fused(x, jkw["key_mask"], h, d, jkw["rot"], jkw["causal"],
                       jkw["pattern_mask"], d**-0.5, True)

    _, vjp = jax.vjp(attend, jnp.asarray(qkv, dtype=jnp.bfloat16))
    (ref,) = vjp(jnp.asarray(do, dtype=jnp.bfloat16))
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    t_qkv = torch.from_numpy(qkv).to(torch.bfloat16)
    t_do = torch.from_numpy(do).to(torch.bfloat16)
    o, lse = fa.fused_qkv_attention(t_qkv, h, d, sm_scale=d**-0.5, **tkw)
    got = fa.fused_qkv_attention_bwd(t_qkv, o, lse, t_do, h, d, sm_scale=d**-0.5, **tkw)
    assert got.dtype == torch.bfloat16
    _, row_rel, zeros_exact = bwd_errors(got, ref, h, d, tkw)
    assert zeros_exact and row_rel <= 1e-2, row_rel
    if name == "key_mask":
        assert (got[1] == 0).all()


def test_inverse_rotation_needs_a_pair_constant_table():
    """The backward's inverse rotation t*cos - rotate_half(t)*sin is the
    VJP of the rotation only when each channel pair shares its angle:
    with tables from angles that differ within a pair the plain backward
    departs from autograd, and ``rot_tables`` refuses such a table."""
    h, d = 2, 16
    rng = np.random.RandomState(3)
    angles = torch.from_numpy(rng.rand(N, d).astype(np.float32))
    with pytest.raises(ValueError, match="pair-constant"):
        rot_tables(angles, N, d, torch.float32)
    qkv = torch.from_numpy(rng.randn(1, N, 3 * h * d).astype(np.float32)).requires_grad_()
    do = torch.from_numpy(rng.randn(1, N, h * d).astype(np.float32))
    for table, agrees in ((angles.repeat_interleave(2, dim=1)[:, :d], True), (angles, False)):
        rot = (table.cos(), table.sin())
        o, lse = fa.reference_fused_qkv(qkv, h, d, rot=rot)
        (autograd,) = torch.autograd.grad(o, qkv, do)
        plain = fa.reference_fused_qkv_bwd(qkv.detach(), o.detach(), lse.detach(), do,
                                           h, d, rot=rot)
        assert torch.allclose(plain, autograd, **TOL) == agrees


def test_cpu_backward_counts_no_launch():
    qkv, do, _, tkw = _inputs("key_mask", 2, 64)
    t_qkv = torch.from_numpy(qkv)
    o, lse = fa.fused_qkv_attention(t_qkv, 2, 64, **tkw)
    before = fa.fused_qkv_attention_bwd.launches
    fa.fused_qkv_attention_bwd(t_qkv, o, lse, torch.from_numpy(do), 2, 64, **tkw)
    assert fa.fused_qkv_attention_bwd.launches == before


def test_bf16_row_metric_needs_its_floor(monkeypatch):
    """The bf16 metric of ``dalle_pytorch_tpu_torch.testing`` (each dqkv
    row's error relative to the plain row's norm, floored at 1e-3 of the
    median row) accepts the plain
    version against itself with every product summed in float64 instead
    of float32, at a causal rotary shape (n 200, 4 heads of 64); without
    the floor the same comparison fails: dq of a query row that attends
    one key is 0 exactly, and both sides hold only rounding noise there."""
    qkv, o, lse, do, h, d, opts = bwd_inputs("d64", torch.bfloat16, "cpu")
    plain = fa.reference_fused_qkv_bwd(qkv, o, lse, do, h, d, **opts)
    einsum = torch.einsum
    monkeypatch.setattr(torch, "einsum",
                        lambda eq, *ops: einsum(eq, *(t.double() for t in ops)).float())
    other = fa.reference_fused_qkv_bwd(qkv, o, lse, do, h, d, **opts)
    _, floored, zeros_exact = bwd_errors(other, plain, h, d, opts)
    assert floored <= BWD_BF16_ROW_REL and zeros_exact
    dq, dq_plain = other[..., :h * d].float(), plain[..., :h * d].float()
    unfloored = ((dq - dq_plain).norm(dim=-1) / dq_plain.norm(dim=-1)).max().item()
    assert unfloored > 0.5
