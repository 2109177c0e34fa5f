"""The numerics of the tiled flash kernels' bf16 forward and bf16
single-block backward on the CPU. On the card they run on bf16
tensor-core tiles (csrc/bf16_sweeps.cuh): the forward
(``flash_fwd_tc_kernel``) an online softmax per streamed 32-key half, p
rounded to bf16 against the running max before P.V, every sum in
float32; the single-block backward (``flash_bwd_fused_tc_kernel``) the
tiled bf16 dq and dk/dv sweeps in one launch, its key blocks deriving
each 32-row half's delta from O and dO. ``testing.emulated_bf16_tiled_fwd``
runs the forward's arithmetic in torch, ``emulated_bf16_tiled_dq`` and
``emulated_bf16_tiled_dkdv`` the backward's, and they are held:

- the forward against float64 at the 512 px length (n 4,352, one head of
  64, causal, and causal with a key mask made as ``flash_inputs``'
  "long_d96" case makes it: a fifth of row 0's keys and key 0 dropped,
  every key of row 1): o within ``BF16_GAP_FACTOR`` times the port's
  plain bf16 forward's own relative L2 gap to float64, lse within 1e-4
  of the float64 lse's largest entry on rows that attend a key;
- the forward against JAX ``flash_attention``'s bf16 forward
  (``_fwd_kernel`` in interpret mode) at ``flash_inputs("tiled")`` (n
  1152, 3 x 3 flash blocks of 384, 2 x 2 heads of 64, the key mask):
  the row metric and lse within ``FLASH_BF16_ROW_REL``;
- the single-block backward (delta derived per 32-row half, which must
  equal the dq pass's bit for bit) against JAX's bf16 vjp at
  ``flash_inputs("one_block")`` (n 1280, one flash block: JAX runs
  ``_bwd_fused_kernel`` in interpret mode), on JAX's o and lse: the
  floored row metric within ``BWD_BF16_ROW_REL``;
- rows with no allowed key: o exactly 0 and lse -1e30; keys no query
  attends: dk and dv exactly 0.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.ops import flash_attention as fa
from dalle_pytorch_tpu_torch.testing import (
    BF16_GAP_FACTOR,
    BWD_BF16_ROW_REL,
    FLASH_BF16_ROW_REL,
    emulated_bf16_tiled_dkdv,
    emulated_bf16_tiled_dq,
    emulated_bf16_tiled_fwd,
    emulated_row_delta,
    flash_bwd_errors,
    flash_fwd_errors,
    flash_inputs,
    rel_l2,
)

# the module, not the function that dalle_pytorch_tpu.ops exports under its name
jfa = importlib.import_module("dalle_pytorch_tpu.ops.flash_attention")

torch.set_num_threads(2)

N_LONG = 4352


def _exact_fwd(q, k, v, key_mask, chunk: int = 1088):
    """float64 (o, lse) of causal attention on the bf16 q, k, v (b, h, n,
    d), ``chunk`` query rows at a time."""
    q, k, v = (t.double() for t in (q, k, v))
    n, d = q.shape[-2:]
    allowed = fa.may_attend(n, q.device, key_mask)
    o, lse = torch.zeros_like(q), torch.zeros(q.shape[:-1], dtype=torch.float64)
    for r0 in range(0, n, chunk):
        rows = slice(r0, r0 + chunk)
        s = (q[..., rows, :] @ k.transpose(-1, -2) * d**-0.5).masked_fill(
            ~allowed[..., rows, :], fa.NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.where(s > 0.5 * fa.NEG_INF, torch.exp(s - m), 0.0)
        l_safe = p.sum(-1, keepdim=True)
        l_safe = torch.where(l_safe == 0, 1.0, l_safe)
        o[..., rows, :] = p @ v / l_safe
        lse[..., rows] = (m + torch.log(l_safe))[..., 0]
    return o, lse


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "key_mask"])
def test_bf16_tiled_forward_within_the_plain_gap_at_4352(masked):
    """o of the emulated forward within ``BF16_GAP_FACTOR`` times the plain
    bf16 forward's relative L2 gap to float64; lse within 1e-4 of the
    float64 lse's largest entry on live rows; dead rows exactly 0 with lse
    -1e30."""
    rng = np.random.RandomState(7)
    b = 2 if masked else 1
    km = None
    if masked:
        km = rng.rand(b, N_LONG) > 0.2
        km[0, 0], km[1] = False, False
        km = torch.from_numpy(km)
    q, k, v = (torch.from_numpy(rng.randn(b, 1, N_LONG, 64).astype(np.float32)).bfloat16()
               for _ in range(3))
    exact_o, exact_lse = _exact_fwd(q, k, v, km)
    o, lse = emulated_bf16_tiled_fwd(q, k, v, key_mask=km)
    po, plse = fa.reference_flash_attention(q, k, v, key_mask=km)
    ratio = rel_l2(o, exact_o) / rel_l2(po, exact_o)
    assert ratio <= BF16_GAP_FACTOR, ratio
    live = fa.may_attend(N_LONG, "cpu", km).any(-1).expand(b, 1, N_LONG)
    lse_err = (lse.double() - exact_lse)[live].abs().max().item()
    assert lse_err <= 1e-4 * exact_lse[live].abs().max().item(), lse_err
    assert flash_fwd_errors(o, lse, po, plse, key_mask=km)[3]
    if masked:  # row 1 drops every key: all its rows dead
        assert (o[1] == 0).all() and (lse[1] == fa.NEG_INF).all()


def test_bf16_tiled_forward_matches_jax():
    """The emulated forward against JAX's bf16 ``flash_attention`` forward
    (``_fwd_kernel`` in interpret mode, blocks of 384) at
    ``flash_inputs("tiled")``: the row metric and lse within
    ``FLASH_BF16_ROW_REL``; dead rows exactly 0 with lse -1e30 in both."""
    q, k, v, _, opts = flash_inputs("tiled", torch.bfloat16, "cpu")
    km = opts["key_mask"]
    jq, jk, jv = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in (q, k, v))
    jo, jlse = jfa._flash_fwd(jq, jk, jv, jnp.asarray(km.numpy()), True, None, 64**-0.5, 384,
                              384, True)
    jo = torch.from_numpy(np.array(jo.astype(jnp.float32))).bfloat16()
    jlse = torch.from_numpy(np.array(jlse))
    o, lse = emulated_bf16_tiled_fwd(q, k, v, key_mask=km)
    _, row_rel, lse_err, dead_exact = flash_fwd_errors(o, lse, jo, jlse, key_mask=km)
    assert row_rel <= FLASH_BF16_ROW_REL and lse_err <= FLASH_BF16_ROW_REL, (row_rel, lse_err)
    assert dead_exact and flash_fwd_errors(jo, jlse, o, lse, key_mask=km)[3]
    # the key mask kills batch row 1 and query 0 of row 0
    assert (o[1] == 0).all() and (o[0, :, 0] == 0).all() and (lse[1] == fa.NEG_INF).all()


def _single_block(q, k, v, o, lse, do, key_mask=None):
    """The bf16 single-block backward's arithmetic: dq with the dq
    blocks' delta, dk and dv on the key blocks' delta, derived per 32-row
    half. Returns (dq, dk, dv, the dq blocks' delta, the key blocks')."""
    n = q.shape[-2]
    dq, delta_q = emulated_bf16_tiled_dq(q, k, v, o, lse, do, key_mask=key_mask)
    delta_k = torch.cat([emulated_row_delta(o[..., r:r + 32, :], do[..., r:r + 32, :])
                         for r in range(0, n, 32)], -1)
    dk, dv = emulated_bf16_tiled_dkdv(q, k, v, do, lse, delta_k, key_mask=key_mask)
    return dq, dk, dv, delta_q, delta_k


def test_bf16_single_block_matches_jax_vjp():
    """The emulated single-block backward on JAX's o and lse against JAX's
    bf16 vjp at ``flash_inputs("one_block")`` (b 2, 3 heads of 64, n
    1280, causal: one flash block, ``_bwd_fused_kernel`` in interpret
    mode): the floored row metric within ``BWD_BF16_ROW_REL``; the key
    blocks' delta bitwise the dq blocks'."""
    q, k, v, do, _ = flash_inputs("one_block", torch.bfloat16, "cpu")
    n = q.shape[2]
    assert fa.flash_block(n) == n
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in (q, k, v, do))
    jo, jlse = jfa._flash_fwd(jq, jk, jv, None, True, None, 64**-0.5, n, n, True)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=True, sm_scale=64**-0.5, block_q=n, block_k=n, interpret=True),
        jq, jk, jv)
    to_torch = lambda t: torch.from_numpy(np.array(t.astype(jnp.float32)))  # noqa: E731
    jax_grads = tuple(to_torch(g).bfloat16() for g in vjp(jdo))
    o, lse = to_torch(jo).bfloat16(), to_torch(jlse)
    *got, delta_q, delta_k = _single_block(q, k, v, o, lse, do)
    assert torch.equal(delta_k, delta_q)
    rel, row_rel, zeros_exact = flash_bwd_errors(got, jax_grads)
    assert row_rel <= BWD_BF16_ROW_REL, (rel, row_rel)
    assert zeros_exact


def test_bf16_single_block_dead_rows_and_keys_are_exactly_zero():
    """At ``flash_inputs("d64")`` (n 384, one flash block; the key mask
    kills batch row 1 and query 0 of row 0): dq of every dead row and dk,
    dv of every dropped key exactly 0, and only there, in the emulated
    single-block backward on the emulated forward's o and lse."""
    q, k, v, do, opts = flash_inputs("d64", torch.bfloat16, "cpu")
    km = opts["key_mask"]
    assert fa.flash_block(q.shape[2]) == q.shape[2]
    o, lse = emulated_bf16_tiled_fwd(q, k, v, key_mask=km)
    dq, dk, dv, _, _ = _single_block(q, k, v, o, lse, do, key_mask=km)
    assert (dq[1] == 0).all() and (dq[0, :, 0] == 0).all()
    dropped = ~km.bool()[:, None].expand(-1, 2, -1)
    assert (dk[dropped] == 0).all() and (dv[dropped] == 0).all()
    assert (dk[0].float().norm(dim=-1)[:, km[0].bool()] > 0).all()
    plain = fa.reference_flash_attention_bwd(q, k, v, o, lse, do, key_mask=km)
    assert flash_bwd_errors((dq, dk, dv), plain, key_mask=km)[2]
