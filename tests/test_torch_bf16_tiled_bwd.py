"""The numerics of the tiled flash kernels' bf16 dq and dk/dv on the CPU.
On the card they run on bf16 tensor-core tiles (``flash_dq_tc_kernel``,
``flash_dkdv_tc_kernel``, csrc/bf16_sweeps.cuh): float32 sums of bf16
products per streamed 32-row half, p and ds rounded to bf16 where the
sweeps pack them into the next product's A fragments, delta summed in
float32 from the bf16 o and do. ``testing.emulated_bf16_tiled_dq`` and
``emulated_bf16_tiled_dkdv`` run that arithmetic in torch, and are held:

- against float64 at the 512 px length (n 4,352, one head of 64,
  causal, and causal with a key mask made as ``flash_inputs``' "long_d96"
  case makes it: a fifth of row 0's keys and key 0 dropped, every key of
  row 1): each of dq, dk, dv within ``BF16_GAP_FACTOR`` times the port's
  plain bf16 backward's own relative L2 gap to float64, delta within 1e-4
  of the plain delta's largest entry;
- against JAX ``flash_attention``'s bf16 vjp, which runs
  ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` in interpret mode, at
  ``flash_inputs``' "tiled" shape (n 1152, 3 x 3 flash blocks of 384,
  2 x 2 heads of 64, the key mask): the floored row metric within
  ``BWD_BF16_ROW_REL``, on JAX's own o and lse;
- rows with no allowed key and keys no query attends exactly 0 in both.
"""

import importlib

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.ops import flash_attention as fa
from dalle_pytorch_tpu_torch.testing import (
    BF16_GAP_FACTOR,
    BWD_BF16_ROW_REL,
    emulated_bf16_tiled_dkdv,
    emulated_bf16_tiled_dq,
    flash_bwd_errors,
    flash_inputs,
    rel_l2,
)

# the module, not the function that dalle_pytorch_tpu.ops exports under its name
jfa = importlib.import_module("dalle_pytorch_tpu.ops.flash_attention")

torch.set_num_threads(2)

N_LONG = 4352


def _exact(q, k, v, do, key_mask, chunk: int = 1088):
    """float64 (o, lse, dq, dk, dv) of causal attention on the bf16 q, k,
    v, do (b, h, n, d), ``chunk`` query rows at a time."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    n, d = q.shape[-2:]
    scale = d**-0.5
    allowed = fa.may_attend(n, q.device, key_mask)
    o, lse, dq = torch.zeros_like(q), torch.zeros(q.shape[:-1], dtype=torch.float64), \
        torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for r0 in range(0, n, chunk):
        rows = slice(r0, r0 + chunk)
        s = (q[..., rows, :] @ k.transpose(-1, -2) * scale).masked_fill(
            ~allowed[..., rows, :], fa.NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.where(s > 0.5 * fa.NEG_INF, torch.exp(s - m), 0.0)
        l_sum = p.sum(-1, keepdim=True)
        l_safe = torch.where(l_sum == 0, 1.0, l_sum)
        p = p / l_safe
        o[..., rows, :] = p @ v
        lse[..., rows] = (m + torch.log(l_safe))[..., 0]
        delta = (do[..., rows, :] * o[..., rows, :]).sum(-1, keepdim=True)
        ds = p * (do[..., rows, :] @ v.transpose(-1, -2) - delta) * scale
        dq[..., rows, :] = ds @ k
        dk += ds.transpose(-1, -2) @ q[..., rows, :]
        dv += p.transpose(-1, -2) @ do[..., rows, :]
    return o, lse, (dq, dk, dv)


@pytest.fixture(scope="module", params=["causal", "key_mask"])
def long_case(request):
    """(q, k, v, o, lse, do, key_mask, exact grads) at n 4,352, one head of
    64: b 1 causal, or b 2 with the "long_d96" key mask; o rounded to bf16
    and lse to float32 from the float64 forward."""
    rng = np.random.RandomState(5)
    masked = request.param == "key_mask"
    b = 2 if masked else 1
    km = None
    if masked:
        km = rng.rand(b, N_LONG) > 0.2
        km[0, 0], km[1] = False, False
        km = torch.from_numpy(km)
    q, k, v, do = (torch.from_numpy(rng.randn(b, 1, N_LONG, 64).astype(np.float32)).bfloat16()
                   for _ in range(4))
    o, lse, exact = _exact(q, k, v, do, km)
    return q, k, v, o.bfloat16(), lse.float(), do, km, exact


def test_bf16_tiled_backward_within_the_plain_gap_at_4352(long_case):
    """Each of dq, dk, dv of the emulated kernels within ``BF16_GAP_FACTOR``
    times the plain bf16 backward's relative L2 gap to float64; delta
    within 1e-4 of the plain delta's largest entry; dead rows exactly 0."""
    q, k, v, o, lse, do, km, exact = long_case
    dq, delta = emulated_bf16_tiled_dq(q, k, v, o, lse, do, key_mask=km)
    dk, dv = emulated_bf16_tiled_dkdv(q, k, v, do, lse, delta, key_mask=km)
    plain = fa.reference_flash_attention_bwd(q, k, v, o, lse, do, key_mask=km)
    pdelta = (do.float() * o.float()).sum(-1)
    assert (delta - pdelta).abs().max().item() <= 1e-4 * pdelta.abs().max().item()
    for name, got, ref, want in zip(("dq", "dk", "dv"), (dq, dk, dv), plain, exact):
        ratio = rel_l2(got, want) / rel_l2(ref, want)
        assert ratio <= BF16_GAP_FACTOR, (name, ratio)
    _, _, zeros_exact = flash_bwd_errors((dq, dk, dv), plain, key_mask=km)
    assert zeros_exact


@pytest.fixture(scope="module")
def tiled_case():
    """``flash_inputs("tiled")`` in bf16 (b 2, 2 heads of 64, n 1152, the
    key mask), JAX's o and lse of them and JAX's vjp dq, dk, dv
    (interpret mode, blocks of 384), all as torch tensors."""
    q, k, v, do, opts = flash_inputs("tiled", torch.bfloat16, "cpu")
    km = opts["key_mask"]
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in (q, k, v, do))
    jkm = jnp.asarray(km.numpy())
    kw = dict(key_mask=jkm, causal=True, pattern_mask=None, sm_scale=64**-0.5, block_q=384,
              block_k=384, interpret=True)
    o, lse = jfa._flash_fwd(jq, jk, jv, jkm, True, None, 64**-0.5, 384, 384, True)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, **kw), jq, jk, jv)
    to_torch = lambda t: torch.from_numpy(np.array(t.astype(jnp.float32)))  # noqa: E731
    grads = tuple(to_torch(g).bfloat16() for g in vjp(jdo))
    return q, k, v, to_torch(o).bfloat16(), to_torch(lse), do, km, grads


def test_bf16_tiled_backward_matches_jax_vjp(tiled_case):
    """The emulated dq and dk/dv on JAX's o and lse against JAX's bf16 vjp
    (``_bwd_dq_kernel``, ``_bwd_dkv_kernel`` in interpret mode): the
    floored row metric within ``BWD_BF16_ROW_REL``; dead rows and keys
    exactly 0 in both."""
    q, k, v, o, lse, do, km, jax_grads = tiled_case
    dq, delta = emulated_bf16_tiled_dq(q, k, v, o, lse, do, key_mask=km)
    got = (dq, *emulated_bf16_tiled_dkdv(q, k, v, do, lse, delta, key_mask=km))
    rel, row_rel, zeros_exact = flash_bwd_errors(got, jax_grads, key_mask=km)
    assert row_rel <= BWD_BF16_ROW_REL, (rel, row_rel)
    assert zeros_exact
    assert flash_bwd_errors(jax_grads, got, key_mask=km)[2]


def test_bf16_tiled_dead_rows_and_keys_are_exactly_zero(tiled_case):
    """The "tiled" key mask kills batch row 1 entirely and query 0 of row
    0 (its only key dropped): their dq rows, and the dk, dv rows of every
    dropped key, are exactly 0 in the emulation, and only there."""
    q, k, v, o, lse, do, km, _ = tiled_case
    dq, delta = emulated_bf16_tiled_dq(q, k, v, o, lse, do, key_mask=km)
    dk, dv = emulated_bf16_tiled_dkdv(q, k, v, do, lse, delta, key_mask=km)
    assert (dq[1] == 0).all() and (dq[0, :, 0] == 0).all()
    assert (dk[~km.bool()[:, None].expand(-1, 2, -1)] == 0).all()
    assert (dv[~km.bool()[:, None].expand(-1, 2, -1)] == 0).all()
    assert (dk[0].float().norm(dim=-1)[:, km[0].bool()] > 0).all()
