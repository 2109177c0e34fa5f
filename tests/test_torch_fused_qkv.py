"""The port's packed-qkv attention (plain version, which every CPU tensor
runs) against the JAX package's ``fused_qkv_attention`` in interpret
mode, on the CPU in float32 at n = 128, b = 2: o to atol 1e-5 (and the
JAX ``_fused_qkv_fwd``'s lse to atol 1e-5) for causal attention with the
DALL-E rotary table, non-causal attention with a key mask that masks one
batch row entirely (o exactly 0 there, lse -1e30), and a static pattern
mask. The same cases in bfloat16 (the kernels' serving type, both sides
rounding where the plain version rounds): each live query row's o within
a row-relative 2e-3 of JAX's and lse within 1e-5, masked rows exactly 0
and -1e30. Also: a table that is not pair-constant raises, the dispatch rule is
JAX's, and a CPU tensor never counts a kernel launch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops.flash_attention import StaticMask, StaticTable
from dalle_pytorch_tpu.ops.flash_attention import _fused_qkv_fwd as j_fused_fwd
from dalle_pytorch_tpu.ops.flash_attention import fused_qkv_attention as j_fused
from dalle_pytorch_tpu.ops.flash_attention import fused_qkv_supported as j_supported
from dalle_pytorch_tpu_torch.ops import flash_attention as fa
from dalle_pytorch_tpu_torch.ops.rotary import dalle_rotary_table, rot_tables

torch.set_num_threads(1)

B, N = 2, 128
ATOL = 1e-5


def _case(name, h, d, seed=0, dtype=torch.float32):
    """(qkv, JAX kwargs, port kwargs) for case ``name``; the port's rotary
    tables in ``dtype``."""
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, N, 3 * h * d).astype(np.float32)
    if name == "causal_rotary":
        table = dalle_rotary_table(d, N - 15, 4)  # N rows, 2-D grid of 4x4
        padded = np.pad(table, ((0, 0), (0, d - table.shape[1])))
        return qkv, dict(key_mask=None, rot=StaticTable(padded), causal=True,
                         pattern_mask=None), \
            dict(rot=rot_tables(torch.from_numpy(table), N, d, dtype),
                 causal=True)
    if name == "key_mask":
        km = rng.rand(B, N) > 0.3
        km[1] = False  # every query row of batch row 1 is fully masked
        return qkv, dict(key_mask=jnp.asarray(km), rot=None, causal=False,
                         pattern_mask=None), \
            dict(key_mask=torch.from_numpy(km), causal=False)
    pattern = rng.rand(N, N) > 0.5
    pattern[:, 0] = True
    return qkv, dict(key_mask=None, rot=None, causal=True,
                     pattern_mask=StaticMask(pattern)), \
        dict(pattern_mask=torch.from_numpy(pattern), causal=True)


@pytest.mark.parametrize("name", ["causal_rotary", "key_mask", "pattern"])
@pytest.mark.parametrize("h,d", [(2, 64), (4, 32)], ids=["h2d64", "h4d32"])
def test_plain_matches_jax_interpret(name, h, d):
    qkv, jkw, tkw = _case(name, h, d)
    ref_o = j_fused(jnp.asarray(qkv), jkw["key_mask"], h, d, jkw["rot"],
                    jkw["causal"], jkw["pattern_mask"], d**-0.5, True)
    _, ref_lse = j_fused_fwd(jnp.asarray(qkv), jkw["key_mask"], h, d, jkw["rot"],
                             jkw["causal"], jkw["pattern_mask"], d**-0.5, True)
    o, lse = fa.fused_qkv_attention(torch.from_numpy(qkv), h, d,
                                    sm_scale=d**-0.5, **tkw)
    assert o.shape == (B, N, h * d) and lse.shape == (B, h, 1, N)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=ATOL, rtol=0)
    if name == "key_mask":
        assert (o[1] == 0).all()
        assert (lse[1] == fa.NEG_INF).all()


def _rows_rel(got, ref, live):
    """Max over the live positions of |got - ref| / |ref| in L2 over each
    position's h*d row."""
    diff = (got - ref)[live].norm(dim=-1)
    return (diff / ref[live].norm(dim=-1)).max().item()


@pytest.mark.parametrize("name", ["causal_rotary", "key_mask", "pattern"])
@pytest.mark.parametrize("h,d", [(2, 64), (4, 32)], ids=["h2d64", "h4d32"])
def test_plain_bf16_matches_jax_interpret(name, h, d):
    qkv, jkw, tkw = _case(name, h, d, dtype=torch.bfloat16)
    jqkv = jnp.asarray(qkv, dtype=jnp.bfloat16)
    ref_o = j_fused(jqkv, jkw["key_mask"], h, d, jkw["rot"], jkw["causal"],
                    jkw["pattern_mask"], d**-0.5, True)
    _, ref_lse = j_fused_fwd(jqkv, jkw["key_mask"], h, d, jkw["rot"], jkw["causal"],
                             jkw["pattern_mask"], d**-0.5, True)
    o, lse = fa.fused_qkv_attention(torch.from_numpy(qkv).to(torch.bfloat16), h, d,
                                    sm_scale=d**-0.5, **tkw)
    assert o.dtype == torch.bfloat16 and ref_o.dtype == jnp.bfloat16
    ref_o = torch.from_numpy(np.array(ref_o.astype(jnp.float32)))
    ref_lse = torch.from_numpy(np.array(ref_lse))
    live = torch.ones(B, N, dtype=torch.bool)
    if name == "key_mask":
        live[1] = False
        assert (o[1] == 0).all() and (lse[1] == fa.NEG_INF).all()
        assert (ref_o[1] == 0).all() and (ref_lse[1] == fa.NEG_INF).all()
    assert _rows_rel(o.float(), ref_o, live) <= 2e-3
    lse_err = (lse - ref_lse)[:, :, 0].transpose(1, 2)[live].abs().max().item()
    assert lse_err <= 1e-5


def test_non_pair_constant_table_raises():
    table = np.repeat(np.linspace(0, 1, N * 8).reshape(N, 8), 2, axis=1)
    qkv = torch.zeros(1, N, 3 * 2 * 16)
    rot = rot_tables(torch.from_numpy(table), N, 16, torch.float32)
    fa.fused_qkv_attention(qkv, 2, 16, rot=rot)
    table[:, 0] += 0.5
    with pytest.raises(ValueError, match="pair-constant"):
        rot_tables(torch.from_numpy(table), N, 16, torch.float32)


@pytest.mark.parametrize("n,h,d", [
    (1280, 16, 64), (1536, 16, 64), (1792, 16, 64), (2048, 16, 64),
    (2048, 8, 128), (1280 + 64, 16, 64), (256, 8, 64), (128, 2, 64),
    (128, 4, 32), (128, 2, 32), (64, 8, 64),
])
def test_dispatch_rule_is_jax(n, h, d):
    assert fa.fused_qkv_supported(n, h, d) == j_supported(n, h, d)


def test_cpu_tensor_counts_no_launch():
    before = fa.fused_qkv_attention.launches
    qkv, _, tkw = _case("key_mask", 2, 64)
    fa.fused_qkv_attention(torch.from_numpy(qkv), 2, 64, **tkw)
    assert fa.fused_qkv_attention.launches == before
