"""The port's fused decode attention against the JAX package on the CPU:
``reference_fused_decode`` (the plain version the wrapper runs on CPU
tensors) against JAX's ``fused_decode_attention`` in interpret mode on the
same numpy-seeded inputs (``testing.decode_inputs``): rotary x key mask,
the masked own key with an extreme score, idx 0, and bfloat16 caches. out
within abs 1e-5 in float32 (both sum in float32, in another order) and
within ``testing.DECODE_BF16_ROW_REL`` of each row in bfloat16; the k/v
rows bitwise in both. ``fused_decode_supported`` equals JAX's predicate
on a grid of (heads, dim_head)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops import decode_attention as jdk
from dalle_pytorch_tpu.ops.rotary import _rotate_half_matrix
from dalle_pytorch_tpu_torch.ops import decode_attention as da
from dalle_pytorch_tpu_torch.testing import DECODE_BF16_ROW_REL, decode_errors, decode_inputs

torch.set_num_threads(1)

B, L, H = 2, 40, 4


def _jnp(t, dtype):
    return None if t is None else jnp.asarray(t.float().numpy()).astype(dtype)


def jax_fused(x, idx, dtype, rotary):
    """JAX's kernel (interpret mode) on the port's inputs ``x``."""
    qkv, kc, vc, cos, sin, km = x
    d = qkv.shape[-1] // (3 * H)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    if cos is None:
        cos = sin = torch.zeros(L - 1, d)
    out = jdk.fused_decode_attention(
        _jnp(qkv, jdt), _jnp(kc, jdt), _jnp(vc, jdt), idx, _jnp(cos, jdt), _jnp(sin, jdt),
        jnp.asarray(_rotate_half_matrix(d), jdt),
        None if km is None else jnp.asarray(km.numpy()[..., None]),
        heads=H, dim_head=d, use_rotary=rotary, interpret=True)
    return tuple(torch.from_numpy(np.array(t.astype(jnp.float32))) for t in out)


def plain(x, idx):
    qkv, kc, vc, cos, sin, km = x
    return da.reference_fused_decode(qkv, kc, vc, idx, cos, sin, km, H)


@pytest.mark.parametrize("rotary", [True, False], ids=["rotary", "no_rotary"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("idx", [0, 23])
def test_plain_matches_jax_kernel(rotary, masked, idx):
    x = decode_inputs(B, L, H, 64, idx, torch.float32, "cpu", rotary=rotary, masked=masked)
    err, rel, rows_equal, dead_zero = decode_errors(plain(x, idx), jax_fused(x, idx,
                                                                            torch.float32,
                                                                            rotary),
                                                    x[5], idx)
    assert err <= 1e-5 and rows_equal and dead_zero, (err, rel)


def test_masked_own_key_with_extreme_score():
    """q and the fresh k aligned and large, the fresh key masked: its score
    must not enter the max (which would underflow every live key's weight
    and zero the output)."""
    x = decode_inputs(B, L, H, 64, 17, torch.float32, "cpu", rotary=False, own_masked=True)
    got = plain(x, 17)
    assert got[0].abs().amax(dim=-1).min() > 0, "output spuriously zeroed"
    err, _, rows_equal, _ = decode_errors(got, jax_fused(x, 17, torch.float32, False), x[5], 17)
    assert err <= 1e-5 and rows_equal, err


def test_no_live_key_gives_zero():
    """At idx 0 with the fresh key masked no key is live: the output is 0
    (the denominator 0 taken as 1), as JAX's kernel gives."""
    x = decode_inputs(B, L, H, 64, 0, torch.float32, "cpu", own_masked=True)
    got = plain(x, 0)
    assert (got[0] == 0).all()
    err, _, rows_equal, dead_zero = decode_errors(got, jax_fused(x, 0, torch.float32, True),
                                                  x[5], 0)
    assert err == 0 and rows_equal and dead_zero


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_bf16_caches_rows_bitwise(masked):
    x = decode_inputs(B, L, H, 32, 31, torch.bfloat16, "cpu", masked=masked)
    got = plain(x, 31)
    assert all(t.dtype == torch.bfloat16 for t in got)
    err, rel, rows_equal, dead_zero = decode_errors(got, jax_fused(x, 31, torch.bfloat16, True),
                                                    x[5], 31)
    assert rows_equal and dead_zero and rel <= DECODE_BF16_ROW_REL, (err, rel)


def test_supported_matches_jax():
    grid = [(h, d) for h in range(1, 17) for d in (8, 16, 32, 48, 64, 96, 128)]
    assert [da.fused_decode_supported(h, d) for h, d in grid] == [
        jdk.fused_decode_supported(h, d) for h, d in grid]


def test_wrapper_runs_the_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version and counts no
    launch."""
    x = decode_inputs(B, L, H, 64, 9, torch.float32, "cpu", masked=True)
    before = da.fused_decode_attention.launches
    got = da.fused_decode_attention(x[0], x[1], x[2], 9, *x[3:], heads=H)
    assert da.fused_decode_attention.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, plain(x, 9)))
