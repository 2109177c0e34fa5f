"""The port's ragged paged attention (dalle_pytorch_tpu_torch/ops/
ragged_attention.py) against the JAX package: the plain version vs the
Pallas kernel in interpret mode and vs the jnp reference, on valid query
columns, float32, atol/rtol 1e-5 (the online softmax reassociates the
sum). Cases: decode rows, a prefill chunk, page-boundary starts, an idle
row, a permuted global-id table. The CUDA kernel itself is held against
the plain version on the card by tests/test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops import paged_kv as jpaged
from dalle_pytorch_tpu.ops import ragged_attention as jra
from dalle_pytorch_tpu_torch.ops import paged_kv
from dalle_pytorch_tpu_torch.ops import ragged_attention as ra

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
B, N, H, D, PAGE, NP = 4, 4, 2, 8, 4, 5

# (label, start, length): rows at scattered positions, including starts on
# and just before page boundaries, a full-width chunk, a short chunk and
# an idle row
CASES = [
    ("decode", [7, 3, 12, 19], [1, 1, 1, 1]),
    ("prefill_chunk", [0, 4, 8, 2], [4, 4, 4, 4]),
    ("page_boundary", [3, 4, 7, 8], [2, 1, 4, 3]),
    ("mixed_idle", [9, 0, 5, 16], [1, 4, 0, 2]),
]


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, N, H, D).astype(np.float32) * 0.3
    k = rng.randn(B, NP, PAGE, H * D).astype(np.float32) * 0.3
    v = rng.randn(B, NP, PAGE, H * D).astype(np.float32) * 0.3
    return q, k, v


def _flat(pool: np.ndarray) -> torch.Tensor:
    """The port's flat pool (plus the sink page) holding ``pool``'s pages."""
    b, n_p, page, feat = pool.shape
    flat = paged_kv.alloc(b, n_p, page, feat, torch.float32, "cpu")
    paged_kv.pool_view(flat, b).copy_(torch.from_numpy(pool))
    return flat


def _valid(length):
    return (np.arange(N)[None] < np.asarray(length)[:, None])[..., None, None]


def _port(q, k, v, table, start, length):
    return ra.kernel_attend(
        torch.from_numpy(q), _flat(k), _flat(v),
        torch.as_tensor(np.array(table), dtype=torch.int32),
        torch.as_tensor(start, dtype=torch.int32),
        torch.as_tensor(length, dtype=torch.int32),
    ).numpy()


@pytest.mark.parametrize("label,start,length", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_jax_kernel_and_reference(label, start, length):
    q, k, v = _inputs()
    table = jpaged.identity_table(B, NP)
    s, ln = jnp.asarray(start, jnp.int32), jnp.asarray(length, jnp.int32)
    ker = np.asarray(jra.kernel_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), table, s, ln,
        interpret=True,
    ))
    pos = s[:, None] + jnp.arange(N)[None]
    allowed = (jnp.arange(NP * PAGE)[None, None] <= pos[..., None])[:, None]
    ref = np.asarray(jra.reference_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), table, allowed
    ))
    out = _port(q, k, v, table, start, length)
    assert np.isfinite(out).all(), label
    valid = _valid(length)
    np.testing.assert_allclose(np.where(valid, out, 0), np.where(valid, ker, 0),
                               err_msg=label, **TOL)
    np.testing.assert_allclose(np.where(valid, out, 0), np.where(valid, ref, 0),
                               err_msg=label, **TOL)


def test_permuted_global_table():
    """Tables hold GLOBAL ids: permuting each row's pages across rows'
    storage (and the table with them) leaves the output unchanged."""
    q, k, v = _inputs(seed=1)
    start, length = [5, 0, 13, 2], [1, 4, 3, 0]
    ident = np.asarray(jpaged.identity_table(B, NP))
    base = _port(q, k, v, ident, start, length)
    perm = np.random.RandomState(7).permutation(B * NP)  # new slot of each page
    k_perm = np.empty_like(k.reshape(B * NP, PAGE, -1))
    v_perm = np.empty_like(k_perm)
    k_perm[perm] = k.reshape(B * NP, PAGE, -1)
    v_perm[perm] = v.reshape(B * NP, PAGE, -1)
    table = perm[ident].astype(np.int32)
    out = _port(q, k_perm.reshape(k.shape), v_perm.reshape(v.shape), table,
                start, length)
    jax_out = np.asarray(jra.kernel_attend(
        jnp.asarray(q), jnp.asarray(k_perm.reshape(k.shape)),
        jnp.asarray(v_perm.reshape(v.shape)), jnp.asarray(table),
        jnp.asarray(start, jnp.int32), jnp.asarray(length, jnp.int32),
        interpret=True,
    ))
    valid = _valid(length)
    np.testing.assert_allclose(np.where(valid, out, 0), np.where(valid, base, 0), **TOL)
    np.testing.assert_allclose(np.where(valid, out, 0), np.where(valid, jax_out, 0), **TOL)


def test_cpu_tensors_never_launch_the_kernel():
    q, k, v = _inputs()
    before = ra.kernel_attend.launches
    _port(q, k, v, jpaged.identity_table(B, NP), *CASES[0][1:])
    assert ra.kernel_attend.launches == before


def test_scale_pools_are_refused():
    """Scale pools belong to int8 pools, both or neither: one scale pool
    alone, or scale pools beside pools of the compute dtype, is refused
    instead of ignored."""
    q, k, v = _inputs()
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32)  # noqa: E731
    scales = torch.ones(B * NP + 1, PAGE, H)
    args = (torch.from_numpy(q), _flat(k), _flat(v),
            i32(np.array(jpaged.identity_table(B, NP))), i32([0] * B), i32([1] * B))
    with pytest.raises(TypeError):
        ra.kernel_attend(*args, k_scales=scales, v_scales=scales)
    int8 = [a.to(torch.int8) for a in args[1:3]]
    with pytest.raises(ValueError):
        ra.kernel_attend(args[0], *int8, *args[3:], k_scales=scales)
