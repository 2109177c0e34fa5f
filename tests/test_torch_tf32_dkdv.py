"""The numerics and the walk of the float32 kernels that share the
key-major split-3xTF32 dk/dv sweep (``csrc/tf32_sweeps.cuh``), on the
CPU, where no kernel runs: their arithmetic emulated on the card's
truncating accumulation (``testing.matmul_3xtf32_card``), one head of 64,
inputs made with numpy from a seed.

- The single-block backward (``flash_bwd_fused_tf32_kernel``): query
  blocks compute dq, key blocks dk and dv, each deriving delta from O and
  dO, the key blocks per streamed 32-row half
  (``testing.emulated_single_block_bwd``). Against float64 at the
  flagship's length (n 1,280), causal and with a key mask, within
  ``BWD_F32_REL``; against JAX ``flash_attention``'s vjp at a one-block n
  (384), where JAX runs ``_bwd_fused_kernel`` in interpret mode, within
  ``BWD_F32_REL``; the key blocks' delta equal to the query blocks' and to
  the dq pass's bit for bit, which is what makes the kernel's gradients
  the two-launch chain's.
- The pair grid's dk/dv (``bs_dkdv_tf32_kernel``): its k-major walk
  (``testing.pair_dkdv_halves``) visits every allowed pair of a key tile
  once, in query order, and no half it could pass over; its arithmetic
  (``testing.emulated_pair_dkdv``) against float64 at the flagship
  geometry (n 1,280, the axial_row and conv_like layouts) within
  ``BWD_F32_REL``, and against JAX ``block_sparse_attention``'s vjp in
  interpret mode at n 640 and at a ragged n 600, within ``BWD_F32_REL``.
- Which real shapes take the single-block kernel: the flagship's n 1,280
  with 16 heads of 32 (the packed kernel refuses them), not of 64.

Dead rows (queries with no allowed key, keys no query attends) must be
exactly 0 wherever a result is compared.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops import block_sparse_attention as jbs
from dalle_pytorch_tpu_torch.ops import block_sparse_attention as bs
from dalle_pytorch_tpu_torch.ops import flash_attention as fa
from dalle_pytorch_tpu_torch.ops import masks
from dalle_pytorch_tpu_torch.ops.attention import full_route
from dalle_pytorch_tpu_torch.testing import (
    BWD_F32_REL,
    emulated_pair_dkdv,
    emulated_row_delta,
    emulated_single_block_bwd,
    pair_dkdv_halves,
)

# the module, not the function that dalle_pytorch_tpu.ops exports under its name
jfa = importlib.import_module("dalle_pytorch_tpu.ops.flash_attention")

torch.set_num_threads(2)


def _tensors(rng, b, n, count=4):
    """``count`` standard normal float32 (b, 1, n, 64) tensors."""
    return [torch.from_numpy(rng.randn(b, 1, n, 64).astype(np.float32)) for _ in range(count)]


def _key_mask(rng, b, n):
    """testing's key mask: a fifth of the keys and key 0 of row 0 dropped
    (causal query 0 then attends nothing), every key of row 1 (b 2)."""
    km = rng.rand(b, n) > 0.2
    km[0, 0] = False
    km[1:] = False
    return torch.from_numpy(km)


def _float64(q, k, v, do, allowed):
    """(o, lse, (dq, dk, dv)) in float64 where ``allowed`` (b or 1, 1, n, n)
    may attend: the plain forward, then delta = rowsum(do * o)."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    s = (q @ k.transpose(-1, -2) * scale).masked_fill(~allowed, fa.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > 0.5 * fa.NEG_INF, torch.exp(s - m), 0.0)
    l_safe = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l_safe == 0, 1.0, l_safe)
    o, lse = (p @ v) / l_safe, (m + torch.log(l_safe))[..., 0]
    p = torch.where(s > 0.5 * fa.NEG_INF, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (do @ v.transpose(-1, -2) - (do * o).sum(-1, keepdim=True)) * scale
    return o, lse, (ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do)


def _rel(got, want) -> float:
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


def _dead_exact(grads, allowed) -> bool:
    """dq at query rows with no allowed key, dk and dv at keys no query
    attends: exactly 0 (grads (b, 1, n, d) each)."""
    b, n = grads[0].shape[0], grads[0].shape[2]
    allowed = allowed[:, 0].expand(b, n, n)
    dead = (~allowed.any(dim=2), ~allowed.any(dim=1), ~allowed.any(dim=1))
    return all(bool((g[:, 0][z] == 0).all()) for g, z in zip(grads, dead))


# ------------------------------------------------ the single-block backward


@pytest.fixture(scope="module", params=["causal", "key_mask"])
def single_block_1280(request):
    """(emulated (dq, dk, dv, delta_q, delta_k), the float64 gradients,
    o, do, allowed) at n 1,280, one head of 64, causal, with or without
    the key mask."""
    rng = np.random.RandomState(5)
    q, k, v, do = _tensors(rng, 1, 1280)
    km = _key_mask(rng, 1, 1280) if request.param == "key_mask" else None
    allowed = fa.may_attend(1280, "cpu", km)
    o, lse, exact = _float64(q, k, v, do, allowed)
    o = o.float()
    got = emulated_single_block_bwd(q, k, v, o, lse.float(), do, key_mask=km)
    return got, exact, o, do, allowed


def test_single_block_emulation_holds_float32_tolerance_at_1280(single_block_1280):
    """Each of dq, dk, dv within ``BWD_F32_REL`` (relative L2) of float64
    at the flagship's length, dead rows exactly 0."""
    got, exact, _, _, allowed = single_block_1280
    rel = [_rel(g, e) for g, e in zip(got[:3], exact)]
    assert max(rel) <= BWD_F32_REL, rel
    assert _dead_exact(got[:3], allowed)


def test_single_block_delta_is_the_split_chains_bitwise(single_block_1280):
    """The key blocks' delta, summed per streamed 32-row half, equals the
    query blocks' (per 64-row tile) and the dq pass's over whole rows bit
    for bit: each row's sum depends on that row alone, in the warp's
    order (lane partials, then the butterfly), so the single launch's
    dk and dv are the chain's."""
    (_, _, _, delta_q, delta_k), _, o, do, _ = single_block_1280
    assert torch.equal(delta_k, delta_q)
    assert torch.equal(delta_q, emulated_row_delta(o, do))


def test_single_block_emulation_matches_jax_vjp_at_one_block():
    """n 384, one flash block (JAX runs ``_bwd_fused_kernel`` in
    interpret mode), b 2 x 1 head of 64, causal, the key mask (row 1
    wholly dead): each of dq, dk, dv within ``BWD_F32_REL`` (relative L2)
    of JAX's, dead rows exactly 0 in both."""
    rng = np.random.RandomState(6)
    b, n = 2, 384
    q, k, v, do = _tensors(rng, b, n)
    km = _key_mask(rng, b, n)
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
        q, k, v, key_mask=jnp.asarray(km.numpy()), causal=True, sm_scale=64**-0.5,
        block_q=n, block_k=n, interpret=True), *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    ref = [torch.from_numpy(np.array(g)) for g in vjp(jnp.asarray(do.numpy()))]
    o, lse = fa.reference_flash_attention(q, k, v, key_mask=km)
    got = emulated_single_block_bwd(q, k, v, o, lse, do, key_mask=km)[:3]
    rel = [_rel(g, r) for g, r in zip(got, ref)]
    assert max(rel) <= BWD_F32_REL, rel
    allowed = fa.may_attend(n, "cpu", km)
    assert _dead_exact(got, allowed) and _dead_exact(ref, allowed)


# --------------------------------------------------- the pair grid's dk/dv


def _layout(case: str):
    """The 128-block layout of ``testing.bs_inputs``' case: "axial_row" /
    "conv_like" at the flagship geometry (257 + 32 x 32, n 1280),
    "ragged" (conv_like of 13 + 17 x 17 at n 300, n_pad 384) and
    "synthetic" (n 300, causal, query block 1 and keys 256-299 dead)."""
    if case in ("axial_row", "conv_like"):
        return bs.compile_block_layout(masks.pattern_mask(case, 257, 32)[:1280, :1280])
    if case == "ragged":
        return bs.compile_block_layout(masks.pattern_mask("conv_like", 13, 17)[:300, :300])
    mask = masks.causal_mask(300)
    mask[128:256] = False
    mask[:, 256:] = False
    return bs.compile_block_layout(mask)


@pytest.mark.parametrize("case", ["axial_row", "conv_like", "ragged", "synthetic"])
def test_pair_walk_visits_every_allowed_pair_once(case):
    """For every 64-key tile below n: the halves ``PairRun`` issues lie
    below n, in strictly rising query order (each once, as the k-major
    table orders its q blocks); every query row with an allowed key in
    the tile lies in one; no issued half is empty (class 1: its mask
    tile has a set bit; class 2: every pair of the tile is allowed, rows
    and keys below n)."""
    layout = _layout(case)
    n, mask = layout.n, layout.mask
    issued = 0
    for k0 in range(0, n, 64):
        halves = pair_dkdv_halves(layout, k0)
        starts = [q0 for q0, _ in halves]
        assert starts == sorted(set(starts)) and all(q0 < n for q0 in starts)
        covered = np.zeros(layout.n_pad, bool)
        for q0, cls in halves:
            tile = mask[q0:q0 + 32, k0:k0 + 64]
            assert tile.any() if cls == 1 else (cls == 2 and tile.all() and q0 + 32 <= n
                                                and k0 + 64 <= n)
            covered[q0:q0 + 32] = True
        assert not (mask[:, k0:k0 + 64].any(axis=1) & ~covered).any()
        issued += len(halves)
    assert issued > 0


@pytest.fixture(scope="module", params=["axial_row", "conv_like"])
def pair_1280(request):
    """(emulated (dk, dv), float64 (dk, dv), allowed) at the flagship
    geometry, one head of 64, no key mask."""
    layout = _layout(request.param)
    q, k, v, do = _tensors(np.random.RandomState(7), 1, 1280)
    allowed = bs.may_attend(layout, 1280, "cpu")
    o, lse, (_, dk, dv) = _float64(q, k, v, do, allowed)
    delta = (do.double() * o).sum(-1)
    got = emulated_pair_dkdv(q, k, v, do, lse.float(), delta.float(), layout)
    return got, (dk, dv), allowed


def test_pair_dkdv_emulation_holds_float32_tolerance_at_1280(pair_1280):
    """dk and dv within ``BWD_F32_REL`` (relative L2) of float64, keys no
    query attends exactly 0."""
    got, exact, allowed = pair_1280
    rel = [_rel(g, e) for g, e in zip(got, exact)]
    assert max(rel) <= BWD_F32_REL, rel
    dead = ~allowed[0, 0].any(dim=0)
    assert all(bool((g[0, 0][dead] == 0).all()) for g in got)


@pytest.mark.parametrize("n,pattern", [(640, "axial_row"), (600, "conv_like")],
                         ids=["n640_axial_row", "ragged_n600_conv_like"])
def test_pair_dkdv_emulation_matches_jax_vjp(n, pattern):
    """``tests/test_torch_block_sparse.py``'s oracle: JAX
    ``block_sparse_attention``'s vjp in interpret mode, b 2 x 1 head of
    64, the pattern of 65 + 24 x 24 cut to n (n 600: a ragged last block,
    n_pad 640) and the key mask (row 1 wholly dead). The emulation on the
    plain forward's lse and the plain dq pass's delta: dk and dv within
    ``BWD_F32_REL`` (relative L2) of JAX's, dead keys exactly 0 in both."""
    mask = masks.pattern_mask(pattern, 65, 24)[:n, :n]
    layout = bs.compile_block_layout(mask)
    rng = np.random.RandomState(8)
    q, k, v, do = _tensors(rng, 2, n)
    km = _key_mask(rng, 2, n)
    _, vjp = jax.vjp(lambda q, k, v: jbs.block_sparse_attention(
        q, k, v, jbs.compile_block_layout(mask, 128, 128), key_mask=jnp.asarray(km.numpy()),
        interpret=True), *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    ref = [torch.from_numpy(np.array(g)) for g in vjp(jnp.asarray(do.numpy()))[1:]]
    o, lse = bs.reference_block_sparse(q, k, v, layout, km)
    _, delta = bs.reference_block_sparse_dq(q, k, v, o, lse, do, layout, km)
    got = emulated_pair_dkdv(q, k, v, do, lse, delta, layout, km)
    rel = [_rel(g, r) for g, r in zip(got, ref)]
    assert max(rel) <= BWD_F32_REL, rel
    dead = ~bs.may_attend(layout, n, "cpu", km)[:, 0].any(dim=1)  # (b, key)
    assert all(bool((g[:, 0][dead] == 0).all()) for g in (*got, *ref))


# ------------------------------------------------------------------ routing


@pytest.mark.parametrize("dim_head,route", [(32, "tiled_one_block"), (64, "packed")])
def test_flagship_length_route(dim_head, route):
    """The flagship's 256 + 1024 positions (n 1280, one flash block) with
    16 heads: at dim_head 32 the packed kernel refuses (its VMEM rule) and
    training takes the single-block backward; at 64 the packed kernel."""
    assert full_route(1280, 16, dim_head) == route
