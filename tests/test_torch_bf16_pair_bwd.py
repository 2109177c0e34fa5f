"""The pair grid's bf16 dq and dk/dv on bf16 tensor-core tiles
(``bs_dq_tc_kernel``, ``bs_dkdv_tc_kernel`` in
``csrc/block_sparse_attention.cu``), on the CPU, where no kernel runs:
their walks and their arithmetic, heads of 64, inputs made with numpy
from a seed.

- The k-major per-half class map (``block_sparse_attention.half_columns``)
  equals a brute-force classification of every (32-row query half, 64-key
  tile) from ``layout.mask`` and the k-major pair table, at the flagship
  layouts (axial_row and conv_like, n 1,280), a ragged n 300 and a layout
  with synthetic pairs.
- The column walk (``testing.pair_column_halves``) visits every allowed
  (query, key) pair of a key tile once, in query order, no empty half,
  and the same halves as the float32 dk/dv's pair-run walk
  (``testing.pair_dkdv_halves``).
- The arithmetic (``testing.emulated_bf16_pair_dq``,
  ``emulated_bf16_pair_dkdv``: float32 sums of bf16 products per 32-row
  or 32-key half, p and ds rounded to bf16 where the sweeps pack them):
  against float64 at n 1,280 (one batch row, 2 heads), each of dq, dk, dv
  within ``BF16_GAP_FACTOR`` times the plain bf16 backward's own relative
  L2 gap to float64, the dq pass's delta bitwise ``emulated_row_delta``'s;
  against JAX ``block_sparse_attention``'s bf16 vjp in interpret mode at n
  640 and at a ragged n 600, with and without a key mask, the floored row
  metric within ``BWD_BF16_ROW_REL`` on JAX's own o and lse.

Rows with no allowed key, and keys no query attends, must be exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops import block_sparse_attention as jbs
from dalle_pytorch_tpu_torch.ops import block_sparse_attention as bs
from dalle_pytorch_tpu_torch.ops import masks
from dalle_pytorch_tpu_torch.testing import (
    BF16_GAP_FACTOR,
    BWD_BF16_ROW_REL,
    bs_bwd_errors,
    emulated_bf16_pair_dkdv,
    emulated_bf16_pair_dq,
    emulated_row_delta,
    pair_column_halves,
    pair_dkdv_halves,
    rel_l2,
)

torch.set_num_threads(2)

LAYOUTS = ["axial_row", "conv_like", "ragged", "synthetic"]


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


def _tensors(rng, b, h, n, count):
    """``count`` standard normal (b, h, n, 64) tensors, rounded to bf16."""
    return [torch.from_numpy(rng.randn(b, h, n, 64).astype(np.float32)).bfloat16()
            for _ in range(count)]


def _key_mask(rng, b, n):
    """testing's key mask: a fifth of the keys and key 0 of row 0 dropped,
    every key of row 1 (b 2)."""
    km = rng.rand(b, n) > 0.2
    km[0, 0] = False
    km[1:] = False
    return torch.from_numpy(km)


def _allowed(layout, n, key_mask, b):
    """(b, n, n) bool: the (query, key) pairs that may attend."""
    return bs.may_attend(layout, n, "cpu", key_mask)[:, 0].expand(b, n, n)


# ---------------------------------------------------------------- the walk


def _brute_columns(layout) -> np.ndarray:
    """Every (64-key tile, 32-row query half) classified on its own: its
    pair's class looked up in the k-major table (absent: 0), its tile of
    the mask tested element by element."""
    nt, nh = layout.n_pad // 64, layout.n_pad // 32
    pairs = {}
    for qb, kb, cls in zip(*layout.kv_table[:3]):
        pairs[int(qb), int(kb)] = int(cls)
    want = np.zeros((nt, nh), np.int8)
    for kt in range(nt):
        for h in range(nh):
            cls = pairs.get((h * 32 // 128, kt * 64 // 128), 0)
            tile = layout.mask[32 * h:32 * h + 32, 64 * kt:64 * kt + 64]
            if cls == 0 or 32 * h >= layout.n or not tile.any():
                want[kt, h] = 0
            elif cls == 2 or tile.all():
                want[kt, h] = 2
            else:
                want[kt, h] = 1
    return want


@pytest.mark.parametrize("case", LAYOUTS)
def test_column_map_matches_brute_force(case):
    """``half_columns`` is the brute-force map: 0 for class 0 or absent
    pairs, halves at or past n and empty tiles; 2 for class 2 pairs and
    full tiles; 1 otherwise. ``device_layout`` holds it as int8 of shape
    (n_pad / 64, n_pad / 32) beside the q-major map, and a layout of other
    blocks gets none."""
    layout = _layout(case)
    columns = bs.half_columns(layout)
    assert columns.dtype == np.int8 and columns.shape == (layout.n_pad // 64,
                                                          layout.n_pad // 32)
    assert np.array_equal(columns, _brute_columns(layout))
    assert (columns == 1).any() or case == "synthetic"
    assert (columns == 0).any()
    dl = bs.device_layout(layout, "cpu")
    assert torch.equal(dl.columns, torch.from_numpy(columns))
    other = bs.device_layout(bs.compile_block_layout(masks.causal_mask(64), 8, 8), "cpu")
    assert other.columns is None


@pytest.mark.parametrize("case", LAYOUTS)
def test_pair_column_walk_visits_every_allowed_pair_once(case):
    """For every 64-key tile below n: the halves ``HalfColumn`` issues lie
    below n, in strictly rising query order (each once); every query row
    with an allowed key in the tile lies in one; no issued half is empty
    (class 1: its mask tile has a set bit; class 2: every pair of the tile
    is allowed, rows and keys below n). The walk issues exactly the halves
    that the float32 dk/dv's pair run finds live, with the same class but
    where a class 1 half's tile is full (promoted to 2)."""
    layout = _layout(case)
    n, mask = layout.n, layout.mask
    issued = 0
    for k0 in range(0, n, 64):
        halves = pair_column_halves(layout, k0)
        starts = [q0 for q0, _ in halves]
        assert starts == sorted(set(starts)) and all(q0 < n for q0 in starts)
        covered = np.zeros(layout.n_pad, bool)
        for q0, cls in halves:
            tile = mask[q0:q0 + 32, k0:k0 + 64]
            assert tile.any() if cls == 1 else (cls == 2 and tile.all() and q0 + 32 <= n
                                                and k0 + 64 <= n)
            covered[q0:q0 + 32] = True
        assert not (mask[:, k0:k0 + 64].any(axis=1) & ~covered).any()
        run = pair_dkdv_halves(layout, k0)
        assert starts == [q0 for q0, _ in run]
        for (q0, cls), (_, run_cls) in zip(halves, run):
            assert cls == run_cls or (run_cls == 1 and cls == 2
                                      and mask[q0:q0 + 32, k0:k0 + 64].all())
        issued += len(halves)
    assert issued > 0


# ----------------------------------------------------------- the arithmetic


def _float64(q, k, v, do, allowed):
    """(o, lse, (dq, dk, dv)) in float64 where ``allowed`` (b or 1, 1, n,
    n) may attend: the plain forward, then the backward on delta =
    rowsum(do * o)."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    s = (q @ k.transpose(-1, -2) * scale).masked_fill(~allowed, bs.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > 0.5 * bs.NEG_INF, torch.exp(s - m), 0.0)
    l_safe = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l_safe == 0, 1.0, l_safe)
    p = p / l_safe
    o, lse = p @ v, (m + torch.log(l_safe))[..., 0]
    ds = p * (do @ v.transpose(-1, -2) - (do * o).sum(-1, keepdim=True)) * scale
    return o, lse, (ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do)


@pytest.fixture(scope="module", params=["axial_row", "conv_like"])
def pair_1280(request):
    """(emulated (dq, dk, dv), emulated delta, plain bf16 (dq, dk, dv),
    plain delta, float64 grads, o and do as the emulations took them,
    layout) at the flagship geometry, one batch row, 2 heads of 64, no key
    mask; o rounded to bf16 and lse to float32 from the float64
    forward."""
    layout = _layout(request.param)
    q, k, v, do = _tensors(np.random.RandomState(13), 1, 2, 1280, 4)
    o, lse, exact = _float64(q, k, v, do, bs.may_attend(layout, 1280, "cpu"))
    o, lse = o.bfloat16(), lse.float()
    dq, delta = emulated_bf16_pair_dq(q, k, v, o, lse, do, layout)
    dk, dv = emulated_bf16_pair_dkdv(q, k, v, do, lse, delta, layout)
    pdq, pdelta = bs.reference_block_sparse_dq(q, k, v, o, lse, do, layout)
    pdk, pdv = bs.reference_block_sparse_dkdv(q, k, v, do, lse, pdelta, layout)
    return (dq, dk, dv), delta, (pdq, pdk, pdv), pdelta, exact, (o, do), layout


def test_bf16_pair_backward_within_the_plain_gap_at_1280(pair_1280):
    """Each of dq, dk, dv of the emulated kernels within
    ``BF16_GAP_FACTOR`` times the plain bf16 backward's relative L2 gap to
    float64; delta within 1e-4 of the plain delta's largest entry; rows
    and keys with no allowed pair exactly 0."""
    got, delta, plain, pdelta, exact, _, layout = pair_1280
    assert (delta - pdelta).abs().max().item() <= 1e-4 * pdelta.abs().max().item()
    for name, g, ref, want in zip(("dq", "dk", "dv"), got, plain, exact):
        assert g.dtype == torch.bfloat16
        ratio = rel_l2(g, want) / rel_l2(ref, want)
        assert ratio <= BF16_GAP_FACTOR, (name, ratio)
    _, row_rel, zeros_exact = bs_bwd_errors(got, plain, layout)
    assert zeros_exact and row_rel <= BWD_BF16_ROW_REL, row_rel


def test_bf16_pair_dq_delta_is_row_delta_bitwise(pair_1280):
    """The dq pass's delta, summed per 64-row tile from the bf16 o and do,
    is ``emulated_row_delta`` over whole rows bit for bit: each row's sum
    depends on that row alone, so the dk/dv pass reads the dq pass's
    delta."""
    _, delta, _, _, _, (o, do), _ = pair_1280
    assert torch.equal(delta, emulated_row_delta(o, do))


def _jax_case(n, pattern, key_mask):
    """b 2 x 1 head of 64 in bf16, the pattern of 65 + 24 x 24 cut to n
    (n 600: a ragged last block, n_pad 640), with or without the key mask
    (row 1 wholly dead): (q, k, v, do, key mask, layout, JAX's o and lse
    of its forward kernel, JAX's vjp dq, dk, dv), all as torch tensors."""
    mask = masks.pattern_mask(pattern, 65, 24)[:n, :n]
    layout = bs.compile_block_layout(mask)
    rng = np.random.RandomState(14)
    q, k, v, do = _tensors(rng, 2, 1, n, 4)
    km = _key_mask(rng, 2, n) if key_mask else None
    jkm = None if km is None else jnp.asarray(km.numpy())
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in (q, k, v, do))
    jlayout = jbs.compile_block_layout(mask, 128, 128)
    _, vjp = jax.vjp(lambda a, b, c: jbs.block_sparse_attention(
        a, b, c, jlayout, key_mask=jkm, interpret=True), jq, jk, jv)
    # the forward kernel's o and lse, on block_sparse_attention's operands
    bh = 2
    flat = [jbs._pad_rows(t.reshape(bh, n, 64), jlayout.n_pad, 1) for t in (jq, jk, jv)]
    kmf = None if jkm is None else jbs._pad_rows(jbs._bcast_key_mask(jkm, bh, 1, n),
                                                 jlayout.n_pad, 2)
    jo, jlse = jbs._bs_fwd(*flat, kmf, jnp.asarray(jlayout.mask, jnp.int8),
                           jnp.asarray(jlayout.fwd_table), jnp.asarray(jlayout.kv_table),
                           64**-0.5, 128, 128, True)
    to_torch = lambda t: torch.from_numpy(np.array(t.astype(jnp.float32)))  # noqa: E731
    o = to_torch(jo[:, :n]).reshape(2, 1, n, 64).bfloat16()
    lse = to_torch(jlse[:, 0, :n]).reshape(2, 1, n)
    grads = tuple(to_torch(g).bfloat16() for g in vjp(jdo))
    return q, k, v, do, km, layout, o, lse, grads


@pytest.fixture(scope="module", params=[(640, "axial_row"), (600, "conv_like")],
                ids=["n640_axial_row", "ragged_n600_conv_like"])
def jax_cases(request):
    """{key mask: ``_jax_case``} without and with the key mask."""
    n, pattern = request.param
    return {key_mask: _jax_case(n, pattern, key_mask) for key_mask in (False, True)}


@pytest.mark.parametrize("key_mask", [False, True], ids=["no_key_mask", "key_mask"])
def test_bf16_pair_backward_matches_jax_vjp(jax_cases, key_mask):
    """``tests/test_torch_block_sparse.py``'s oracle: JAX
    ``block_sparse_attention``'s bf16 vjp (``_bwd_dq_kernel``,
    ``_bwd_dkv_kernel`` in interpret mode). The emulated dq on JAX's o and
    lse and the emulated dk/dv on JAX's lse and the emulated delta: the
    floored row metric within ``BWD_BF16_ROW_REL``; rows and keys with no
    allowed pair exactly 0 in both."""
    q, k, v, do, km, layout, o, lse, jax_grads = jax_cases[key_mask]
    dq, delta = emulated_bf16_pair_dq(q, k, v, o, lse, do, layout, km)
    got = (dq, *emulated_bf16_pair_dkdv(q, k, v, do, lse, delta, layout, km))
    rel, row_rel, zeros_exact = bs_bwd_errors(got, jax_grads, layout, km)
    assert row_rel <= BWD_BF16_ROW_REL, (rel, row_rel)
    assert zeros_exact
    assert bs_bwd_errors(jax_grads, got, layout, km)[2]


def test_bf16_pair_dead_rows_and_keys_are_exactly_zero(jax_cases):
    """With the key mask batch row 1 is wholly dead and so is query 0 of
    row 0 (its only key dropped): their dq rows, and the dk, dv rows of
    every key no query may attend, are exactly 0 in the emulation, and
    every live key's dk row is not."""
    q, k, v, do, km, layout, o, lse, _ = jax_cases[True]
    n = q.shape[2]
    dq, delta = emulated_bf16_pair_dq(q, k, v, o, lse, do, layout, km)
    dk, dv = emulated_bf16_pair_dkdv(q, k, v, do, lse, delta, layout, km)
    allowed = _allowed(layout, n, km, 2)
    dead_rows, dead_keys = ~allowed.any(dim=2), ~allowed.any(dim=1)  # (b, n)
    assert dead_rows[1].all() and dead_rows[0, 0]
    assert (dq[:, 0][dead_rows] == 0).all()
    assert (dk[:, 0][dead_keys] == 0).all() and (dv[:, 0][dead_keys] == 0).all()
    assert (dk[:, 0].float().norm(dim=-1)[~dead_keys] > 0).all()
