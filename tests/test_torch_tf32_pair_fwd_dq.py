"""The pair grid's float32 forward and dq on split-3xTF32 tiles
(``bs_fwd_tf32_kernel``, ``bs_dq_tf32_kernel`` in
``csrc/block_sparse_attention.cu``), on the CPU, where no kernel runs:
their walk and their arithmetic, one head of 64, inputs made with numpy
from a seed.

- The per-half class map (``block_sparse_attention.half_classes``) equals
  a brute-force classification of every (64-row query tile, 32-key half)
  from ``layout.mask`` and the q-major pair table, at the flagship
  layouts (axial_row and conv_like, n 1,280), a ragged n 300 and a layout
  with synthetic pairs; the tile order starts with the longest rows.
- The row walk (``testing.pair_row_halves``) visits every allowed (query,
  key) pair of a query tile once, in key order, and no half it could pass
  over.
- The arithmetic, emulated on the card's truncating accumulation
  (``testing.emulated_pair_fwd``, ``emulated_pair_dq``): against float64
  at n 1,280 within ``BS_F32_ATOL`` (o, lse) and ``BWD_F32_REL`` (dq);
  against JAX ``block_sparse_attention``'s forward in interpret mode and
  the dq of its vjp at n 640 and at a ragged n 600, with and without a
  key mask; the dq emulation's delta equal to ``emulated_row_delta``'s bit
  for bit.

Dead rows (queries with no allowed key) must be exactly 0 wherever a
result is compared, with lse -1e30.
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
    BS_F32_ATOL,
    BWD_F32_REL,
    emulated_pair_dq,
    emulated_pair_fwd,
    emulated_row_delta,
    pair_row_halves,
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


def _tensors(rng, b, n, count):
    """``count`` standard normal float32 (b, 1, n, 64) tensors."""
    return [torch.from_numpy(rng.randn(b, 1, n, 64).astype(np.float32)) for _ in range(count)]


def _key_mask(rng, b, n):
    """testing's key mask: a fifth of the keys and key 0 of row 0 dropped,
    every key of row 1 (b 2)."""
    km = rng.rand(b, n) > 0.2
    km[0, 0] = False
    km[1:] = False
    return torch.from_numpy(km)


def _rel(got, want) -> float:
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


def _dead_rows(layout, n, key_mask, b):
    """(b, n) bool: query rows with no allowed key."""
    return ~bs.may_attend(layout, n, "cpu", key_mask)[:, 0].expand(b, n, n).any(dim=2)


# ---------------------------------------------------------------- the walk


def _brute_classes(layout) -> np.ndarray:
    """Every (64-row tile, 32-key half) classified on its own: its pair's
    class looked up in the q-major table (absent: 0), its tile of the
    mask tested element by element."""
    nt, nh = layout.n_pad // 64, layout.n_pad // 32
    pairs = {}
    for qb, kb, cls in zip(*layout.fwd_table[:3]):
        pairs[int(qb), int(kb)] = int(cls)
    want = np.zeros((nt, nh), np.int8)
    for qt in range(nt):
        for h in range(nh):
            cls = pairs.get((qt * 64 // 128, h * 32 // 128), 0)
            tile = layout.mask[64 * qt:64 * qt + 64, 32 * h:32 * h + 32]
            if cls == 0 or 32 * h >= layout.n or not tile.any():
                want[qt, h] = 0
            elif cls == 2 or tile.all():
                want[qt, h] = 2
            else:
                want[qt, h] = 1
    return want


@pytest.mark.parametrize("case", LAYOUTS)
def test_class_map_matches_brute_force(case):
    """``half_classes`` is the brute-force map: 0 for class 0 or absent
    pairs, halves at or past n and empty tiles; 2 for class 2 pairs and
    full tiles; 1 otherwise. ``device_layout`` holds it as int8 of shape
    (n_pad / 64, n_pad / 32), and the tile order as a permutation whose
    live-half counts never rise."""
    layout = _layout(case)
    classes = bs.half_classes(layout)
    assert classes.dtype == np.int8
    assert np.array_equal(classes, _brute_classes(layout))
    assert (classes == 1).any() or case == "synthetic"
    dl = bs.device_layout(layout, "cpu")
    assert torch.equal(dl.halves, torch.from_numpy(classes))
    order = dl.order.numpy()
    assert dl.order.dtype == torch.int32 and sorted(order) == list(range(layout.n_pad // 64))
    counts = (classes != 0).sum(axis=1)[order]
    assert (np.diff(counts) <= 0).all()


def test_class_map_only_for_128_blocks():
    """A layout of other blocks (which no kernel takes) gets no class map
    or order on a device."""
    dl = bs.device_layout(bs.compile_block_layout(masks.causal_mask(64), 8, 8), "cpu")
    assert dl.halves is None and dl.order is None


@pytest.mark.parametrize("case", LAYOUTS)
def test_pair_row_walk_visits_every_allowed_pair_once(case):
    """For every 64-row query tile below n: the halves ``HalfRow`` issues
    lie below n, in strictly rising key order (each once); every key with
    an allowed query in the tile lies in one; no issued half is empty
    (class 1: its mask tile has a set bit; class 2: every pair of the tile
    is allowed, rows and keys below n)."""
    layout = _layout(case)
    n, mask = layout.n, layout.mask
    issued = 0
    for q0 in range(0, n, 64):
        halves = pair_row_halves(layout, q0)
        starts = [k0 for k0, _ in halves]
        assert starts == sorted(set(starts)) and all(k0 < n for k0 in starts)
        covered = np.zeros(layout.n_pad, bool)
        for k0, cls in halves:
            tile = mask[q0:q0 + 64, k0:k0 + 32]
            assert tile.any() if cls == 1 else (cls == 2 and tile.all() and q0 + 64 <= n
                                                and k0 + 32 <= n)
            covered[k0:k0 + 32] = True
        assert not (mask[q0:q0 + 64].any(axis=0) & ~covered).any()
        issued += len(halves)
    assert issued > 0


# ----------------------------------------------------------- the arithmetic


def _float64(q, k, v, do, allowed):
    """(o, lse, dq) in float64 where ``allowed`` (b or 1, 1, n, n) may
    attend: the plain forward, then dq on delta = rowsum(do * o)."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    s = (q @ k.transpose(-1, -2) * scale).masked_fill(~allowed, bs.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > 0.5 * bs.NEG_INF, torch.exp(s - m), 0.0)
    l_safe = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l_safe == 0, 1.0, l_safe)
    o, lse = (p @ v) / l_safe, (m + torch.log(l_safe))[..., 0]
    p = torch.where(s > 0.5 * bs.NEG_INF, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (do @ v.transpose(-1, -2) - (do * o).sum(-1, keepdim=True)) * scale
    return o, lse, ds @ k


@pytest.fixture(scope="module", params=["axial_row", "conv_like"])
def pair_1280(request):
    """(emulated (o, lse), emulated (dq, delta), float64 (o, lse, dq), o
    and do as the emulated dq took them, layout) at the flagship
    geometry, one head of 64, no key mask."""
    layout = _layout(request.param)
    q, k, v, do = _tensors(np.random.RandomState(11), 1, 1280, 4)
    exact = _float64(q, k, v, do, bs.may_attend(layout, 1280, "cpu"))
    o = exact[0].float()
    fwd = emulated_pair_fwd(q, k, v, layout)
    bwd = emulated_pair_dq(q, k, v, o, exact[1].float(), do, layout)
    return fwd, bwd, exact, (o, do), layout


def test_pair_fwd_emulation_holds_float32_tolerance_at_1280(pair_1280):
    """o and lse within ``BS_F32_ATOL`` (max abs) of float64 on live rows;
    rows with no allowed key exactly 0 with lse -1e30."""
    (o, lse), _, (eo, e_lse, _), _, layout = pair_1280
    dead = _dead_rows(layout, 1280, None, 1)[0]
    err = max((o - eo).abs()[0, 0][~dead].max().item(),
              (lse - e_lse).abs()[0, 0][~dead].max().item())
    assert err <= BS_F32_ATOL, err
    assert bool((o[0, 0][dead] == 0).all()) and bool((lse[0, 0][dead] == bs.NEG_INF).all())


def test_pair_dq_emulation_holds_float32_tolerance_at_1280(pair_1280):
    """dq within ``BWD_F32_REL`` (relative L2) of float64, dead rows
    exactly 0."""
    _, (dq, _), (_, _, edq), _, layout = pair_1280
    rel = _rel(dq, edq)
    assert rel <= BWD_F32_REL, rel
    dead = _dead_rows(layout, 1280, None, 1)[0]
    assert bool((dq[0, 0][dead] == 0).all())


def test_pair_dq_delta_is_row_delta_bitwise(pair_1280):
    """The dq pass's delta, summed per 64-row tile, is
    ``emulated_row_delta`` over whole rows bit for bit: each row's sum
    depends on that row alone, so the dk/dv pass (and the single-block
    kernel) read the same delta."""
    _, (_, delta), _, (o, do), _ = pair_1280
    assert torch.equal(delta, emulated_row_delta(o, do))


@pytest.mark.parametrize("key_mask", [False, True], ids=["no_key_mask", "key_mask"])
@pytest.mark.parametrize("n,pattern", [(640, "axial_row"), (600, "conv_like")],
                         ids=["n640_axial_row", "ragged_n600_conv_like"])
def test_pair_fwd_dq_emulation_matches_jax(n, pattern, key_mask):
    """``tests/test_torch_block_sparse.py``'s oracle: JAX
    ``block_sparse_attention`` in interpret mode, b 2 x 1 head of 64, the
    pattern of 65 + 24 x 24 cut to n (n 600: a ragged last block, n_pad
    640), with or without the key mask (row 1 wholly dead). The forward
    emulation's o within ``BS_F32_ATOL`` (max abs) of JAX's forward on live
    rows, its lse within it of the plain forward's; the dq emulation on the
    plain o and lse within ``BWD_F32_REL`` (relative L2) of the dq of JAX's
    vjp; dead rows exactly 0 in both, lse -1e30 there."""
    mask = masks.pattern_mask(pattern, 65, 24)[:n, :n]
    layout = bs.compile_block_layout(mask)
    rng = np.random.RandomState(12)
    q, k, v, do = _tensors(rng, 2, n, 4)
    km = _key_mask(rng, 2, n) if key_mask else None
    jkm = None if km is None else jnp.asarray(km.numpy())
    jo, vjp = jax.vjp(lambda q, k, v: jbs.block_sparse_attention(
        q, k, v, jbs.compile_block_layout(mask, 128, 128), key_mask=jkm, interpret=True),
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    jo = torch.from_numpy(np.array(jo))
    jdq = torch.from_numpy(np.array(vjp(jnp.asarray(do.numpy()))[0]))
    po, plse = bs.reference_block_sparse(q, k, v, layout, km)
    o, lse = emulated_pair_fwd(q, k, v, layout, km)
    dq, _ = emulated_pair_dq(q, k, v, po, plse, do, layout, km)
    dead = _dead_rows(layout, n, km, 2)  # (b, n)
    live = ~dead
    err = max((o - jo).abs()[:, 0][live].max().item(),
              (lse - plse).abs()[:, 0][live].max().item())
    assert err <= BS_F32_ATOL, err
    rel = _rel(dq, jdq)
    assert rel <= BWD_F32_REL, rel
    assert bool((o[:, 0][dead] == 0).all()) and bool((jo[:, 0][dead] == 0).all())
    assert bool((lse[:, 0][dead] == bs.NEG_INF).all())
    assert bool((dq[:, 0][dead] == 0).all()) and bool((jdq[:, 0][dead] == 0).all())
    if key_mask:
        assert dead[1].all()
