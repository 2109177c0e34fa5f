"""The pair grid's bf16 forward on bf16 tensor-core tiles
(``bs_fwd_tc_kernel`` in ``csrc/block_sparse_attention.cu``: the
``fwd_sweep`` of ``csrc/bf16_sweeps.cuh`` over ``tf32::HalfRow``), on the
CPU, where no kernel runs: its arithmetic, heads of 64, inputs made with
numpy from a seed. ``testing.emulated_bf16_pair_fwd`` runs it in torch
(per 64-row query tile, the online softmax over the 32-key halves of the
tile's row of ``half_classes``, p rounded to bf16 against the running
max before P.V, every sum in float32), and it is held:

- against float64 at n 1,280 (axial_row and conv_like at the flagship
  geometry, one batch row, 2 heads): o within ``BF16_GAP_FACTOR`` times
  the plain bf16 forward's own relative L2 gap to float64, lse within
  1e-4 of the float64 lse's largest entry on rows that attend a key;
- against JAX ``block_sparse_attention``'s bf16 forward (``_fwd_kernel``
  in interpret mode) at n 640 axial_row and at a ragged n 600
  conv_like, with and without a key mask: the row metric of
  ``bs_fwd_errors`` and lse within ``BS_BF16_ROW_REL``;
- on the causal layout of n 1,280, against the tiled bf16 forward's
  emulation (``emulated_bf16_tiled_fwd``): the two kernels run the same
  sweep over the same halves in the same key order with the same allowed
  bits, so o agrees within one bf16 rounding step and lse within 1e-5 of
  its largest entry (only the CPU's product blocking differs);
- rows with no allowed key (a key mask, a layout with synthetic pairs):
  o exactly 0 and lse -1e30.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops import block_sparse_attention as jbs
from dalle_pytorch_tpu_torch.ops import block_sparse_attention as bs
from dalle_pytorch_tpu_torch.ops import masks
from dalle_pytorch_tpu_torch.testing import (
    BF16_GAP_FACTOR,
    BS_BF16_ROW_REL,
    bs_fwd_errors,
    emulated_bf16_pair_fwd,
    emulated_bf16_tiled_fwd,
    rel_l2,
)

torch.set_num_threads(2)


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


def _float64(q, k, v, allowed):
    """(o, lse) in float64 where ``allowed`` (b or 1, 1, n, n) may attend."""
    q, k, v = (t.double() for t in (q, k, v))
    s = (q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5).masked_fill(~allowed, bs.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > 0.5 * bs.NEG_INF, torch.exp(s - m), 0.0)
    l_safe = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l_safe == 0, 1.0, l_safe)
    return p @ v / l_safe, (m + torch.log(l_safe))[..., 0]


@pytest.mark.parametrize("pattern", ["axial_row", "conv_like"])
def test_bf16_pair_forward_within_the_plain_gap_at_1280(pattern):
    """o of the emulated kernel within ``BF16_GAP_FACTOR`` times the plain
    bf16 forward's relative L2 gap to float64; lse within 1e-4 of the
    float64 lse's largest entry on live rows; the row metric within
    ``BS_BF16_ROW_REL`` of the plain forward."""
    layout = bs.compile_block_layout(masks.pattern_mask(pattern, 257, 32)[:1280, :1280])
    q, k, v = _tensors(np.random.RandomState(15), 1, 2, 1280, 3)
    allowed = bs.may_attend(layout, 1280, "cpu")
    exact_o, exact_lse = _float64(q, k, v, allowed)
    o, lse = emulated_bf16_pair_fwd(q, k, v, layout)
    po, plse = bs.reference_block_sparse(q, k, v, layout)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ratio = rel_l2(o, exact_o) / rel_l2(po, exact_o)
    assert ratio <= BF16_GAP_FACTOR, ratio
    live = allowed[:, 0].any(-1)[:, None].expand(1, 2, 1280)
    lse_err = (lse.double() - exact_lse)[live].abs().max().item()
    assert lse_err <= 1e-4 * exact_lse[live].abs().max().item(), lse_err
    _, row_rel, lse_plain, dead_exact = bs_fwd_errors(o, lse, po, plse, layout)
    assert row_rel <= BS_BF16_ROW_REL and lse_plain <= BS_BF16_ROW_REL, (row_rel, lse_plain)
    assert dead_exact


def _jax_case(n, pattern, key_mask):
    """b 2 x 1 head of 64 in bf16, the pattern of 65 + 24 x 24 cut to n
    (n 600: a ragged last block, n_pad 640), with or without the key mask
    (row 1 wholly dead): (q, k, v, key mask, layout, JAX's o and lse of
    its bf16 forward kernel in interpret mode), as torch tensors."""
    mask = masks.pattern_mask(pattern, 65, 24)[:n, :n]
    layout = bs.compile_block_layout(mask)
    rng = np.random.RandomState(16)
    q, k, v = _tensors(rng, 2, 1, n, 3)
    km = _key_mask(rng, 2, n) if key_mask else None
    jlayout = jbs.compile_block_layout(mask, 128, 128)
    bh = 2
    flat = [jbs._pad_rows(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16).reshape(bh, n, 64),
                          jlayout.n_pad, 1) for t in (q, k, v)]
    kmf = None if km is None else jbs._pad_rows(
        jbs._bcast_key_mask(jnp.asarray(km.numpy()), bh, 1, n), jlayout.n_pad, 2)
    jo, jlse = jbs._bs_fwd(*flat, kmf, jnp.asarray(jlayout.mask, jnp.int8),
                           jnp.asarray(jlayout.fwd_table), jnp.asarray(jlayout.kv_table),
                           64**-0.5, 128, 128, True)
    o = torch.from_numpy(np.array(jo[:, :n].astype(jnp.float32))).reshape(2, 1, n, 64).bfloat16()
    lse = torch.from_numpy(np.array(jlse[:, 0, :n])).reshape(2, 1, n)
    return q, k, v, km, layout, o, lse


@pytest.fixture(scope="module", params=[(640, "axial_row"), (600, "conv_like")],
                ids=["n640_axial_row", "ragged_n600_conv_like"])
def jax_cases(request):
    """{key mask: ``_jax_case``} without and with the key mask."""
    n, pattern = request.param
    return {key_mask: _jax_case(n, pattern, key_mask) for key_mask in (False, True)}


@pytest.mark.parametrize("key_mask", [False, True], ids=["no_key_mask", "key_mask"])
def test_bf16_pair_forward_matches_jax(jax_cases, key_mask):
    """``tests/test_torch_block_sparse.py``'s oracle: JAX
    ``block_sparse_attention``'s bf16 forward (``_fwd_kernel`` in
    interpret mode, (q block, pair) steps over 128-blocks). The emulated
    kernel's o: the row metric within ``BS_BF16_ROW_REL``, lse within the
    same absolute; rows with no allowed key exactly 0 with lse -1e30 in
    both."""
    q, k, v, km, layout, jo, jlse = jax_cases[key_mask]
    o, lse = emulated_bf16_pair_fwd(q, k, v, layout, km)
    _, row_rel, lse_err, dead_exact = bs_fwd_errors(o, lse, jo, jlse, layout, km)
    assert row_rel <= BS_BF16_ROW_REL and lse_err <= BS_BF16_ROW_REL, (row_rel, lse_err)
    assert dead_exact and bs_fwd_errors(jo, jlse, o, lse, layout, km)[3]


def test_bf16_pair_forward_dead_rows_are_exactly_zero(jax_cases):
    """With the key mask batch row 1 is wholly dead and so is query 0 of
    row 0 (its only key dropped): their o rows are exactly 0 and their lse
    -1e30; every live row's o is not 0."""
    q, k, v, km, layout, _, _ = jax_cases[True]
    n = q.shape[2]
    o, lse = emulated_bf16_pair_fwd(q, k, v, layout, km)
    dead = ~bs.may_attend(layout, n, "cpu", km)[:, 0].any(-1)  # (b, n)
    assert dead[1].all() and dead[0, 0]
    assert (o[:, 0][dead] == 0).all() and (lse[:, 0][dead] == bs.NEG_INF).all()
    assert (o[:, 0].float().norm(dim=-1)[~dead] > 0).all()


def test_bf16_pair_forward_synthetic_rows_are_exactly_zero():
    """A causal layout of n 300 whose query block 1 attends nothing (its
    q-major row holds a synthetic pair, its row of ``half_classes`` no
    live half): those 128 rows are exactly 0 with lse -1e30, and the rows
    around them within ``BS_BF16_ROW_REL`` of the plain forward."""
    mask = masks.causal_mask(300)
    mask[128:256] = False
    mask[:, 256:] = False
    layout = bs.compile_block_layout(mask)
    assert (layout.fwd_table[2] == 0).any()
    assert not bs.half_classes(layout)[2:4].any()
    q, k, v = _tensors(np.random.RandomState(17), 1, 2, 300, 3)
    o, lse = emulated_bf16_pair_fwd(q, k, v, layout)
    assert (o[..., 128:256, :] == 0).all() and (lse[..., 128:256] == bs.NEG_INF).all()
    po, plse = bs.reference_block_sparse(q, k, v, layout)
    _, row_rel, lse_err, dead_exact = bs_fwd_errors(o, lse, po, plse, layout)
    assert row_rel <= BS_BF16_ROW_REL and lse_err <= BS_BF16_ROW_REL and dead_exact


def test_bf16_pair_forward_is_the_tiled_forward_on_the_causal_layout():
    """On ``compile_block_layout(causal_mask(1280))`` the pair grid's walk
    (``HalfRow``) visits the halves the tiled forward's visit map does, in
    the same key order and with the same allowed bits, and both kernels
    run ``bf16s::fwd_sweep``: the emulations agree, o within one bf16
    rounding step of the larger magnitude and lse within 1e-5 of its
    largest entry (the CPU blocks the pair emulation's products per
    64-row tile and the tiled one's over all rows)."""
    layout = bs.compile_block_layout(masks.causal_mask(1280))
    q, k, v = _tensors(np.random.RandomState(18), 1, 2, 1280, 3)
    o, lse = emulated_bf16_pair_fwd(q, k, v, layout)
    to, tlse = emulated_bf16_tiled_fwd(q, k, v, causal=True)
    a, b = o.float(), to.float()
    _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
    step = torch.ldexp(torch.ones_like(a), exp - 8)  # a bf16 ulp at that magnitude
    assert ((a - b).abs() <= step).all(), (a - b).abs().max().item()
    assert (lse - tlse).abs().max().item() <= 1e-5 * tlse.abs().max().item()
