"""The port's block-sparse pair-grid attention against the JAX package on
the CPU, float32 (``dalle_pytorch_tpu_torch/ops/block_sparse_attention.py``
and the pattern dispatch of ``ops/attention.py``):

- layouts: ``compile_block_layout`` gives JAX's visit map, mask, both
  pair tables, pair counts and visited-block fraction exactly, on
  ``tests/test_block_sparse.py``'s layout cases, its ragged tail and the
  flagship geometry (257 + 32 x 32, n 1280, block 128), where axial_row
  and conv_like engage and axial_col and sparse decline;
- forward: ``reference_block_sparse`` against JAX
  ``block_sparse_attention(..., interpret=True)`` at atol 2e-5 (JAX's own
  test's tolerance), o and lse, with a ragged tail and a key mask whose
  dead rows must be exactly 0;
- backward: ``reference_block_sparse_bwd`` and autograd through
  ``BlockSparseAttention`` against ``jax.vjp`` of the interpret-mode
  kernel, each of dq, dk, dv within relative L2 1e-5;
- the attention layer: ``Attention`` of every type on converted weights
  against JAX ``PatternAttention`` at a non-flash n (the dense path) and
  at n 640 with ``DALLE_TPU_SPARSE_KERNEL=1``, where JAX takes the same
  pair-grid route in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops import block_sparse_attention as jbs
from dalle_pytorch_tpu.ops import masks as jmasks
from dalle_pytorch_tpu.ops.attention import PatternAttention
from dalle_pytorch_tpu.ops.flash_attention import StaticTable
from dalle_pytorch_tpu_torch.ops import block_sparse_attention as bs
from dalle_pytorch_tpu_torch.ops.attention import Attention, sparse_block
from dalle_pytorch_tpu_torch.ops.rotary import dalle_rotary_table, rot_tables

torch.set_num_threads(2)


def _cases():
    """(name, mask, block): tests/test_block_sparse.py's LAYOUT_CASES and
    its ragged tail."""
    return [
        ("axial_row", jmasks.axial_mask(8, 4, axis=0), 4),
        ("axial_col", jmasks.axial_mask(8, 8, axis=1), 4),
        ("conv_like", jmasks.conv_mask(8, 4, 3, 1), 4),
        ("strided", jmasks.block_sparse_mask(64, block_size=8, text_seq_len=15,
                                             causal=True, seed=0), 8),
        ("ragged_tail", jmasks.axial_mask(8, 4, axis=0), 16),
    ]


CASES = _cases()
IDS = [c[0] for c in CASES]
FLAGSHIP_TYPES = ("axial_row", "axial_col", "conv_like", "sparse")


def _same_layout(ours, theirs):
    for name in ("n", "n_pad", "block_q", "block_k", "n_pairs", "dense_pairs",
                 "visited_block_frac"):
        assert getattr(ours, name) == getattr(theirs, name), name
    for name in ("visit", "mask", "fwd_table", "kv_table"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("name,mask,block", CASES, ids=IDS)
def test_layout_equals_jax(name, mask, block):
    _same_layout(bs.compile_block_layout(mask, block, block),
                 jbs.compile_block_layout(mask, block, block))


@pytest.mark.parametrize("attn_type", FLAGSHIP_TYPES)
def test_flagship_layouts_equal_jax_and_route_as_jax(attn_type):
    """Text 256 (+ <bos>), a 32 x 32 grid, n 1280, block 128: the layer's
    own pattern; axial_row and conv_like engage, axial_col and sparse do
    not."""
    seq_len, fmap, n = 257 + 32 * 32, 32, 1280
    jlayer = PatternAttention(dim=64, seq_len=seq_len, attn_type=attn_type, heads=16,
                              dim_head=64, image_fmap_size=fmap)
    layer = Attention(64, seq_len, 16, 64, attn_type=attn_type, image_fmap_size=fmap,
                      device="cpu")
    mask = jlayer.pattern_mask()[:n, :n]
    assert np.array_equal(layer.pattern_mask()[:n, :n], mask)
    ours = layer.block_layout(n)
    _same_layout(ours, jbs.compile_block_layout(mask, 128, 128))
    engages = attn_type in ("axial_row", "conv_like")
    assert (ours.visited_block_frac <= bs.ENGAGE_FRAC) == engages
    assert layer.uses_block_sparse(n) == engages
    if engages:
        assert (ours.n_pairs, ours.dense_pairs) == (40, 55)


def test_layers_of_one_pattern_share_its_layout_and_mask():
    """Layouts and pattern tensors are cached per (pattern config, n), as
    JAX's ``_cached_block_layout`` keys them, not per layer: the seed
    separates only "sparse" layers, the one type whose mask reads it."""
    seq_len, fmap, n = 65 + 24 * 24, 24, 640

    def layers(attn_type):
        return [Attention(16, seq_len, 2, 8, attn_type=attn_type, image_fmap_size=fmap,
                          layout_seed=seed, device="cpu") for seed in (0, 1)]

    for attn_type in ("axial_row", "axial_col", "conv_like"):
        a, b = layers(attn_type)
        assert a.block_layout(n) is b.block_layout(n)
        assert a.pattern(n, "cpu") is b.pattern(n, "cpu")
    a, b = layers("sparse")
    assert a.block_layout(n) is not b.block_layout(n)
    assert not np.array_equal(a.pattern_mask(), b.pattern_mask())
    assert a.block_layout(n) is layers("sparse")[0].block_layout(n)


def _inputs(rng, b, h, n, d):
    return [rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4)]


def _key_mask(b, n):
    """Row 0 drops key 0 (text row 0 then attends nothing) and a few
    others; row 1 drops its tail."""
    km = np.ones((b, n), bool)
    km[0, 0], km[0, 5::7] = False, False
    km[1, n - 5:] = False
    return km


@pytest.mark.parametrize("with_mask", [False, True], ids=["no_mask", "key_mask"])
@pytest.mark.parametrize("name,mask,block", CASES, ids=IDS)
def test_forward_matches_jax_interpret(name, mask, block, with_mask):
    n = mask.shape[0]
    b, h, d = 2, 2, 32
    rng = np.random.default_rng(0)
    q, k, v, _ = _inputs(rng, b, h, n, d)
    km = _key_mask(b, n) if with_mask else None
    jlayout = jbs.compile_block_layout(mask, block, block)
    ref = np.asarray(jbs.block_sparse_attention(
        *map(jnp.asarray, (q, k, v)), jlayout,
        key_mask=None if km is None else jnp.asarray(km), interpret=True))
    layout = bs.compile_block_layout(mask, block, block)
    tkm = None if km is None else torch.from_numpy(km)
    before = bs.block_sparse_attention.launches
    o, lse = bs.block_sparse_attention(*map(torch.from_numpy, (q, k, v)), layout, tkm)
    assert bs.block_sparse_attention.launches == before  # CPU: the plain version
    np.testing.assert_allclose(o.numpy(), ref, atol=2e-5, rtol=0)
    # lse from JAX's forward body over the padded, flattened operands
    pad = lambda t: jnp.pad(jnp.asarray(t).reshape(b * h, n, d),  # noqa: E731
                            ((0, 0), (0, jlayout.n_pad - n), (0, 0)))
    jkm = None
    if km is not None:
        jkm = jnp.pad(jbs._bcast_key_mask(jnp.asarray(km), b * h, h, n),
                      ((0, 0), (0, 0), (0, jlayout.n_pad - n)))
    _, jlse = jbs._bs_fwd(pad(q), pad(k), pad(v), jkm, jnp.asarray(jlayout.mask, jnp.int8),
                          jnp.asarray(jlayout.fwd_table), jnp.asarray(jlayout.kv_table),
                          d**-0.5, block, block, True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0, :n].reshape(b, h, n),
                               atol=2e-5, rtol=0)
    if km is not None:
        live = (mask[None] & km[:, None, :]).any(-1)  # (b, n)
        assert not live.all()
        dead = torch.from_numpy(~live)[:, None, :].expand(b, h, n)
        assert (o[dead] == 0).all() and (lse[dead] == bs.NEG_INF).all()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("with_mask", [False, True], ids=["no_mask", "key_mask"])
@pytest.mark.parametrize("name,mask,block", CASES, ids=IDS)
def test_backward_matches_jax_vjp(name, mask, block, with_mask):
    n = mask.shape[0]
    b, h, d = 2, 2, 32
    rng = np.random.default_rng(1)
    q, k, v, do = _inputs(rng, b, h, n, d)
    km = _key_mask(b, n) if with_mask else None
    jlayout = jbs.compile_block_layout(mask, block, block)
    jkm = None if km is None else jnp.asarray(km)
    _, vjp = jax.vjp(lambda q, k, v: jbs.block_sparse_attention(
        q, k, v, jlayout, key_mask=jkm, interpret=True), *map(jnp.asarray, (q, k, v)))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    layout = bs.compile_block_layout(mask, block, block)
    tkm = None if km is None else torch.from_numpy(km)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = bs.reference_block_sparse(tq, tk, tv, layout, tkm)
    plain = bs.reference_block_sparse_bwd(tq, tk, tv, o, lse, tdo, layout, tkm)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out, _ = bs.BlockSparseAttention.apply(*leaves, tkm, layout, None)
    auto = torch.autograd.grad(out, leaves, tdo)
    for part, want, got_plain, got_auto in zip("qkv", ref, plain, auto):
        assert _rel(got_plain.numpy(), want) <= 1e-5, (part, _rel(got_plain.numpy(), want))
        assert _rel(got_auto.numpy(), want) <= 1e-5, (part, _rel(got_auto.numpy(), want))


def test_device_layout_offsets_frame_the_runs():
    mask = jmasks.block_sparse_mask(64, block_size=8, text_seq_len=15, causal=True, seed=0)
    layout = bs.compile_block_layout(mask, 8, 8)
    dl = bs.device_layout(layout, "cpu")
    assert bs.device_layout(layout, "cpu") is dl  # built once per layout
    assert dl.mask.dtype == torch.int8 and tuple(dl.mask.shape) == (64, 64)
    # the k-major runs on the device; the q-major ones, which no kernel
    # reads, framed the same way on the host
    fwd_offsets = bs._run_offsets(layout.fwd_table[0], layout.nq)
    for table, offsets, row in ((layout.fwd_table, fwd_offsets, 0),
                                (dl.kv_table, dl.kv_offsets, 1)):
        for blk in range(len(offsets) - 1):
            run = table[:, offsets[blk]:offsets[blk + 1]]
            assert (run[row] == blk).all()
            assert run[3, 0] == 1 and run[4, -1] == 1


# ------------------------------------------------------ the attention layer


DIM, HEADS, DIM_HEAD = 64, 4, 32


def _layer_pair(attn_type, seq_len, fmap, seed):
    """(JAX PatternAttention, its params, the port's Attention on the same
    converted weights)."""
    jlayer = PatternAttention(dim=DIM, seq_len=seq_len, attn_type=attn_type, heads=HEADS,
                              dim_head=DIM_HEAD, image_fmap_size=fmap, layout_seed=seed)
    rng = np.random.RandomState(seed)
    params = {
        "to_qkv": {"kernel": rng.randn(DIM, 3 * HEADS * DIM_HEAD).astype(np.float32) * 0.2},
        "to_out": {"kernel": rng.randn(HEADS * DIM_HEAD, DIM).astype(np.float32) * 0.2,
                   "bias": rng.randn(DIM).astype(np.float32) * 0.1},
    }
    layer = Attention(DIM, seq_len, HEADS, DIM_HEAD, attn_type=attn_type,
                      image_fmap_size=fmap, layout_seed=seed, device="cpu")
    layer.load_state_dict({
        "to_qkv.weight": torch.from_numpy(params["to_qkv"]["kernel"].T.copy()),
        "to_out.weight": torch.from_numpy(params["to_out"]["kernel"].T.copy()),
        "to_out.bias": torch.from_numpy(params["to_out"]["bias"]),
    })
    return jlayer, params, layer


@pytest.mark.parametrize("attn_type", ["full", "axial_row", "axial_col", "conv_like",
                                       "sparse"])
@pytest.mark.parametrize("text_len,fmap,n", [(8, 4, 23), (65, 24, 640)],
                         ids=["dense_n23", "n640"])
def test_attention_layer_matches_jax(monkeypatch, attn_type, text_len, fmap, n):
    """Converted weights, rotary (the DALL-E table), a text key mask that
    keeps <bos>; x float32. At n 23 JAX takes its grouped/dense paths and
    the port the dense one; at n 640 both take the pair grid for axial_row
    and conv_like and the packed path with the pattern otherwise."""
    monkeypatch.setenv("DALLE_TPU_SPARSE_KERNEL", "1")
    seq_len = text_len + fmap**2
    jlayer, params, layer = _layer_pair(attn_type, seq_len, fmap, seed=3)
    rng = np.random.RandomState(4)
    x = rng.randn(2, n, DIM).astype(np.float32)
    km = np.ones((2, n), bool)
    km[0, 3:text_len:2] = False
    km[1, text_len - 6:text_len] = False
    table = dalle_rotary_table(DIM_HEAD, text_len, fmap)
    padded = np.pad(table, ((0, 0), (0, DIM_HEAD - table.shape[1])))
    ref = jlayer.apply({"params": params}, jnp.asarray(x), mask=jnp.asarray(km),
                       rotary_pos_emb=StaticTable(padded))
    rot = rot_tables(torch.from_numpy(table), n, DIM_HEAD, torch.float32)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), rotary=rot, mask=torch.from_numpy(km))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    engages = sparse_block(n) > 0 and attn_type in ("axial_row", "conv_like")
    assert layer.uses_block_sparse(n) == engages


def test_attention_layer_gradients_take_the_pair_grid(monkeypatch):
    """At n 640 an axial_row layer's backward runs through
    ``BlockSparseAttention`` (on the CPU its plain versions) and agrees
    with ``jax.grad`` of the interpret-mode layer."""
    text_len, fmap, n = 65, 24, 640
    seq_len = text_len + fmap**2
    jlayer, params, layer = _layer_pair("axial_row", seq_len, fmap, seed=5)
    rng = np.random.RandomState(6)
    x = rng.randn(2, n, DIM).astype(np.float32)
    w = rng.randn(2, n, DIM).astype(np.float32)
    table = dalle_rotary_table(DIM_HEAD, text_len, fmap)
    padded = StaticTable(np.pad(table, ((0, 0), (0, DIM_HEAD - table.shape[1]))))

    monkeypatch.setenv("DALLE_TPU_SPARSE_KERNEL", "1")

    def j_loss(p, x):
        return (jlayer.apply({"params": p}, x, rotary_pos_emb=padded) * w).sum()

    jgx = np.asarray(jax.grad(j_loss, argnums=1)(params, jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    rot = rot_tables(torch.from_numpy(table), n, DIM_HEAD, torch.float32)
    (layer(tx, rotary=rot) * torch.from_numpy(w)).sum().backward()
    assert _rel(tx.grad.numpy(), jgx) <= 1e-5
