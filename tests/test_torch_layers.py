"""The port's building blocks against the JAX package on the CPU: the
rotary table (exactly equal), rotation of q/k/v, LayerScale(PreNorm(GEGLU
FeedForward)) on converted weights, the PreShiftToken decode ring over a
sequence of ragged blocks with idle rows, token shift over a whole
sequence (padded image grid included; exactly equal), and paged append
(with a row limit) and gather. float32; tolerances per test."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops import layers as jlayers
from dalle_pytorch_tpu.ops import paged_kv as jpaged
from dalle_pytorch_tpu.ops import rotary as jrotary
from dalle_pytorch_tpu_torch.ops import layers, paged_kv, rotary

torch.set_num_threads(1)


@pytest.mark.parametrize("dim_head,text_len,fmap", [(64, 257, 32), (32, 7, 4)])
def test_rotary_table_equals_reference(dim_head, text_len, fmap):
    ours = rotary.dalle_rotary_table(dim_head, text_len, fmap)
    ref = jrotary.dalle_rotary_table(dim_head, text_len, fmap)
    assert ours.shape == ref.shape == (text_len + fmap**2 - 1, 3 * 2 * (dim_head // 3 // 2))
    np.testing.assert_array_equal(ours, ref)


def test_apply_rotary_matches_reference():
    """The port rotates the table's width and passes the rest through; the
    reference model zero-pads the table to the head width instead. Both
    must give the same q/k/v."""
    rng = np.random.RandomState(0)
    table = rotary.dalle_rotary_table(64, 9, 4)
    rows = table[rng.randint(0, table.shape[0], size=(2, 3))]  # (b, n, 60)
    t = rng.randn(2, 3, 4, 64).astype(np.float32)  # (b, n, h, d)
    padded = np.pad(rows, ((0, 0), (0, 0), (0, 4)))
    ref = np.asarray(jrotary.apply_rotary_emb(jnp.asarray(padded)[:, :, None], jnp.asarray(t)))
    ours = rotary.apply_rotary_emb(torch.from_numpy(rows)[:, :, None], torch.from_numpy(t))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(ours.numpy()[..., 60:], t[..., 60:])


def test_layerscale_prenorm_feedforward_on_converted_weights():
    dim, depth = 16, 3
    mod = jlayers.LayerScale(
        dim=dim, depth=depth, fn=jlayers.PreNorm(dim=dim, fn=jlayers.FeedForward(dim=dim))
    )
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, dim).astype(np.float32)
    params = mod.init(jax.random.key(0), jnp.asarray(x))["params"]
    # random values everywhere (the init's unit norms and 0.1 gains would
    # hide transposition mistakes)
    params = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32) * 0.5, params
    )
    ref = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))

    ours = layers.LayerScale(dim, depth, layers.PreNorm(dim, layers.FeedForward(dim)))
    p, ff = params["fn"], params["fn"]["fn"]
    ours.load_state_dict({
        "scale": torch.from_numpy(params["scale"]),
        "fn.norm.weight": torch.from_numpy(p["LayerNorm_0"]["scale"]),
        "fn.norm.bias": torch.from_numpy(p["LayerNorm_0"]["bias"]),
        "fn.fn.proj_in.weight": torch.from_numpy(ff["Dense_0"]["kernel"].T.copy()),
        "fn.fn.proj_in.bias": torch.from_numpy(ff["Dense_0"]["bias"]),
        "fn.fn.proj_out.weight": torch.from_numpy(ff["Dense_1"]["kernel"].T.copy()),
        "fn.fn.proj_out.bias": torch.from_numpy(ff["Dense_1"]["bias"]),
    })
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


class _Identity(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return x


def test_shift_ring_over_ragged_blocks():
    """A sequence of ragged blocks (prefill chunks crossing into the image
    grid, decode rows, idle rows with garbage starts) through the decode
    ring: outputs on valid columns and the ring state after every block
    equal the reference's."""
    b, n, d, fmap = 3, 3, 8, 3
    seq_len = 3 + fmap**2  # text_seq_len 3 (+ <bos>) and a 3x3 grid
    R = fmap + 1
    jmod = jlayers.PreShiftToken(fn=_Identity(), image_size=fmap, seq_len=seq_len)
    tmod = layers.PreShiftToken(torch.nn.Identity(), fmap, seq_len)
    cache = {"shift_hist": jnp.zeros((b, R, d)), "shift_index": jnp.zeros((b,), jnp.int32)}
    ring = layers.ShiftRing(torch.zeros(b, R, d), torch.zeros(b, dtype=torch.int32))
    # (start, length) per row per block; idle rows carry a garbage start
    blocks = [
        ([0, 0, 5], [3, 2, 0]),
        ([3, 2, 0], [1, 3, 0]),
        ([4, 5, 0], [1, 3, 3]),
        ([5, 8, 3], [1, 1, 2]),
        ([6, 9, 5], [0, 1, 1]),
        ([6, 10, 6], [1, 1, 3]),
        ([7, 11, 9], [3, 0, 1]),
    ]
    rng = np.random.RandomState(2)
    for start, length in blocks:
        x = rng.randn(b, n, d).astype(np.float32)
        s, ln = np.asarray(start, np.int32), np.asarray(length, np.int32)
        ref, mut = jmod.apply(
            {"cache": cache}, jnp.asarray(x), decode=True,
            block_len=jnp.asarray(ln), block_start=jnp.asarray(s),
            mutable=["cache"],
        )
        cache = mut["cache"]
        got = tmod(torch.from_numpy(x), ring, torch.from_numpy(ln), torch.from_numpy(s))
        valid = (np.arange(n)[None] < ln[:, None])[..., None]
        np.testing.assert_array_equal(np.where(valid, got.numpy(), 0), np.where(valid, ref, 0))
        np.testing.assert_array_equal(ring.hist.numpy(), np.asarray(cache["shift_hist"]))
        np.testing.assert_array_equal(ring.index.numpy(), np.asarray(cache["shift_index"]))


def test_paged_append_with_limit_and_gather():
    b, n_p, page, feat = 3, 4, 2, 5
    rng = np.random.RandomState(3)
    pool = np.zeros((b, n_p, page, feat), np.float32)
    flat = paged_kv.alloc(b, n_p, page, feat, torch.float32, "cpu")
    perm = rng.permutation(b * n_p).astype(np.int32).reshape(b, n_p)
    for index, limit in (([0, 1, 6], [3, 0, 2]), ([3, 1, 7], [2, 3, 3])):
        rows = rng.randn(b, 3, feat).astype(np.float32)
        pool = np.asarray(jpaged.append(
            jnp.asarray(pool), jnp.asarray(perm), jnp.asarray(index, jnp.int32),
            jnp.asarray(rows), limit=jnp.asarray(limit, jnp.int32),
        ))
        paged_kv.append_([flat], torch.from_numpy(perm), torch.tensor(index, dtype=torch.int32),
                         [torch.from_numpy(rows)], limit=torch.tensor(limit, dtype=torch.int32))
        np.testing.assert_array_equal(paged_kv.pool_view(flat, b).numpy(), pool)
    np.testing.assert_array_equal(
        paged_kv.gather(flat, torch.from_numpy(perm)).numpy(),
        np.asarray(jpaged.gather(jnp.asarray(pool), jnp.asarray(perm))),
    )


@pytest.mark.parametrize("text_len,fmap,n", [(257, 32, 1280), (9, 4, 24), (9, 4, 25), (5, 3, 10)],
                         ids=["flagship_padded", "padded", "full_grid", "short"])
def test_shift_tokens_full_sequence_matches_reference(text_len, fmap, n):
    """Token shift over a whole sequence, the image part zero-padded to a
    full grid and cut back where n falls short of it (the flagship's
    257 + 1024 - 1280 = 1 position): exactly equal."""
    x = np.random.RandomState(5).randn(2, n, 8).astype(np.float32)
    ref = np.asarray(jlayers.shift_tokens(jnp.asarray(x), text_len, fmap))
    np.testing.assert_array_equal(layers.shift_tokens(torch.from_numpy(x), text_len, fmap).numpy(), ref)


def test_preshift_full_sequence_form_matches_reference():
    """PreShiftToken without a ring (the training forward) equals the JAX
    module's non-decode branch."""
    fmap, seq_len = 3, 4 + 9
    x = np.random.RandomState(6).randn(2, seq_len, 8).astype(np.float32)
    jmod = jlayers.PreShiftToken(fn=_Identity(), image_size=fmap, seq_len=seq_len)
    ref = np.asarray(jmod.apply({}, jnp.asarray(x)))
    got = layers.PreShiftToken(torch.nn.Identity(), fmap, seq_len)(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_dropout_raises():
    """Dropout is ported (tests/test_torch_dropout.py), so nothing raises
    any more: the layers build at a rate above 0, and a call without a
    generator (flax's deterministic call) is the identity."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.ops.attention import Attention

    x = torch.randn(2, 4, 8)
    assert layers.dropout(x, 0.1, None) is x
    ff = layers.FeedForward(8, dropout=0.1)
    attn = Attention(8, 4, heads=2, dim_head=4, dropout=0.1)
    assert (ff.dropout, attn.dropout) == (0.1, 0.1)
    assert torch.equal(ff(x), ff(x, generator=None))
    model = DALLE(dim=16, depth=1, num_text_tokens=10, text_seq_len=4, num_image_tokens=6,
                  image_fmap_size=2, heads=2, dim_head=8, attn_dropout=0.1, device="cpu")
    text, image = torch.ones(1, 4, dtype=torch.long), torch.zeros(1, 4, dtype=torch.long)
    torch.testing.assert_close(model(text, image), model(text, image, generator=None),
                               rtol=0, atol=0)
