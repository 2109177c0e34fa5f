"""The fused decode kernel's split and the decode route, on the CPU.

- ``testing.emulated_split_decode`` runs the kernel's split in plain
  PyTorch (the cache rows [0, idx) cut into ``decode_slices``, a partial
  softmax per slice, merged in rank order with the fresh token). It is
  held against ``reference_fused_decode`` within ``DECODE_F32_ATOL`` at
  the flagship's L 1281 (S 1, 2, 4, 8; idx 0, 1, S - 1, S, 767, 1279;
  rotary on and off; key masks that kill whole slices, and one that kills
  every key: exactly 0), and against JAX's ``fused_decode_attention`` in
  interpret mode as ``test_torch_decode_attention.py`` holds the plain
  version; the k/v rows bitwise in both.
- ``decode_splits`` and ``decode_slices``: deterministic, S 1 at idx 0,
  no empty slice unless idx < S, at least ``DECODE_MIN_ROWS`` rows a
  block, the flagship's choices.
- The route: a truth table of ``decode_kernel_route`` and
  ``Attention.uses_decode_kernel`` with ``torch.device("cuda")`` passed as
  a value (no card needed), and ``fused_decode=None`` on the CPU taking
  exactly the unfused chain that ``False`` takes (JAX's default).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops import decode_attention as jdk
from dalle_pytorch_tpu.ops.rotary import _rotate_half_matrix
from dalle_pytorch_tpu_torch.models import sampling
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.ops import attention as attention_mod
from dalle_pytorch_tpu_torch.ops import decode_attention as da
from dalle_pytorch_tpu_torch.ops.attention import Attention, DenseKV, decode_kernel_route
from dalle_pytorch_tpu_torch.testing import (
    DECODE_F32_ATOL,
    decode_errors,
    decode_inputs,
    emulated_split_decode,
)

torch.set_num_threads(1)

L, B, H = 1281, 2, 4
CUDA, CPU = torch.device("cuda"), torch.device("cpu")


def _idx_cases():
    return sorted({(s, i) for s in da.DECODE_SPLITS for i in (0, 1, s - 1, s, 767, 1279)})


@pytest.fixture(scope="module")
def flagship_length():
    """The inputs at L 1281 (4 heads of 64, float32), with and without
    rotary, made once."""
    return {rot: decode_inputs(B, L, H, 64, 0, torch.float32, "cpu", rotary=rot)
            for rot in (True, False)}


def _emulate(x, idx, splits, key_mask=None):
    qkv, kc, vc, cos, sin, _ = x
    return emulated_split_decode(qkv, kc, vc, idx, cos, sin, key_mask, H, splits)


def _plain(x, idx, key_mask=None):
    qkv, kc, vc, cos, sin, _ = x
    return da.reference_fused_decode(qkv, kc, vc, idx, cos, sin, key_mask, H)


@pytest.mark.parametrize("rotary", [True, False], ids=["rotary", "no_rotary"])
@pytest.mark.parametrize("splits,idx", _idx_cases())
def test_split_matches_plain(flagship_length, splits, idx, rotary):
    x = flagship_length[rotary]
    err, _, rows_equal, dead_zero = decode_errors(_emulate(x, idx, splits), _plain(x, idx))
    assert err <= DECODE_F32_ATOL and rows_equal and dead_zero, err


@pytest.mark.parametrize("dead", [(0,), (2, 5), (1, 2, 3, 4, 5, 6, 7)],
                         ids=["first", "two", "all_but_first"])
def test_split_with_whole_slices_masked(flagship_length, dead):
    """A key mask that kills every key of some slices of S 8 at idx 767
    (the fresh key live): those partials have l = 0 and weight 0."""
    idx, splits = 767, 8
    km = torch.ones(B, L, dtype=torch.int32)
    for r in dead:
        lo, hi = da.decode_slices(idx, splits)[r]
        km[:, lo:hi] = 0
    km[1, :idx] = 0  # row 1: every cache key masked, the fresh key alone
    x = flagship_length[True]
    got = _emulate(x, idx, splits, km)
    assert all(torch.isfinite(t).all() for t in got)
    err, _, rows_equal, dead_zero = decode_errors(got, _plain(x, idx, km), km, idx)
    assert err <= DECODE_F32_ATOL and rows_equal and dead_zero, err


@pytest.mark.parametrize("splits", da.DECODE_SPLITS)
def test_split_with_every_key_masked_gives_zero(flagship_length, splits):
    idx = 767
    km = torch.ones(B, L, dtype=torch.int32)
    km[0, :idx + 1] = 0
    got = _emulate(flagship_length[True], idx, splits, km)
    assert not torch.isnan(got[0]).any()
    assert (got[0][0] == 0).all() and (got[0][1] != 0).any()
    err, _, rows_equal, dead_zero = decode_errors(got, _plain(flagship_length[True], idx, km),
                                                  km, idx)
    assert err <= DECODE_F32_ATOL and rows_equal and dead_zero, err


JL = 40  # cache rows of the JAX comparison, as in test_torch_decode_attention.py


def _jax_fused(x, idx, rotary):
    """JAX's kernel (interpret mode, float32) on the port's inputs."""
    qkv, kc, vc, cos, sin, km = x
    d = qkv.shape[-1] // (3 * H)
    f32 = lambda t: None if t is None else jnp.asarray(t.float().numpy())  # noqa: E731
    if cos is None:
        cos = sin = torch.zeros(JL - 1, d)
    out = jdk.fused_decode_attention(
        f32(qkv), f32(kc), f32(vc), idx, f32(cos), f32(sin),
        jnp.asarray(_rotate_half_matrix(d), jnp.float32),
        None if km is None else jnp.asarray(km.numpy()[..., None]),
        heads=H, dim_head=d, use_rotary=rotary, interpret=True)
    return tuple(torch.from_numpy(np.array(t)) for t in out)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("splits", da.DECODE_SPLITS)
@pytest.mark.parametrize("idx", [0, 23, 38])
def test_split_matches_jax_kernel(splits, idx, masked):
    x = decode_inputs(B, JL, H, 64, idx, torch.float32, "cpu", masked=masked)
    err, _, rows_equal, dead_zero = decode_errors(
        _emulate(x, idx, splits, x[5]), _jax_fused(x, idx, True), x[5], idx)
    assert err <= DECODE_F32_ATOL and rows_equal and dead_zero, err


def test_decode_splits_rule():
    """Deterministic; S 1 at idx 0; every block at least
    ``DECODE_MIN_ROWS`` rows when S > 1; pairs x S within the target; the
    flagship's choices at batch 1 and 8 (16 heads) and their boundaries."""
    for pairs in (1, 4, 16, 32, 64, 128, 256, 1024):
        for idx in range(0, 1300, 7):
            s = da.decode_splits(pairs, idx)
            assert s == da.decode_splits(pairs, idx)
            assert s in da.DECODE_SPLITS
            if s > 1:
                assert idx >= s * da.DECODE_MIN_ROWS
                assert pairs * s <= da.DECODE_TARGET_BLOCKS
        assert da.decode_splits(pairs, 0) == 1
    assert [da.decode_splits(16, i) for i in (0, 127, 128, 255, 256, 511, 512, 768, 1279)] == [
        1, 1, 2, 2, 4, 4, 4, 4, 4]
    assert [da.decode_splits(128, i) for i in (127, 128, 768, 1279)] == [1, 1, 1, 1]
    assert [da.decode_splits(8, i) for i in (511, 512, 1279)] == [4, 8, 8]


@pytest.mark.parametrize("splits", da.DECODE_SPLITS)
def test_decode_slices_cover_the_rows_in_order(splits):
    for idx in list(range(0, 40)) + [127, 128, 767, 1279]:
        slices = da.decode_slices(idx, splits)
        assert len(slices) == splits and slices[0][0] == 0 and slices[-1][1] == idx
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
        sizes = [hi - lo for lo, hi in slices]
        assert max(sizes) - min(sizes) <= 1
        assert min(sizes) > 0 or idx < splits


@pytest.mark.parametrize("device,n,attn_type,causal,heads,dim_head,want", [
    (CUDA, 1, "full", True, 16, 64, True),
    (CUDA, 1, "full", True, 2, 64, True),
    (CUDA, 1, "full", True, 16, 8, True),
    (CUDA, 2, "full", True, 16, 64, False),  # a block of tokens
    (CUDA, 257, "full", True, 16, 64, False),  # the prompt
    (CUDA, 1, "axial_row", True, 16, 64, False),
    (CUDA, 1, "conv_like", True, 16, 64, False),
    (CUDA, 1, "full", False, 16, 64, False),
    (CUDA, 1, "full", True, 4, 16, False),  # outside fused_decode_supported
    (CUDA, 1, "full", True, 3, 64, False),
    (CPU, 1, "full", True, 16, 64, False),  # never off the card
    ("cuda:0", 1, "full", True, 16, 64, True),
])
def test_decode_kernel_route(device, n, attn_type, causal, heads, dim_head, want):
    assert decode_kernel_route(device, n, attn_type, causal, heads, dim_head) is want


@pytest.mark.parametrize("fused", [None, True, False], ids=["none", "true", "false"])
@pytest.mark.parametrize("window", [True, False], ids=["window", "whole_cache"])
@pytest.mark.parametrize("device", [CUDA, CPU], ids=["cuda", "cpu"])
def test_uses_decode_kernel(device, window, fused):
    """Which dense decode steps take the kernel: on the card None and True
    at any window, on the CPU True only over the whole cache (JAX's gate),
    None never; False never."""
    attn = Attention(dim=128, seq_len=64, causal=True, heads=2, dim_head=64, device="cpu")
    k = torch.zeros(1, 64, 128)
    kv = DenseKV(k, k.clone(), "4d", 2, width=32 if window else 0)
    want = {(CUDA, None): True, (CUDA, True): True, (CPU, None): False,
            (CPU, True): not window}.get((device, fused), False)
    assert attn.uses_decode_kernel(1, kv, device, fused) is want
    assert not attn.uses_decode_kernel(2, kv, device, fused)


CONFIG = dict(dim=64, depth=2, num_text_tokens=16, text_seq_len=6, num_image_tokens=20,
              image_fmap_size=4, heads=2, dim_head=64)


@pytest.fixture
def port_calls(monkeypatch):
    calls = {"n": 0}
    real = attention_mod.fused_decode_attention

    def spy(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(attention_mod, "fused_decode_attention", spy)
    return calls


@pytest.mark.parametrize("fmt", ["4d", "flat"])
def test_default_route_on_cpu_is_the_unfused_chain(port_calls, fmt):
    """``decode_step`` with ``fused_decode=None`` (the default) on the CPU
    gives bit for bit the logits and caches of ``False``, and neither
    calls the kernel's wrapper; ``True`` calls it once a layer and step."""
    model = DALLE(**CONFIG, device="cpu").init_weights(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    text = torch.from_numpy(rng.randint(1, 16, size=(2, 6)))
    ids = torch.cat((model.remap_text(text), torch.from_numpy(rng.randint(0, 20, (2, 16)))),
                    1)[:, :model.total_seq_len].to(torch.int32)
    runs = {}
    for fused in (None, False, True):
        port_calls["n"] = 0
        cache = sampling.init_decode_cache(model, 2, fmt)
        logits = torch.stack([model.decode_step(ids[:, i], i, cache, fused_decode=fused)
                              for i in range(ids.shape[1])], 1)
        runs[fused] = (logits, [t.clone() for kv in cache.kv for t in (kv.k, kv.v)],
                       port_calls["n"])
    (l_none, c_none, n_none), (l_false, c_false, n_false) = runs[None], runs[False]
    assert n_none == n_false == 0
    assert torch.equal(l_none, l_false)
    assert all(torch.equal(a, b) for a, b in zip(c_none, c_false))
    assert runs[True][2] == CONFIG["depth"] * ids.shape[1]


def test_default_generation_on_cpu_is_the_unfused_chain(port_calls):
    """``generate_image_tokens`` with default arguments (the window on)
    on the CPU: the tokens of ``fused_decode=False`` and no kernel call."""
    model = DALLE(**CONFIG, device="cpu").init_weights(torch.Generator().manual_seed(2))
    text = torch.from_numpy(np.random.RandomState(3).randint(1, 16, size=(2, 6)))
    got = sampling.generate_image_tokens(model, text, 0, cache_format="4d")
    assert port_calls["n"] == 0
    want = sampling.generate_image_tokens(model, text, 0, cache_format="4d", fused_decode=False)
    assert torch.equal(got, want)
