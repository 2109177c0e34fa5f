"""The port's DALLE.fused_step against the JAX package on the CPU: a tiny
DALLE (depth 2, dim 64, 2 heads of 32, text_seq_len 6, 4x4 image grid,
page size 4), JAX-initialised and converted, driven through a scripted
sequence of mixed ragged iterations (prefill chunks, final chunks, decode
rows crossing page boundaries, idle rows with garbage starts). Logits of
every active row agree to atol 1e-4 (float32), and every cache leaf (K/V
page pools, tables, write indices, shift rings) agrees after every
iteration."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import DALLE as JDALLE
from dalle_pytorch_tpu.models import init_decode_cache as j_init_cache
from dalle_pytorch_tpu.models.sampling import set_decode_offsets as j_set_offsets
from dalle_pytorch_tpu_torch.convert import dalle_state_dict
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.sampling import init_decode_cache
from dalle_pytorch_tpu_torch.ops import paged_kv

torch.set_num_threads(1)

PAGE = 4
CONFIG = dict(dim=64, depth=2, num_text_tokens=16, text_seq_len=6,
              num_image_tokens=20, image_fmap_size=4, heads=2, dim_head=32)


def tiny_models(seed=0, **config):
    """(JAX DALLE, its params with every leaf perturbed, the converted port
    model on the CPU in float32); ``config`` overrides ``CONFIG``."""
    config = {**CONFIG, **config}
    jmodel = JDALLE(**config)
    params = jmodel.init(
        jax.random.key(seed), jnp.ones((1, 6), jnp.int32), jnp.zeros((1, 16), jnp.int32)
    )["params"]
    rng = np.random.RandomState(seed)
    # perturb every leaf (unit LayerNorms and 0.1 LayerScales would hide
    # swapped or mis-transposed weights)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        + 0.02 * rng.randn(*a.shape).astype(np.float32),
        params,
    )
    model = DALLE(**config, device="cpu", dtype=torch.float32)
    model.load_state_dict(dalle_state_dict(params))
    return jmodel, params, model


@pytest.fixture
def jax_pages(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))


def _leaves(cache, key):
    return [
        np.asarray(x) for p, x in jax.tree_util.tree_leaves_with_path(cache)
        if getattr(p[-1], "key", None) == key
    ]


# (start, length, final) per row, B = 3 rows, width 4, T = 7 prompt positions
ITERATIONS = [
    ([0, 0, 3], [4, 4, 0], [0, 0, 0]),
    ([4, 4, 0], [3, 3, 4], [1, 1, 0]),
    ([7, 7, 4], [1, 1, 3], [0, 0, 1]),
    ([8, 5, 7], [1, 0, 1], [0, 0, 0]),
    ([9, 8, 8], [1, 1, 1], [0, 0, 0]),
    ([10, 9, 9], [1, 1, 1], [0, 0, 0]),
    ([11, 10, 2], [1, 1, 0], [0, 0, 0]),
    ([12, 11, 10], [1, 1, 1], [0, 0, 0]),
]


def test_fused_step_logits_and_caches_match(jax_pages):
    check_fused_step(*tiny_models())


def check_fused_step(jmodel, params, model):
    """``ITERATIONS`` through JAX's and the port's ``fused_step``: active
    rows' logits within 1e-4, every cache leaf within 1e-5 after every
    iteration (JAX's pages come from ``DALLE_TPU_KV_PAGE_SIZE``)."""
    B, W = 3, 4
    T = model.text_len_internal
    jcache = j_set_offsets(
        j_init_cache(jmodel, params, B, cache_format="paged"), jnp.zeros((B,), jnp.int32)
    )
    cache = init_decode_cache(model, B, page_size=PAGE)
    rng = np.random.RandomState(1)
    prompts = rng.randint(0, model.num_text_tokens_ext, size=(B, T))
    for it, (start, length, final) in enumerate(ITERATIONS):
        start, length = np.asarray(start, np.int32), np.asarray(length, np.int32)
        final = np.asarray(final, bool)
        tokens = np.zeros((B, W), np.int32)
        for r in range(B):
            if start[r] < T:
                chunk = prompts[r, start[r]:start[r] + W]
                tokens[r, :len(chunk)] = chunk
            else:
                tokens[r, 0] = rng.randint(0, model.num_image_tokens)
        ref, mut = jmodel.apply(
            {"params": params, "cache": jcache}, jnp.asarray(tokens),
            jnp.asarray(start), jnp.asarray(length), jnp.asarray(final),
            rowwise_head=bool(final.any()), method=JDALLE.fused_step,
            mutable=["cache"],
        )
        jcache = mut["cache"]
        got = model.fused_step(
            torch.from_numpy(tokens), torch.from_numpy(start),
            torch.from_numpy(length), torch.from_numpy(final), cache,
            rowwise_head=bool(final.any()),
        )
        active = length > 0
        np.testing.assert_allclose(
            got.numpy()[active], np.asarray(ref)[active], atol=1e-4, rtol=1e-4,
            err_msg=f"iteration {it}",
        )
        for name, ours in (
            ("cached_key_pages", [paged_kv.pool_view(kv.k, B) for kv in cache.kv]),
            ("cached_value_pages", [paged_kv.pool_view(kv.v, B) for kv in cache.kv]),
            ("page_table", [kv.table for kv in cache.kv]),
            ("cache_index", [kv.index for kv in cache.kv]),
            ("shift_hist", [r.hist for r in cache.attn_rings + cache.ff_rings]),
            ("shift_index", [r.index for r in cache.attn_rings + cache.ff_rings]),
        ):
            refs = _leaves(jcache, name)
            assert len(refs) == len(ours), name
            for a, b in zip(ours, refs):
                np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=1e-5,
                                           err_msg=f"{name} after iteration {it}")


def test_remap_text_matches_reference():
    jmodel, params, model = tiny_models()
    text = np.array([[3, 0, 5, 0, 0, 1], [0, 0, 0, 0, 0, 0]], np.int32)
    ref = jmodel.apply({"params": params}, jnp.asarray(text), method=JDALLE.remap_text)
    np.testing.assert_array_equal(model.remap_text(torch.from_numpy(text)).numpy(), ref)


@pytest.mark.parametrize("kwargs", [
    dict(attn_types=("mlp",)), dict(serve_quant=True),
], ids=lambda kw: next(iter(kw)))
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError):
        DALLE(**{**CONFIG, **kwargs}, device="cpu")
