"""The split serving path's model pieces against the JAX package on the
CPU, on the tiny converted DALLE of test_torch_dalle.py (T = 7 prompt
positions, a 4 x 4 image grid, page 4, 6 pages a row), float32:

- ``DALLE.prefill_chunk``: the chunkings the split engine makes of a
  7-position prompt (chunk 2: 2-2-3, its 1-token tail merged; chunk 3:
  3-4; chunk 7: one chunk), each chunk's logits within 1e-4 of JAX's
  ``DALLE.prefill_chunk`` on the same cache, and the final logits and
  every cache leaf within 1e-5 of one ``prefill_step`` (the same function
  through projections of another row count, so not bitwise); an
  intermediate chunk without logits returns None; ``image_only`` is the
  full head's image-vocab slice.
- the vector ``decode_step``: three rows at different text and image
  positions over the same converted paged cache (random contents,
  permuted page tables, unquantized and int8 pages) as JAX's vector
  ``decode_step``: logits within 1e-4, every cache leaf after the step
  within 1e-5; a dense cache refuses per-row positions.
- ``insert_decode_cache``, ``merge_decode_caches`` and
  ``set_decode_offsets`` against JAX's on converted random caches, every
  leaf (K/V pools, int8 scale pools, tables, indices, both shift rings'
  history and index) equal after conversion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import DALLE as JDALLE
from dalle_pytorch_tpu.models import init_decode_cache as j_init_cache
from dalle_pytorch_tpu.models.sampling import insert_decode_cache as j_insert
from dalle_pytorch_tpu.models.sampling import merge_decode_caches as j_merge
from dalle_pytorch_tpu.models.sampling import set_decode_offsets as j_set_offsets
from dalle_pytorch_tpu_torch.models.sampling import (
    init_decode_cache,
    insert_decode_cache,
    merge_decode_caches,
    set_decode_offsets,
)
from dalle_pytorch_tpu_torch.ops import paged_kv
from test_torch_dalle import PAGE, jax_pages, tiny_models  # noqa: F401

torch.set_num_threads(1)

# the split engine's chunk widths of a 7-position prompt (engine._next_chunk)
CHUNKINGS = {"monolithic": None, "chunk2": [2, 2, 3], "chunk3": [3, 4], "chunk7": [7]}
QUANTS = [None, "int8"]
LEAF_KEYS = ("cached_key_pages", "cached_value_pages", "cached_key_scale_pages",
             "cached_value_scale_pages", "page_table", "cache_index", "shift_hist",
             "shift_index")


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def _jcache(jmodel, params, b, kv_quant=None, offsets=True):
    """A JAX paged cache; with ``offsets`` every index per row (the
    engine's batched form), else the shift rings' scalar index (JAX's
    prefill form above batch 1)."""
    cache = j_init_cache(jmodel, params, b, cache_format="paged", kv_quant=kv_quant)
    return j_set_offsets(cache, jnp.zeros((b,), jnp.int32)) if offsets else cache


def port_leaves(cache):
    """{JAX cache leaf name: [per-layer numpy arrays]} of a port cache, in
    the JAX tree's leaf order (pools in the (rows, n_pages, page, feat)
    view, the sink page left out)."""
    rows = cache.kv[0].table.shape[0]
    view = lambda t: paged_kv.pool_view(t, rows).numpy()  # noqa: E731
    rings = (cache.attn_rings or []) + (cache.ff_rings or [])
    out = {
        "cached_key_pages": [view(kv.k) for kv in cache.kv],
        "cached_value_pages": [view(kv.v) for kv in cache.kv],
        "page_table": [kv.table.numpy() for kv in cache.kv],
        "cache_index": [kv.index.numpy() for kv in cache.kv],
        "shift_hist": [r.hist.numpy() for r in rings],
        "shift_index": [r.index.numpy() for r in rings],
    }
    if cache.kv[0].k_scale is not None:
        out["cached_key_scale_pages"] = [view(kv.k_scale) for kv in cache.kv]
        out["cached_value_scale_pages"] = [view(kv.v_scale) for kv in cache.kv]
    return out


def jax_leaves(jcache):
    out = {}
    for path, x in jax.tree_util.tree_leaves_with_path(jcache):
        out.setdefault(getattr(path[-1], "key", None), []).append(np.asarray(x))
    return {k: v for k, v in out.items() if k in LEAF_KEYS}


def to_jax(jcache, cache):
    """``jcache`` (a JAX cache of the same shape) holding ``cache``'s
    contents."""
    leaves = {k: iter(v) for k, v in port_leaves(cache).items()}

    def fn(path, x):
        key = getattr(path[-1], "key", None)
        return jnp.asarray(next(leaves[key])) if key in leaves else x

    return jax.tree_util.tree_map_with_path(fn, jcache)


def assert_caches_match(cache, jcache, atol=1e-5, what=""):
    ours, ref = port_leaves(cache), jax_leaves(jcache)
    assert sorted(ours) == sorted(ref), (sorted(ours), sorted(ref))
    for key in ref:
        assert len(ours[key]) == len(ref[key]), key
        for a, b in zip(ours[key], ref[key]):
            np.testing.assert_allclose(a, b, atol=atol, rtol=atol, err_msg=f"{key} {what}")


def random_cache(model, rows, kv_quant, seed, index=None):
    """A port cache of ``rows`` rows with random contents: pools, scale
    pools, per-row permuted page tables, indices (``index`` or random),
    ring histories and indices."""
    rng = np.random.RandomState(seed)
    cache = init_decode_cache(model, rows, "paged", kv_quant=kv_quant, page_size=PAGE)
    n_p = cache.n_pages
    idx = rng.randint(0, 20, size=rows) if index is None else np.asarray(index)
    for kv in cache.kv:
        for pool in kv.pools():
            if pool.dtype == torch.int8:
                pool.copy_(torch.from_numpy(rng.randint(-127, 128, size=pool.shape)))
            elif pool is kv.k_scale or pool is kv.v_scale:
                pool.copy_(torch.from_numpy(rng.uniform(0.005, 0.02, pool.shape)))
            else:
                pool.copy_(torch.from_numpy(rng.randn(*pool.shape)))
        perm = np.stack([r * n_p + rng.permutation(n_p) for r in range(rows)])
        kv.table = torch.from_numpy(perm.astype(np.int32))
        kv.index = torch.from_numpy(idx.astype(np.int32))
    for ring in cache.attn_rings + cache.ff_rings:
        ring.hist = torch.from_numpy(rng.randn(*ring.hist.shape).astype(np.float32))
        ring.index = torch.from_numpy(idx.astype(np.int32))
    return cache


def _prompts(model, b=2, seed=3):
    rng = np.random.RandomState(seed)
    return rng.randint(0, model.num_text_tokens_ext, size=(b, model.text_len_internal))


@pytest.mark.parametrize("name", list(CHUNKINGS))
def test_prefill_chunks_match_prefill_step_and_jax(jax_pages, models, name):  # noqa: F811
    jmodel, params, model = models
    prompts = _prompts(model)
    b, T = prompts.shape
    ref_cache = init_decode_cache(model, b, "paged", page_size=PAGE)
    ref = model.prefill_step(torch.from_numpy(prompts), ref_cache)
    widths = CHUNKINGS[name]
    jcache = _jcache(jmodel, params, b, offsets=False)
    if widths is None:  # one prefill_step, held against JAX's
        want, mut = jmodel.apply({"params": params, "cache": jcache}, jnp.asarray(prompts),
                                 method=JDALLE.prefill_step, mutable=["cache"])
        np.testing.assert_allclose(ref.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
        assert_caches_match(ref_cache, mut["cache"], what=name)
        return
    cache = init_decode_cache(model, b, "paged", page_size=PAGE)
    start = 0
    for c in widths:
        chunk = prompts[:, start:start + c]
        got = model.prefill_chunk(torch.from_numpy(chunk), start, cache)
        want, mut = jmodel.apply({"params": params, "cache": jcache}, jnp.asarray(chunk),
                                 jnp.int32(start), method=JDALLE.prefill_chunk,
                                 mutable=["cache"])
        jcache = mut["cache"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4,
                                   err_msg=f"chunk at {start}")
        start += c
    assert start == T
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
    assert_caches_match(cache, jcache, what=name)
    for key, ours in port_leaves(cache).items():
        for a, r in zip(ours, port_leaves(ref_cache)[key]):
            np.testing.assert_allclose(a, r, atol=1e-5, rtol=1e-5, err_msg=key)


def test_monolithic_prefill_matches_jax(jax_pages, models):  # noqa: F811
    jmodel, params, model = models
    prompts = _prompts(model)
    cache = init_decode_cache(model, 2, "paged", page_size=PAGE)
    got = model.prefill_step(torch.from_numpy(prompts), cache, image_only=True)
    want, mut = jmodel.apply({"params": params, "cache": _jcache(jmodel, params, 2,
                                                                 offsets=False)},
                             jnp.asarray(prompts), image_only=True,
                             method=JDALLE.prefill_step, mutable=["cache"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert_caches_match(cache, mut["cache"])


def test_intermediate_chunk_and_image_only_head(models):
    _, _, model = models
    prompts = torch.from_numpy(_prompts(model))
    ext = model.num_text_tokens_ext
    heads = {}
    for image_only in (False, True):
        cache = init_decode_cache(model, 2, "paged", page_size=PAGE)
        assert model.prefill_chunk(prompts[:, :3], 0, cache, return_logits=False) is None
        heads[image_only] = model.prefill_chunk(prompts[:, 3:], 3, cache,
                                                image_only=image_only)
    assert heads[True].shape == (2, model.num_image_tokens)
    torch.testing.assert_close(heads[True], heads[False][:, ext:], atol=0, rtol=0)
    cache = init_decode_cache(model, 2, "paged", page_size=PAGE)
    with pytest.raises(ValueError):  # the chunk does not end the prompt
        model.prefill_chunk(prompts[:, :3], 0, cache, image_only=True)


@pytest.mark.parametrize("kv_quant", QUANTS, ids=["none", "int8"])
@pytest.mark.parametrize("image_only", [False, True], ids=["full_head", "image_only"])
def test_vector_decode_step_matches_jax(jax_pages, models, kv_quant, image_only):  # noqa: F811
    """Rows at text position 3, the first image position 7 and image
    position 12 in one step."""
    jmodel, params, model = models
    pos = np.array([3, 7, 12])
    b = len(pos)
    if image_only:
        pos = np.array([7, 9, 12])  # image_only: every row predicts an image token
    cache = random_cache(model, b, kv_quant, seed=5, index=pos)
    jcache = to_jax(_jcache(jmodel, params, b, kv_quant), cache)
    rng = np.random.RandomState(6)
    tok = np.where(pos < model.text_len_internal,
                   rng.randint(0, model.num_text_tokens_ext, size=b),
                   rng.randint(0, model.num_image_tokens, size=b)).astype(np.int32)
    got = model.decode_step(torch.from_numpy(tok), torch.from_numpy(pos.astype(np.int32)),
                            cache, image_only=image_only)
    want, mut = jmodel.apply({"params": params, "cache": jcache}, jnp.asarray(tok),
                             jnp.asarray(pos, jnp.int32), image_only=image_only,
                             method=JDALLE.decode_step, mutable=["cache"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert_caches_match(cache, mut["cache"], what="after the step")
    np.testing.assert_array_equal(cache.kv[0].index.numpy(), pos + 1)


def test_vector_decode_step_needs_pages(models):
    _, _, model = models
    cache = init_decode_cache(model, 2, "flat")
    with pytest.raises(ValueError):
        model.decode_step(torch.zeros(2, dtype=torch.int32),
                          torch.tensor([3, 7], dtype=torch.int32), cache)


@pytest.mark.parametrize("kv_quant", QUANTS, ids=["none", "int8"])
def test_insert_decode_cache_matches_jax(jax_pages, models, kv_quant):  # noqa: F811
    jmodel, params, model = models
    batched, sub = random_cache(model, 3, kv_quant, 7), random_cache(model, 1, kv_quant, 8)
    jbatched = to_jax(_jcache(jmodel, params, 3, kv_quant), batched)
    jsub = to_jax(_jcache(jmodel, params, 1, kv_quant), sub)
    out = insert_decode_cache(batched, sub, 2)
    assert out is batched
    assert_caches_match(batched, j_insert(jbatched, jsub, 2), atol=0)


@pytest.mark.parametrize("kv_quant", QUANTS, ids=["none", "int8"])
def test_merge_decode_caches_matches_jax(jax_pages, models, kv_quant):  # noqa: F811
    jmodel, params, model = models
    caches = [random_cache(model, 1, kv_quant, 9), random_cache(model, 2, kv_quant, 10)]
    jcaches = [to_jax(_jcache(jmodel, params, c.kv[0].table.shape[0], kv_quant), c)
               for c in caches]
    merged = merge_decode_caches(caches)
    assert_caches_match(merged, j_merge(jcaches), atol=0)
    for kv in merged.kv:  # one zero sink page after the real ones
        assert all(p.shape[0] == 3 * merged.n_pages + 1 and not p[-1].any()
                   for p in kv.pools())


@pytest.mark.parametrize("kv_quant", QUANTS, ids=["none", "int8"])
def test_set_decode_offsets_matches_jax(jax_pages, models, kv_quant):  # noqa: F811
    jmodel, params, model = models
    cache = random_cache(model, 3, kv_quant, 11)
    jcache = to_jax(_jcache(jmodel, params, 3, kv_quant), cache)
    offsets = np.array([0, 5, 13], np.int32)
    assert set_decode_offsets(cache, torch.from_numpy(offsets)) is cache
    assert_caches_match(cache, j_set_offsets(jcache, jnp.asarray(offsets)), atol=0)
    with pytest.raises(ValueError):  # one offset per row
        set_decode_offsets(cache, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):  # per-row offsets need the paged format
        set_decode_offsets(init_decode_cache(model, 3, "flat"), torch.from_numpy(offsets))
