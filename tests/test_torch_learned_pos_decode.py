"""Learned positions (``rotary_emb=False``) and ``stable`` through the
port's decode paths against the JAX package on the CPU, on the tiny
converted DALLE of test_torch_dalle.py (every leaf perturbed), float32,
both configurations of test_torch_learned_pos.py:

- ``decode_step`` at every position reproducing JAX's forward logits
  (atol 1e-4) on "4d" and "flat" (the unfused chain and the fused decode
  kernel's plain version, no rotary tables) and "paged";
- ``prefill_step`` equal to sequential ``decode_step`` (1e-5) and to
  JAX's ``prefill_step`` (1e-4); chunks 2-2-3 equal to one
  ``prefill_step`` (1e-5) and each chunk to JAX's ``prefill_chunk``
  (1e-4), every cache leaf within 1e-5 of JAX's;
- the vector ``decode_step`` against JAX's on a random paged cache
  (1e-4), and against each row's own scalar step over its batch-1 cache
  (1e-5, the JAX package's test_serving.py check);
- ``fused_step`` through test_torch_dalle.py's scripted iterations
  (logits 1e-4, cache leaves 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import DALLE as JDALLE
from dalle_pytorch_tpu.models import init_decode_cache as j_init_cache
from dalle_pytorch_tpu_torch.models.sampling import init_decode_cache, merge_decode_caches
from test_torch_dalle import PAGE, check_fused_step, jax_pages, tiny_models  # noqa: F401
from test_torch_generate import internal_sequence
from test_torch_learned_pos import CASES, _inputs
from test_torch_prefill_chunk import _jcache, assert_caches_match, random_cache, to_jax

torch.set_num_threads(1)

FORMATS = ("4d", "flat", "paged")
CHUNKS = (2, 2, 3)  # the split engine's chunk-2 widths of a 7-position prompt


@pytest.fixture(scope="module", params=list(CASES))
def models(request):
    return tiny_models(**CASES[request.param])


def _decode_all(model, fmt, ids, fused=None):
    cache = init_decode_cache(model, ids.shape[0], fmt, page_size=PAGE)
    out = [model.decode_step(torch.from_numpy(ids[:, i]), i, cache, fused_decode=fused)
           for i in range(ids.shape[1])]
    return torch.stack(out, 1).numpy(), cache


@pytest.mark.parametrize("fmt,fused", [("4d", False), ("4d", True), ("flat", False),
                                       ("flat", True), ("paged", None)],
                         ids=["4d", "4d_kernel", "flat", "flat_kernel", "paged"])
def test_decode_step_reproduces_forward(models, fmt, fused):
    jmodel, params, model = models
    text, _ = _inputs(model)
    ids = internal_sequence(model, text)
    image = ids[:, model.text_len_internal:]
    full = np.asarray(jmodel.apply({"params": params}, jnp.asarray(text),
                                   jnp.asarray(np.pad(image, ((0, 0), (0, 1))))))
    got, _ = _decode_all(model, fmt, ids, fused)
    np.testing.assert_allclose(got, full[:, :ids.shape[1]], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("fmt", FORMATS)
def test_prefill_equals_sequential_decode_and_jax(jax_pages, models, fmt):  # noqa: F811
    jmodel, params, model = models
    text, _ = _inputs(model)
    T = model.text_len_internal
    ids = internal_sequence(model, text)[:, :T]
    seq, seq_cache = _decode_all(model, fmt, ids)
    cache = init_decode_cache(model, 2, fmt, page_size=PAGE)
    full = model.prefill_step(torch.from_numpy(ids), cache)
    np.testing.assert_allclose(full.numpy(), seq[:, -1], atol=1e-5, rtol=1e-5)
    tok = torch.tensor([3, 11], dtype=torch.int32)
    after = [model.decode_step(tok, T, c) for c in (cache, seq_cache)]
    np.testing.assert_allclose(after[0].numpy(), after[1].numpy(), atol=1e-5, rtol=1e-5)
    jcache = j_init_cache(jmodel, params, 2, cache_format=fmt)
    ref, _ = jmodel.apply({"params": params, "cache": jcache}, jnp.asarray(ids),
                          method=JDALLE.prefill_step, mutable=["cache"])
    np.testing.assert_allclose(full.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_chunked_prefill_equals_monolithic_and_jax(jax_pages, models):  # noqa: F811
    jmodel, params, model = models
    text, _ = _inputs(model)
    prompts = internal_sequence(model, text)[:, :model.text_len_internal]
    mono_cache = init_decode_cache(model, 2, "paged", page_size=PAGE)
    mono = model.prefill_step(torch.from_numpy(prompts), mono_cache)
    cache = init_decode_cache(model, 2, "paged", page_size=PAGE)
    jcache = _jcache(jmodel, params, 2, offsets=False)
    start = 0
    for c in CHUNKS:
        chunk = prompts[:, start:start + c]
        got = model.prefill_chunk(torch.from_numpy(chunk), start, cache)
        want, mut = jmodel.apply({"params": params, "cache": jcache}, jnp.asarray(chunk),
                                 jnp.int32(start), method=JDALLE.prefill_chunk,
                                 mutable=["cache"])
        jcache = mut["cache"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4,
                                   err_msg=f"chunk at {start}")
        start += c
    np.testing.assert_allclose(got.numpy(), mono.numpy(), atol=1e-5, rtol=1e-5)
    assert_caches_match(cache, jcache)
    assert_caches_match(mono_cache, jcache)


@pytest.mark.parametrize("image_only", [False, True], ids=["full_head", "image_only"])
def test_vector_decode_step_matches_jax(jax_pages, models, image_only):  # noqa: F811
    """Rows at a text position, the first image position and an image
    position in one step (image_only: three image positions)."""
    jmodel, params, model = models
    pos = np.array([7, 9, 12] if image_only else [3, 7, 12])
    cache = random_cache(model, 3, None, seed=5, index=pos)
    jcache = to_jax(_jcache(jmodel, params, 3), cache)
    rng = np.random.RandomState(6)
    tok = np.where(pos < model.text_len_internal,
                   rng.randint(0, model.num_text_tokens_ext, size=3),
                   rng.randint(0, model.num_image_tokens, size=3)).astype(np.int32)
    got = model.decode_step(torch.from_numpy(tok), torch.from_numpy(pos.astype(np.int32)),
                            cache, image_only=image_only)
    want, mut = jmodel.apply({"params": params, "cache": jcache}, jnp.asarray(tok),
                             jnp.asarray(pos, jnp.int32), image_only=image_only,
                             method=JDALLE.decode_step, mutable=["cache"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert_caches_match(cache, mut["cache"], what="after the step")


def test_vector_decode_step_equals_each_rows_scalar_step(models):
    """Two rows replayed to positions 6 and 9 in batch-1 paged caches,
    merged: the vector step's rows equal each row's scalar step."""
    _, _, model = models
    text, _ = _inputs(model)
    ids = internal_sequence(model, text)
    offs = (6, 9)

    def replay(row, upto):
        cache = init_decode_cache(model, 1, "paged", page_size=PAGE)
        for i in range(upto):
            model.decode_step(torch.from_numpy(ids[row:row + 1, i]), i, cache)
        return cache

    merged = merge_decode_caches([replay(r, o) for r, o in enumerate(offs)])
    tok = torch.tensor([ids[r, o] for r, o in enumerate(offs)], dtype=torch.int32)
    vector = model.decode_step(tok, torch.tensor(offs, dtype=torch.int32), merged)
    for r, o in enumerate(offs):
        scalar = model.decode_step(tok[r:r + 1], o, replay(r, o))
        np.testing.assert_allclose(vector[r:r + 1].numpy(), scalar.numpy(), atol=1e-5, rtol=1e-5)


def test_fused_step_matches_jax(jax_pages, models):  # noqa: F811
    check_fused_step(*models)
