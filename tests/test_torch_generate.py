"""Generation outside the engine against the JAX package on the CPU, on
converted weights (every leaf perturbed), float32:

- the cache format policy (``kv_policy.choose_cache_format``) equals
  JAX's with no environment override, and bad values raise typed errors;
- ``DALLE.decode_step`` logits at every position (with a text key mask)
  equal JAX's ``decode_step`` for the "4d", "flat" and "paged" formats,
  with ``fused_decode`` on and off (JAX's fused kernel in interpret mode
  behind its flag), and the dense caches equal JAX's; to atol 1e-4;
- ``prefill_step`` equals sequential ``decode_step`` calls and JAX's
  ``prefill_step``; the windowed scan equals the full one; the
  image-only head equals the full head's ``[ext:]``;
- greedy (``filter_thres=1.0``, k = 1, so the port's draw cannot differ
  from JAX's threefry one) tokens of ``generate_image_tokens`` (with and
  without priming), ``generate_texts`` (with and without a prompt) and
  ``generate_images`` (pixels and CLIP scores to atol 1e-4) equal JAX's;
- a dispatch spy: the port's fused kernel wrapper is called exactly when
  JAX's gate calls its kernel, including never under the default window
  at a sequence of 257 positions (L - 1 a multiple of 128, as the
  flagship's 1281), and the sparse cycle's non-"full" layers decode
  unfused;
- the token-shift ring at one position for the whole batch (the dense
  cache's decode) equals the whole-sequence shift.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import DALLE as JDALLE
from dalle_pytorch_tpu.models import sampling as jsampling
from dalle_pytorch_tpu.models.clip import CLIP as JCLIP
from dalle_pytorch_tpu.models.vae import DiscreteVAE as JVAE
from dalle_pytorch_tpu.ops import decode_attention as jdk
from dalle_pytorch_tpu.ops import kv_policy as jkv_policy
from dalle_pytorch_tpu_torch.convert import clip_state_dict, dalle_state_dict, vae_state_dict
from dalle_pytorch_tpu_torch.models import sampling
from dalle_pytorch_tpu_torch.models.clip import CLIP
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
from dalle_pytorch_tpu_torch.ops import attention as attention_mod
from dalle_pytorch_tpu_torch.ops import kv_policy
from dalle_pytorch_tpu_torch.ops.layers import PreShiftToken, ShiftRing

torch.set_num_threads(1)

PAGE = 4
FORMATS = ("4d", "flat", "paged")
# dim_head 64 and 2 heads: JAX's fused kernel takes the "full" layers
CONFIG = dict(dim=64, depth=2, num_text_tokens=16, text_seq_len=6, num_image_tokens=20,
              image_fmap_size=4, heads=2, dim_head=64)
# 112 text + a 12 x 12 grid: L = 257, whose last window is 256 rows
LONG = dict(CONFIG, dim=32, depth=1, text_seq_len=112, image_fmap_size=12)
SPARSE = dict(CONFIG, depth=4, attn_types=("full", "axial_row", "axial_col", "conv_like"))
VAE_CFG = dict(image_size=16, num_layers=2, num_resnet_blocks=1, hidden_dim=8,
               num_tokens=20, codebook_dim=8)
CLIP_CFG = dict(dim_text=16, dim_image=16, dim_latent=16, num_text_tokens=16,
                text_enc_depth=1, text_seq_len=6, text_heads=2, text_dim_head=8,
                visual_enc_depth=1, visual_heads=2, visual_dim_head=8,
                visual_image_size=16, visual_patch_size=4)


def perturbed(params, seed):
    """Every leaf scaled and shifted by seeded noise (unit LayerNorms and
    0.1 LayerScales would hide swapped or mis-transposed weights)."""
    rng = np.random.RandomState(seed)
    noise = lambda a: np.asarray(rng.randn(*np.shape(a)), np.float32)  # noqa: E731
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1 + 0.2 * noise(a)) + 0.02 * noise(a), params)


def models(config=CONFIG, seed=0):
    """(JAX DALLE, its perturbed params, the converted port DALLE)."""
    jmodel = JDALLE(**config)
    params = perturbed(jmodel.init(
        jax.random.key(seed), jnp.ones((1, config["text_seq_len"]), jnp.int32),
        jnp.zeros((1, config["image_fmap_size"] ** 2), jnp.int32))["params"], seed)
    model = DALLE(**config, device="cpu", dtype=torch.float32)
    model.load_state_dict(dalle_state_dict(params))
    return jmodel, params, model


def prompts(model, b=2, seed=1):
    """(b, text_seq_len) raw ids with zero tails of two lengths, and the
    text key mask text != 0."""
    text = np.random.RandomState(seed).randint(1, model.num_text_tokens,
                                               size=(b, model.text_seq_len))
    text[0, -2:] = 0
    text[1 % b, model.text_seq_len // 2:] = 0
    return text, text != 0


@pytest.fixture
def jax_pages(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))
    monkeypatch.delenv("DALLE_TPU_KV_FORMAT", raising=False)
    monkeypatch.delenv("DALLE_TPU_FLAT_KV", raising=False)


@pytest.fixture
def spies(monkeypatch):
    """Counters of calls to JAX's fused kernel (its flag on) and to the
    port's wrapper, each passing through to the real function."""
    calls = {"jax": 0, "port": 0}

    def spy(name, real):
        def fn(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return fn

    monkeypatch.setattr(jdk, "FUSED_DECODE_ENABLED", True)
    monkeypatch.setattr(jdk, "fused_decode_attention", spy("jax", jdk.fused_decode_attention))
    monkeypatch.setattr(attention_mod, "fused_decode_attention",
                        spy("port", attention_mod.fused_decode_attention))
    return calls


def internal_sequence(model, text, seed=2):
    """The internal [<bos>, text, image] ids of ``text`` and seeded image
    tokens, (b, total_seq_len)."""
    image = np.random.RandomState(seed).randint(0, model.num_image_tokens,
                                                size=(text.shape[0], model.image_seq_len))
    remapped = model.remap_text(torch.from_numpy(text)).numpy()
    return np.concatenate((remapped, image), axis=1)[:, :model.total_seq_len].astype(np.int32)


def jax_decode(jmodel, params, fmt, ids, mask, fused, monkeypatch):
    """JAX ``decode_step`` at every position: (logits (b, n, vocab), the
    final cache)."""
    monkeypatch.setattr(jdk, "FUSED_DECODE_ENABLED", fused)
    cache = jsampling.init_decode_cache(jmodel, params, ids.shape[0], cache_format=fmt)
    out = []
    for i in range(ids.shape[1]):
        logits, mut = jmodel.apply(
            {"params": params, "cache": cache}, jnp.asarray(ids[:, i]), jnp.array(i, jnp.int32),
            None if mask is None else jnp.asarray(mask),
            method=JDALLE.decode_step, mutable=["cache"])
        cache = mut["cache"]
        out.append(np.asarray(logits))
    return np.stack(out, 1), cache


def port_decode(model, fmt, ids, mask, fused, **kw):
    cache = sampling.init_decode_cache(model, ids.shape[0], fmt, page_size=PAGE)
    tmask = None if mask is None else torch.from_numpy(mask)
    out = [model.decode_step(torch.from_numpy(ids[:, i]), i, cache, tmask,
                             fused_decode=fused, **kw) for i in range(ids.shape[1])]
    return torch.stack(out, 1).numpy(), cache


def test_choose_cache_format_matches_jax(monkeypatch):
    monkeypatch.delenv("DALLE_TPU_KV_FORMAT", raising=False)
    monkeypatch.delenv("DALLE_TPU_FLAT_KV", raising=False)
    for b in range(1, 33):
        assert kv_policy.choose_cache_format(b) == jkv_policy.choose_cache_format(b), b
        for fmt in FORMATS:
            assert kv_policy.resolve_format(fmt, b) == jkv_policy.resolve_format(fmt, b)
    assert kv_policy.FORMATS == jkv_policy.FORMATS


def test_bad_formats_raise_typed_errors():
    model = DALLE(**CONFIG, device="cpu")
    with pytest.raises(kv_policy.InvalidKVFormatError):
        kv_policy.resolve_format("2d", 1)
    with pytest.raises(kv_policy.InvalidKVFormatError):
        sampling.init_decode_cache(model, 1, "2d")
    with pytest.raises(kv_policy.InvalidKVFormatError):
        sampling.init_decode_cache(model, 2, "paged", kv_quant="fp8")
    tokens = torch.zeros((1, model.text_len_internal + model.image_seq_len), dtype=torch.int32)
    with pytest.raises(kv_policy.InvalidKVFormatError):
        sampling.decode_tokens(model, tokens, 1, 0, cache_format="flat8")
    with pytest.raises(ValueError):  # int8 storage is paged-only
        sampling.init_decode_cache(model, 8, kv_quant="int8")
    with pytest.raises(ValueError):
        sampling.decode_tokens(model, tokens, 1, 0, window_seg=-1)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_step_logits_match_jax(jax_pages, monkeypatch, fmt, fused):
    jmodel, params, model = models()
    text, mask = prompts(model)
    ids = internal_sequence(model, text)
    ref, jcache = jax_decode(jmodel, params, fmt, ids, mask, fused, monkeypatch)
    got, cache = port_decode(model, fmt, ids, mask, fused)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    if fmt != "paged":
        leaves = {getattr(p[-1], "key", None): [] for p, _ in
                  jax.tree_util.tree_leaves_with_path(jcache)}
        for p, x in jax.tree_util.tree_leaves_with_path(jcache):
            leaves[getattr(p[-1], "key", None)].append(np.asarray(x))
        for name, part in (("cached_key", "k"), ("cached_value", "v")):
            for kv, want in zip(cache.kv, leaves[name]):
                got_kv = kv.tagged(getattr(kv, part)).numpy()
                assert got_kv.shape == want.shape
                np.testing.assert_allclose(got_kv, want, atol=1e-5, rtol=1e-5)
        assert all(kv.index == int(i) for kv, i in zip(cache.kv, leaves["cache_index"]))


@pytest.mark.parametrize("fmt", FORMATS)
def test_prefill_equals_sequential_decode(jax_pages, fmt):
    """``prefill_step`` over the whole prompt against T ``decode_step``
    calls (logits, and the caches through a following decode step) and
    JAX's ``prefill_step``."""
    jmodel, params, model = models()
    text, mask = prompts(model)
    ids = internal_sequence(model, text)
    T = model.text_len_internal
    tmask = torch.from_numpy(mask)
    seq, seq_cache = port_decode(model, fmt, ids[:, :T], mask, False)
    cache = sampling.init_decode_cache(model, 2, fmt, page_size=PAGE)
    full = model.prefill_step(torch.from_numpy(ids[:, :T]), cache, tmask)
    np.testing.assert_allclose(full.numpy(), seq[:, -1], atol=1e-5, rtol=1e-5)
    image_only = model.prefill_step(torch.from_numpy(ids[:, :T]),
                                    sampling.init_decode_cache(model, 2, fmt, page_size=PAGE),
                                    tmask, image_only=True)
    np.testing.assert_allclose(image_only.numpy(), full[:, model.num_text_tokens_ext:].numpy(),
                               atol=1e-6, rtol=0)
    tok = torch.from_numpy(ids[:, T])
    after = [model.decode_step(tok, T, c, tmask) for c in (cache, seq_cache)]
    np.testing.assert_allclose(after[0].numpy(), after[1].numpy(), atol=1e-5, rtol=1e-5)
    jcache = jsampling.init_decode_cache(jmodel, params, 2, cache_format=fmt)
    ref, _ = jmodel.apply({"params": params, "cache": jcache}, jnp.asarray(ids[:, :T]),
                          jnp.asarray(mask), method=JDALLE.prefill_step, mutable=["cache"])
    np.testing.assert_allclose(full.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_image_only_head_equals_full_head():
    _, _, model = models()
    text, mask = prompts(model)
    ids = internal_sequence(model, text)
    T, ext = model.text_len_internal, model.num_text_tokens_ext
    for fmt in FORMATS:
        caches = [sampling.init_decode_cache(model, 2, fmt, page_size=PAGE) for _ in range(2)]
        for c in caches:
            model.prefill_step(torch.from_numpy(ids[:, :T]), c)
        for i in range(T, model.total_seq_len):
            tok = torch.from_numpy(ids[:, i])
            full = model.decode_step(tok, i, caches[0])
            img = model.decode_step(tok, i, caches[1], image_only=True)
            np.testing.assert_allclose(img.numpy(), full[:, ext:].numpy(), atol=1e-6, rtol=0)


def test_windowed_scan_equals_full(jax_pages):
    """A sequence of 257 positions in windows of 64 steps (sweep extents
    128, 128, 257 rows... as JAX's segmented scan sizes its caches) against
    one unwindowed scan, the dense formats; and JAX's windowed tokens."""
    jmodel, params, model = models(LONG)
    text, _ = prompts(model)
    runs = {(fmt, seg): sampling.generate_image_tokens(
        model, torch.from_numpy(text), 0, filter_thres=1.0, cache_format=fmt, window_seg=seg)
        for fmt in ("4d", "flat") for seg in (64, 0)}
    ref = np.asarray(jsampling.generate_image_tokens(
        jmodel, params, jnp.asarray(text), jax.random.key(0), filter_thres=1.0,
        cache_format="4d", window_seg=64))
    for key, got in runs.items():
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(key))
    # logits at every position through a 128-row window equal the full sweep
    ids = internal_sequence(model, text)[:, :128]
    caches = [sampling.init_decode_cache(model, 2, "flat") for _ in range(2)]
    caches[1].set_window(128)
    for i in range(ids.shape[1]):
        tok = torch.from_numpy(ids[:, i])
        a, b = (model.decode_step(tok, i, c) for c in caches)
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def image_refs():
    """JAX's greedy image tokens of one model and two prompts per format
    (batch 2's default is "paged"), and with 5 priming tokens."""
    jmodel, params, model = models()
    text, _ = prompts(model)
    key = jax.random.key(0)
    prime = np.random.RandomState(3).randint(0, model.num_image_tokens, size=(2, 5))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))
        refs = {fmt: np.asarray(jsampling.generate_image_tokens(
            jmodel, params, jnp.asarray(text), key, filter_thres=1.0, cache_format=fmt))
            for fmt in FORMATS}
        refs["prime"] = np.asarray(jsampling.generate_image_tokens(
            jmodel, params, jnp.asarray(text), key, filter_thres=1.0,
            prime_tokens=jnp.asarray(prime)))
    return model, text, prime, refs


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_generate_image_tokens_match_jax(image_refs, fmt, fused):
    model, text, prime, refs = image_refs
    for seed in (0, 7):  # greedy: the seed does not matter
        got = sampling.generate_image_tokens(model, torch.from_numpy(text), seed,
                                             filter_thres=1.0, cache_format=fmt,
                                             fused_decode=fused, window_seg=0, page_size=PAGE)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), refs[fmt])
    primed = sampling.generate_image_tokens(model, torch.from_numpy(text), 0, filter_thres=1.0,
                                            prime_tokens=torch.from_numpy(prime),
                                            cache_format=fmt, fused_decode=fused,
                                            page_size=PAGE)
    np.testing.assert_array_equal(primed.numpy(), refs["prime"])
    np.testing.assert_array_equal(primed.numpy()[:, :5], prime)
    with pytest.raises(ValueError):
        sampling.generate_image_tokens(model, torch.from_numpy(text), 0,
                                       prime_tokens=torch.zeros((2, 16), dtype=torch.int32))


def test_sampled_tokens_are_seeded_and_in_range():
    """Top-k 0.5 at temperature 1: rows draw from their own seed, the same
    seed twice gives the same tokens, and every token is an image id."""
    _, _, model = models()
    text, _ = prompts(model)
    a, b = (sampling.generate_image_tokens(model, torch.from_numpy(text), 5) for _ in range(2))
    c = sampling.generate_image_tokens(model, torch.from_numpy(text), 6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert ((a >= 0) & (a < model.num_image_tokens)).all()


@pytest.fixture(scope="module")
def text_refs():
    jmodel, params, model = models(seed=4)
    prompt = np.concatenate((np.zeros((2, 1), np.int32), np.random.RandomState(5).randint(
        1, model.num_text_tokens, size=(2, 3)).astype(np.int32)), axis=1)
    key = jax.random.key(1)
    refs = {None: np.asarray(jsampling.generate_texts(jmodel, params, key,
                                                      filter_thres=1.0)[0]),
            "prompt": np.asarray(jsampling.generate_texts(
                jmodel, params, key, jnp.asarray(prompt), filter_thres=1.0)[0])}
    return model, prompt, refs


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_generate_texts_match_jax(text_refs, fmt, fused):
    model, prompt, refs = text_refs
    got = sampling.generate_texts(model, 0, filter_thres=1.0, cache_format=fmt,
                                  fused_decode=fused, page_size=PAGE)
    assert got.shape == (1, model.text_seq_len)
    np.testing.assert_array_equal(got.numpy(), refs[None])
    got = sampling.generate_texts(model, 0, torch.from_numpy(prompt), filter_thres=1.0,
                                  cache_format=fmt, fused_decode=fused, page_size=PAGE)
    np.testing.assert_array_equal(got.numpy(), refs["prompt"])


@pytest.fixture(scope="module")
def images_refs():
    """JAX's generate_images with VAE priming and CLIP scores."""
    jmodel, params, model = models(seed=6)
    text, _ = prompts(model, seed=7)
    jvae = JVAE(**VAE_CFG)
    vparams = perturbed(jvae.init({"params": jax.random.key(8), "gumbel": jax.random.key(9)},
                                  jnp.zeros((1, 16, 16, 3)))["params"], 8)
    vae = DiscreteVAE(**VAE_CFG, device="cpu")
    vae.load_state_dict(vae_state_dict(vparams))
    jclip = JCLIP(**CLIP_CFG)
    cparams = perturbed(jclip.init(jax.random.key(10), jnp.ones((1, 6), jnp.int32),
                                   jnp.zeros((1, 16, 16, 3)))["params"], 10)
    clip = CLIP(**CLIP_CFG, device="cpu")
    clip.load_state_dict(clip_state_dict(cparams))
    img = np.random.RandomState(11).rand(2, 16, 16, 3).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))
        images, scores = jsampling.generate_images(
            jmodel, params, jvae, {"params": vparams}, jnp.asarray(text), jax.random.key(2),
            clip=jclip, clip_variables={"params": cparams}, filter_thres=1.0,
            img=jnp.asarray(img))
    return model, vae, clip, text, img, np.asarray(images), np.asarray(scores)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_generate_images_match_jax(images_refs, fmt, fused):
    model, vae, clip, text, img, ref_images, ref_scores = images_refs
    images, scores = sampling.generate_images(
        model, vae, torch.from_numpy(text), 0, clip=clip, filter_thres=1.0,
        img=torch.from_numpy(img), cache_format=fmt, fused_decode=fused, window_seg=0,
        page_size=PAGE)
    assert images.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(images.numpy(), ref_images, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(scores.numpy(), ref_scores, atol=1e-4, rtol=1e-4)


def test_dispatch_matches_jax_gate_step_by_step(jax_pages, monkeypatch, spies):
    """Eager decode steps: JAX's kernel and the port's wrapper are called
    the same number of times, depth x positions on the dense formats (the
    JAX flag and ``fused_decode`` on) and never on the paged one."""
    jmodel, params, model = models()
    text, mask = prompts(model)
    ids = internal_sequence(model, text)
    for fmt in FORMATS:
        spies.update(jax=0, port=0)
        jax_decode(jmodel, params, fmt, ids, mask, True, monkeypatch)
        port_decode(model, fmt, ids, mask, True)
        want = 0 if fmt == "paged" else model.depth * ids.shape[1]
        assert spies == {"jax": want, "port": want}, fmt
    spies.update(jax=0, port=0)
    port_decode(model, "4d", ids, mask, False)
    assert spies["port"] == 0


def test_dispatch_under_the_window_matches_jax(jax_pages, spies):
    """L = 257: the default window's last extent is 256 rows, so neither
    JAX's generation nor the port's ever calls the fused kernel; with
    ``window_seg=0`` both do, the port once a layer and decode step."""
    jmodel, params, model = models(LONG)
    text, _ = prompts(model)
    jtext = jnp.asarray(text)
    for seg, fused_expected in ((None, False), (0, True)):
        spies.update(jax=0, port=0)
        ref = np.asarray(jsampling.generate_image_tokens(
            jmodel, params, jtext, jax.random.key(0), filter_thres=1.0, cache_format="4d",
            window_seg=seg))
        got = sampling.generate_image_tokens(model, torch.from_numpy(text), 0,
                                             filter_thres=1.0, cache_format="4d",
                                             window_seg=seg, fused_decode=True)
        np.testing.assert_array_equal(got.numpy(), ref)
        steps = model.image_seq_len - 1
        assert (spies["jax"] > 0) == fused_expected
        assert spies["port"] == (model.depth * steps if fused_expected else 0)


def test_sparse_cycle_decodes_its_other_types_unfused(jax_pages, monkeypatch, spies):
    """The four-type cycle on the dense cache: only the "full" layer takes
    the fused kernel (in JAX and in the port), the others the unfused
    chain; logits equal JAX's at every position."""
    jmodel, params, model = models(SPARSE)
    text, mask = prompts(model)
    ids = internal_sequence(model, text)
    ref, _ = jax_decode(jmodel, params, "4d", ids, mask, True, monkeypatch)
    got, _ = port_decode(model, "4d", ids, mask, True)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    full = sum(t == "full" for t in model.transformer.attn_types)
    assert full == 1
    assert spies == {"jax": full * ids.shape[1], "port": full * ids.shape[1]}


def test_shift_ring_at_one_position_equals_whole_sequence_shift():
    """The token-shift ring driven one position at a time for the whole
    batch (block_start broadcast), after a prefill block, gives the
    whole-sequence shift at every position."""
    torch.manual_seed(0)
    f, text_len, dim, b = 4, 7, 8, 3
    seq_len = text_len - 1 + f * f
    shift = PreShiftToken(torch.nn.Identity(), f, seq_len)
    x = torch.randn(b, seq_len, dim)
    want = shift(x)
    ring = ShiftRing(torch.zeros(b, f + 1, dim), torch.zeros(b, dtype=torch.int32))
    full = lambda v: torch.full((b,), v, dtype=torch.int32)  # noqa: E731
    got = [shift(x[:, :text_len], ring=ring, block_len=full(text_len), block_start=full(0))]
    for p in range(text_len, seq_len):
        got.append(shift(x[:, p:p + 1], ring=ring, block_len=full(1), block_start=full(p)))
    torch.testing.assert_close(torch.cat(got, 1), want, atol=0, rtol=0)
