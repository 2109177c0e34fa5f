"""The port's prefix index (``serving/prefix_cache.py``) and its storage
pieces against the JAX package on the CPU, exact:

- the chain index: the same operation sequences through the port's
  ``PrefixCache`` and JAX's give the same digests, probes, refcounts,
  reclaimable counts, eviction order and stats; token verification
  rejects a colliding lookup (and the ``prefix_hash_collide`` drill);
  the dedup, underflow and arena asserts;
- ``paged_kv.copy_pages_`` / ``copy_pages_across_`` against JAX's
  ``copy_pages`` / ``copy_pages_across`` (rows past ``valid`` zeroed),
  and the arena rows of ``init_decode_cache`` (the sink page last; a
  slot row's reset never touches them; ``insert_decode_cache`` lands in
  a slot row of a pool with arena rows);
- the shift ring: ``shift_pad`` 0 is today's ring, and a widened ring
  gives the same block outputs and the same newest rows;
- ``PagePool.holders`` / ``release``, the new fault sites.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops import paged_kv as jpaged
from dalle_pytorch_tpu.serving import prefix_cache as jpc
from dalle_pytorch_tpu.serving.scheduler import PagePool as JPagePool
from dalle_pytorch_tpu.utils.faults import FAULTS as JFAULTS
from dalle_pytorch_tpu_torch.models.sampling import init_decode_cache, insert_decode_cache
from dalle_pytorch_tpu_torch.ops import paged_kv
from dalle_pytorch_tpu_torch.ops.layers import PreShiftToken, ShiftRing
from dalle_pytorch_tpu_torch.serving import prefix_cache as pc
from dalle_pytorch_tpu_torch.serving.scheduler import PagePool
from dalle_pytorch_tpu_torch.utils.faults import SITES, FaultRegistry
from test_torch_dalle import tiny_models

torch.set_num_threads(1)

PAGE = 4


def _toks(seed, n=11):
    return np.random.RandomState(seed).randint(0, 30, size=(n,))


def _pair(format_tag=b""):
    """The port's index and JAX's over the same arena ids."""
    return (pc.PrefixCache(range(100, 110), PAGE, format_tag=format_tag),
            jpc.PrefixCache(list(range(100, 110)), PAGE, format_tag=format_tag))


def _publish(cache, toks, now, ring="r", logits=None):
    """Insert a prompt's whole chain (the engine's publish, host side)."""
    parent = None
    for k, block in enumerate(pc.chain_blocks(toks, PAGE)):
        parent = cache.insert(parent, block, start=k * PAGE, page_id=cache.alloc_page(),
                              now=now, ring=ring, logits=logits)
    return parent


def _state(cache):
    return sorted((n.digest, n.parent, n.start, n.page_id, n.refcount, n.last_hit,
                   n.children, tuple(n.tokens)) for n in cache.nodes())


@pytest.mark.parametrize("tag", [b"", b"kv:int8:page4:float32,int8"], ids=["none", "int8"])
def test_chain_addressing_equals_jax(tag):
    toks = _toks(0)
    assert [list(b) for b in pc.chain_blocks(toks, PAGE)] == \
        [list(b) for b in jpc.chain_blocks(toks, PAGE)]
    assert pc.chain_root(tag) == jpc.chain_root(tag)
    parent = None
    for block in pc.chain_blocks(toks, PAGE):
        d = pc.chain_digest(parent, block, tag)
        assert d == jpc.chain_digest(parent, block, tag)
        parent = d
    # an even T: the last full block is the terminal
    assert [len(b) for b in pc.chain_blocks(_toks(0, 8), PAGE)] == [4, 4]


def test_operation_sequence_equals_jax():
    """Publish two prompts sharing one page, probe, acquire, release,
    evict: every node's state, the probes and the stats equal JAX's."""
    ours, theirs = _pair()
    a = _toks(1)
    b = a.copy()
    b[6] += 1  # shares block 0 (positions 0..3)
    c = _toks(2)
    for cache in (ours, theirs):
        _publish(cache, a, now=1.0)
        # b's chain: block 0 exists (dedup), blocks 1.. new
        existing = cache.match(b)
        parent = existing[-1]
        for k, block in enumerate(pc.chain_blocks(b, PAGE)[len(existing):], len(existing)):
            parent = cache.insert(parent, block, start=k * PAGE, page_id=cache.alloc_page(),
                                  now=2.0)
        _publish(cache, c, now=3.0, ring=None)
    assert _state(ours) == _state(theirs)
    for toks, now in ((a, 4.0), (b, 5.0), (c, 6.0), (_toks(3), 7.0)):
        got = [n.digest for n in ours.probe(toks, now)]
        want = [n.digest for n in theirs.probe(toks, now)]
        assert got == want
    hits = ours.probe(a, 8.0)
    ours.acquire(hits, 8.0)
    theirs.acquire(theirs.probe(a, 8.0), 8.0)
    assert ours.reclaimable_pages() == theirs.reclaimable_pages()
    order = []
    for cache in (ours, theirs):
        seq = []
        while (node := cache.evict_one()) is not None:
            seq.append(node.digest)
        order.append(seq)
    assert order[0] == order[1] and order[0]
    assert all(n.refcount == 1 for n in ours.nodes()) and len(ours) == len(hits)
    ours.release(hits)
    assert ours.reclaimable_pages() == len(ours)
    assert vars(ours.stats) == vars(theirs.stats)
    ours.verify_invariants()


def test_probe_verifies_tokens_and_collision_drill():
    ours, _ = _pair()
    a = _toks(4)
    _publish(ours, a, now=0.0)
    node = ours.nodes()[0]
    # a forged entry under the right digest: verification rejects it
    key = next(k for k, n in ours._nodes.items() if n.start == 0)
    ours._nodes[key].tokens = ours._nodes[key].tokens + 1
    assert ours.probe(a, 1.0) == [] and ours.stats.collisions == 1
    ours._nodes[key].tokens = ours._nodes[key].tokens - 1
    faults = FaultRegistry()
    drilled = pc.PrefixCache(range(10), PAGE, faults=faults)
    faults.arm("prefix_hash_collide", 1)
    assert drilled.probe(a, 0.0) == []  # empty index: the drill is not spent
    assert faults.fired.get("prefix_hash_collide") is None
    _publish(drilled, a, now=0.0)
    assert drilled.probe(a, 1.0) == [] and drilled.stats.collisions == 1
    assert faults.fired["prefix_hash_collide"] == 1
    assert len(drilled.probe(a, 2.0)) == len(pc.chain_blocks(a, PAGE))
    assert node.coverage == PAGE and node.valid == PAGE and node.resumable
    JFAULTS.reset()


def test_asserts_and_arena_accounting():
    ours, _ = _pair()
    a = _toks(5)
    last = _publish(ours, a, now=0.0, logits="l")
    with pytest.raises(AssertionError, match="dedup"):
        ours.insert(None, pc.chain_blocks(a, PAGE)[0], 0, 0, now=0.0)
    with pytest.raises(AssertionError, match="underflow"):
        ours.release([last])
    ours.upgrade(last, ring="new", logits="new")
    assert (last.ring, last.logits) == ("r", "l")  # never replaced
    assert ours.free_arena_pages == 10 - len(ours)
    while ours.alloc_page() is not None:
        pass
    assert ours.alloc_page() is None
    ours.return_page(109)
    assert ours.alloc_page() == 109


def test_copy_pages_equal_jax():
    rng = np.random.RandomState(0)
    rows, n_p, feat = 3, 4, 5
    src = rng.randn(rows * n_p, PAGE, feat).astype(np.float32)
    dst = rng.randn(2 * n_p, PAGE, feat).astype(np.float32)
    flat = lambda a: torch.from_numpy(np.concatenate([a, np.zeros((1, PAGE, feat), np.float32)]))  # noqa: E731
    s_ids, d_ids, valid = [9, 2, 5], [1, 6, 0], [4, 2, 0]
    want = jpaged.copy_pages_across(jnp.asarray(dst.reshape(2, n_p, PAGE, feat)),
                                    jnp.asarray(src.reshape(rows, n_p, PAGE, feat)),
                                    s_ids, d_ids, valid)
    got = flat(dst)
    paged_kv.copy_pages_across_(got, flat(src), s_ids, d_ids, valid)
    np.testing.assert_array_equal(paged_kv.pool_view(got, 2).numpy(), np.asarray(want))
    assert not got[-1].any()  # the sink untouched
    want = jpaged.copy_pages(jnp.asarray(src.reshape(rows, n_p, PAGE, feat)), [11], [0], [3])
    got = flat(src)
    paged_kv.copy_pages_(got, torch.tensor([11]), torch.tensor([0]), torch.tensor([3]))
    np.testing.assert_array_equal(paged_kv.pool_view(got, rows).numpy(), np.asarray(want))


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["none", "int8"])
def test_arena_rows_in_the_pools(kv_quant):
    _, _, model = tiny_models()
    cache = init_decode_cache(model, 2, "paged", kv_quant=kv_quant, page_size=PAGE,
                              arena_rows=3)
    n_p = cache.n_pages
    for kv in cache.kv:
        assert kv.table.shape == (2, n_p) and kv.index.shape == (2,)
        for pool in kv.pools():
            assert pool.shape[0] == 5 * n_p + 1
            assert paged_kv.storage_rows(pool, n_p) == 5
    for kv in cache.kv:
        for pool in kv.pools():
            pool.fill_(1)
    cache.reset_row_(1)
    for kv in cache.kv:
        for pool in kv.pools():
            assert not pool[n_p:2 * n_p].any()
            assert pool[2 * n_p:].all() and pool[:n_p].all()
    sub = init_decode_cache(model, 1, "paged", kv_quant=kv_quant, page_size=PAGE)
    for kv in sub.kv:
        for pool in kv.pools():
            pool.fill_(2)
        kv.index.fill_(7)
    insert_decode_cache(cache, sub, 0)
    for kv in cache.kv:
        assert kv.table[0].tolist() == list(range(n_p)) and int(kv.index[0]) == 7
        for pool in kv.pools():
            assert (pool[:n_p] == 2).all() and (pool[2 * n_p:-1] == 1).all()
    with pytest.raises(ValueError, match="arena"):
        init_decode_cache(model, 1, "flat", arena_rows=1)


def test_shift_pad_widens_the_ring_only():
    """A ring built with ``shift_pad`` rows more reads the same shifted
    inputs and keeps the same newest rows as today's; at 0 it is today's
    ring (``init_decode_cache``: R = image_fmap_size + 1)."""
    _, _, model = tiny_models()
    assert init_decode_cache(model, 2, "paged", page_size=PAGE).attn_rings[0].hist.shape[1] == 5
    f, d = 4, 8
    layer = PreShiftToken(torch.nn.Identity(), f, seq_len=6 + f * f)
    outs, rings = [], []
    for pad in (0, 3):
        ring = ShiftRing(hist=torch.zeros(2, f + 1 + pad, d), index=torch.zeros(2, dtype=torch.int32))
        out = []
        g = np.random.RandomState(1)
        for start, n in ((0, 4), (4, 3), (7, 1), (8, 1), (9, 2)):
            x = torch.from_numpy(g.randn(2, n, d).astype(np.float32))
            st = torch.full((2,), start, dtype=torch.int32)
            out.append(layer(x, ring=ring, block_len=torch.full((2,), n, dtype=torch.int32),
                             block_start=st))
        outs.append(torch.cat(out, 1))
        rings.append(ring)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(rings[0].hist, rings[1].hist[:, 3:])
    assert torch.equal(rings[0].index, rings[1].index)


def test_page_pool_holders_and_release_equal_jax():
    ours, theirs = PagePool(10), JPagePool(10)
    for pool in (ours, theirs):
        pool.alloc("r", 3)
        pool.alloc("__prefix__", 4)
        pool.release("__prefix__", 1)
    assert ours.holders() == theirs.holders() == {"r", "__prefix__"}
    assert ours.held("__prefix__") == theirs.held("__prefix__") == 3
    ours.release("__prefix__", 3)
    assert ours.holders() == {"r"} and ours.free == 7
    with pytest.raises(AssertionError):
        ours.release("r", 4)


def test_new_fault_sites_are_known():
    for site in ("prefix_hash_collide", "prefix_publish_fail", "spec_verify_abort"):
        assert site in SITES
        FaultRegistry().arm(site, 1)
