"""Content-addressed index over immutable, fully written KV pages: the
serving engine's cross-request prefix cache (counterpart of
``dalle_pytorch_tpu/serving/prefix_cache.py``, the port's own copy).

Templated traffic re-runs identical prompt prefixes. The global-id page
tables (``ops/paged_kv.py``) make reusing that work a table indirection:
this module indexes computed prompt pages by the hash chain of the token
ids they cover, and the engine maps hit pages into an admitted slot's
table read-only instead of recomputing them.

The index is host bookkeeping (numpy and hashlib, no tensors of its
own). Page content lives in ARENA rows of the engine's pools (rows past
the slot rows, reachable only through remapped table entries); this
module owns the arena's id space and the chain, the engine every device
copy and table write. The ring seam and the terminal logits are opaque
payloads (tensors on the device) that the engine captures at prefill
page boundaries and restores at a hit.

Chain addressing: the prompt's internal token row is cut into page-sized
blocks plus one terminal partial block ending at T; node k's digest is
``sha1(parent_digest || block_bytes)``, so two prompts share exactly the
nodes of their common page-aligned prefix. Every lookup VERIFIES the
stored tokens against the query before a page is mapped (the hash is an
address, not a proof); the ``prefix_hash_collide`` fault forges a lookup
so a collision's cold fallback can be tested.

Refcounts: ``node.refcount`` is the number of live slots mapping the
node's page, acquired and released symmetrically by the engine on every
termination path; a referenced node is never evicted; eviction is
leaf-first (an interior node's would orphan its descendants) and LRU by
``last_hit``. The index is its own eviction tier: unreferenced pages are
dropped to free budget before any running request is preempted.

Snapshots: ``snapshot_records`` gives the index's structure as JSON
records (the engine persists page bytes and payloads beside them,
``Engine.save_prefix_snapshot``), and ``verify_snapshot_records`` is the
mandatory check on load: every digest recomputed from its parent and its
stored tokens.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.faults import FaultRegistry

_ROOT = b"prefix-cache-root"


def chain_root(format_tag: bytes = b"") -> bytes:
    """The chain's root digest. A non-empty ``format_tag`` (the engine's
    KV storage format: quantization, page size, pool dtypes) salts it, so
    every digest addresses (format, tokens), the pair page content is a
    function of; the empty tag is the unquantized format's."""
    if not format_tag:
        return _ROOT
    return hashlib.sha1(_ROOT + format_tag).digest()


def chain_blocks(tokens: np.ndarray, page_size: int) -> List[np.ndarray]:
    """A prompt's internal token row cut into its chain blocks: full
    ``page_size`` blocks plus one terminal partial block ending at T
    (absent when T divides evenly). Block k covers positions
    [k * page_size, ...)."""
    t = np.asarray(tokens, np.int64).reshape(-1)
    return [t[i: i + page_size] for i in range(0, len(t), page_size)]


def _digest(parent: bytes, block: np.ndarray) -> bytes:
    return hashlib.sha1(parent + np.asarray(block, np.int64).tobytes()).digest()


def chain_digest(parent: Optional[bytes], block: np.ndarray,
                 format_tag: bytes = b"") -> bytes:
    """A node's digest from its parent's (None: the chain root, salted by
    ``format_tag``) and its token block."""
    return _digest(chain_root(format_tag) if parent is None else parent, block)


def snapshot_records(cache: "PrefixCache") -> List[dict]:
    """The index's JSON-able structure, parents before children (a
    parent's ``start`` is smaller, so a ``start`` sort is topological).
    The payloads (ring seams, terminal logits) are not here: the engine
    persists them beside the page bytes."""
    nodes = sorted(cache.nodes(), key=lambda n: (n.start, n.digest))
    return [
        {
            "digest": n.digest.hex(),
            "parent": None if n.parent is None else n.parent.hex(),
            "tokens": [int(t) for t in np.asarray(n.tokens).reshape(-1)],
            "start": int(n.start),
            "page_id": int(n.page_id),
            "has_ring": n.ring is not None,
            "has_logits": n.logits is not None,
        }
        for n in nodes
    ]


def verify_snapshot_records(records: List[dict], page_size: int,
                            format_tag: bytes = b"") -> Tuple[bool, str]:
    """Verify-on-load of persisted records: every digest recomputes from
    its parent's and its stored tokens, parents precede children, blocks
    fit the page, coverage continues the parent's, no node repeats.
    (ok, reason); any failure rejects the whole snapshot."""
    seen: Dict[str, dict] = {}
    for i, rec in enumerate(records):
        try:
            tokens = np.asarray(rec["tokens"], np.int64)
            start = int(rec["start"])
            digest = bytes.fromhex(rec["digest"])
            parent_hex = rec["parent"]
        except (KeyError, TypeError, ValueError) as e:
            return False, f"record {i}: malformed ({e})"
        if rec["digest"] in seen:
            return False, (f"record {i}: duplicate chain node (dedup-on-insert "
                           "would be violated at restore)")
        if not (0 < len(tokens) <= page_size):
            return False, (f"record {i}: block of {len(tokens)} tokens does not fit "
                           f"page size {page_size}")
        if parent_hex is None:
            parent_bytes = None
            if start != 0:
                return False, f"record {i}: root block at start {start}"
        else:
            parent = seen.get(parent_hex)
            if parent is None:
                return False, f"record {i}: parent {parent_hex[:12]} missing or out of order"
            parent_bytes = bytes.fromhex(parent_hex)
            expect = int(parent["start"]) + len(parent["tokens"])
            if start != expect:
                return False, (f"record {i}: start {start} not contiguous with parent "
                               f"coverage {expect}")
        if chain_digest(parent_bytes, tokens, format_tag) != digest:
            return False, (f"record {i}: stored digest does not recompute from its tokens "
                           "(corrupt block or forged address)")
        seen[rec["digest"]] = rec
    return True, "ok"


@dataclass
class PageNode:
    """One immutable, fully written KV page. ``page_id`` is its global
    arena page; ``valid`` the rows written (the page size but for the
    terminal block); ``ring`` the shift-ring seam at ``coverage`` (present
    when the publisher saw that boundary: what makes the node
    resumable); ``logits`` the terminal image logits (full-prompt nodes
    only: what lets a full hit draw its first token without a prefill)."""

    digest: bytes
    parent: Optional[bytes]
    tokens: np.ndarray
    start: int
    page_id: int
    ring: Any = None
    logits: Any = None
    refcount: int = 0
    last_hit: float = 0.0
    children: int = 0

    @property
    def coverage(self) -> int:
        return self.start + len(self.tokens)

    @property
    def valid(self) -> int:
        return len(self.tokens)

    @property
    def resumable(self) -> bool:
        """Prefill can resume from this node (or, with logits, decode
        start from it): it carries the ring seam at its coverage."""
        return self.ring is not None


@dataclass
class PrefixStats:
    hits: int = 0
    misses: int = 0
    collisions: int = 0
    published: int = 0
    deduped: int = 0
    evicted: int = 0
    publish_skips: int = 0


class PrefixCache:
    """See the module docstring. ``faults``: the registry whose
    ``prefix_hash_collide`` site a lookup consults (None: none)."""

    def __init__(self, arena_page_ids: Sequence[int], page_size: int,
                 format_tag: bytes = b"", faults: Optional[FaultRegistry] = None):
        assert page_size > 0, page_size
        self.page_size = page_size
        self.format_tag = format_tag
        self.faults = faults if faults is not None else FaultRegistry()
        self._root = chain_root(format_tag)
        self.arena_total = len(arena_page_ids)
        self._free_pages: List[int] = list(arena_page_ids)
        self._nodes: Dict[bytes, PageNode] = {}
        self.stats = PrefixStats()

    def __len__(self) -> int:
        return len(self._nodes)

    @property
    def free_arena_pages(self) -> int:
        return len(self._free_pages)

    def nodes(self) -> List[PageNode]:
        return list(self._nodes.values())

    def total_refs(self) -> int:
        return sum(n.refcount for n in self._nodes.values())

    # -------------------------------------------------------------- probe

    def _lookup_child(self, parent: bytes, block: np.ndarray) -> Optional[PageNode]:
        """The child by chain digest, then VERIFIED against the query's
        tokens. The ``prefix_hash_collide`` fault (consulted only on a
        non-empty index, so an armed drill is spent on a lookup that can
        forge) returns a node whose tokens do not match."""
        digest = _digest(parent, block)
        node = self._nodes.get(digest)
        if self._nodes and self.faults.take("prefix_hash_collide"):
            node = next(iter(self._nodes.values()))
            if np.array_equal(np.asarray(node.tokens, np.int64), np.asarray(block, np.int64)):
                node = PageNode(digest=digest, parent=parent,
                                tokens=np.asarray(block, np.int64) + 1,
                                start=node.start, page_id=node.page_id)
        if node is None:
            return None
        if not np.array_equal(np.asarray(node.tokens, np.int64), np.asarray(block, np.int64)):
            self.stats.collisions += 1
            return None
        return node

    def probe(self, tokens: np.ndarray, now: float, count: bool = True) -> List[PageNode]:
        """The verified matched prefix of the prompt's chain (possibly
        empty), ``last_hit`` touched on each node; takes no references.
        ``count=False`` skips the hit/miss tally (the engine counts one
        per admission)."""
        out: List[PageNode] = []
        parent = self._root
        for block in chain_blocks(tokens, self.page_size):
            node = self._lookup_child(parent, block)
            if node is None:
                break
            node.last_hit = now
            out.append(node)
            parent = node.digest
        if count:
            if out:
                self.stats.hits += 1
            else:
                self.stats.misses += 1
        return out

    def match(self, tokens: np.ndarray) -> List[PageNode]:
        """The probe's walk without tallies, recency or faults: the
        publish path's dedup check."""
        out: List[PageNode] = []
        parent = self._root
        for block in chain_blocks(tokens, self.page_size):
            node = self._nodes.get(_digest(parent, block))
            if node is None or not np.array_equal(
                np.asarray(node.tokens, np.int64), np.asarray(block, np.int64)
            ):
                break
            out.append(node)
            parent = node.digest
        return out

    # ---------------------------------------------------------- refcounts

    def acquire(self, nodes: Sequence[PageNode], now: float) -> None:
        for n in nodes:
            assert n.digest in self._nodes, "acquire of evicted node"
            n.refcount += 1
            n.last_hit = now

    def release(self, nodes: Sequence[PageNode]) -> None:
        for n in nodes:
            assert n.refcount > 0, f"refcount underflow for node at {n.start}"
            n.refcount -= 1

    # ------------------------------------------------------------ publish

    def alloc_page(self) -> Optional[int]:
        """A free arena page id; None when the arena is exhausted."""
        return self._free_pages.pop() if self._free_pages else None

    def return_page(self, page_id: int) -> None:
        """Give back a page allocated but never committed."""
        self._free_pages.append(page_id)

    def insert(self, parent: Optional[PageNode], block: np.ndarray, start: int,
               page_id: int, now: float, ring: Any = None, logits: Any = None) -> PageNode:
        """Commit one published page (the caller probes first: inserting
        an existing chain position is a bug)."""
        parent_digest = self._root if parent is None else parent.digest
        digest = _digest(parent_digest, block)
        assert digest not in self._nodes, "dedup-on-insert violated"
        node = PageNode(
            digest=digest, parent=None if parent is None else parent.digest,
            tokens=np.asarray(block, np.int64).copy(), start=start, page_id=page_id,
            ring=ring, logits=logits, last_hit=now,
        )
        self._nodes[digest] = node
        if parent is not None:
            parent.children += 1
        self.stats.published += 1
        return node

    def upgrade(self, node: PageNode, ring: Any = None, logits: Any = None) -> None:
        """Add payloads an earlier publisher did not observe (content is
        identical by addressing); never replaces one."""
        if ring is not None and node.ring is None:
            node.ring = ring
        if logits is not None and node.logits is None:
            node.logits = logits

    def reclaimable_pages(self) -> int:
        """Pages the leaf-first LRU eviction could free now: the nodes of
        wholly unreferenced subtrees (a reference pins its ancestors)."""
        pinned: set = set()
        for n in self._nodes.values():
            if n.refcount > 0:
                d: Optional[bytes] = n.digest
                while d is not None and d not in pinned:
                    pinned.add(d)
                    node = self._nodes.get(d)
                    d = node.parent if node is not None else None
        return len(self._nodes) - len(pinned)

    # ------------------------------------------------------------- evict

    def evictable(self) -> List[PageNode]:
        """Unreferenced leaves, least recently hit first."""
        return sorted((n for n in self._nodes.values()
                       if n.refcount == 0 and n.children == 0),
                      key=lambda n: n.last_hit)

    def evict_one(self) -> Optional[PageNode]:
        """Drop the LRU unreferenced leaf and return it (the engine gives
        its page back to the budget); None when nothing is evictable."""
        cands = self.evictable()
        if not cands:
            return None
        node = cands[0]
        del self._nodes[node.digest]
        if node.parent is not None and node.parent in self._nodes:
            self._nodes[node.parent].children -= 1
        self._free_pages.append(node.page_id)
        self.stats.evicted += 1
        return node

    # -------------------------------------------------------- invariants

    def verify_invariants(self) -> None:
        """Every node owns a distinct arena page and held + free pages are
        the arena; every non-root parent is indexed; child counts hold."""
        held = [n.page_id for n in self._nodes.values()]
        assert len(held) == len(set(held)), "node pages alias"
        assert len(held) + len(self._free_pages) == self.arena_total, (
            f"arena leak: {len(held)} held + {len(self._free_pages)} free "
            f"!= {self.arena_total}"
        )
        kids: Dict[bytes, int] = {}
        for n in self._nodes.values():
            assert n.refcount >= 0, "negative refcount"
            if n.parent is not None:
                assert n.parent in self._nodes, "orphaned chain node"
                kids[n.parent] = kids.get(n.parent, 0) + 1
        for n in self._nodes.values():
            assert n.children == kids.get(n.digest, 0), "child count drift"
