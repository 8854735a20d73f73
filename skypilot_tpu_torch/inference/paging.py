"""Host-side bookkeeping for the paged KV cache: page allocator +
radix prefix cache.

The engine's per-layer KV pool is ``[n_pages, n_kv_heads, page_size,
head_dim]`` on device; everything in this module is pure-Python loop-
thread state describing who owns which page.  Nothing here ever touches
a device array — page-table updates are host-side by design (the
``skytpu check`` one-sync-per-step contract), and the jitted gathers /
scatters in inference/engine.py consume the tables this module builds.

Ownership model (the invariant tests/test_serve_paged.py soaks):

- every page's refcount = (number of live slots whose page table
  references it) + (1 if a radix-cache node holds it);
- a page referenced by two live slots is ALWAYS a shared prefix page
  (both slots matched it through the radix cache) — slots never share
  the pages they write;
- pages are immutable once full: a prefix extension allocates fresh
  pages ("copy-on-extend" at page granularity degenerates to
  plain extension because matches are page-aligned and writes only
  land at positions past the match);
- freed-page count is conserved: free + referenced == n_pages - 1
  (page 0 is the trash page inactive slots scribble into).

Dtype-blindness: with ``kv_dtype='int8'`` the device pool becomes a
QuantPages pair — int8 payload of the same ``[n_pages, n_kv_heads,
page_size, head_dim]`` geometry plus a per-(page, head, position) f32
scale (inference/kv_quant.py) — but page IDENTITY is unchanged, so
nothing in this module knows or cares: the allocator, radix cache, and
refcount invariants operate on page indices, and the same page table
drives the quantized gather/scatter.  Keep it that way — a dtype
branch here would couple host bookkeeping to device layout.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

# Page 0 is reserved as the TRASH page: every page-table entry beyond a
# slot's reservation points here, so clamped/overrun device writes land
# somewhere harmless (never read at an unmasked position).
TRASH_PAGE = 0


class PagePool:
    """Free-list page allocator with refcounts (host loop thread only).

    Deterministic on purpose (LIFO free list, no clocks): two identical
    runs produce identical page tables, which keeps the engine's
    bit-identical-rerun tests meaningful with paging on.
    """

    def __init__(self, n_pages: int, page_size: int) -> None:
        if n_pages < 2:
            raise ValueError(
                f'kv page pool needs >= 2 pages (1 trash + 1 usable), '
                f'got {n_pages}')
        self.n_pages = n_pages
        self.page_size = page_size
        # LIFO stack of free page ids (1..n_pages-1; 0 is trash).
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._refs: List[int] = [0] * n_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages (refcount 1 each) or None — never a
        partial allocation (admission is all-or-nothing so a half-
        reserved request cannot deadlock the pool)."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def ref(self, pages: List[int]) -> None:
        for p in pages:
            assert self._refs[p] > 0, f'ref of free page {p}'
            self._refs[p] += 1

    def release(self, pages: List[int]) -> int:
        """Drop one reference per page; pages reaching zero return to
        the free list.  Returns how many were freed."""
        freed = 0
        for p in pages:
            assert self._refs[p] > 0, f'release of free page {p}'
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                freed += 1
        return freed

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def check_conserved(self) -> None:
        """Soak-test invariant: every non-trash page is either free or
        referenced, never both, and the counts add up."""
        free_set = set(self._free)
        assert len(free_set) == len(self._free), 'double-free'
        for p in range(1, self.n_pages):
            in_free = p in free_set
            assert (self._refs[p] == 0) == in_free, (
                f'page {p}: refs={self._refs[p]} free={in_free}')
        assert self.free_pages + self.used_pages == self.n_pages - 1


class _Node:
    __slots__ = ('key', 'page', 'children', 'parent', 'last_hit',
                 'digest')

    def __init__(self, key: Optional[Tuple[int, ...]], page: int,
                 parent: Optional['_Node']) -> None:
        self.key = key
        self.page = page
        self.children: Dict[Tuple[int, ...], '_Node'] = {}
        self.parent = parent
        self.last_hit = 0
        # Path digest: folds the parent's digest with this node's
        # token key, so the digest identifies the full PREFIX the node
        # spells, not just its last page.  Content-only (no pool page
        # ids, no clocks): two caches holding the same prefixes agree
        # byte-for-byte across processes.
        if parent is None:
            self.digest = 0
        else:
            self.digest = zlib.crc32(
                repr((parent.digest, key)).encode('ascii'))


class RadixCache:
    """Radix/prefix cache over the page pool, keyed on exact token
    content at page granularity.

    One trie node per cached page; a node's path from the root spells
    the token prefix whose KV the page holds.  Exact token tuples (not
    hashes) key the children map — Python hashes them under the hood
    and collisions can never alias two different prefixes.  LRU is a
    deterministic logical clock bumped on every match, so eviction
    order is reproducible in tests.
    """

    def __init__(self, pool: PagePool) -> None:
        self._pool = pool
        self._root = _Node(None, TRASH_PAGE, None)
        self._clock = 0
        self.nodes = 0
        # Rolling fingerprint of the RESIDENT prefix set: XOR of every
        # live node's path digest, updated O(1) on insert/evict.  Equal
        # caches expose equal fingerprints (XOR is order-free), so the
        # federated `skytpu_engine_prefix_fingerprint` gauge tells the
        # router which replicas hold the same hot prefixes.
        self.fingerprint = 0

    def _keys(self, tokens: List[int], n_pages: int):
        ps = self._pool.page_size
        for i in range(n_pages):
            yield tuple(tokens[i * ps:(i + 1) * ps])

    def match(self, tokens: List[int],
              max_pages: int) -> Tuple[int, List[int]]:
        """Longest cached page-aligned prefix of ``tokens`` (at most
        ``max_pages`` pages).  Takes one pool reference per matched
        page ON BEHALF OF THE CALLER — the matching slot releases them
        at retire exactly like the pages it owns."""
        self._clock += 1
        node, pages = self._root, []
        for key in self._keys(tokens, max_pages):
            child = node.children.get(key)
            if child is None:
                break
            child.last_hit = self._clock
            pages.append(child.page)
            node = child
        if pages:
            self._pool.ref(pages)
        return len(pages), pages

    def insert(self, tokens: List[int], pages: List[int]) -> int:
        """Record ``pages[i]`` as holding the KV of tokens
        ``[i*ps, (i+1)*ps)``.  Walks the trie, adding nodes only where
        missing (an existing node keeps ITS page — the caller's
        duplicate page is simply not adopted and frees at retire).
        Each adopted page gains one trie reference.  Returns the number
        of pages adopted."""
        self._clock += 1
        node, adopted = self._root, 0
        for i, key in enumerate(self._keys(tokens, len(pages))):
            child = node.children.get(key)
            if child is None:
                child = _Node(key, pages[i], node)
                node.children[key] = child
                self._pool.ref([pages[i]])
                self.nodes += 1
                self.fingerprint ^= child.digest
                adopted += 1
            child.last_hit = self._clock
            node = child
        return adopted

    def _evictable_leaves(self) -> List[_Node]:
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif self._pool.refcount(n.page) == 1:
                # Only the trie holds it: no live slot, safe to drop.
                out.append(n)
        return out

    def evict(self, n_pages: int) -> int:
        """LRU-evict up to ``n_pages`` cached pages (leaf nodes whose
        page no live slot references; evicting a leaf may expose its
        parent as the next candidate).  Returns pages actually freed.
        O(nodes) per eviction — fine at serving scale where evictions
        are rare; a heap is the upgrade path if they stop being."""
        freed = 0
        while freed < n_pages:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: (nd.last_hit, nd.page))
            del victim.parent.children[victim.key]
            self.nodes -= 1
            self.fingerprint ^= victim.digest
            freed += self._pool.release([victim.page])
        return freed
