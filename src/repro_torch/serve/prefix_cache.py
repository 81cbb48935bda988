"""Radix prefix cache over the paged KV pool (the port's copy of
``repro.serve.prefix_cache``: host-side, unchanged).

Production traffic is dominated by shared prompt prefixes (system prompts,
few-shot headers). The page pool makes vLLM-style dedup natural: this module
indexes **resident** KV pages by the token run they hold, so a hot-prefix
admission becomes a page-table splice (``KVPool.attach``) plus a short tail
prefill instead of a full prompt forward.

Granularity is one **full page**: a node caches exactly ``page_size`` tokens
worth of KV, keyed by that token chunk, and a child's meaning depends on its
whole ancestor chain — the same physical page holds *different* KV for a
different prefix, which the tree encodes for free. Partial tail pages are
never cached (their pages keep growing under decode).

Lifetime protocol (all refcounts live in
:class:`repro_torch.serve.kv_pool.KVPool`):

* ``insert`` pins each newly-indexed page (``incref``) so it survives its
  admitting slot's eviction;
* ``match`` returns the longest resident run for a prompt — the caller
  ``attach``-es those pages (incref per slot) and prefills only the tail;
* ``evict``/``make_room`` unpin LRU leaves whose page nobody else holds
  (``refcount == 1``) — a page a live slot still maps stays resident, so the
  cache can only ever return truly-orphaned pages to the free list.

Cache-only subtrees are downward-closed: a child page can only be slot-held
if its ancestors are too (matches are prefix-contiguous), so leaf-first LRU
eviction can always reach every reclaimable page.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.kv_pool import KVPool

Chunk = Tuple[int, ...]


class _Node:
    __slots__ = ("children", "page", "stamp", "parent", "chunk")

    def __init__(self, page: int, parent: Optional["_Node"], chunk: Optional[Chunk]):
        self.children: Dict[Chunk, _Node] = {}
        self.page = page  # -1 on the root sentinel
        self.stamp = 0
        self.parent = parent
        self.chunk = chunk


class PrefixCache:
    """Host-side radix index; the KV page *contents* live in the engine's
    device state and are only ever referenced by id here."""

    def __init__(self, pool: KVPool):
        self.pool = pool
        self.page_size = pool.page_size
        self._root = _Node(-1, None, None)
        self._tick = 0
        self._n_nodes = 0

    # -- bookkeeping ---------------------------------------------------------

    @property
    def cached_pages(self) -> int:
        """Pages the cache currently pins (== node count)."""
        return self._n_nodes

    def reclaimable(self) -> int:
        """Pages eviction could return to the free list right now: cached
        pages no slot table holds (refcount is exactly the cache's own pin)."""
        return sum(
            1 for node in self._iter_nodes() if self.pool.refcount(node.page) == 1
        )

    def clear(self) -> None:
        """Drop the index without touching refcounts — pair with
        ``KVPool.reset()``, which already wiped them."""
        self._root = _Node(-1, None, None)
        self._tick = 0
        self._n_nodes = 0

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def _chunks(self, tokens: Sequence[int]) -> List[Chunk]:
        ps = self.page_size
        n_full = len(tokens) // ps
        return [
            tuple(int(t) for t in tokens[i * ps : (i + 1) * ps])
            for i in range(n_full)
        ]

    # -- queries -------------------------------------------------------------

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest resident full-page run for ``tokens``; touches the LRU
        stamps along the path. The caller must ``attach`` the returned pages
        (or not use them) before any pool transition can evict them."""
        self._tick += 1
        node, pages = self._root, []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            child.stamp = self._tick
            pages.append(child.page)
            node = child
        return pages

    def probe(self, tokens: Sequence[int]) -> int:
        """Resident full pages for ``tokens`` WITHOUT touching LRU state —
        used by admission capacity checks and router prefix-affinity, which
        must not age-out pages they don't end up using."""
        node, n = self._root, 0
        for chunk in self._chunks(tokens):
            node = node.children.get(chunk)
            if node is None:
                break
            n += 1
        return n

    # -- transitions ---------------------------------------------------------

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Index ``tokens``'s full pages (``pages`` is the slot's page table
        in logical order, as long as or longer than the full-page count).
        Chunks already resident are left alone — a spliced admission maps
        them to the very same page ids; fresh chunks pin their page.
        Returns the number of newly-cached pages."""
        self._tick += 1
        node, added = self._root, 0
        for i, chunk in enumerate(self._chunks(tokens)):
            child = node.children.get(chunk)
            if child is None:
                child = _Node(int(pages[i]), node, chunk)
                node.children[chunk] = child
                self.pool.incref(child.page)
                self._n_nodes += 1
                added += 1
            child.stamp = self._tick
            node = child
        return added

    def _evict(self, node: _Node) -> bool:
        """Unpin one childless node; True when its page hit the free list."""
        assert not node.children
        node.parent.children.pop(node.chunk)
        self._n_nodes -= 1
        return self.pool.decref(node.page)

    def make_room(self, n_pages: int) -> int:
        """Evict LRU reclaimable leaves until ``n_pages`` pages have returned
        to the free list (or nothing evictable remains); returns the count
        actually freed. Leaves whose page a slot still maps are skipped —
        their KV is live and eviction would free HBM out from under it."""
        freed = 0
        while freed < n_pages:
            victims = [
                node
                for node in self._iter_nodes()
                if not node.children and self.pool.refcount(node.page) == 1
            ]
            if not victims:
                break
            victim = min(victims, key=lambda node: node.stamp)
            if self._evict(victim):
                freed += 1
        return freed
