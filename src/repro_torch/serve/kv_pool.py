"""Paged KV-cache block pool for the continuous-batching engine (the port's
copy of ``repro.serve.kv_pool``: host numpy, unchanged).

The dense engine cache is a per-slot rectangle: every slot owns
``cache_len = min(window, max_seq) or max_seq`` KV positions whether it is
serving a 2k-token request or an 8-token one — HBM is ``slots × max_len``
at rest. The pool replaces that rectangle with fixed-size **pages**:

  * the device buffers are ``(pool_pages, page_size, KH, hd)`` per attention
    layer (stacked over scan groups) — HBM scales with *allocated pages*,
    i.e. live tokens, not slot capacity;
  * each slot's logical cache is its **page table** row: logical index ``j``
    lives at ``(page_table[slot, j // page_size], j % page_size)``. For
    sliding-window layers the logical space is the same ring the dense cache
    uses, so the two layouts are token-for-token interchangeable;
  * this class is the HOST-side allocator: a free list plus per-slot
    ownership. Admission allocates the pages the bucketed prefill fills,
    :meth:`ServeEngine.decode_chunk` appends pages as positions cross page
    boundaries (at chunk granularity — the device program never touches the
    free list), and eviction returns a slot's pages.

Pages are **refcounted** so a radix prefix cache (the JAX package's
``serve/prefix_cache.py``, not ported yet) can share one physical page
between several slots (and keep it resident after every owner drains): ``alloc`` hands out fresh pages at refcount 1,
``attach`` splices already-allocated pages into another slot's table
(incref), ``incref``/``decref`` let the prefix cache pin pages with no slot
owner at all, and ``free_slot`` only returns truly-orphaned pages (refcount
hitting 0) to the free list. A decode write that would land in a shared page
goes through ``cow`` — a fresh private copy — never through the shared page.

Invariants (pinned by the JAX package's randomized property test in
``tests/test_kv_pool.py``): free + allocated always partitions ``range(n_pages)``; a page appears at most
once in any one slot's table; a page's refcount equals the number of slot
tables it appears in plus its prefix-cache pins; no page is freed while its
refcount is positive; ``alloc`` past capacity raises instead of silently
reusing.

Unallocated/stale page-table entries point at the **scratch page** — one
sacrificial page past the pool that is never handed out. It exists because
idle slots keep rewriting their frozen position as they ride along in the
batched decode: pointing them anywhere allocatable would clobber a live
slot's KV the moment their old pages were handed out again.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.models.attention import cache_len


class KVPool:
    """Host-side page allocator; the page buffers themselves live in the
    engine's device state and are addressed by the ids handed out here."""

    def __init__(self, cfg, ecfg):
        self.page_size = ecfg.page_size
        self.cache_len = cache_len(cfg, ecfg.max_seq)
        # table width: pages needed to cover one slot's full logical cache
        self.pages_per_slot = -(-self.cache_len // self.page_size)
        self.n_pages = ecfg.pool_pages or ecfg.max_slots * self.pages_per_slot
        # fail-fast floor, billed in PAGES against the MODEL's cache length:
        # a minimal (bucket_min-token) admission occupies whole pages, but
        # never more than the slot's full ring — so tight SWA pools that a
        # token-level or window-blind bound would spuriously reject pass.
        # pages_min >= 1, so this also guarantees one page per slot.
        bucket_min = min(ecfg.prefill_bucket, ecfg.max_seq)
        pages_min = min(-(-bucket_min // self.page_size), self.pages_per_slot)
        if self.n_pages < ecfg.max_slots * pages_min:
            raise ValueError(
                f"pool_pages={self.n_pages} cannot back max_slots={ecfg.max_slots} "
                f"minimal admissions of {pages_min} page(s) each "
                f"(bucket_min={bucket_min} tokens, page_size={self.page_size}, "
                f"cache_len={self.cache_len}) — a full admission burst would "
                "exhaust the pool at prefill. Raise pool_pages or lower "
                "max_slots/prefill_bucket."
            )
        # INACTIVE slots still ride along in the batched decode, rewriting
        # their frozen position every step (the dense layout absorbs that in
        # the slot's own row). Their page-table rows must therefore never
        # point at allocatable pages: one sacrificial page past the pool is
        # the write target for every idle/evicted slot. It is never handed
        # out, so a stale row can clobber nothing.
        self.scratch_page = self.n_pages
        self._free: List[int] = []
        self._owned: Dict[int, List[int]] = {}
        self._ref: Dict[int, int] = {}
        self._staged: set = set()
        self._next_sid = 0
        self.reset()

    # -- bookkeeping ---------------------------------------------------------

    def reset(self) -> None:
        """Return the pool to its pristine state. Clears ownership, the free
        list, per-page refcounts AND the donate/adopt staging bookkeeping —
        a handoff staged before reset must not leak a reservation (or a stale
        refcount on a page id handed out again) into the next run."""
        self._free = list(range(self.n_pages - 1, -1, -1))  # pop() hands out 0 first
        self._owned = {}
        self._ref = {}
        self._staged = set()
        # sid stays monotonic: a KVHandoff sealed before reset must never
        # collide with a reservation staged after it.

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Distinct allocated pages (a page shared by N tables counts once)."""
        return len(self._ref)

    @property
    def staged_ids(self) -> List[int]:
        """Staging reservations currently holding pages (handoff in flight)."""
        return sorted(self._staged)

    def owned(self, slot: int) -> List[int]:
        return list(self._owned.get(slot, ()))

    def refcount(self, page: int) -> int:
        """0 for free pages; otherwise slot-table memberships + cache pins."""
        return self._ref.get(page, 0)

    def required_pages(self, length: int) -> int:
        """Pages covering ``length`` logical positions (ring-clamped)."""
        return min(-(-min(length, self.cache_len) // self.page_size), self.pages_per_slot)

    # -- transitions ---------------------------------------------------------

    def alloc(self, slot: int, n_pages: int) -> List[int]:
        """Grow ``slot``'s ownership to ``n_pages`` pages (idempotent past
        what it already holds); returns the slot's full page list in logical
        order. Raises when the pool cannot cover the growth."""
        owned = self._owned.setdefault(slot, [])
        need = n_pages - len(owned)
        if need > len(self._free):
            raise RuntimeError(
                f"KV pool exhausted: slot {slot} needs {need} more pages but only "
                f"{len(self._free)}/{self.n_pages} are free "
                f"(page_size={self.page_size}). Raise --pool-pages, shrink request "
                "budgets, or lower --max-slots."
            )
        for _ in range(max(need, 0)):
            page = self._free.pop()
            self._ref[page] = 1
            owned.append(page)
        return list(owned)

    def free_slot(self, slot: int) -> List[int]:
        """Drop ``slot``'s table (eviction/drain), decrementing each page's
        refcount; returns the pages that actually went back to the free list
        (a page still pinned by the prefix cache or another slot's table
        stays allocated)."""
        freed: List[int] = []
        for page in self._owned.pop(slot, []):
            if self._decref(page):
                freed.append(page)
        return freed

    # -- sharing (radix prefix cache) ----------------------------------------

    def _decref(self, page: int) -> bool:
        self._ref[page] -= 1
        if self._ref[page] == 0:
            del self._ref[page]
            self._free.append(page)
            return True
        return False

    def attach(self, slot: int, pages: List[int]) -> None:
        """Splice already-allocated ``pages`` into ``slot``'s table (in
        logical order, before any privately-alloc'd tail pages): the hot half
        of a prefix-cache admission. Increments each page's refcount — no
        allocation happens and the free list is untouched."""
        owned = self._owned.setdefault(slot, [])
        for page in pages:
            if page not in self._ref:
                raise RuntimeError(
                    f"attach: page {page} is not allocated — the prefix cache "
                    "handed out a stale id (evicted without decref?)"
                )
            self._ref[page] += 1
            owned.append(page)

    def incref(self, page: int) -> None:
        """Pin an allocated page with no slot table (prefix-cache insertion)."""
        if page not in self._ref:
            raise RuntimeError(f"incref: page {page} is not allocated")
        self._ref[page] += 1

    def decref(self, page: int) -> bool:
        """Drop a prefix-cache pin; True when the page went back to the free
        list (no slot table and no other pin held it)."""
        if page not in self._ref:
            raise RuntimeError(f"decref: page {page} is not allocated")
        return self._decref(page)

    def cow(self, slot: int, idx: int):
        """Copy-on-write ``slot``'s ``idx``-th table entry: swap the shared
        page for a freshly-allocated private one and return ``(old, new)``.
        The caller owns the device copy old→new before any write lands. A
        page the slot already owns exclusively is returned as-is (no copy
        needed): ``old == new``."""
        owned = self._owned.get(slot)
        if not owned or idx >= len(owned):
            raise RuntimeError(f"cow: slot {slot} has no page at index {idx}")
        old = owned[idx]
        if self._ref[old] == 1:
            return old, old
        if not self._free:
            raise RuntimeError(
                f"KV pool exhausted: slot {slot} needs a copy-on-write page "
                f"but 0/{self.n_pages} are free. Raise --pool-pages."
            )
        new = self._free.pop()
        self._ref[new] = 1
        owned[idx] = new
        self._decref(old)
        return old, new

    # -- handoff protocol ----------------------------------------------------
    #
    # A disaggregated prefill->decode handoff moves SEALED pages between two
    # pools that index two different device buffers: the sending side
    # ``donate``s (its reservation is released once the receiver has copied
    # the sealed contents out) and the receiving side ``adopt``s (fresh ids
    # in ITS buffer for the incoming pages). The page *contents* travel with
    # the handoff structure (repro_torch.serve.engine.KVHandoff) — ids are local to
    # a pool and never cross it.

    def stage(self, n_pages: int):
        """Reserve ``n_pages`` under a fresh staging id (the in-flight half of
        a prefill→decode handoff); returns ``(sid, pages)``. The reservation
        is released by ``donate(sid)`` once the receiver has adopted the
        sealed contents — or by ``reset()``, which must not leak it."""
        sid = self._next_sid
        self._next_sid += 1
        pages = self.alloc(sid, n_pages)
        self._staged.add(sid)
        return sid, pages

    def adopt(self, slot: int, n_pages: int) -> List[int]:
        """Receiving half of a handoff: allocate ``n_pages`` fresh ids for a
        slot that owns NOTHING yet (an adopted request starts from a clean
        slot — adopting on top of live pages would orphan them)."""
        if self._owned.get(slot):
            raise RuntimeError(
                f"slot {slot} still owns {len(self._owned[slot])} page(s); adopt "
                "targets a clean slot — free_slot/donate it first"
            )
        return self.alloc(slot, n_pages)

    def donate(self, slot: int) -> List[int]:
        """Sending half of a handoff: relinquish ``slot``'s pages back to the
        free list and return their ids. The caller must have materialized (or
        started the device copy of) the sealed page contents first — after
        donation the ids may go to the next staged prefill."""
        self._staged.discard(slot)
        return self.free_slot(slot)

    def table_row(self, slot: int) -> np.ndarray:
        """The slot's full-width page-table row, scratch-padded past its
        allocation (padding entries are a safe DMA/write target, never an
        owned page)."""
        row = np.full((self.pages_per_slot,), self.scratch_page, np.int32)
        owned = self._owned.get(slot, ())
        row[: len(owned)] = owned
        return row
