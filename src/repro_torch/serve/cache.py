"""Paged KV cache manager: a refcounted page pool with prefix sharing,
copy-on-write and cross-lifetime prefix retention.

Port of ``repro/serve/cache.py::PagedKVCache``.  The device state (k/v
pools (L, num_pages, page, KV, hd), and scale pools for int8) are torch
tensors on the engine's device; the block table, lengths, per-slot page
lists, free list, refcounts and the retained pool are host-side
numpy/Python bookkeeping, as in the JAX package.  Page 0 is the reserved
NULL page — never allocated, the landing zone for inactive slots' appends
and for unallocated table entries.

Prefix sharing maps one physical page into several block tables
(``share``): rope positions are request-relative, so the K/V rows of an
identical token prefix are the same in every slot and the reference is
exact.  A page referenced more than once is immutable: before a slot
appends into it the scheduler reserves a copy-on-write (``cow_reserve``)
and the tick's reservations are copied in one indexed copy per pool
(``cow_flush``), on the same stream and before the tick's K/V scatter.

Retention (``retain=True``): a freed slot's page-aligned token prefix
stays in a RETAINED pool — refcount 0, content frozen, keyed by the same
rolling-hash digests as the engine's live-donor index
(``prefix_digests``) — and a later admission with the same prefix adopts
those pages (``match_retained`` / ``adopt_retained``).  Retained pages are
reclaimable: ``_alloc_page`` drops entries in policy order before it
reports a dry pool.

Fault injection's pool pressure (``seize_pages``) moves pages from the
free list (reclaiming retained ones first, as any allocation does) into a
SEIZED set until ``release_pages`` returns them.  Not ported: ``warm_copy``
(see ``cow_flush``).

Invariants (``check()``): every page's refcount equals its block-table
references; the null page, the referenced pages, the free list, the
seized pages and the retained-only pages partition [0, num_pages) — no
page is double-allocated, leaked, or freed while referenced, seized or
retained.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np
import torch

# rolling-hash prefix digests, shared with the engine's live-donor index;
# the constants are the JAX package's, so both key a prefix the same way
_HASH_MUL = 1_000_003
_HASH_MOD = (1 << 61) - 1


def digest_step(h: int, tok: int) -> int:
    """One token step of the rolling prefix digest (+1 biases token 0)."""
    return (h * _HASH_MUL + int(tok) + 1) % _HASH_MOD


def prefix_digests(tokens, page: int) -> List[int]:
    """Digest of every page-aligned prefix of ``tokens``: out[j] covers
    tokens[:(j+1)*page].  Only full pages are digested — retention is
    page-granular (a partial trailing page is recomputed by the adopter)."""
    out: List[int] = []
    h = 0
    for idx, t in enumerate(tokens):
        h = digest_step(h, t)
        if (idx + 1) % page == 0:
            out.append(h)
    return out


@dataclasses.dataclass
class RetainedPrefix:
    """A dead slot's page-aligned token prefix, held for re-sharing.

    ``tokens`` is the exact prefix (len == page * len(pages)), ``pages``
    the physical pages holding its K/V rows, ``keys`` the (n_pages,
    digest) keys it is registered under (one per page boundary, so a
    shorter prompt still hits a longer entry), ``stamp`` the retention
    clock at last touch (LRU) and ``hits`` its adoptions (popularity)."""
    tokens: List[int]
    pages: List[int]
    keys: List[Tuple[int, int]]
    stamp: int
    hits: int = 0


class PagedKVCache:
    """Host-side manager for the paged decode cache (see module docstring)."""

    RETAIN_POLICIES = ("lru", "popularity")

    def __init__(self, model, max_batch: int, max_seq: int, *,
                 page_size: int = 16, max_blocks: int = 0,
                 num_pages: int = 0, retain: bool = False,
                 retain_cap: int = 0, retain_policy: str = "lru",
                 device="cuda"):
        if retain_policy not in self.RETAIN_POLICIES:
            raise ValueError(f"unknown retain_policy {retain_policy!r}; "
                             f"expected one of {self.RETAIN_POLICIES}")
        self.page = page_size
        self.max_blocks = max_blocks or -(-max_seq // page_size)
        # default pool: every slot can hold its full table + the null page
        self.num_pages = num_pages or (max_batch * self.max_blocks + 1)
        self.B = max_batch
        arrays = model.init_paged_cache(max_batch, self.max_blocks,
                                        self.page, self.num_pages, device)
        self.k = arrays["k"]
        self.v = arrays["v"]
        self.k_scale = arrays.get("k_scale")
        self.v_scale = arrays.get("v_scale")
        self.quantized = self.k_scale is not None
        self.table = np.zeros((max_batch, self.max_blocks), np.int32)
        self.length = np.zeros((max_batch,), np.int32)
        self.owned: List[List[int]] = [[] for _ in range(max_batch)]
        self.refcount = np.zeros((self.num_pages,), np.int32)
        self.free: List[int] = list(range(self.num_pages - 1, 0, -1))
        # one page's bytes across both pools (and both scale pools when
        # quantized), from the pools' own itemsize, as the JAX cache
        # computes it
        L = self.k.shape[0]
        self.page_bytes = 2 * L * self.page * self.k.shape[3] \
            * self.k.shape[4] * self.k.element_size()
        if self.quantized:
            self.page_bytes += 2 * L * self.page * self.k_scale.shape[3] \
                * self.k_scale.element_size()
        self.cow_copies = 0
        self.cow_bytes = 0               # cow_copies x page_bytes
        self.cow_dispatches = 0          # flushes that copied (1 per tick)
        self.shared_pages = 0            # page references handed out by
                                         # share() and adopt_retained()
        # (dst, src, slot, blk) pairs reserved by cow_reserve(), copied by
        # the tick's one cow_flush()
        self._pending_cow: List[Tuple[int, int, int, int]] = []
        # pages the fault injection's squeeze took from the free list: not
        # allocatable, not referenced, counted by check()
        self.seized: Set[int] = set()
        # slot rows whose table/length changed since the engine last
        # synced its device mirrors
        self.dirty: Set[int] = set(range(max_batch))
        # -- cross-lifetime retention ------------------------------------
        self.retain = retain
        self.retain_cap = retain_cap     # max retained-only pages; 0 = pool
        self.retain_policy = retain_policy
        self.retained: List[RetainedPrefix] = []
        # (n_pages, digest) -> entries registered under that page boundary
        self._retained_keys: Dict[Tuple[int, int], List[RetainedPrefix]] = {}
        # per-page count of retained entries holding the page: a page is
        # not free while this or its refcount is nonzero
        self.retained_refs = np.zeros((self.num_pages,), np.int32)
        self._retain_clock = 0
        self.retained_hits = 0               # adopt_retained() calls
        self.retained_hit_tokens = 0         # tokens adopted from retained
        self.retained_reclaimed_pages = 0    # pages freed from retention
        self.retained_dropped = 0            # entries reclaimed/flushed

    # -- allocation ----------------------------------------------------------

    def _alloc_page(self) -> Optional[int]:
        """The one allocation choke point: pop a free page, reclaiming
        retained entries (policy order) when the free list is dry, so a
        retained page is as allocatable as a free one."""
        if not self.free and self.retained:
            self.reclaim_retained(1)
        return self.free.pop() if self.free else None

    def ensure(self, i: int, n_tokens: int) -> bool:
        """Allocate pages so slot ``i`` can hold ``n_tokens`` tokens.
        Returns False (allocating nothing further) if the pool runs dry."""
        need = -(-n_tokens // self.page)
        if need > self.max_blocks:
            raise RuntimeError(
                f"slot {i} needs {need} blocks > max_blocks="
                f"{self.max_blocks} (request exceeds max_seq)")
        while len(self.owned[i]) < need:
            pg = self._alloc_page()
            if pg is None:
                return False
            self.refcount[pg] = 1
            self.table[i, len(self.owned[i])] = pg
            self.owned[i].append(pg)
            self.dirty.add(i)
        return True

    def share(self, dst: int, donor: int, n_tokens: int) -> None:
        """Map the donor's pages covering positions [0, n_tokens) into
        empty slot ``dst``'s table (refcount bump, no allocation, no copy)
        and set its length.  The trailing page may be partly filled:
        ``dst`` reads only rows below its own length there, and its first
        append into it is copied on write first."""
        assert not self.owned[dst], "share() target slot must be empty"
        need = -(-n_tokens // self.page)
        pages = self.owned[donor][:need]
        assert len(pages) == need, "donor does not cover the shared prefix"
        for j, pg in enumerate(pages):
            self.table[dst, j] = pg
            self.refcount[pg] += 1
        self.owned[dst] = list(pages)
        self.length[dst] = n_tokens
        self.shared_pages += need
        self.dirty.add(dst)

    def cow_reserve(self, i: int, blk: int) -> bool:
        """Reserve a copy-on-write of block ``blk`` of slot ``i`` if its
        page is shared: fresh page, this slot's table rewired, copy queued
        for ``cow_flush``.  Returns False if no page is free.  No-op on an
        exclusively owned page."""
        pg = self.owned[i][blk]
        if self.refcount[pg] <= 1:
            return True
        q = self._alloc_page()
        if q is None:
            return False
        self._pending_cow.append((q, pg, i, blk))
        self.refcount[pg] -= 1
        self.refcount[q] = 1
        self.owned[i][blk] = q
        self.table[i, blk] = q
        self.cow_copies += 1
        self.cow_bytes += self.page_bytes
        self.dirty.add(i)
        return True

    def cow_flush(self) -> int:
        """Copy every page queued by ``cow_reserve`` in one indexed copy
        per pool (scale pools included), queued on the current stream, so
        it lands before any later kernel reads or appends to the pages.
        The JAX package pre-compiles these copies (``warm_copy``); an
        indexed torch copy compiles nothing, so the port has no
        counterpart.  Returns the pages copied."""
        if not self._pending_cow:
            return 0
        dev = self.k.device
        dst = torch.tensor([p[0] for p in self._pending_cow], device=dev)
        src = torch.tensor([p[1] for p in self._pending_cow], device=dev)
        pools = [self.k, self.v]
        if self.quantized:                   # scales move with their pages
            pools += [self.k_scale, self.v_scale]
        for pool in pools:
            pool[:, dst] = pool[:, src]
        n = len(self._pending_cow)
        self._pending_cow.clear()
        self.cow_dispatches += 1
        return n

    def cow_rollback(self, i: int, from_blk: int = 0) -> int:
        """Undo slot ``i``'s pending copy-on-write reservations at block
        indices >= ``from_blk`` (shared mapping restored, reserved page
        freed).  Returns the number undone."""
        kept, undone = [], 0
        for (q, pg, s, b) in self._pending_cow:
            if s == i and b >= from_blk:
                self.refcount[pg] += 1
                self.refcount[q] = 0
                self.free.append(q)
                self.owned[i][b] = pg
                self.table[i, b] = pg
                self.cow_copies -= 1
                self.cow_bytes -= self.page_bytes
                undone += 1
            else:
                kept.append((q, pg, s, b))
        self._pending_cow = kept
        if undone:
            self.dirty.add(i)
        return undone

    def cow_many(self, items: Iterable[Tuple[int, int]]) -> int:
        """Privatize every shared (slot, blk) pair with one flush; a dry
        pool stops the batch at the first pair it cannot serve.  Returns
        the pages copied."""
        for i, blk in items:
            if not self.cow_reserve(i, blk):
                break
        return self.cow_flush()

    def cow(self, i: int, blk: int) -> bool:
        """Single-page copy-on-write: reserve and flush at once."""
        ok = self.cow_reserve(i, blk)
        self.cow_flush()
        return ok

    def shared_blocks(self, i: int, lo_tok: int, hi_tok: int) -> List[int]:
        """Block indices of slot ``i`` with shared pages (refcount > 1)
        among those that appends to positions [lo_tok, hi_tok) touch."""
        b0 = lo_tok // self.page
        b1 = (hi_tok - 1) // self.page
        return [b for b in range(b0, min(b1, len(self.owned[i]) - 1) + 1)
                if self.refcount[self.owned[i][b]] > 1]

    def seize_pages(self, n: int) -> List[int]:
        """Pool pressure (fault injection): move up to ``n`` pages into the
        SEIZED set, unallocatable until ``release_pages``.  They come
        through ``_alloc_page``, so a squeeze deeper than the free list
        drains the retained pool too.  Returns the seized page ids."""
        took = []
        while len(took) < n:
            pg = self._alloc_page()
            if pg is None:
                break
            took.append(pg)
        self.seized.update(took)
        return took

    def release_pages(self, pages: Iterable[int]) -> None:
        """Return previously seized pages to the free list."""
        for pg in pages:
            assert pg in self.seized, f"page {pg} was not seized"
            self.seized.discard(pg)
            self.free.append(pg)

    def free_slot(self, i: int, retain_tokens=None) -> None:
        """Eviction: cancel the slot's pending copies (a copy into a page
        that just went back to the free list would corrupt its next
        owner), retain its page-aligned prefix when ``retain_tokens`` (the
        slot's token history) is given and retention is on, then drop its
        page references (a page returns to the free list when no table
        and no retained entry holds it) and clear its row."""
        if self._pending_cow:
            self.cow_rollback(i)
        if self.retain and retain_tokens is not None:
            self._retain_prefix(self.owned[i], retain_tokens)
        for pg in reversed(self.owned[i]):
            self.refcount[pg] -= 1
            if self.refcount[pg] == 0 and self.retained_refs[pg] == 0:
                self.free.append(pg)
        self.owned[i] = []
        self.table[i, :] = 0
        self.length[i] = 0
        self.dirty.add(i)
        if self.retain and self.retain_cap > 0:
            # the cap counts retained-only pages, so it runs after the
            # slot's references dropped
            self._enforce_retain_cap()

    # -- cross-lifetime retention --------------------------------------------

    def _retain_prefix(self, pages: List[int], tokens) -> None:
        """Register ``tokens``' page-aligned prefix (held in ``pages``) as
        a retained entry.  An exact duplicate is touched, not re-inserted;
        a shorter or longer prefix of an entry coexists with it."""
        n_full = min(len(tokens) // self.page, len(pages))
        if n_full == 0:
            return
        toks = [int(t) for t in tokens[:n_full * self.page]]
        digests = prefix_digests(toks, self.page)
        self._retain_clock += 1
        for cand in self._retained_keys.get((n_full, digests[-1]), []):
            if cand.tokens == toks:          # exact duplicate: refresh LRU
                cand.stamp = self._retain_clock
                return
        entry = RetainedPrefix(
            tokens=toks, pages=list(pages[:n_full]),
            keys=[(j + 1, d) for j, d in enumerate(digests)],
            stamp=self._retain_clock)
        self.retained.append(entry)
        for pg in entry.pages:
            self.retained_refs[pg] += 1
        for key in entry.keys:
            self._retained_keys.setdefault(key, []).append(entry)

    def _retained_only(self) -> Set[int]:
        """Pages held only by retained entries (refcount 0)."""
        return {int(p) for p in np.flatnonzero(
            (self.retained_refs > 0) & (self.refcount == 0))}

    def _enforce_retain_cap(self) -> None:
        while len(self._retained_only()) > self.retain_cap:
            victims = [e for e in self._reclaim_order()
                       if self._entry_freeable(e)]
            if not victims:
                break
            self._drop_entry(victims[0])

    def _entry_freeable(self, e: RetainedPrefix) -> int:
        """Pages dropping ``e`` would return to the free list."""
        return sum(1 for pg in e.pages
                   if self.refcount[pg] == 0 and self.retained_refs[pg] == 1)

    def _reclaim_order(self) -> List[RetainedPrefix]:
        if self.retain_policy == "popularity":
            # least-adopted first; LRU breaks ties
            return sorted(self.retained, key=lambda e: (e.hits, e.stamp))
        return sorted(self.retained, key=lambda e: e.stamp)

    def _drop_entry(self, e: RetainedPrefix) -> int:
        """Forget a retained entry: unregister its keys, drop its page
        holds, free the pages nobody else holds.  Returns pages freed."""
        self.retained.remove(e)
        for key in e.keys:
            owners = self._retained_keys[key]
            owners.remove(e)
            if not owners:
                del self._retained_keys[key]
        freed = 0
        for pg in e.pages:
            self.retained_refs[pg] -= 1
            if self.retained_refs[pg] == 0 and self.refcount[pg] == 0:
                self.free.append(pg)
                freed += 1
        self.retained_dropped += 1
        self.retained_reclaimed_pages += freed
        return freed

    def reclaim_retained(self, need: int) -> int:
        """Drop retained entries in policy order until >= ``need`` pages
        went back to the free list.  An entry whose pages are all live
        (adopted by running slots) frees nothing and is skipped, so
        reclamation never touches a page a live slot re-shared."""
        freed = 0
        for e in self._reclaim_order():
            if freed >= need:
                break
            if self._entry_freeable(e) == 0:
                continue
            freed += self._drop_entry(e)
        return freed

    def flush_retained(self) -> int:
        """Drop every retained entry.  Returns pages freed."""
        freed = 0
        for e in list(self.retained):
            freed += self._drop_entry(e)
        return freed

    def match_retained(self, prompt, cap: int):
        """Longest page-aligned retained prefix of ``prompt[:cap]``: walks
        the rolling digest page by page and stops at the first boundary
        no entry registers.  The winner is verified token for token; on a
        digest collision an exact scan over all entries decides.  Returns
        (entry, n_tokens) or (None, 0)."""
        if not self.retained:
            return None, 0
        limit = min(cap, len(prompt))
        h = 0
        best: Optional[RetainedPrefix] = None
        best_n = 0
        for idx in range(limit):
            h = digest_step(h, prompt[idx])
            if (idx + 1) % self.page:
                continue
            owners = self._retained_keys.get(((idx + 1) // self.page, h))
            if not owners:
                break
            best, best_n = owners[0], idx + 1
        if best is not None \
                and best.tokens[:best_n] != [int(t) for t in
                                             prompt[:best_n]]:
            best, best_n = None, 0           # collision: exact fallback
            for e in self.retained:
                n = 0
                for a, b in zip(e.tokens, prompt[:limit]):
                    if a != int(b):
                        break
                    n += 1
                n -= n % self.page
                if n > best_n:
                    best, best_n = e, n
        if best is None or best_n == 0:
            return None, 0
        return best, best_n

    def adopt_retained(self, dst: int, entry: RetainedPrefix,
                       n_tokens: int) -> None:
        """Cross-lifetime ``share``: map the entry's pages covering [0,
        n_tokens) into empty slot ``dst``'s table (refcount bump: the pages
        are live again and safe from reclamation) and set its length.
        Adopted pages are full, so the adopter never writes into them."""
        assert not self.owned[dst], "adopt_retained() target must be empty"
        assert n_tokens % self.page == 0, "retained adoption is page-aligned"
        need = n_tokens // self.page
        assert need <= len(entry.pages), "entry does not cover the prefix"
        for j, pg in enumerate(entry.pages[:need]):
            self.table[dst, j] = pg
            self.refcount[pg] += 1
        self.owned[dst] = list(entry.pages[:need])
        self.length[dst] = n_tokens
        self.shared_pages += need
        self._retain_clock += 1
        entry.stamp = self._retain_clock
        entry.hits += 1
        self.retained_hits += 1
        self.retained_hit_tokens += n_tokens
        self.dirty.add(dst)

    # -- bookkeeping ----------------------------------------------------------

    @property
    def live_pages(self) -> int:
        """Distinct physical pages referenced by at least one slot."""
        return len({p for o in self.owned for p in o})

    @property
    def retained_pages(self) -> int:
        """Distinct pages held by retained entries (live or not)."""
        return len({p for e in self.retained for p in e.pages})

    @property
    def allocatable(self) -> int:
        """Pages an allocation could obtain now: the free list plus the
        retained-only pages."""
        return len(self.free) + len(self._retained_only())

    @property
    def logical_pages(self) -> int:
        """Block-table references summed over slots (>= live_pages when
        sharing maps one page into several tables)."""
        return sum(len(o) for o in self.owned)

    def utilization(self) -> float:
        """Fraction of allocatable pages referenced by live slots (a
        shared page counts once)."""
        return self.live_pages / max(1, self.num_pages - 1)

    def occupancy(self) -> float:
        """Fraction of rows in live pages that hold tokens, each page
        filled as far as its furthest-advanced referent (unchanged by
        defrag, which only renumbers)."""
        rows = self.live_pages * self.page
        fill = {}
        for i in range(self.B):
            n = int(self.length[i])
            for j, pg in enumerate(self.owned[i]):
                f = min(self.page, max(0, n - j * self.page))
                fill[pg] = max(fill.get(pg, 0), f)
        return sum(fill.values()) / rows if rows else 0.0

    def check(self, allow_pending: bool = False) -> None:
        """Refcount / free-list / table / retained-pool invariants: every
        page's refcount equals its block-table references, every page's
        retained count its retaining entries, every entry is page-aligned
        and registered under exactly its digest keys, and the null page,
        the referenced pages, the free list, the seized pages and the
        retained-only pages partition [0, num_pages).  ``allow_pending``
        checks the mid-plan state: pending copies may touch live pages
        only."""
        if allow_pending:
            free = set(self.free)
            for (q, pg, s, b) in self._pending_cow:
                assert q not in free and pg not in free, \
                    f"pending COW ({q} <- {pg}) references a free page"
                assert self.refcount[q] == 1, \
                    f"pending COW destination {q} has refcount " \
                    f"{self.refcount[q]}"
                assert 0 <= b < len(self.owned[s]) \
                    and self.owned[s][b] == q, \
                    f"pending COW for slot {s} block {b} lost its rewire"
        else:
            assert not self._pending_cow, "unflushed COW reservations"
        refs = Counter(p for o in self.owned for p in o)
        assert 0 not in refs, "null page referenced"
        for i, o in enumerate(self.owned):
            assert len(set(o)) == len(o), f"slot {i} references a page twice"
            assert list(self.table[i, :len(o)]) == o, "table/owned drift"
            assert not self.table[i, len(o):].any(), "stale table entry"
        for p in range(1, self.num_pages):
            assert self.refcount[p] == refs.get(p, 0), \
                f"page {p}: refcount {self.refcount[p]} != " \
                f"{refs.get(p, 0)} table references"
        assert len(set(self.free)) == len(self.free), "free-list duplicate"
        assert not set(refs) & set(self.free), "page both referenced and free"
        assert not self.seized & set(refs), "seized page still referenced"
        assert not self.seized & set(self.free), "seized page still free"
        rr = Counter(p for e in self.retained for p in e.pages)
        assert 0 not in rr, "null page retained"
        for p in range(1, self.num_pages):
            assert self.retained_refs[p] == rr.get(p, 0), \
                f"page {p}: retained_refs {self.retained_refs[p]} != " \
                f"{rr.get(p, 0)} retaining entries"
        assert not set(rr) & set(self.free), "retained page in the free list"
        assert not set(rr) & self.seized, "retained page seized"
        for e in self.retained:
            assert e.pages and len(e.tokens) == self.page * len(e.pages), \
                "retained entry is not page-aligned"
            assert len(set(e.pages)) == len(e.pages), \
                "retained entry holds a page twice"
            digs = prefix_digests(e.tokens, self.page)
            assert e.keys == [(j + 1, d) for j, d in enumerate(digs)], \
                "retained entry digests drifted from its tokens"
            for key in e.keys:
                assert e in self._retained_keys.get(key, []), \
                    f"retained entry unregistered under key {key}"
        n_keys = sum(len(v) for v in self._retained_keys.values())
        assert n_keys == sum(len(e.keys) for e in self.retained), \
            "digest map holds keys for a dropped entry"
        retained_only = {p for p in rr if self.refcount[p] == 0}
        assert set(refs) | set(self.free) | self.seized | retained_only \
            == set(range(1, self.num_pages)), "page leaked"

    # -- defrag ----------------------------------------------------------------

    def defrag(self) -> None:
        """Compact the occupied pages to the pool's prefix — [null | live |
        retained-only | seized | free] — and renumber every table, retained
        entry and seized page through the same permutation (a page shared
        by several tables moves once); seized pages stay out of the rebuilt
        free list.  Pending copies address the old page ids, so
        they are flushed first; every row is marked dirty.  Purely
        physical: outputs are the same across a defrag.

        Each pool (and scale pool) is gathered through the permutation
        with one ``index_select`` on dim 1 into a new tensor: for a moment
        the old and the new pool are both alive, so the peak is one extra
        pool (k, v and the scales, one at a time).  The JAX package
        donates the pool instead; an in-place permutation could read a
        page it has already overwritten."""
        self.cow_flush()
        mapping = {0: 0}
        perm = [0]                                    # new -> old; null stays
        for i in range(self.B):
            for j, pg in enumerate(self.owned[i]):
                if pg not in mapping:
                    mapping[pg] = len(perm)
                    perm.append(pg)
                self.table[i, j] = mapping[pg]
            self.owned[i] = [mapping[pg] for pg in self.owned[i]]
        for e in self.retained:          # retained-only pages pack next
            for pg in e.pages:
                if pg not in mapping:
                    mapping[pg] = len(perm)
                    perm.append(pg)
            e.pages = [mapping[pg] for pg in e.pages]
        for pg in sorted(self.seized):   # seized keep their rows, renumbered
            if pg not in mapping:
                mapping[pg] = len(perm)
                perm.append(pg)
        self.seized = {mapping[pg] for pg in self.seized}
        kept = len(perm) - 1             # live + retained-only + seized
        perm.extend(p for p in range(1, self.num_pages) if p not in mapping)
        new_rc = np.zeros_like(self.refcount)
        new_rr = np.zeros_like(self.retained_refs)
        for old, new in mapping.items():
            new_rc[new] = self.refcount[old]
            new_rr[new] = self.retained_refs[old]
        self.refcount = new_rc
        self.retained_refs = new_rr
        self.free = list(range(self.num_pages - 1, kept, -1))
        idx = torch.tensor(perm, dtype=torch.long, device=self.k.device)
        self.k = self.k.index_select(1, idx)
        self.v = self.v.index_select(1, idx)
        if self.quantized:               # scales renumber with their pages
            self.k_scale = self.k_scale.index_select(1, idx)
            self.v_scale = self.v_scale.index_select(1, idx)
        self.dirty.update(range(self.B))     # every table renumbered
