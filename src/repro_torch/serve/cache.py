"""Paged KV cache manager: a refcounted page pool with copy-on-write.

Port of the part of ``repro/serve/cache.py::PagedKVCache`` that the tick
scheduler and the engine's plain path use.  The device state (k/v pools
(L, num_pages, page, KV, hd), and scale pools for int8) are torch tensors
on the engine's device; the block table, lengths, per-slot page lists,
free list and refcounts are host-side numpy/Python bookkeeping, as in the
JAX package.  Page 0 is the reserved NULL page — never allocated, the
landing zone for inactive slots' appends and for unallocated table
entries.

Not ported yet (later slices): ``share`` and cross-lifetime retention
(the engine refuses ``prefix_sharing``/``retain_prefixes``), seized pages
(fault injection) and defrag.  Without sharing no page ever has a
refcount above 1, so the copy-on-write path below is present for the
scheduler's calls but never copies.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Set, Tuple

import numpy as np
import torch


class PagedKVCache:
    """Host-side manager for the paged decode cache."""

    def __init__(self, model, max_batch: int, max_seq: int, *,
                 page_size: int = 16, max_blocks: int = 0,
                 num_pages: int = 0, device="cuda"):
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
        # (dst, src, slot, blk) pairs reserved by cow_reserve(), copied by
        # the tick's one cow_flush()
        self._pending_cow: List[Tuple[int, int, int, int]] = []
        # slot rows whose table/length changed since the engine last
        # synced its device mirrors
        self.dirty: Set[int] = set(range(max_batch))
        self.retained_reclaimed_pages = 0    # no retention in this port yet

    # -- allocation ----------------------------------------------------------

    def _alloc_page(self):
        return self.free.pop() if self.free else None

    def ensure(self, i: int, n_tokens: int) -> bool:
        """Allocate pages so slot ``i`` can hold ``n_tokens`` tokens.
        Returns False (allocating nothing further) if the free list runs
        dry."""
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
        self.dirty.add(i)
        return True

    def cow_flush(self) -> int:
        """Copy every page queued by ``cow_reserve`` in one indexed copy
        per pool.  Returns the pages copied."""
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
                undone += 1
            else:
                kept.append((q, pg, s, b))
        self._pending_cow = kept
        if undone:
            self.dirty.add(i)
        return undone

    def shared_blocks(self, i: int, lo_tok: int, hi_tok: int) -> List[int]:
        """Block indices of slot ``i`` with shared pages (refcount > 1)
        among those that appends to positions [lo_tok, hi_tok) touch."""
        b0 = lo_tok // self.page
        b1 = (hi_tok - 1) // self.page
        return [b for b in range(b0, min(b1, len(self.owned[i]) - 1) + 1)
                if self.refcount[self.owned[i][b]] > 1]

    def free_slot(self, i: int) -> None:
        """Eviction: cancel the slot's pending copies, drop its page
        references (a page returns to the free list when its refcount
        reaches zero), clear its table row and length."""
        if self._pending_cow:
            self.cow_rollback(i)
        for pg in reversed(self.owned[i]):
            self.refcount[pg] -= 1
            if self.refcount[pg] == 0:
                self.free.append(pg)
        self.owned[i] = []
        self.table[i, :] = 0
        self.length[i] = 0
        self.dirty.add(i)

    # -- bookkeeping ----------------------------------------------------------

    @property
    def allocatable(self) -> int:
        return len(self.free)

    def check(self, allow_pending: bool = False) -> None:
        """Refcount / free-list / table invariants: every page's refcount
        equals its block-table references, and the null page, the
        referenced pages and the free list partition [0, num_pages)."""
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
        assert set(refs) | set(self.free) == set(range(1, self.num_pages)), \
            "page leaked"
