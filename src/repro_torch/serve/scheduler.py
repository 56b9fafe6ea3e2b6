"""Tick scheduler: packs chunked-prefill and decode work into each engine
tick — a copy of ``repro/serve/scheduler.py`` (host numpy logic).

Every ``PagedEngine`` tick runs at most two steps: the ragged multi-token
PREFILL LANE (one kernel step per layer appends and attends a chunk of up
to ``prefill_tokens`` prompt tokens per slot) and the DECODE loop
(``chunk`` steps under a per-step active mask).  The scheduler only sets
the per-slot GRANTS:

  * prefill grants — a slot with unfed prompt tokens gets a chunk of up
    to ``prefill_tokens`` of them, clipped to end on a page boundary when
    the boundary is reachable and the chunk does not drain the prompt;
  * partial grants — a slot whose full chunk does not fit the free list
    gets as many steps/tokens as its pages allow;
  * copy-on-write — a shared block an append would touch is privatized
    first (reserved per slot, copied once per tick by ``cow_flush``);
  * fairness (``"least-served"`` or ``"slot-order"``) and a per-tick
    token budget (0 = uncapped).

It mutates the ``PagedKVCache`` through ``ensure()`` / ``cow_reserve()``
and returns a ``TickPlan``; the engine owns the device steps.  When no
slot can get step capacity the engine asks ``pick_victim`` for the slot
to preempt, under one of ``PREEMPT_POLICIES``.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.serve.cache import PagedKVCache


@dataclasses.dataclass
class TickPlan:
    """One tick's work assignment.  The engine uploads ``steps`` (B ints)
    for the decode cell (the per-step mask is built ON DEVICE) and
    ``prefill`` (B ints) alongside the ragged (B, T) token block for the
    prefill lane; ``active`` is derived lazily for tests/introspection and
    never materialized on the tick path."""
    steps: np.ndarray          # (B,) int32 — fused decode steps per slot
    chunk: int                 # scan steps in the tick's decode cell
    prefill: np.ndarray = None  # (B,) int32 — prefill-lane tokens per slot
    stalled: int = 0           # active slots that wanted work but got none
    cow_copies: int = 0        # pages privatized for this tick's appends
    reclaimed: int = 0         # retained pages reclaimed to serve grants

    def __post_init__(self):
        if self.prefill is None:
            self.prefill = np.zeros_like(self.steps)

    @property
    def active(self) -> np.ndarray:
        """(chunk, B) bool per-step decode mask (derived from steps)."""
        return np.arange(self.chunk)[:, None] < self.steps[None, :]

    @property
    def any_work(self) -> bool:
        return bool(self.steps.any()) or bool(self.prefill.any())


PREEMPT_POLICIES = ("fewest-tokens", "most-pages")


class TickScheduler:
    """Allocates each tick's per-slot grants (see module docstring) and
    picks preemption victims when the engine must reclaim capacity."""

    def __init__(self, fairness: str = "least-served", tick_budget: int = 0,
                 preempt_policy: str = "fewest-tokens"):
        if fairness not in ("least-served", "slot-order"):
            raise ValueError(f"unknown fairness policy: {fairness!r}")
        if preempt_policy not in PREEMPT_POLICIES:
            raise ValueError(f"unknown preempt policy: {preempt_policy!r} "
                             f"(choices: {PREEMPT_POLICIES})")
        self.fairness = fairness
        self.tick_budget = tick_budget
        self.preempt_policy = preempt_policy

    def _order(self, slots) -> List[int]:
        idx = range(len(slots))
        if self.fairness == "least-served":
            return sorted(idx, key=lambda i: (slots[i].served, i))
        return list(idx)

    def pick_victim(self, slots, kv: PagedKVCache,
                    generated=None, exclude=()) -> int:
        """The slot to preempt when no slot can be granted work.
        ``"fewest-tokens"``: the fewest tokens generated (the least
        recompute), ties to the most pages held, then the lowest index;
        ``"most-pages"``: the most pages held first, fewest tokens as the
        tie break.  ``generated`` maps slot -> tokens generated across
        preemptions (default: the slot's current ``out``).  Returns -1 if
        no active slot is eligible."""
        cand = [i for i, s in enumerate(slots)
                if s.active and i not in exclude]
        if not cand:
            return -1

        def gen(i):
            if generated is not None and i in generated:
                return generated[i]
            return len(slots[i].out)

        if self.preempt_policy == "most-pages":
            key = lambda i: (-len(kv.owned[i]), gen(i), i)  # noqa: E731
        else:
            key = lambda i: (gen(i), -len(kv.owned[i]), i)  # noqa: E731
        return min(cand, key=key)

    def _grant(self, kv: PagedKVCache, i: int, length: int, want: int):
        """Privatize shared blocks the appends would touch, then reserve
        pages for the largest feasible grant.  COW FIRST, then reserve:
        privatizing a shared block needs a free page, and ensure()
        extending the table could consume the last one — COW-before-ensure
        lets the slot privatize and advance within its existing pages
        instead of hoarding a fresh page it cannot write past
        (regression-tested).  Only RESERVED here (host bookkeeping); the
        one batched device copy for every page the tick privatizes is
        flushed at the end of the plan.  A reservation the granted range
        no longer reaches is ROLLED BACK (``cow_rollback``): under pool
        pressure a page privatized ahead of an append that will never
        come is a page stolen from whoever could actually advance.
        Returns (granted, cows)."""
        cows = 0
        for b in kv.shared_blocks(i, length, length + want):
            if kv.cow_reserve(i, b):
                cows += 1
            else:
                # no page free for the copy: stop before the shared
                # block — a shared page is never appended to
                want = max(0, b * kv.page - length)
                break
        granted = 0
        for s in range(want, 0, -1):
            if kv.ensure(i, length + s):
                granted = s
                break
        if cows:
            # blocks past the last one the granted appends touch: undo
            last_blk = (length + granted - 1) // kv.page if granted else -1
            cows -= kv.cow_rollback(i, last_blk + 1)
        return granted, cows

    def plan(self, slots, kv: PagedKVCache, chunk: int,
             prefill_tokens: int = 0) -> TickPlan:
        """Grant work slot by slot in fairness order.  A slot with unfed
        prompt tokens gets a PREFILL-LANE grant (page-aligned chunk of up
        to ``prefill_tokens``); everyone else gets decode steps capped at
        remaining work (budget + unfed prompt when the lane is off — chunk
        overshoot past the request's last kept token lands on the null
        page and needs no pages)."""
        B = len(slots)
        steps = np.zeros((B,), np.int32)
        prefill = np.zeros((B,), np.int32)
        budget = self.tick_budget if self.tick_budget > 0 \
            else (chunk + prefill_tokens) * B
        stalled = 0
        cows = 0
        reclaimed0 = kv.retained_reclaimed_pages
        for i in self._order(slots):
            slot = slots[i]
            if not slot.active or budget <= 0:
                continue
            length = int(kv.length[i])
            if prefill_tokens > 0 and slot.prompt_left > 0:
                want = min(prefill_tokens, slot.prompt_left, budget)
                if want < slot.prompt_left:
                    # page-aligned chunk: end on a page boundary unless
                    # the grant cannot even reach one
                    aligned = want - (length + want) % kv.page
                    if aligned > 0:
                        want = aligned
                granted, c = self._grant(kv, i, length, want)
                cows += c
                if granted == 0:
                    stalled += 1
                prefill[i] = granted
                budget -= granted
                continue
            remaining = len(slot.forced) + slot.budget - len(slot.out)
            want = min(chunk, remaining, budget)
            if want <= 0:
                continue
            granted, c = self._grant(kv, i, length, want)
            cows += c
            if granted == 0:
                stalled += 1
            steps[i] = granted
            budget -= granted
        kv.cow_flush()                  # ONE device copy for the whole tick
        return TickPlan(steps=steps, chunk=chunk, prefill=prefill,
                        stalled=stalled, cow_copies=cows,
                        reclaimed=kv.retained_reclaimed_pages - reclaimed0)
