"""Seeded fault injection for the paged serving engine — a copy of
``repro/serve/faults.py`` (plain data and numpy).

A ``FaultPlan`` is a deterministic schedule of events keyed on the
engine's tick counter, so every injected overload schedule replays
exactly, and ``FaultPlan.random`` gives the JAX package's plan from the
same seed (the same ``np.random.RandomState`` draws in the same order),
so one plan can drive both engines.

Event kinds (handled in ``PagedEngine._apply_faults`` / ``step``):

  * ``squeeze`` — pool pressure: ``pages`` pages leave the free list for
    ``duration`` ticks (``PagedKVCache.seize_pages``), as if another
    tenant allocated them;
  * ``evict`` — forced eviction of ``slot`` (any active slot if that one
    is inactive): the request requeues and recomputes;
  * ``drop`` — the tick's granted work for ``slot`` (< 0: every slot) is
    lost after planning; the scheduler grants it again next tick;
  * ``poison`` — the slot's sampled tokens come back out of vocabulary
    this tick (the stand-in for nonfinite logits); the engine's output
    guard quarantines the slot and requeues the request with its
    pre-tick output;
  * ``kill`` — process death: the engine raises ``EngineKilled`` at the
    top of the tick, before any state changes; the caller restores the
    newest snapshot into a fresh engine (``serve/snapshot.py``).

``FaultPlan.random`` samples only the recoverable kinds by default.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

RECOVERABLE_KINDS = ("squeeze", "evict", "drop", "poison")
FAULT_KINDS = RECOVERABLE_KINDS + ("kill",)


class EngineKilled(RuntimeError):
    """Raised when a ``kill`` event fires; ``tick`` is the tick the kill
    pre-empted (its work never ran)."""

    def __init__(self, tick: int):
        super().__init__(f"engine killed by fault plan at tick {tick}")
        self.tick = tick


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault, fired when the engine's tick counter reaches
    ``tick``.  ``slot`` targets a slot index for evict/drop/poison (-1:
    the engine picks / every slot); ``pages`` and ``duration`` size a
    squeeze."""
    tick: int
    kind: str
    slot: int = -1
    pages: int = 0
    duration: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind: {self.kind!r} "
                             f"(choices: {FAULT_KINDS})")
        if self.tick < 1:
            raise ValueError("fault tick must be >= 1 (ticks are counted "
                             "from the first step() call)")
        if self.kind == "squeeze" and (self.pages < 1 or self.duration < 1):
            raise ValueError("squeeze needs pages >= 1 and duration >= 1")


class FaultPlan:
    """An immutable, replayable schedule of ``FaultEvent``s; arm it with
    ``PagedEngine.install_faults(plan)``."""

    def __init__(self, events: List[FaultEvent] = ()):  # noqa: B006
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.tick, e.kind, e.slot)))
        self._by_tick: Dict[int, List[FaultEvent]] = {}
        for ev in self.events:
            self._by_tick.setdefault(ev.tick, []).append(ev)

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        kinds = {}
        for ev in self.events:
            kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
        return f"FaultPlan({len(self.events)} events: {kinds})"

    def events_at(self, tick: int) -> List[FaultEvent]:
        return self._by_tick.get(tick, [])

    @property
    def last_tick(self) -> int:
        return self.events[-1].tick if self.events else 0

    def without_kills_through(self, tick: int) -> "FaultPlan":
        """A new plan with every ``kill`` at or before ``tick`` removed, so
        a restored engine replays the recoverable events but not the kill
        that already fired."""
        return FaultPlan([ev for ev in self.events
                          if not (ev.kind == "kill" and ev.tick <= tick)])

    @classmethod
    def random(cls, seed: int, *, n_events: int = 6, max_tick: int = 40,
               max_batch: int = 4, max_pages: int = 4,
               max_duration: int = 6, deep_squeeze: float = 0.25,
               kinds: Tuple[str, ...] = RECOVERABLE_KINDS) -> "FaultPlan":
        """``n_events`` events uniformly over ticks [1, max_tick], kinds
        from ``kinds``, slots from [-1, max_batch), squeezes of up to
        ``max_pages`` pages for up to ``max_duration`` ticks; with
        probability ``deep_squeeze`` a squeeze asks for 4x ``max_pages``,
        more than the free list usually holds, so it drains the retained
        pool too.  Same seed, same plan."""
        rng = np.random.RandomState(seed)
        events = []
        for _ in range(n_events):
            kind = kinds[rng.randint(len(kinds))]
            tick = int(rng.randint(1, max_tick + 1))
            slot = int(rng.randint(-1, max_batch))
            if kind == "squeeze":
                pages = int(rng.randint(1, max_pages + 1))
                if rng.rand() < deep_squeeze:
                    pages = 4 * max_pages
                events.append(FaultEvent(
                    tick, kind, pages=pages,
                    duration=int(rng.randint(1, max_duration + 1))))
            else:
                events.append(FaultEvent(tick, kind, slot=slot))
        return cls(events)
