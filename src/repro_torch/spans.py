"""Spans inside the port: named, nested intervals on the host's clock,
each with a count of the synchronizing CUDA calls made inside it.

    from repro_torch import spans

    with spans.span("engine.tick", tick=n):
        with spans.span("engine.plan"):
            ...
    records = spans.take()

Each finished span is a ``Span``: its name, its parent (the span open
when it began) and root (the outermost one), start and end in
``time.perf_counter_ns``, its attributes, and ``syncs``, the synchronizing
calls made while it was the innermost open span, by calling ``file:line``.
Spans are kept in memory, in a buffer of the newest ``LIMIT``; a root's
descendants join the buffer when the root closes, so a root that
``discard`` drops takes them along.  ``record`` adds a span whose interval
is already known (a request's time in the queue).

On and off.  The recorder is on while a ``torch.profiler`` session is
live, or inside ``recording()``; otherwise ``span`` hands back one shared
null context after one flag check, and nothing is recorded.  While a
profiler is live each span is also a ``record_function`` range of its
name, so it lies on the profiler's timeline beside the kernels it
launched.

Synchronizing calls.  While a root span is open, with the recorder on and
CUDA initialized, CUDA's sync debug mode is "warn": each synchronizing
call (a blocking copy, ``torch.tensor`` onto the device, ``.cpu()``,
``.item()``) raises a warning, which the recorder takes into the
``syncs`` of the innermost open span at the Python line that made it.
Other warnings pass through.  The mode, the warning filters and
``warnings.showwarning`` are put back when the root closes.

One stack of open spans serves the process: the engine and the trainer
open spans from one thread, and the autograd engine's device thread runs
a custom backward (and its spans) while that thread waits on it.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import time
import warnings
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

LIMIT = 1 << 16                          # spans the buffer keeps
SYNC_WARNING = "called a synchronizing CUDA operation"


class Span:
    """One finished (or open) span; times in ``perf_counter_ns``.
    ``syncs`` is None where the recorder did not count (no CUDA)."""
    __slots__ = ("name", "id", "parent", "root", "start", "end", "attrs",
                 "syncs", "_kids", "_dropped")

    def __init__(self, name: str, sid: int, parent: Optional["Span"],
                 attrs: dict):
        self.name, self.id, self.attrs = name, sid, attrs
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else sid
        self.start = self.end = 0
        self.syncs: Optional[Dict[str, int]] = None
        self._kids: List[Span] = []     # a root's finished descendants
        self._dropped = False

    @property
    def ms(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def n_syncs(self) -> int:
        return sum(self.syncs.values()) if self.syncs else 0

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.ms:.3f} ms, id={self.id}, "
                f"parent={self.parent}, {self.attrs})")


class _Null:
    """The context ``span`` hands back while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


NULL = _Null()


class _Recorder:
    """The process's recorder: the open spans, the finished ones, and the
    sync counting that a root switches on."""

    def __init__(self):
        self.ids = itertools.count(1)
        self.stack: List[Span] = []
        self.done: collections.deque = collections.deque(maxlen=LIMIT)
        self.explicit = 0                 # depth of recording() blocks
        self.saved = None                 # what a counting root replaced

    def on(self) -> bool:
        return bool(self.explicit or _profiler._is_profiler_enabled)

    # -- sync counting ------------------------------------------------------

    @staticmethod
    def _counting() -> bool:
        return torch.cuda.is_available() and torch.cuda.is_initialized()

    def _start_counting(self) -> None:
        mode = None
        if torch.cuda.is_initialized():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        self.saved = (mode, warnings.filters[:], warnings.showwarning)
        warnings.filterwarnings("always", message=SYNC_WARNING)
        shown = self.saved[2]

        def show(message, category, filename, lineno, file=None,
                 line=None):
            if self.stack and str(message).startswith(SYNC_WARNING):
                top = self.stack[-1]
                key = f"{_short(filename)}:{lineno}"
                top.syncs[key] = top.syncs.get(key, 0) + 1
            else:
                shown(message, category, filename, lineno, file, line)
        warnings.showwarning = show

    def _stop_counting(self) -> None:
        mode, filters, shown = self.saved
        self.saved = None
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        warnings.filters[:] = filters
        warnings._filters_mutated()
        warnings.showwarning = shown

    # -- spans ----------------------------------------------------------------

    def open(self, sp: Span) -> None:
        if not self.stack and self._counting():
            self._start_counting()
        if self.saved is not None:
            sp.syncs = {}
        self.stack.append(sp)

    def close(self, sp: Span) -> None:
        self.stack.pop()
        if self.stack:                    # the root is the outermost
            self.stack[0]._kids.append(sp)
            return
        if self.saved is not None:
            self._stop_counting()
        if not sp._dropped:
            self.done.extend(sp._kids)
            self.done.append(sp)
        sp._kids = []


_REC = _Recorder()


class _Open:
    """A live span's context: its ``record_function`` range while a
    profiler is live.  The span's clock is read right inside the range,
    so that the two agree to the cost of one call."""
    __slots__ = ("sp", "rf")

    def __init__(self, sp: Span):
        self.sp, self.rf = sp, None

    def __enter__(self) -> Span:
        sp = self.sp
        _REC.open(sp)
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(sp.name)
            self.rf.__enter__()
        sp.start = time.perf_counter_ns()
        return sp

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self.sp
        sp.end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        if exc_type is not None:
            sp.attrs["error"] = exc_type.__name__
        _REC.close(sp)
        return False


def on() -> bool:
    """Whether spans are being recorded."""
    return _REC.on()


def span(name: str, **attrs):
    """A context that records the block as a span named ``name`` with
    ``attrs``, and yields the ``Span`` (its ``attrs`` may still be added
    to); off, the shared null context, which yields None."""
    if not (_REC.explicit or _profiler._is_profiler_enabled):
        return NULL
    stack = _REC.stack
    return _Open(Span(name, next(_REC.ids), stack[-1] if stack else None,
                      attrs))


def discard(sp: Optional[Span]) -> None:
    """Drop the open root span ``sp`` and its descendants: they are not
    recorded when it closes.  None (the recorder was off) is a no-op."""
    if sp is not None:
        sp._dropped = True


def record(name: str, start_s: float, end_s: float, **attrs) -> None:
    """Record a root span over [start_s, end_s] of ``time.perf_counter``,
    an interval the caller timed itself, if the recorder is on."""
    if not _REC.on():
        return
    sp = Span(name, next(_REC.ids), None, attrs)
    sp.start, sp.end = int(start_s * 1e9), int(end_s * 1e9)
    _REC.done.append(sp)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """The recorder on for the block, without a profiler."""
    _REC.explicit += 1
    try:
        yield
    finally:
        _REC.explicit -= 1


def take() -> List[Span]:
    """The finished spans, oldest root first, each root after its
    descendants (a copy: the buffer keeps them; ``clear`` empties it)."""
    return list(_REC.done)


def clear() -> None:
    _REC.done.clear()


# -- reading ----------------------------------------------------------------

def trees(records: List[Span], name: str) -> List[Tuple[Span, List[Span]]]:
    """(root, its descendants) for each root span named ``name``."""
    kids: Dict[int, List[Span]] = {}
    for s in records:
        if s.root != s.id:
            kids.setdefault(s.root, []).append(s)
    return [(s, kids.get(s.id, [])) for s in records
            if s.name == name and s.root == s.id]


def self_ns(records: List[Span]) -> Dict[int, int]:
    """Each span's self time: its duration less the part of it that its
    children cover."""
    kids: Dict[int, List[Tuple[int, int]]] = {}
    for s in records:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append((s.start, s.end))
    out = {}
    for s in records:
        covered, reach = 0, s.start
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, reach), min(b, s.end)
            if b > a:
                covered += b - a
                reach = b
        out[s.id] = s.end - s.start - covered
    return out


def _short(path: str) -> str:
    """A source path from its package down (``repro_torch/...``,
    ``torch/...``)."""
    p = path.replace("\\", "/")
    for anchor in ("/src/", "/site-packages/", "/dist-packages/"):
        i = p.rfind(anchor)
        if i >= 0:
            return p[i + len(anchor):]
    return p
