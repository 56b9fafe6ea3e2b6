"""Reading a ``torch.profiler`` trace of the port: device time by kernel,
by the benchmark's ranges, the device's busy time and its idle gaps.

The ranges are put around the program's entry points from outside
(``marked``), by the benchmark's own files; spans inside the program are
a later change.  Each kernel is counted once: in the part of the
innermost marked range, or autograd node, that launched it, a node
belonging to the part whose range ran its forward op (matched by
sequence number and thread), so that a part's backward kernels count
with it; else in no part.  That attribution is a frozen copy of
``chip_smoke.py::train_split``; the parsing of device time by kernel name
follows ``scripts/torch_kernel_profile.py``.
"""
from __future__ import annotations

import contextlib
import inspect
from typing import Dict, List, Sequence, Tuple

AUTOGRAD_NODE = "autograd::engine::evaluate_function: "


@contextlib.contextmanager
def marked(marks: Sequence[Tuple[object, str, str]]):
    """Within the block, each (owner, attribute, part) of ``marks`` runs
    inside a ``record_function`` range named ``part``; the attributes are
    put back afterwards."""
    import torch
    saved = [(o, a, inspect.getattr_static(o, a)) for o, a, _ in marks]

    def wrap(fn, part):
        def inner(*args, **kw):
            with torch.profiler.record_function(part):
                return fn(*args, **kw)
        return inner

    for (o, a, part), (_, _, raw) in zip(marks, saved):
        fn = wrap(getattr(o, a), part)
        setattr(o, a, staticmethod(fn) if isinstance(raw, staticmethod)
                else fn)
    try:
        yield
    finally:
        for o, a, raw in saved:
            setattr(o, a, raw)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(prof, parts: Sequence[str], window_s: float) -> Dict:
    """The traced span's device activity: ``by_kernel`` {name: s},
    ``parts`` {part: device s}, ``busy_s`` (the union of kernel
    intervals), ``window_s``, and ``idle`` {what the host was doing:
    idle s} (the innermost range around each gap's middle).  With host
    events traced, the host runs slower than it does untraced;
    ``quiet_span`` gives the busy share without them.  The profiler has
    to start with the device idle (``traced``), so that every kernel it
    holds ran inside the span; a trace with more busy time than
    ``window_s`` is a miscount, and raises."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    host = [e for e in events if e.device_type != cuda]
    names = {e.name for e in host}
    # the device timeline also carries each range as an annotation of
    # the range's name: only kernels (names no CPU event has) count
    kernels = [e for e in events if e.device_type == cuda
               and e.name not in names]
    part_set = set(parts)

    def in_range(e):
        while e is not None and e.name not in part_set:
            e = e.cpu_parent
        return e and e.name

    made = {(e.sequence_nr, e.thread): in_range(e) for e in host
            if e.sequence_nr >= 0 and not e.name.startswith(AUTOGRAD_NODE)
            and in_range(e)}

    def owner(e):
        while e is not None:
            if e.name in part_set:
                return e.name
            if e.name.startswith(AUTOGRAD_NODE):
                part = made.get((e.sequence_nr, e.fwd_thread))
                if part:
                    return part
            e = e.cpu_parent
        return None

    by_part = {p: 0.0 for p in parts}
    for e in host:
        us = sum(k.duration for k in e.kernels)
        part = owner(e) if us else None
        if part:
            by_part[part] += us / 1e6
    by_kernel: Dict[str, float] = {}
    spans = []
    for k in kernels:
        s, t = k.time_range.start, k.time_range.end
        by_kernel[k.name] = by_kernel.get(k.name, 0.0) + (t - s) / 1e6
        spans.append((s, t))
    merged = _union(spans)
    busy = sum(t - s for s, t in merged) / 1e6
    if busy > window_s:
        raise RuntimeError(f"the trace holds {busy!r} s of device activity "
                           f"in a span of {window_s!r} s")
    ranges = sorted(((e.time_range.start, e.time_range.end, e.name)
                     for e in host if e.name in part_set),
                    key=lambda r: r[1] - r[0])
    idle: Dict[str, float] = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        label = next((n for s, t, n in ranges if s <= mid <= t),
                     "outside the marked ranges")
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return {"by_kernel": by_kernel, "parts": by_part,
            "busy_s": busy, "window_s": window_s,
            "idle": idle}


@contextlib.contextmanager
def traced(device, activities):
    """A ``torch.profiler`` trace of the block, started with the device
    idle, so that no kernel launched before the block is in it; yields
    [prof, span], the block's seconds from its start to the device's last
    kernel filled in at its end."""
    import time

    import torch
    from torch.profiler import profile
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    out = [None, None]
    with profile(activities=activities) as prof:
        out[0] = prof
        t0 = time.perf_counter()
        yield out
        if cuda:
            torch.cuda.synchronize()
        out[1] = time.perf_counter() - t0


def quiet_span(run, device):
    """(busy s, window s) of ``run()`` traced with the device's activity
    alone: without host op events the profiler adds little to the host's
    time, which the idle share would otherwise carry.  None off CUDA, or
    where the trace holds no device operation."""
    import torch
    from torch.profiler import ProfilerActivity
    if torch.device(device).type != "cuda":
        return None
    with traced(device, [ProfilerActivity.CUDA]) as t:
        run()
    busy = summarize(t[0], [], t[1])["busy_s"]
    return (busy, t[1]) if busy > 0 else None


def breakdown(summary: Dict, n: int = 10) -> Dict:
    """The result line's ``breakdown``: the device operations that took
    most time, and the idle gaps by what the host was doing."""
    top = sorted(summary["by_kernel"].items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[f"idle while {k}", v] for k, v in gaps]}


def kernel_seconds(summary: Dict, *needles: str) -> float:
    """Device seconds of the kernels whose name holds any of
    ``needles``."""
    return sum(s for name, s in summary["by_kernel"].items()
               if any(n in name for n in needles))
