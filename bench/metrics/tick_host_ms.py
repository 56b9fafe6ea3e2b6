"""The engine's host time per tick over the window: the sum of
``PagedEngine.host_ms_trace`` (each tick's wall time less its waits for
the device) over the window's ticks, divided by their number."""


def read(rec):
    t = rec.get("tick_host_ms")
    return sum(t) / len(t) if t else None
