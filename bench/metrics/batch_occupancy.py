"""The share of the engine's slots that held a request in each tick of
the window (running after the tick, or finished in it), averaged over
the ticks.  ``PagedEngine.occupancy_trace`` is another quantity, the
fill of the live pages' rows."""


def read(rec):
    t = rec.get("occupancy")
    return 100.0 * sum(t) / len(t) if t else None
