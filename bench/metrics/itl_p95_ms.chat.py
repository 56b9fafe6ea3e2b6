"""The 95th percentile of the gaps between a request's output ticks,
over the gaps that ended in the window."""
import common


def read(rec):
    t = rec.get("itl_ms")
    return common.quantile(t, 0.95) if t else None
