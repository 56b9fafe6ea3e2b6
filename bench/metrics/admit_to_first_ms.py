"""The p75 of the time from a request's first admission to its first
token (nearest rank, as ``ttft_p75_ms``, which it splits): the port's
``request.prefill`` spans that ended in the traced span's ticks."""
import common
from work import program_spans as ps


def read(rec):
    t = [s.ms for s in ps.named("request.prefill")]
    return common.quantile(t, 0.75) if t else None
