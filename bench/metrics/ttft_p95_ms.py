"""The 95th percentile of time to first token over the requests sent in
the window (a request without its first token at the close counts the
time it has waited); shared by ``ttft_p95_ms.chat`` and ``.rag``."""
import common


def read(rec):
    t = rec.get("ttft_ms")
    return common.quantile(t, 0.95) if t else None
