"""The time a tick waits for the device: over the traced span's
``engine.tick`` spans, the mean ms of their ``engine.upload`` and
``engine.readback`` descendants (the port's spans); shared by
``tick_wait_ms.chat`` and ``.rag``.  ``tick_host_ms`` is the rest of a
tick's wall time."""
from work import program_spans as ps


def read(rec):
    ticks = ps.roots("engine.tick")
    return sum(ps.wait_ms(kids) for _, kids in ticks) / len(ticks) \
        if ticks else None
