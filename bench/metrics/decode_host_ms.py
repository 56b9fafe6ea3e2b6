"""The host's time a decode step: over the traced span's
``engine.decode_loop`` spans (inside ticks on the device), their duration
less their waits for the device (the feed's and grants' uploads), over
the decode steps they dispatched (``num_steps``)."""
from work import program_spans as ps


def read(rec):
    host = steps = 0
    for _, kids in ps.roots("engine.tick"):
        for loop in (k for k in kids if k.name == "engine.decode_loop"):
            host += loop.ms - ps.wait_ms(
                [k for k in kids if k.parent == loop.id])
            steps += loop.attrs["num_steps"]
    return host / steps if steps else None
