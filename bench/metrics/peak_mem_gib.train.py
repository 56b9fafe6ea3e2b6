"""``torch.cuda.max_memory_allocated`` over the window, after a reset at
its start, in GiB."""


def read(rec):
    b = rec.get("window_peak_bytes")
    return b / 2 ** 30 if b else None
