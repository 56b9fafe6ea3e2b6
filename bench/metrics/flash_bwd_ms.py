"""Device ms a step of the kernels that ``flash_bwd`` (the plain chunked
flash backward) launches, attributed by its range and autograd node."""


def read(rec):
    tr = rec.get("trace")
    s = tr and tr["parts"].get("flash backward")
    return 1e3 * s / tr["steps"] if s else None
