"""Device ms a step of the fused unembedding cross-entropy
(``models/losses.py::_FusedXent``), forward and backward."""


def read(rec):
    tr = rec.get("trace")
    s = tr and tr["parts"].get("fused loss")
    return 1e3 * s / tr["steps"] if s else None
