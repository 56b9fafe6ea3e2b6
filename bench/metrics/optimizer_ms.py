"""Device ms a step inside ``AdamW.update``."""


def read(rec):
    tr = rec.get("trace")
    s = tr and tr["parts"].get("optimizer")
    return 1e3 * s / tr["steps"] if s else None
