"""The share of the traced span (serving: ticks; training: a step) in
which no kernel ran; shared by ``device_idle_pct.chat``, ``.rag`` and
``.train``."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"]
