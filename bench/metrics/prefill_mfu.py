"""The prefill lane's model FLOPs against the bf16 peak: 2 x the
non-embedding parameters x the prompt tokens granted in the window, over
the window's length; the whole lane's share, beside its kernel's
roofline."""
from work import model


def read(rec):
    n = rec.get("prompt_tokens")
    if not n or rec.get("window_s", 0) <= 0:
        return None
    return 100.0 * model.forward_flops(rec["cfg"], n) / rec["window_s"] \
        / rec["peaks"]["bf16_flops_per_s"]
