"""The window's model FLOPs against the bf16 peak: 2 x the
non-embedding parameters x the tokens processed (prompt and output K/V
rows appended) in the window, over the window's length."""
from work import model


def read(rec):
    n = rec.get("tokens_appended")
    if not n or rec.get("window_s", 0) <= 0:
        return None
    return 100.0 * model.forward_flops(rec["cfg"], n) / rec["window_s"] \
        / rec["peaks"]["bf16_flops_per_s"]
