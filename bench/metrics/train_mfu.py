"""Model FLOPs of the window's steps against the bf16 peak: 6 N D a step
(N with the embedding, D the step's tokens) over the window's length."""
from work import model


def read(rec):
    if not rec.get("steps"):
        return None
    flops = model.train_step_flops(rec["cfg"], rec["step_tokens"])
    return 100.0 * flops * rec["steps"] / rec["window_s"] \
        / rec["peaks"]["bf16_flops_per_s"]
