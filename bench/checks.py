"""The numbers that decide ``correct``: each compares what the timed path
produced with the plain reference, and has a limit of its own
(``bench/limits/<cell>.json``), set from the readings in PERF.md.

Training: the gap between the program's and the reference's norm of
step 1's gradient as the optimizer got it (``grad_gap``), and of each
leaf's change over the steps the reference follows (``change_gap``),
taken by the worst leaf against the reference's norm of that leaf or of
the median leaf, whichever is larger; and, the same way, the norm of the
difference of step 1's gradients (``grad_diff``): a gap of norms is second
order in rounding that does not lean one way, so it cannot tell bf16 from
fp8, and the difference can.  Leaves whose reference gradient is under a
thousandth of the median leaf's (a key's bias under softmax) move by
round-off alone and are left out of the change.  The losses' gaps, of
step 1 (``loss1_gap``) and of every step (``loss_gap``), are read but not
judged: neither the fp8 control nor a fault separates from the program's
own readings there (PERF.md).  Serving: the widest gap by which a served
token's reference logit lies below the reference's best.
"""
from __future__ import annotations

import statistics
from typing import Dict, List


def loss_gap(got: List[float], want: List[float]) -> float:
    """The largest relative gap of a step's loss."""
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def norm_gap(got: Dict[str, float], want: Dict[str, float],
             keep=None) -> float:
    """max over leaves of |got - want| / max(want, median of want)."""
    keys = [k for k in want if keep is None or k in keep]
    med = statistics.median(want[k] for k in keys)
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in keys)


def diff_gap(got: Dict, want: Dict) -> float:
    """max over leaves of |got - want| / max(|want|, median |want|), the
    leaves' tensors on the host."""
    import torch
    norms = {k: float(torch.linalg.vector_norm(w)) for k, w in want.items()}
    med = statistics.median(norms.values())
    return max(float(torch.linalg.vector_norm(got[k] - want[k]))
               / max(norms[k], med, 1e-30) for k in want)


def moved_leaves(grad: Dict[str, float]) -> set:
    """The leaves whose reference gradient is at least a thousandth of
    the median leaf's."""
    med = statistics.median(grad.values())
    return {k for k, g in grad.items() if g >= 1e-3 * med}


def train_checks(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every training number of a program's (or a control's) readings
    against the reference's."""
    keep = moved_leaves(ref["grad"])
    return {"loss1_gap": loss_gap(prog["losses"][:1], ref["losses"][:1]),
            "loss_gap": loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": norm_gap(prog["grad"], ref["grad"]),
            "change_gap": norm_gap(prog["change"], ref["change"], keep),
            "grad_diff": diff_gap(prog["g1"], ref["g1"])}


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number at most its
    limit; a number that is not finite fails."""
    checks = {k: {"value": float(values[k]), "limit": float(limits[k])}
              for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
