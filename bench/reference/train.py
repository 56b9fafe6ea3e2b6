"""The plain reference of a training job's first steps: the loss and
gradients of ``dense_lm.row_loss_sum`` over the batch (the mean token
NLL, one row at a time), the global-norm clip and AdamW, in float32 with
TF32 off, from the weights and batches that the benchmark made.

AdamW as the configuration's job states it: m = b1 m + (1 - b1) g,
v = b2 v + (1 - b2) g^2, p -= lr ((m / (1 - b1^t)) / (sqrt(v / (1 -
b2^t)) + eps) + wd p), every leaf decayed; the gradients clipped to a
global norm of ``clip`` first.  The parameters are stored in the dtype
the configuration gives them (bf16: each step's result is rounded to
it), as the job runs them; all arithmetic is float32.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from reference import dense_lm

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaves(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path: tensor} of a nested dict, keys sorted at every level."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(leaves(v, path))
        else:
            out[path] = v
    return out


def _rebuild(tree: Dict, flat: Dict[str, torch.Tensor], prefix: str = ""):
    return {k: (_rebuild(tree[k], flat, f"{prefix}/{k}")
                if isinstance(tree[k], dict) else flat[f"{prefix}/{k}"])
            for k in sorted(tree)}


def run(weights: Dict, cfg: Dict, job: Dict, batches: List[Dict],
        precision: str = "f32") -> Dict:
    """Follows ``len(batches)`` steps from ``weights``.  Returns the loss
    of each step, each leaf's norm of step 1's clipped gradient
    (``grad``) and the gradient itself on the host (``g1``), and each
    leaf's norm of its change over all the steps (``change``)."""
    dense_lm.no_tf32()
    store = DTYPES[cfg["torch_dtype"]]
    opt = job["optimizer"]
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    flat0 = {k: v.to(torch.float32) for k, v in leaves(weights).items()}
    p = {k: v.clone().requires_grad_(True) for k, v in flat0.items()}
    m = {k: torch.zeros_like(v) for k, v in flat0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in flat0.items()}
    losses, grad_norms, g1 = [], {}, {}
    for t, batch in enumerate(batches, start=1):
        tree = _rebuild(weights, p)
        tokens, labels = batch["tokens"], batch["labels"]
        n = labels.numel()
        total = 0.0
        for r in range(tokens.shape[0]):
            loss = dense_lm.row_loss_sum(tree, cfg, tokens[r], labels[r],
                                         precision) / n
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            # a leaf the loss does not reach (a norm's unused bias)
            g = {k: (torch.zeros_like(x) if x.grad is None else x.grad)
                 for k, x in p.items()}
            gnorm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
            scale = torch.clamp(opt["clip"] / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
            for k, x in p.items():
                gk = g[k] * scale
                if t == 1:
                    grad_norms[k] = float(torch.linalg.vector_norm(gk))
                    g1[k] = gk.cpu()
                m[k] = b1 * m[k] + (1 - b1) * gk
                v2[k] = b2 * v2[k] + (1 - b2) * gk * gk
                upd = (m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + eps) \
                    + opt["weight_decay"] * x
                x.sub_(opt["lr"] * upd)
                x.copy_(x.to(store).to(torch.float32))
                x.grad = None
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(p[k] - flat0[k]))
                  for k in p}
    return {"losses": losses, "grad": grad_norms, "g1": g1,
            "change": change}
