"""Train step: loss -> grads -> AdamW update, with optional gradient
accumulation over microbatches — port of ``repro/train/train_step.py``.

The step is functional, as the JAX one: ``step(params, opt_state, batch)``
returns new parameters and optimizer state and leaves its arguments as
they were.  Gradients come from ``torch.autograd.grad`` on detached
copies of the parameters that require grad, so the caller's tensors need
not.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, tree_leaves, tree_map


def loss_and_grads(model: Model, params, batch: Dict[str, torch.Tensor]):
    """(loss, grads) of ``model.loss`` at ``params``: a detached 0-d f32
    loss and a tree of gradients in each parameter's dtype (zeros for a
    parameter the loss does not reach)."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = model.loss(leaves, batch)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, grads))
    return loss.detach(), tree_map(lambda _: next(it), params)


def split_batch(batch: Dict[str, torch.Tensor], microbatches: int
                ) -> list:
    """The batch as ``microbatches`` consecutive slices of its batch axis:
    axis 0 for ordinary leaves, axis 1 for (3, B, S) M-RoPE positions."""
    B = batch["labels"].shape[0]
    assert B % microbatches == 0, (B, microbatches)
    per = B // microbatches
    out = []
    for i in range(microbatches):
        mb = {}
        for k, x in batch.items():
            ax = 0 if x.shape[0] == B else 1
            assert x.shape[ax] == B, (x.shape, B)
            mb[k] = x.narrow(ax, i * per, per)
        out.append(mb)
    return out


def make_train_step(model: Model, optimizer: AdamW, microbatches: int = 1,
                    accum_dtype=torch.float32) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``microbatches > 1`` splits the batch on its batch axis and
    sums the microbatches' losses and gradients, the gradients in an
    ``accum_dtype`` accumulator, then divides both by their number.
    metrics: {"grad_norm", "lr", "loss"}, 0-d tensors."""

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = loss_and_grads(model, params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                                   device=p.device), params)
            for mb in split_batch(batch, microbatches):
                l, g = loss_and_grads(model, params, mb)
                loss = loss + l
                tree_map(lambda a, b: a.add_(b.to(accum_dtype)), grads, g)
                del g
            loss = loss / microbatches
            grads = tree_map(lambda g: g.div_(microbatches), grads)
        new_params, new_opt, metrics = optimizer.update(grads, opt_state,
                                                        params)
        return new_params, new_opt, dict(metrics, loss=loss)

    return step
