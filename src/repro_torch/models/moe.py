"""Mixture-of-Experts FFN: router and capacity-bounded expert blocks.

Port of ``repro/models/moe.py``, its local branch: one card is world size
1, so the JAX package's ``shard_map`` island (expert blocks sharded over
the mesh's model axis, combined by a psum) has no counterpart here; it
waits for the multi-device port.

Expert weights keep the JAX block layout ``(G, d, ffp)``: ``G =
cfg.ep_shards`` blocks partition the ``E x d_ff`` expert volume,
``ffp = E * d_ff // G``, and block g holds expert ``g // (G // E)``,
ff-slice ``g % (G // E)``.  The down-projection contracts over ff, so
the blocks' partial outputs sum to the expert's output (llama4: E = G =
16; full grok-1: E 8, G 16, two ff-slices an expert).

Capacity is Switch-style and counts EVERY row of the call: ``C =
max(1, int(capacity_factor * n * k / E))`` with n = B * S, rows taken
in index order, the overflow dropped.  Rows that carry no request (idle
slots, pad rows past a prefill grant, inactive decode slots) route and
take capacity like any other, exactly as in the JAX package; so a
serving engine's tokens depend on what its idle rows hold and on how
many rows a call has.

Nothing here waits for the device: no host read of a count, no skipped
empty block.  Every block runs over its C rows (zeros where fewer rows
picked it), as the JAX function does.  The expert products are plain
``@``, as the JAX package computes them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense


def route(xf: torch.Tensor, router_w: torch.Tensor, cfg: ArchConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf (n, d) -> (gates (n, k) f32, experts (n, k) int64, probs (n, E)
    f32).  The router dot runs in the activation dtype, the softmax in
    f32; the top k are taken lowest index first among equal
    probabilities (``lax.top_k``'s order) and their gates renormalised
    by max(sum, 1e-9)."""
    logits = dense(xf, router_w.to(xf.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates, experts = gates[:, :k], experts[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, experts, probs


def aux_loss(experts: torch.Tensor, probs: torch.Tensor,
             n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum_e f_e * P_e (f over the
    top-1 choices)."""
    f = F.one_hot(experts[..., 0], n_experts).to(torch.float32).mean(dim=0)
    p = probs.mean(dim=0)
    return n_experts * torch.sum(f * p)


def _expert_block_compute(xf, gates, experts, w1g, w2g, w3g, e: int,
                          capacity: int, ffn_kind: str) -> torch.Tensor:
    """The rows routed to expert ``e`` -> their gated partial FFN output
    scattered back to (n, d).  The rows that picked ``e`` come first, in
    index order, then the others; the first ``capacity`` are taken and
    the unselected among them zeroed."""
    n = xf.shape[0]
    w_tok = torch.where(experts == e, gates, 0.0).sum(dim=-1)       # (n,)
    sel = w_tok > 0
    idx = torch.arange(n, device=xf.device)
    score = torch.where(sel, idx, n + idx)
    order = torch.argsort(score, stable=True)[:capacity]
    valid = sel[order]
    toks = xf[order] * valid[:, None].to(xf.dtype)                  # (C, d)
    if ffn_kind == "swiglu":
        h = F.silu(dense(toks, w1g)) * dense(toks, w3g)
    else:
        h = F.gelu(dense(toks, w1g), approximate="tanh")
    y = dense(h, w2g)                                               # (C, d)
    y = y * (w_tok[order] * valid)[:, None].to(y.dtype)
    return torch.zeros_like(xf).index_add_(0, order, y)


def _moe_blocks_local(xf, gates, experts, w1, w2, w3, cfg: ArchConfig,
                      capacity: int) -> torch.Tensor:
    """All G blocks in order, their outputs summed in the activation
    dtype."""
    shards_per_e = max(1, cfg.ep_shards // cfg.n_experts)
    out = torch.zeros_like(xf)
    for g in range(cfg.ep_shards):
        w3g = w3[g] if w3 is not None else None
        out = out + _expert_block_compute(
            xf, gates, experts, w1[g], w2[g], w3g, g // shards_per_e,
            capacity, cfg.ffn_kind)
    return out


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w1: torch.Tensor,
            w2: torch.Tensor, w3: Optional[torch.Tensor], cfg: ArchConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux_loss scalar f32).

    w1 (G, d, ffp); w2 (G, ffp, d); w3 (G, d, ffp), or None for gelu
    experts."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    gates, experts, probs = route(xf, router_w, cfg)
    aux = aux_loss(experts, probs, cfg.n_experts)
    n = B * S
    capacity = max(1, int(cfg.capacity_factor * n * cfg.experts_per_token
                          / cfg.n_experts))
    out = _moe_blocks_local(xf, gates, experts, w1, w2, w3, cfg, capacity)
    return out.reshape(B, S, d), aux
