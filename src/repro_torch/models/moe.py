"""Mixture-of-Experts FFN: router and capacity-bounded expert blocks.

Port of ``repro/models/moe.py``: the local branch, and under a device
mesh (``dist.sharding``) the expert-parallel island of the JAX
``shard_map``.  When the ep axes of the active rules span ``tp_ep > 1``
ranks and ``G % tp_ep == 0``, each rank takes the token rows of its
batch shard and its ``G // tp_ep`` weight blocks (picked by its
row-major combined ep rank), the fsdp-sharded weight dims that EP does
not use gathered whole; capacity counts the LOCAL rows, ``n_local = (B
// n_dp) * S``, as in JAX; the partial outputs are summed over the ep
axes (a Partial value reduced by ``constrain``: an all-reduce over each
ep axis's process group).  Under a mesh without such an EP split the
local branch runs on every rank over ALL the rows (gathered), so its
capacity and token order are the unsharded call's, as GSPMD runs it.
The router (its top-k by ``sort``, which DTensor does not propagate)
runs on each rank's rows in an island of its own.

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
from repro_torch.dist import sharding
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


def _capacity(cfg: ArchConfig, n: int) -> int:
    """Switch capacity of each expert over n rows."""
    return max(1, int(cfg.capacity_factor * n * cfg.experts_per_token
                      / cfg.n_experts))


def _moe_blocks_local(xf, gates, experts, w1, w2, w3, cfg: ArchConfig,
                      capacity: int, blocks: Optional[range] = None
                      ) -> torch.Tensor:
    """Blocks ``blocks`` (all G by default) in order, ``w1[bi]`` holding
    block ``blocks[bi]``; their outputs summed in the activation dtype."""
    blocks = range(cfg.ep_shards) if blocks is None else blocks
    shards_per_e = max(1, cfg.ep_shards // cfg.n_experts)
    out = torch.zeros_like(xf)
    for bi, g in enumerate(blocks):
        w3g = w3[bi] if w3 is not None else None
        out = out + _expert_block_compute(
            xf, gates, experts, w1[bi], w2[bi], w3g, g // shards_per_e,
            capacity, cfg.ffn_kind)
    return out


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w1: torch.Tensor,
            w2: torch.Tensor, w3: Optional[torch.Tensor], cfg: ArchConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux_loss scalar f32).

    w1 (G, d, ffp); w2 (G, ffp, d); w3 (G, d, ffp), or None for gelu
    experts."""
    if sharding.on_mesh(x, w1):
        return _moe_ffn_mesh(x, router_w, w1, w2, w3, cfg)
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    gates, experts, probs = route(xf, router_w, cfg)
    aux = aux_loss(experts, probs, cfg.n_experts)
    out = _moe_blocks_local(xf, gates, experts, w1, w2, w3, cfg,
                            _capacity(cfg, B * S))
    return out.reshape(B, S, d), aux


def _moe_ffn_mesh(x, router_w, w1, w2, w3, cfg: ArchConfig):
    """``moe_ffn`` under a device mesh (see the module docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, rules = sharding.current_mesh(), sharding.active_rules()
    names = list(mesh.mesh_dim_names)
    sizes = sharding.mesh_shape(mesh)
    B, S, d = x.shape
    xf = sharding.constrain(x, "batch", None, None).reshape(B * S, d)
    xf = sharding.constrain(xf, "batch", None)
    rows = tuple(xf.placements)
    repl = (Replicate(),) * mesh.ndim

    def _route(xl, rw):
        gates, experts, probs = route(xl, rw, cfg)
        top1 = F.one_hot(experts[..., 0], cfg.n_experts).to(torch.float32)
        return gates, experts, probs, top1

    gates, experts, probs, top1 = sharding.island(
        _route, mesh, (xf, router_w), (rows, repl), (rows,) * 4)
    # aux_loss over every row: E * sum_e f_e P_e of the global means
    f = sharding.constrain(top1.mean(dim=0), None)
    aux = cfg.n_experts * torch.sum(f * sharding.constrain(
        probs.mean(dim=0), None))

    ep_axes = tuple(a for a in rules.ep_axes if a in sizes)
    tp_ep = 1
    for a in ep_axes:
        tp_ep *= sizes[a]
    if tp_ep > 1 and cfg.ep_shards % tp_ep == 0:
        # the expert-parallel island: each rank its batch shard's rows and
        # its ep shard's blocks; the outputs Partial over the ep axes
        batch_axes = tuple(a for a in rules.batch_axes if a in sizes)
        n_dp = 1
        for a in batch_axes:
            n_dp *= sizes[a]
        n = (B // max(1, n_dp)) * S
        ep_dims = sorted(names.index(a) for a in ep_axes)   # DTensor's order
        tok_pl = tuple(Shard(0) if a in batch_axes else Replicate()
                       for a in names)
        w_pl = tuple(Shard(0) if a in ep_axes else Replicate()
                     for a in names)
        out_pl = tuple(Partial() if a in ep_axes else p
                       for a, p in zip(names, tok_pl))
    else:
        # the local branch, on every rank over all the rows
        n, ep_dims, tok_pl, w_pl, out_pl = B * S, [], repl, repl, repl
    capacity = _capacity(cfg, n)
    per_rank = cfg.ep_shards // (tp_ep if ep_dims else 1)

    def _blocks(xl, gl, el, w1l, w2l, w3l=None):
        r = sharding.mesh_coordinate(mesh, ep_dims)   # combined ep rank
        return _moe_blocks_local(xl, gl, el, w1l, w2l, w3l, cfg, capacity,
                                 range(r * per_rank, (r + 1) * per_rank))

    ws = (w1, w2) if w3 is None else (w1, w2, w3)
    out = sharding.island(_blocks, mesh, (xf, gates, experts, *ws),
                          (tok_pl,) * 3 + (w_pl,) * len(ws), out_pl)
    out = sharding.constrain(out, "batch", None)     # the sum over ep
    out = sharding.constrain(out.reshape(B, S, d), "batch", None, None)
    return out.to(x.dtype), aux
