"""Fused unembed + softmax cross-entropy, sequence-chunked, with its own
backward — port of ``repro/models/losses.py::fused_unembed_xent``.

The logits of a whole batch are never held: (B, S, V) f32 is 20 GB for
8 x 4096 tokens at qwen2's V = 151936.  Forward: per chunk of c
positions, the chunk's logits h_c table^T (in the activation dtype, then
f32), reduced to the rows' logsumexp and gold logit and dropped.  Saved
for the backward: h, table, labels and the per-position lse, O(B S).
Backward: per chunk, the logits again, dlog = (softmax - onehot) g / (B
S) in f32, cast to the table's dtype before both products as in the JAX
function; dh is emitted per chunk and dE accumulates in f32.  The one-hot
is not built: 1.0 is taken from the softmax at each gold index, the same
arithmetic.  These are plain large matrix products (the JAX function
computes them in jnp, outside any Pallas kernel), so ``torch.matmul`` is
their counterpart here.

Under a device mesh the loss runs on each rank's batch rows against the
whole table, in an island: each rank's share of the mean is its rows'
mean times its share of the rows, a Partial value summed over the batch
axes.  The table's gradient leaves the island Partial over those axes
and is reduced to the table's own ("model", "fsdp") placements: the JAX
backward's ``constrain(dE, "model", "fsdp")``.
"""
from __future__ import annotations

import torch

from repro_torch.dist import sharding


def _chunk_logits(h_c: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B, c, d) x (V, d) -> (B, c, V) f32: the product in the activation
    dtype (f32 accumulation inside), then upcast."""
    return torch.matmul(h_c, table.t()).to(torch.float32)


class _FusedXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, table, labels, chunk):
        B, S, _ = h.shape
        lse = torch.empty((B, S), dtype=torch.float32, device=h.device)
        gold = torch.empty((B, S), dtype=torch.float32, device=h.device)
        for c0 in range(0, S, chunk):
            logits = _chunk_logits(h[:, c0:c0 + chunk], table)
            lse[:, c0:c0 + chunk] = torch.logsumexp(logits, dim=-1)
            gold[:, c0:c0 + chunk] = torch.gather(
                logits, -1, labels[:, c0:c0 + chunk, None].long())[..., 0]
            del logits
        ctx.save_for_backward(h, table, labels, lse)
        ctx.chunk = chunk
        return torch.mean(lse - gold)

    @staticmethod
    def backward(ctx, g):
        h, table, labels, lse = ctx.saved_tensors
        B, S, _ = h.shape
        chunk = ctx.chunk
        scale = g.to(torch.float32) / (B * S)
        dE = torch.zeros(table.shape, dtype=torch.float32, device=h.device)
        dh = torch.empty_like(h)
        for c0 in range(0, S, chunk):
            h_c = h[:, c0:c0 + chunk]
            p = _chunk_logits(h_c, table)
            p.sub_(lse[:, c0:c0 + chunk, None]).exp_()          # softmax
            idx = labels[:, c0:c0 + chunk, None].long()
            p.scatter_(-1, idx, torch.gather(p, -1, idx) - 1.0)
            dlog = p.mul_(scale)
            d_t = dlog.to(table.dtype)
            d_h = d_t if h.dtype == table.dtype else dlog.to(h.dtype)
            del p, dlog
            dh[:, c0:c0 + chunk] = torch.matmul(d_t, table).to(h.dtype)
            dE += torch.matmul(d_h.flatten(0, 1).t(),
                               h_c.flatten(0, 1)).to(torch.float32)
            del d_t, d_h
        return dh, dE.to(table.dtype), None, None


def chunk_size(S: int, chunk: int) -> int:
    """The JAX function's rule: min(chunk, S), halved until it divides S."""
    c = min(chunk, S)
    while S % c != 0:
        c //= 2
    return max(1, c)


def fused_unembed_xent(h: torch.Tensor, table: torch.Tensor,
                       labels: torch.Tensor, chunk: int = 512
                       ) -> torch.Tensor:
    """Mean token NLL of softmax(h @ table^T) against labels, computed
    without materializing full logits.  h (B, S, d); table (V, d); labels
    (B, S) int.  Returns a 0-d f32 tensor."""
    chunk = chunk_size(h.shape[1], chunk)
    if sharding.on_mesh(h, table):
        return _mesh_xent(h, table, labels, chunk)
    return _FusedXent.apply(h, table, labels, chunk)


def _mesh_xent(h, table, labels, chunk: int):
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = sharding.current_mesh()
    h = sharding.constrain(h, "batch", None, None)
    labels = sharding.place(labels, "batch", None)
    h_pl = tuple(h.placements)
    rows_pl = tuple(Shard(0) if p == Shard(0) else Replicate()
                    for p in h_pl)
    B = h.shape[0]

    def local(hl, tl, ll):
        return _FusedXent.apply(hl, tl, ll, chunk) * (hl.shape[0] / B)

    loss = sharding.island(
        local, mesh, (h, table, labels),
        (h_pl, (Replicate(),) * mesh.ndim, rows_pl),
        tuple(Partial() if p == Shard(0) else Replicate() for p in h_pl))
    return sharding.constrain(loss)
