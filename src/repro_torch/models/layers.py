"""Core layers: rmsnorm and layernorm, dense, embeddings, rotary
(standard and M-RoPE), sinusoidal positions, the swiglu and gelu MLPs.
Port of the same functions in ``repro/models/layers.py``, with the same
dtype discipline (the tests hold each against its JAX function).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import grad_as_value, is_dtensor


def _mean_last(x: torch.Tensor) -> torch.Tensor:
    """``x.mean(dim=-1, keepdim=True)``.  Where a mesh splits the last dim
    over more than one rank, the mean of a DTensor comes back Partial
    (avg), which DTensor resolves at the next op by reduce-scattering over
    the sequence (a split that a later matmul cannot take) and whose
    backward cannot meet a Partial (sum) gradient; so there the sum is
    reduced to Replicate over the ranks (GSPMD's all-reduce) and divided.
    A plain tensor, or a last dim that no rank splits, takes the mean."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        last = x.dim() - 1
        split = 1
        for m, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == last:
                split *= x.device_mesh.size(m)
        if split > 1:
            s = x.sum(dim=-1, keepdim=True)
            s = s.redistribute(s.device_mesh, [
                Replicate() if p.is_partial() else p for p in s.placements])
            return s / x.shape[-1]
    return x.mean(dim=-1, keepdim=True)


def _reduced(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with a Partial placement reduced there (Replicate): a
    norm is not linear, and GSPMD reduces its input once, where DTensor
    would reduce it for the statistic alone and carry the Partial value
    on through the scale into the next products (a decode step's
    residual after the row-parallel output projection)."""
    if is_dtensor(x) and any(p.is_partial() for p in x.placements):
        from torch.distributed.tensor import Replicate
        return x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    return x


def split_heads(x, n: int, hd: int):
    """x (..., n * hd) as (..., n, hd).  Under a mesh DTensor unflattens a
    sharded feature dim only when its split falls on whole heads; where
    the mesh dims that split it do not divide n (qwen2-0.5b's 14 heads
    over a model axis of 16, a reduced Mamba2's 8 SSD heads) the dim is
    replicated first, as GSPMD reshards it there in the JAX package."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        last = x.dim() - 1
        on = [isinstance(p, Shard) and p.dim == last for p in x.placements]
        split = 1
        for i, o in enumerate(on):
            split *= x.device_mesh.size(i) if o else 1
        if n % split:
            x = x.redistribute(x.device_mesh, [
                Replicate() if o else p for p, o in zip(x.placements, on)])
    return x.reshape(*x.shape[:-1], n, hd)


class _MergeHeads(torch.autograd.Function):
    """(..., n, hd) -> (..., n * hd), whose backward splits the gradient
    with ``split_heads``: the gradient that comes back from the output
    projection may be split over the model axis where n is not."""

    @staticmethod
    def forward(ctx, x):
        ctx.n, ctx.hd = x.shape[-2], x.shape[-1]
        return x.reshape(*x.shape[:-2], ctx.n * ctx.hd)

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, ctx.n, ctx.hd)


def merge_heads(x):
    """(..., n, hd) -> (..., n * hd); under a mesh through
    ``_MergeHeads``, a plain reshape otherwise."""
    if is_dtensor(x):
        return _MergeHeads.apply(x)
    return x.reshape(*x.shape[:-2], -1)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm: the variance accumulates in f32, the rsqrt factor and the
    scale are applied in x's dtype (as the JAX package does, to keep bf16
    activations from being upcast wholesale)."""
    x = _reduced(x)
    var = _mean_last((x * x).to(torch.float32))
    r = torch.rsqrt(var + eps).to(x.dtype)
    return x * r * scale.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics (biased variance) and f32 scale and
    bias; the output in x's dtype."""
    x32 = _reduced(x).to(torch.float32)
    mu = _mean_last(x32)
    var = _mean_last((x32 - mu) ** 2)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def _contracted_split(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x with its last dim split as a row-parallel weight's first dim is
    (a free slice of a replicated x; a Partial one reduce-scattered), as
    GSPMD splits a dot's operand along a sharded contracting dim.
    DTensor would slice x inside the product and keep the whole x for the
    backward, whose weight gradient it then computes whole on every
    rank."""
    from torch.distributed.tensor import Shard
    last = x.dim() - 1
    pl = [Shard(last) if p == Shard(0) and (q.is_replicate() or
                                            q.is_partial()) else q
          for p, q in zip(w.placements, x.placements)]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    if w.dim() == 2 and is_dtensor(x) and is_dtensor(w):
        y = grad_as_value(_contracted_split(x, w) @ w)
    else:
        y = x @ w
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  Under a device mesh (a DTensor table) the
    gather runs in an island on each rank's token rows against its rows
    of the table: DTensor does not propagate the indexing."""
    from repro_torch.dist import sharding
    if sharding.on_mesh(tokens, table):
        return _mesh_embed(tokens, table)
    return table[tokens]


def _mesh_embed(tokens, table):
    """The embedding gather under a mesh: the tokens batch-sharded, the
    table's vocabulary split over the model axis where it divides V and
    its d as ``sharding.vocab_split`` leaves it.  Each rank gathers the
    rows it owns and zeroes the others; the sum over the vocabulary's
    ranks (a Partial value) is reduced, and a split d gathered, to
    ("batch", None, ...).  The table's gradient stays on each rank's
    rows, Partial over the batch axes and reduced to the table's own
    placements."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.dist import sharding
    mesh = sharding.current_mesh()
    rest = [None] * (tokens.dim() - 1)
    tokens = sharding.place(tokens, "batch", *rest)
    tok_pl = tuple(tokens.placements)
    t_pl, dims, d_dims = sharding.vocab_split(table, tok_pl)
    out_pl = tuple(Shard(0) if p == Shard(0) else
                   Partial() if m in dims else
                   Shard(tokens.dim()) if m in d_dims else Replicate()
                   for m, p in enumerate(tok_pl))

    def local(t, e):
        if not dims:
            return e[t]
        V = e.shape[0]
        i = t.long() - sharding.mesh_coordinate(mesh, dims) * V
        own = (i >= 0) & (i < V)
        return e[torch.where(own, i, 0)].masked_fill(~own[..., None], 0)

    out = sharding.island(local, mesh, (tokens, table), (tok_pl, t_pl),
                          out_pl)
    return sharding.constrain(out, "batch", *rest, None)


def unembed(h: torch.Tensor, table: torch.Tensor,
            upcast: bool = False) -> torch.Tensor:
    """Logits via the (possibly tied) embedding table: (..., d) @ (V,
    d)^T, both in f32 when ``upcast``.  Under a device mesh the product
    runs in an island on each rank's rows of the table (the vocabulary
    over the model axis where it divides V, as in ``embed``), and the
    logits come out split over the vocabulary as the table is, never
    whole on a rank."""
    from repro_torch.dist import sharding
    if sharding.on_mesh(h, table):
        return _mesh_unembed(h, table, upcast)
    if upcast:
        h, table = h.to(torch.float32), table.to(torch.float32)
    return h @ table.T


def _mesh_unembed(h, table, upcast: bool):
    """``unembed`` under a mesh: h batch-sharded, the table as
    ``sharding.vocab_split`` places it; the logits split over the
    vocabulary, Partial over a mesh dim that splits d."""
    from torch.distributed.tensor import Partial, Shard
    from repro_torch.dist import sharding
    h = sharding.constrain(h, "batch", *([None] * (h.dim() - 1)))
    t_pl, _, d_dims = sharding.vocab_split(table, h.placements)
    last = h.dim() - 1
    h_pl = tuple(Shard(last) if m in d_dims else p
                 for m, p in enumerate(h.placements))
    out_pl = tuple(Shard(last) if t == Shard(0) else
                   Partial() if m in d_dims else p
                   for m, (p, t) in enumerate(zip(h.placements, t_pl)))

    def local(hl, tl):
        if upcast:
            hl, tl = hl.to(torch.float32), tl.to(torch.float32)
        return hl @ tl.T

    return sharding.island(local, sharding.current_mesh(), (h, table),
                           (h_pl, t_pl), out_pl)


def _inv_freqs(half: int, theta: float, device) -> torch.Tensor:
    """theta ** (-i / half) for i < half, f32: the f32 exponents raised in
    f64 and rounded once, which gives the JAX package's frequencies bit
    for bit (an f32 ``torch.pow`` is an ulp off on some of them, and the
    angle carries that ulp times the position)."""
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float64, device=device),
                     exps.to(torch.float64)).to(torch.float32)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> (cos, sin) of shape (..., S, head_dim/2)."""
    freqs = _inv_freqs(head_dim // 2, theta, positions.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE (Qwen2-VL): positions (3, B, S), one stream each for time,
    height and width.  The rotary half-dim is cut into ``sections`` in
    that order, each section's angles taken from its own stream; returns
    (cos, sin) of shape (B, S, head_dim/2)."""
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    freqs = _inv_freqs(half, theta, positions.device)
    ang_all = positions.to(torch.float32)[..., None] * freqs  # (3,B,S,half)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang_all[i, ..., start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, D/2).  Rotate-half convention."""
    x32 = x.to(torch.float32)
    half = x.shape[-1] // 2
    x1, x2 = x32[..., :half], x32[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# XLA's f32 exp on the CPU: Cephes' range reduction and degree-5
# polynomial, each step one fused multiply-add
_LN2_HI, _LN2_LO = 0.693359375, -2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _exp_as_xla(x: torch.Tensor) -> torch.Tensor:
    """exp of an f32 tensor as the JAX package's CPU backend computes it,
    bit for bit: n = floor(x log2 e + 1/2), r = x - n ln 2 in two parts,
    the polynomial in r by Horner's rule, 2^n (1 + r + r^2 p(r)).  Each
    fused multiply-add runs in f64 (the product of two f32 values is
    exact there) and is rounded to f32.  A correctly rounded exp differs
    from it by an ulp on about a tenth of f32 arguments."""
    f32, f64 = torch.float32, torch.float64

    def const(v):
        return torch.tensor(v, dtype=f32, device=x.device)

    def fma(a, b, c):
        return (a.to(f64) * b.to(f64) + c.to(f64)).to(f32)

    x = torch.clamp(x, -104.0, 88.8)
    n = torch.floor(x * const(1.44269504088896341) + const(0.5))
    r = fma(n, const(-_LN2_HI), x)
    r = fma(n, const(-_LN2_LO), r)
    y = const(_EXP_POLY[0]).expand_as(r)
    for p in _EXP_POLY[1:]:
        y = fma(y, r, const(p))
    y = fma(y, r * r, r) + const(1.0)
    return y * torch.exp2(n)


def sinusoidal_positions(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """Whisper's fixed sinusoidal embeddings: positions (..., S) -> (...,
    S, d_model) f32, the sines then the cosines.  The frequencies are the
    JAX package's f32 exponents through ``_exp_as_xla``, so the table is
    the JAX package's up to sin and cos."""
    half = d_model // 2
    scale = _exp_as_xla(-torch.arange(half, dtype=torch.float32,
                                      device=positions.device)
                        * (math.log(10000.0) / max(1, half - 1)))
    ang = positions.to(torch.float32)[..., None] * scale
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def swiglu(x, w_gate, w_up, w_down):
    g = dense(x, w_gate)
    u = dense(x, w_up)
    return dense(F.silu(g) * u, w_down)


def gelu_mlp(x, w_up, b_up, w_down, b_down):
    """The tanh-approximate GELU MLP, with biases."""
    h = F.gelu(dense(x, w_up, b_up), approximate="tanh")
    return dense(h, w_down, b_down)
