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

from repro_torch.dist.sharding import is_dtensor


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


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm: the variance accumulates in f32, the rsqrt factor and the
    scale are applied in x's dtype (as the JAX package does, to keep bf16
    activations from being upcast wholesale)."""
    var = _mean_last((x * x).to(torch.float32))
    r = torch.rsqrt(var + eps).to(x.dtype)
    return x * r * scale.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics (biased variance) and f32 scale and
    bias; the output in x's dtype."""
    x32 = x.to(torch.float32)
    mu = _mean_last(x32)
    var = _mean_last((x32 - mu) ** 2)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  Under a device mesh (a DTensor table) the
    gather runs on each rank's token rows against the whole table, in an
    island: DTensor does not propagate the indexing."""
    from repro_torch.dist import sharding
    if sharding.on_mesh(tokens, table):
        return _mesh_embed(tokens, table)
    return table[tokens]


def _mesh_embed(tokens, table):
    """The embedding gather under a mesh: the tokens batch-sharded, the
    table gathered whole (its gradient comes back Partial over the batch
    axes and is reduced to the table's own placements)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.dist import sharding
    mesh = sharding.current_mesh()
    tokens = sharding.place(tokens, "batch", *([None] * (tokens.dim() - 1)))
    tok_pl = tuple(tokens.placements)
    out_pl = tuple(Shard(0) if p == Shard(0) else Replicate()
                   for p in tok_pl)
    return sharding.island(lambda t, e: e[t], mesh, (tokens, table),
                           (tok_pl, (Replicate(),) * mesh.ndim), out_pl)


def unembed(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits via the (possibly tied) embedding table: (..., d) @ (V, d)^T."""
    return h @ table.T


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


def sinusoidal_positions(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """Whisper's fixed sinusoidal embeddings: positions (..., S) -> (...,
    S, d_model) f32, the sines then the cosines."""
    half = d_model // 2
    scale = torch.exp(-torch.arange(half, dtype=torch.float32,
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
